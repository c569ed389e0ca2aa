"""Entry points of the port: `python -m repro_torch.launch.serve` (the
serving launcher over the port's torch engines)."""
