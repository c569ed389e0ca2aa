"""Hand-written Hopper kernels of the port (`csrc/*.cu`, built by
`build.py`), their wrappers, their plain PyTorch versions (`ref.py`) and the
device dispatch (`ops.py`)."""
