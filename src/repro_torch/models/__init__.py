"""Model pieces of the paged serving path (PyTorch port of `repro.models`):
layers, GQA attention projections + SDPA, and the stacked parameter tree."""
from repro_torch.models.transformer import (init_params, init_weights, layer,
                                          leaves, param_count)

__all__ = ["init_params", "init_weights", "layer", "leaves", "param_count"]
