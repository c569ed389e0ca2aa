# Copy of src/repro/configs/starcoder2_7b.py (no import of the JAX package).
"""starcoder2-7b [dense] 32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152
GQA, RoPE. [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab=49152,
    gated_mlp=False,           # starcoder2 uses a plain GELU MLP (c_fc/c_proj)
    rope_theta=1_000_000.0,
    source="arXiv:2402.19173; hf",
)
