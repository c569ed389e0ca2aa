# Copy of src/repro/configs/llama31_8b.py (no import of the JAX package).
"""llama3.1-8b — the paper's OWN serving replica model
(meta-llama/Llama-3.1-8B-Instruct on L4 GPUs, SkyLB §5 setup).
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256. [arXiv:2407.21783; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama31-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=128256,
    rope_theta=500000.0,
    source="arXiv:2407.21783; hf (paper's serving model)",
)
