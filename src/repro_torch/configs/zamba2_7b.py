# Copy of src/repro/configs/zamba2_7b.py (no import of the JAX package).
"""zamba2-7b [hybrid] 81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000,
ssm_state=64 — Mamba2 backbone + SHARED attn blocks. [arXiv:2411.15242; unverified]

Layer mapping (DESIGN §4): 81 Mamba2 layers = 13 groups x 6 + 3 tail; ONE
shared attention+MLP block (one parameter set) applied after each group
(13 applications), zamba2's shared-block-every-6 pattern.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,               # mamba2 layers
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    # chunk=128 keeps the intra-chunk (Q x Q) SSD tensors inside per-chip HBM
    # at train_4k with 112 SSM heads (see EXPERIMENTS roofline notes)
    ssm=SSMConfig(state=64, head_dim=64, expand=2, n_groups=1, chunk=128),
    attn_every=6,
    rope_theta=10000.0,
    source="arXiv:2411.15242; unverified",
)
