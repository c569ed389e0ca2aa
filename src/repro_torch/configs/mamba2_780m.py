# Copy of src/repro/configs/mamba2_780m.py (no import of the JAX package).
"""mamba2-780m [ssm] 48L d_model=1536 (attn-free) d_ff=0 vocab=50280,
ssm_state=128 — SSD (state-space duality). [arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    attention="none",
    tie_embeddings=True,
    ssm=SSMConfig(state=128, head_dim=64, expand=2, n_groups=1, chunk=256),
    source="arXiv:2405.21060; unverified",
)
