# Copy of src/repro/configs/chameleon_34b.py (no import of the JAX package).
"""chameleon-34b [vlm] 48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536
early-fusion, VQ image tokens. [arXiv:2405.09818; unverified]

Early fusion means image content arrives as VQ codebook tokens inside the
shared 65536 vocab — the backbone sees one token stream, so input_specs are
plain token ids (the VQ tokenizer itself is out of scope / stubbed).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=65536,
    qk_norm=True,              # chameleon uses qk-norm for stability
    rope_theta=10000.0,
    source="arXiv:2405.09818; unverified",
)
