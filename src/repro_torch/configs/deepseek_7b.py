# Copy of src/repro/configs/deepseek_7b.py (no import of the JAX package).
"""deepseek-7b [dense] 30L d_model=4096 32H (GQA kv=32) d_ff=11008 vocab=102400
llama-arch (MHA: kv == heads). [arXiv:2401.02954; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab=102400,
    rope_theta=10000.0,
    source="arXiv:2401.02954; hf",
)
