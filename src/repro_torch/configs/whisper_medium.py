# Copy of src/repro/configs/whisper_medium.py (no import of the JAX package).
"""whisper-medium [audio] 24L d_model=1024 16H (GQA kv=16) d_ff=4096
vocab=51865 — enc-dec, conv frontend (STUB: input_specs provides precomputed
frame embeddings (batch, 1500, d_model)). [arXiv:2212.04356; unverified]

Assigned seq_len applies to the DECODER; the encoder runs over the fixed
1500-frame stub (30s of audio after 2x conv downsampling).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,               # decoder layers
    n_enc_layers=24,
    is_encdec=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    gated_mlp=False,           # whisper uses plain GELU MLP
    rope_theta=10000.0,
    frontend="audio_stub",
    src_frames=1500,
    source="arXiv:2212.04356; unverified",
)
