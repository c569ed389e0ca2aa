# Copy of src/repro/configs/base.py (no import of the JAX package).
"""Model / shape configuration system.

Every assigned architecture is a `ModelConfig`; every assigned input shape is a
`ShapeConfig`. `input_specs(cfg, shape)` (in launch/dryrun.py) turns a pair into
ShapeDtypeStruct stand-ins for the dry-run; `reduced()` returns a tiny config of
the same family for CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0          # 0 => dense FFN
    top_k: int = 0
    d_expert: int = 0           # per-expert hidden dim
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    state: int = 0              # N, SSM state dim; 0 => no SSM layers
    head_dim: int = 64          # P, mamba2 head dim
    expand: int = 2             # d_inner = expand * d_model
    n_groups: int = 1           # B/C groups
    conv_width: int = 4
    chunk: int = 256            # SSD chunk length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 => d_model // n_heads
    qk_norm: bool = False
    gated_mlp: bool = True      # SwiGLU (3 mats) vs plain GELU MLP (2 mats)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    # hybrid (zamba2-style): a shared attention+MLP block applied every
    # `attn_every` SSM layers, one parameter set reused for all applications.
    attn_every: int = 0
    # enc-dec (whisper-style)
    is_encdec: bool = False
    n_enc_layers: int = 0
    src_frames: int = 1500      # stub frontend sequence length
    # frontends: 'none' (tokens), 'audio_stub' (precomputed frame embeddings)
    frontend: str = "none"
    # attention flavor: 'full' | 'none' (pure SSM)
    attention: str = "full"
    max_seq_len: int = 32768 * 16 + 64
    source: str = ""            # provenance tag from the assignment table

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    @property
    def is_moe(self) -> bool:
        return self.moe.n_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.ssm.state > 0 and self.attn_every == 0 and self.attention == "none"

    @property
    def is_hybrid(self) -> bool:
        return self.ssm.state > 0 and self.attn_every > 0

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm.head_dim

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic archs (SSM / hybrid) run long_500k; pure attention skips."""
        return self.ssm.state > 0

    @property
    def has_decode(self) -> bool:
        """Encoder-only archs would skip decode; none assigned here."""
        return True

    def param_count(self) -> int:
        """Analytic parameter count (matches init exactly; used for 6ND)."""
        c = self
        n = c.vocab * c.d_model                      # embed
        if not c.tie_embeddings:
            n += c.vocab * c.d_model                 # lm head
        n += c.d_model                               # final norm

        def attn_params() -> int:
            p = c.d_model * c.q_dim + 2 * c.d_model * c.kv_dim + c.q_dim * c.d_model
            p += 2 * c.d_model                       # pre-norms (attn, mlp)
            if c.qk_norm:
                p += 2 * c.hd
            return p

        def dense_ffn() -> int:
            return (3 if c.gated_mlp else 2) * c.d_model * c.d_ff

        def moe_ffn() -> int:
            m = c.moe
            return c.d_model * m.n_experts + m.n_experts * 3 * c.d_model * m.d_expert

        def mamba_params() -> int:
            s = c.ssm
            di, g, h = c.d_inner, s.n_groups, c.d_inner // s.head_dim
            in_proj = c.d_model * (2 * di + 2 * g * s.state + h)
            conv = (di + 2 * g * s.state) * (s.conv_width + 1)  # + biases
            extra = 3 * h + di          # A_log, D, dt_bias, gated-norm scale
            out = di * c.d_model
            return in_proj + conv + extra + out + c.d_model  # + pre-norm

        if c.is_hybrid:
            n += c.n_layers * mamba_params()
            n += attn_params() + dense_ffn()         # ONE shared block
        elif c.is_ssm:
            n += c.n_layers * mamba_params()
        elif c.is_encdec:
            # encoder: self-attn + ffn; decoder: self + cross + ffn
            enc = attn_params() + dense_ffn()
            dec = attn_params() + dense_ffn()
            dec += c.d_model * c.q_dim + 2 * c.d_model * c.kv_dim + c.q_dim * c.d_model
            dec += c.d_model                         # cross-attn pre-norm
            n += c.n_enc_layers * enc + c.n_layers * dec + c.d_model  # enc final norm
        elif c.is_moe:
            n += c.n_layers * (attn_params() + moe_ffn())
        else:
            n += c.n_layers * (attn_params() + dense_ffn())
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.param_count()
        m = self.moe
        full_moe = self.n_layers * (m.n_experts * 3 * self.d_model * m.d_expert)
        active_moe = self.n_layers * (m.top_k * 3 * self.d_model * m.d_expert)
        return self.param_count() - full_moe + active_moe

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        small_moe = dataclasses.replace(
            self.moe, n_experts=min(self.moe.n_experts, 4),
            top_k=min(self.moe.top_k, 2), d_expert=min(self.moe.d_expert, 64),
        ) if self.is_moe else self.moe
        small_ssm = dataclasses.replace(
            self.ssm, state=min(self.ssm.state, 16), head_dim=16, chunk=16,
        ) if self.ssm.state else self.ssm
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 4) if not self.is_hybrid else 4,
            n_enc_layers=min(self.n_enc_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab=503,
            moe=small_moe,
            ssm=small_ssm,
            attn_every=2 if self.attn_every else 0,
            src_frames=24,
            max_seq_len=4096,
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch, shape) cell runs; reason if skipped (DESIGN §4)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "full-attention arch: long_500k needs sub-quadratic attention (skip per spec)"
    if shape.kind == "decode" and not cfg.has_decode:
        return False, "encoder-only arch has no decode step"
    return True, ""
