"""Model configuration system.

One `ModelConfig` per architecture (the reference's, field for field);
each ported architecture has its own module in `repro_torch/configs/`
exporting ``CONFIG`` (the published config) and ``SMOKE`` (reduced: <=2
layers, d_model<=512, <=4 experts; runs on CPU).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder tower for encoder-decoder models (whisper).  The modality
    frontend (mel+conv) is a stub: inputs are precomputed frame embeddings."""

    n_layers: int
    n_heads: int
    n_frames: int = 1500          # whisper-medium: 30 s of audio


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    #                               | falcon_h1
    n_layers: int
    d_model: int
    n_heads: int                  # 0 for attention-free (ssm)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0             # expert hidden dim (d_ff of one expert)
    capacity_factor: float = 1.25
    # --- SSM (mamba) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_version: int = 1          # 1 = mamba1 (falcon-mamba), 2 = mamba2
    ssm_head_dim: int = 64        # mamba2 head dim
    ssm_heads: int = 0            # falcon_h1 mixer heads (d_inner = heads x
    #                               ssm_head_dim); 0: d_inner from ssm_expand
    ssm_groups: int = 1           # falcon_h1 mixer B/C groups
    # --- hybrid (zamba2) ---
    attn_every: int = 0           # shared attention block every k ssm blocks
    # --- muP multipliers (falcon_h1; 1 elsewhere), the published names ---
    embedding_multiplier: float = 1.0   # the embedded rows
    lm_head_multiplier: float = 1.0     # the logits
    attention_in_multiplier: float = 1.0
    attention_out_multiplier: float = 1.0
    key_multiplier: float = 1.0         # k, before RoPE and the 1/sqrt(hd)
    ssm_in_multiplier: float = 1.0
    ssm_out_multiplier: float = 1.0
    #: in_proj's z, x, B, C and dt sections
    ssm_multipliers: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0, 1.0)
    #: the MLP's gate (before SiLU) and its down projection's output
    mlp_multipliers: Tuple[float, ...] = (1.0, 1.0)
    # --- attention flavor ---
    sliding_window: int = 0       # 0 = full attention
    rope_theta: float = 10_000.0
    mrope: bool = False           # Qwen2-VL multimodal rotary (3 sections)
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w half-dims
    # --- MLP flavor ---
    activation: str = "swiglu"    # swiglu | gelu | relu2
    # --- encoder-decoder ---
    encoder: Optional[EncoderConfig] = None
    # --- vlm ---
    n_img_tokens: int = 0         # patch-embedding stub length (per batch)
    # --- misc ---
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    source: str = ""              # citation for the config

    def __post_init__(self):
        # a configuration read from JSON gives lists: kept as tuples, so
        # the config stays hashable
        for name in ("ssm_multipliers", "mlp_multipliers"):
            object.__setattr__(self, name, tuple(getattr(self, name)))
        if self.n_heads and self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads and self.n_kv_heads:
            assert self.n_heads % self.n_kv_heads == 0, \
                f"{self.arch_id}: GQA needs n_heads % n_kv_heads == 0"

    @property
    def d_inner(self) -> int:
        if self.ssm_heads:
            return self.ssm_heads * self.ssm_head_dim
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, self.d_model // 16)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic context handling: SSM state, hybrid, or a sliding
        window bound the per-token cost; pure full attention does not."""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window > 0)

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test-sized variant of the same family."""
        small = dict(
            n_layers=2,
            d_model=min(self.d_model, 128),
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=(min(self.n_kv_heads, 2) if self.n_kv_heads else 0),
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=32 if self.n_heads else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_d_ff=min(self.moe_d_ff, 128) if self.moe_d_ff else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.family in ("ssm", "hybrid") else 64,
            attn_every=2 if self.attn_every else 0,
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else 0,
            mrope_sections=(8, 4, 4) if self.mrope else (16, 24, 24),
            n_img_tokens=min(self.n_img_tokens, 16),
            encoder=EncoderConfig(n_layers=2, n_heads=4, n_frames=32)
            if self.encoder else None,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)

    def param_count(self) -> int:
        """Analytic parameter count (for 6·N·D model FLOPs)."""
        D, V, L = self.d_model, self.vocab_size, self.n_layers
        n = V * D  # embedding
        if not self.tie_embeddings:
            n += D * V
        hd = self.head_dim
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "encdec"):
            atn = D * self.n_heads * hd + 2 * D * self.n_kv_heads * hd \
                + self.n_heads * hd * D
            per_layer += atn + 2 * D
            if self.n_experts:
                ff = self.n_experts * 3 * D * self.moe_d_ff \
                    + D * self.n_experts
            else:
                mult = 3 if self.activation == "swiglu" else 2
                ff = mult * D * self.d_ff
            per_layer += ff
        elif self.family == "ssm":
            di, N = self.d_inner, self.ssm_state
            per_layer += D * 2 * di + di * self.ssm_conv \
                + di * (self.dt_rank + 2 * N) + self.dt_rank * di \
                + di * N + di + di * D + D
        elif self.family == "hybrid":
            di, N = self.d_inner, self.ssm_state
            per_layer += D * 2 * di + di * self.ssm_conv + 2 * di \
                + di * N + di + di * D + D  # mamba2-ish block
        elif self.family == "falcon_h1":
            di, nh = self.d_inner, self.ssm_heads
            conv = di + 2 * self.ssm_groups * self.ssm_state
            per_layer += D * (di + conv + nh) + conv * (self.ssm_conv + 1) \
                + 3 * nh + di + di * D                       # the mixer
            per_layer += D * self.n_heads * hd \
                + 2 * D * self.n_kv_heads * hd + self.n_heads * hd * D \
                + 3 * D * self.d_ff + 2 * D     # attention, MLP, norms
        n += L * per_layer
        if self.family == "hybrid" and self.attn_every:
            hd_ = self.head_dim
            shared = (D * self.n_heads * hd_ + 2 * D * self.n_kv_heads * hd_
                      + self.n_heads * hd_ * D + 3 * D * self.d_ff + 2 * D)
            n += shared  # one shared block, reused
        if self.encoder is not None:
            e = self.encoder
            enc_layer = 4 * D * D + 3 * D * self.d_ff + 2 * D
            n += e.n_layers * enc_layer
            # decoder cross-attention
            n += L * (4 * D * D + D)
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        D, L = self.d_model, self.n_layers
        all_experts = L * self.n_experts * 3 * D * self.moe_d_ff
        active = L * self.top_k * 3 * D * self.moe_d_ff
        return self.param_count() - all_experts + active
