"""mixtral-8x22b [arXiv:2401.04088] — MoE 8 experts top-2, SWA."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=32768,
    n_experts=8, top_k=2, moe_d_ff=16384,
    sliding_window=4096, activation="swiglu",
    source="arXiv:2401.04088 (Mixtral of Experts)",
)
SMOKE = CONFIG.reduced()
