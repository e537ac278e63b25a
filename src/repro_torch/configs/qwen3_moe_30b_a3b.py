"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B] — 128 experts top-8."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=768, vocab_size=151936,
    n_experts=128, top_k=8, moe_d_ff=768,
    activation="swiglu", rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-30B-A3B",
)
SMOKE = CONFIG.reduced()
