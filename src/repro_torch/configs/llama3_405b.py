"""llama3-405b [arXiv:2407.21783] — dense GQA, 128k vocab."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
    d_ff=53248, vocab_size=128256,
    activation="swiglu", rope_theta=500_000.0,
    source="arXiv:2407.21783 (The Llama 3 Herd of Models)",
)
SMOKE = CONFIG.reduced()
