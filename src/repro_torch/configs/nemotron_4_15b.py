"""nemotron-4-15b [arXiv:2402.16819] — dense GQA, squared-ReLU MLP,
256k vocab (the largest assigned embedding surface)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=24576, vocab_size=256000,
    activation="relu2", norm="layernorm",
    source="arXiv:2402.16819 (Nemotron-4 15B)",
)
SMOKE = CONFIG.reduced()
