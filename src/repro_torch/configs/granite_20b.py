"""granite-20b code model [arXiv:2405.04324] — llama-arch, MQA (kv=1)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152,
    activation="swiglu",
    source="arXiv:2405.04324 (Granite Code Models)",
)
SMOKE = CONFIG.reduced(n_kv_heads=1)
