"""zamba2-1.2b [arXiv:2411.15242] — Mamba-2 trunk + shared attention block
applied every 6 SSM blocks (weight reuse; simplified: no per-block LoRA)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_version=2,
    ssm_head_dim=64, attn_every=6,
    activation="swiglu",
    source="arXiv:2411.15242 (Zamba2)",
)
SMOKE = CONFIG.reduced()
