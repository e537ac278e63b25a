"""qwen2-vl-7b [arXiv:2409.12191] — VLM backbone with M-RoPE.
ViT frontend is a stub: inputs include precomputed patch embeddings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab_size=152064,
    activation="swiglu", mrope=True, mrope_sections=(16, 24, 24),
    n_img_tokens=256, rope_theta=1_000_000.0,
    source="arXiv:2409.12191 (Qwen2-VL)",
)
SMOKE = CONFIG.reduced(n_heads=4, n_kv_heads=2, mrope_sections=(8, 4, 4))
