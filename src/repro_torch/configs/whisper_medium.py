"""whisper-medium [arXiv:2212.04356] — enc-dec audio transformer backbone.
Conv/mel frontend is a stub: inputs are precomputed frame embeddings."""
from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=51865,
    activation="gelu", norm="layernorm", tie_embeddings=True,
    encoder=EncoderConfig(n_layers=24, n_heads=16, n_frames=1500),
    source="arXiv:2212.04356 (Whisper)",
)
SMOKE = CONFIG.reduced()
