"""smollm-135m [hf:HuggingFaceTB/SmolLM-135M] — small llama-arch, GQA kv=3."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
    d_ff=1536, vocab_size=49152, tie_embeddings=True,
    activation="swiglu",
    source="hf:HuggingFaceTB/SmolLM-135M",
)
SMOKE = CONFIG.reduced(n_heads=3, n_kv_heads=3)
