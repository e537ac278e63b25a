"""falcon-h1-34b [Falcon-H1, TII 2025; the published config.json of
tiiuae/Falcon-H1-34B-Instruct] — a parallel hybrid: in every layer one
RMSNorm feeds GQA attention (20 query and 4 KV heads of 128, RoPE theta
1e11) and a Mamba-2 mixer (32 heads of 128, state 256 in 2 groups of
B/C, conv 4, a gated RMSNorm) side by side, then a SwiGLU MLP; untied,
with muP multipliers on every branch.  No twin in the reference package
(`registry.PORT_ONLY`); trained only, no decoding."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="falcon-h1-34b", family="falcon_h1",
    n_layers=72, d_model=5120, n_heads=20, n_kv_heads=4, head_dim=128,
    d_ff=21504, vocab_size=261120,
    ssm_state=256, ssm_conv=4, ssm_head_dim=128,
    ssm_heads=32, ssm_groups=2,
    rope_theta=1e11, activation="swiglu", norm="rmsnorm", norm_eps=1e-5,
    embedding_multiplier=5.656854249492381,
    lm_head_multiplier=0.0078125,
    attention_in_multiplier=1.0,
    attention_out_multiplier=0.0375,
    key_multiplier=0.011048543456039804,
    ssm_in_multiplier=0.25,
    ssm_out_multiplier=0.08838834764831845,
    ssm_multipliers=(0.3535533905932738, 0.25, 0.1767766952966369, 0.5,
                     0.3535533905932738),
    mlp_multipliers=(0.1767766952966369, 0.011160714285714284),
    source="https://huggingface.co/tiiuae/Falcon-H1-34B-Instruct "
           "(config.json; Falcon-H1, TII 2025)",
)
#: two layers at d_model 128: 4 query / 2 KV heads of 32, a mixer of 4
#: heads of 32 in 2 groups of B/C with a state of 32 (two of the scan's
#: 16-state slices a group)
SMOKE = CONFIG.reduced(ssm_heads=4, ssm_head_dim=32, ssm_groups=2,
                       ssm_state=32)
