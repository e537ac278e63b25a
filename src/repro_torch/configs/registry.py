"""Architecture registry: ``get_config(arch_id)`` resolution for every
architecture of the reference (the dense, MoE, ssm, hybrid, vlm and
encdec families), and for the port's own architectures, which have no
twin in the reference (`PORT_ONLY`) and so stay out of ``ARCH_IDS``."""
from importlib import import_module

_MODULES = {
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "granite-20b": "repro_torch.configs.granite_20b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "nemotron-4-15b": "repro_torch.configs.nemotron_4_15b",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
}

ARCH_IDS = tuple(_MODULES)

#: architectures of the port alone: the reference runs none of them, so
#: nothing that walks ``ARCH_IDS`` against the reference meets them
PORT_ONLY = {
    "falcon-h1-34b": "repro_torch.configs.falcon_h1_34b",
}


def get_config(arch_id: str, smoke: bool = False):
    modules = {**_MODULES, **PORT_ONLY}
    if arch_id not in modules:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{ARCH_IDS + tuple(PORT_ONLY)}")
    mod = import_module(modules[arch_id])
    return mod.SMOKE if smoke else mod.CONFIG
