"""Architecture registry: ``get_config(arch_id)`` resolution for the
architectures the port runs so far (the dense, MoE, vlm and encdec
families)."""
from importlib import import_module

_MODULES = {
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "granite-20b": "repro_torch.configs.granite_20b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "nemotron-4-15b": "repro_torch.configs.nemotron_4_15b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
}

#: every architecture of the reference; the others are not ported yet
KNOWN = ("whisper-medium", "granite-20b", "smollm-135m", "qwen2-vl-7b",
         "mixtral-8x22b", "llama3-405b", "nemotron-4-15b", "falcon-mamba-7b",
         "qwen3-moe-30b-a3b", "zamba2-1.2b")

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str, smoke: bool = False):
    if arch_id not in _MODULES:
        if arch_id in KNOWN:
            raise NotImplementedError(
                f"arch {arch_id!r} is not ported to PyTorch yet; ported: "
                f"{ARCH_IDS}")
        raise KeyError(f"unknown arch {arch_id!r}; known: {KNOWN}")
    mod = import_module(_MODULES[arch_id])
    return mod.SMOKE if smoke else mod.CONFIG
