"""Architecture registry: `get_config` resolution for every arch of the JAX
package's registry."""
from __future__ import annotations

import importlib

from repro_torch.models.config import LayerSpec, ModelConfig

_MODULES = {
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "granite-20b": "repro_torch.configs.granite_20b",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
}

# the JAX package's tiny paper-style LLaMa-family decoder (MHA, head_dim 48)
TINY = ModelConfig(
    name="tiny-lm", family="dense", vocab_size=256, d_model=192, n_heads=4,
    n_kv_heads=4, head_dim=48, d_ff=576,
    pattern=(LayerSpec(kind="attn", mlp="dense"),), n_repeats=8,
    norm="rmsnorm", act="silu", rope="full", remat=False)


def _load(name: str, attr: str) -> ModelConfig:
    if name in ("tiny", "tiny-lm"):
        return TINY
    cfg = getattr(importlib.import_module(_MODULES[name]), attr)
    cfg.validate()
    return cfg


def list_archs() -> list[str]:
    return sorted(_MODULES)


def get_config(name: str) -> ModelConfig:
    return _load(name, "CONFIG")


def get_smoke_config(name: str) -> ModelConfig:
    return _load(name, "SMOKE")
