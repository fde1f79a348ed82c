"""Architecture registry: `get_config` resolution for the archs ported so far."""
from __future__ import annotations

import importlib

from repro_torch.models.config import LayerSpec, ModelConfig

_MODULES = {
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
}

# the JAX package's tiny paper-style LLaMa-family decoder (MHA, head_dim 48)
TINY = ModelConfig(
    name="tiny-lm", vocab_size=256, d_model=192, n_heads=4,
    n_kv_heads=4, head_dim=48, d_ff=576,
    pattern=(LayerSpec(kind="attn", mlp="dense"),), n_repeats=8,
    norm="rmsnorm", act="silu", rope="full")


def _load(name: str, attr: str) -> ModelConfig:
    if name in ("tiny", "tiny-lm"):
        return TINY
    cfg = getattr(importlib.import_module(_MODULES[name]), attr)
    cfg.validate()
    return cfg


def get_config(name: str) -> ModelConfig:
    return _load(name, "CONFIG")


def get_smoke_config(name: str) -> ModelConfig:
    return _load(name, "SMOKE")
