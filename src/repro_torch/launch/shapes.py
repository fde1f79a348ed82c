"""The assigned input shapes per (arch, shape) cell, as tensors without
storage (port of ``repro.launch.shapes``).

  train_4k    : seq 4096,   global batch 256  -> the train step
  prefill_32k : seq 32768,  global batch 32   -> serving prefill
  decode_32k  : 1 new token, KV cache 32768, batch 128 -> serving decode
  long_500k   : 1 new token, context 524288, batch 1   -> serving decode
                (sub-quadratic archs only: mamba2 / jamba / mixtral-SWA)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# archs with sub-quadratic attention or state for the 500k cell
LONG_OK_FAMILIES = {"ssm", "hybrid"}


def long_ok(cfg: ModelConfig) -> bool:
    return cfg.family in LONG_OK_FAMILIES or cfg.attn_window is not None


def skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    if shape.name == "long_500k" and not long_ok(cfg):
        return ("full-attention arch: 500k decode requires sub-quadratic "
                "attention (noted in DESIGN.md)")
    return None


WHISPER_ENC_LEN = 1500  # whisper's native encoder length (30 s of audio)


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                mode: Optional[FakeTensorMode] = None) -> dict:
    """Fake stand-ins (shape and dtype, no storage, on the CPU) for every
    model input of the cell, made under ``mode`` (a fresh fake mode by
    default): token ids int32, frame or patch embeddings in
    ``cfg.adtype``. Shardings are the dry run's (they depend on the
    mesh)."""
    b, s = shape.global_batch, shape.seq_len
    mode = mode or FakeTensorMode()

    def spec(*dims, dtype=torch.int32):
        with mode:
            return torch.empty(dims, dtype=dtype)

    def embeds(n):
        return spec(b, n, cfg.d_model, dtype=cfg.adtype)

    if cfg.enc_dec:      # whisper: frame embeddings + decoder tokens
        if shape.kind == "train":
            return {"frames": embeds(WHISPER_ENC_LEN),
                    "tokens": spec(b, s), "labels": spec(b, s)}
        if shape.kind == "prefill":
            return {"frames": embeds(WHISPER_ENC_LEN), "tokens": spec(b, s)}
        return {"tokens": spec(b, 1), "positions": spec(b, 1)}

    if cfg.frontend == "vision":     # VLM: patch embeds prepended
        f = cfg.frontend_len
        if shape.kind == "train":
            return {"tokens": spec(b, s - f), "labels": spec(b, s - f),
                    "ext_embeds": embeds(f)}
        if shape.kind == "prefill":
            return {"tokens": spec(b, s - f), "ext_embeds": embeds(f)}
        return {"tokens": spec(b, 1), "positions": spec(b, 1)}

    if shape.kind == "train":
        return {"tokens": spec(b, s), "labels": spec(b, s)}
    if shape.kind == "prefill":
        return {"tokens": spec(b, s)}
    return {"tokens": spec(b, 1), "positions": spec(b, 1)}
