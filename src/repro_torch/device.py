"""Device resolution shared by the port's entry points.

Every entry point resolves its ``device=`` argument here, so the rule is
kept in one place: ``"cuda"`` (the default) needs a card and raises
without one — nothing drops to the CPU quietly — and ``"cpu"`` must be
asked for. Resolving also pins float32 matmuls to full float32: the JAX
package computes in full f32 (``cfg.dtype == "float32"``), and TF32 would
keep only about three decimal digits.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    # full-f32 products on the card (see module docstring)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
