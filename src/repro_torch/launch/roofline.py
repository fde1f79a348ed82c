"""Roofline bounds on the H100 (port of ``repro.launch.roofline``).

The JAX package reads FLOPs and bytes from a compiled XLA module and
parses collectives out of its HLO. The port has neither, so the caller
counts the work (``chip_smoke.py`` per kernel call, ``model_flops`` per
model step) and :func:`collective_bytes` reads the bytes that
``distributed/collectives.py`` moved, beside its call counts.

H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM3
3.35 TB/s; tensor cores 989 TFLOP/s bf16 and 1979 TOP/s int8; 67 TFLOP/s
f32 on the CUDA cores; NVLink 4 900 GB/s a card, 450 GB/s each way.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
INT8_TENSOR_OPS = 1979e12
F32_FLOPS = 67e12
NVLINK_BYTES_PER_S = 450e9
# a model step's FLOPs run on the bf16 tensor cores at best
PEAK_FLOPS = BF16_TENSOR_FLOPS


def bound(nbytes: float, flops: float, peak_flops: float):
    """The least time the card could take for a function: the larger of
    its bytes over the memory rate and its operations over ``peak_flops``.
    Returns (ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                      else "operations")


def collective_bytes() -> dict:
    """Bytes a rank sent through each collective of
    ``distributed/collectives.py`` since its ``reset_counts``, with the
    JAX package's operand-size convention (all-reduce and all-to-all: the
    result's size; all-gather: the result's over the axis, i.e. the
    input's), their total and the call counts."""
    from repro_torch.distributed import collectives

    out = dict(collectives.nbytes)
    out["total"] = sum(collectives.nbytes.values())
    out["counts"] = dict(collectives.counts)
    return out


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    model_flops_total: Optional[float] = None
    useful_flops_ratio: Optional[float] = None

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Share of the binding roofline that useful model FLOPs reach:
        (model_flops / chips / peak) / max(term)."""
        if not self.model_flops_total or self.step_time_s <= 0:
            return 0.0
        ideal = self.model_flops_total_per_device / PEAK_FLOPS
        return ideal / self.step_time_s

    @property
    def model_flops_total_per_device(self):
        return (self.model_flops_total or 0.0) / max(self._chips, 1)

    _chips: int = 1


def roofline(cost: dict, coll: dict, *, chips: int,
             model_flops_total: Optional[float] = None) -> RooflineTerms:
    """Terms of one device's step from its counted work: ``cost``
    {"flops", "bytes accessed"} and ``coll`` {"total": bytes}."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    cb = float(coll.get("total", 0))
    t = RooflineTerms(
        compute_s=flops / PEAK_FLOPS,
        memory_s=byts / HBM_BYTES_PER_S,
        collective_s=cb / NVLINK_BYTES_PER_S,
        flops_per_device=flops,
        bytes_per_device=byts,
        coll_bytes_per_device=cb,
        model_flops_total=model_flops_total,
    )
    t._chips = chips
    if model_flops_total and flops > 0:
        t.useful_flops_ratio = (model_flops_total / chips) / flops
    return t


def param_shapes(cfg) -> dict:
    """The float param tree of ``cfg`` as tensors without storage
    (``init_lm`` or ``init_encdec`` under a fake-tensor mode): its shapes,
    at any size, for ``count_params``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.encdec import init_encdec
    from repro_torch.models.transformer import init_lm

    with FakeTensorMode():
        return (init_encdec if cfg.enc_dec else init_lm)(cfg, device="cpu")


def count_params(params, *, exclude=("embed", "pos")) -> int:
    """Total param count of a tree, leaving out leaves whose path
    ("a/b/c") contains any of ``exclude`` (the embeddings)."""
    total = 0

    def walk(tree, prefix):
        nonlocal total
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}{k}/")
        elif hasattr(tree, "numel") and not any(e in prefix[:-1]
                                                for e in exclude):
            total += int(tree.numel())

    walk(params, "")
    return total


def model_flops(cfg, params, shape_spec) -> float:
    """6 N_active D (train) or 2 N_active D (inference) global FLOPs.
    ``shape_spec`` has ``kind`` ("train", "prefill", "decode"),
    ``global_batch`` and ``seq_len``."""
    n_total = count_params(params)
    n_active = n_total
    if cfg.moe is not None:
        # routed experts: only top_k / E of the expert params per token
        e, k = cfg.moe.n_experts, cfg.moe.top_k
        n_moe_layers = sum(1 for s in cfg.all_layer_specs() if s.mlp == "moe")
        expert_params = (n_moe_layers * e * 3 * cfg.d_model
                         * cfg.moe.d_ff_expert)
        n_active = n_total - expert_params + expert_params * k / e
    if shape_spec.kind == "train":
        tokens = shape_spec.global_batch * shape_spec.seq_len
        return 6.0 * n_active * tokens
    if shape_spec.kind == "prefill":
        tokens = shape_spec.global_batch * shape_spec.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape_spec.global_batch  # decode: 1 token a seq
