"""Dry run of every (arch x shape x mesh) cell (port of
``repro.launch.dryrun``), one record (JSON) per cell with the JAX
package's keys: ``status``, ``memory``, ``cost``, ``collectives``,
``model_flops_total``, ``roofline``, ``wall_s`` (and ``reduced``).

The JAX package lowers and compiles each cell for its 256- or 512-device
mesh and reads XLA's memory and cost analyses and the HLO's collectives.
The port has no SPMD partitioner, no XLA and no HLO. Its counterpart is
one rank's share and one card:

  * accounting on fake tensors (``FakeTensorMode``: shapes and dtypes, no
    storage). ``build_cell`` gives the cell's step and its args at their
    global shapes and dtypes. ``memory.argument_bytes`` is one rank's
    share of the args under the port's sharding specs at the mesh's axis
    sizes (the training rules, the cache's sequence on "model", the
    variant's rules; ``shape_mesh``: a ``Mesh`` with no process group).
    The cost is counted on the step at depth R=1 and R=2 and extrapolated
    to the config's depth (``_extrapolate``): FLOPs by
    ``torch.utils.flop_counter.FlopCounterMode``, bytes accessed as the
    sum over the step's eager ops of each op's input and output bytes,
    transcendentals as the elements of its exp / log / tanh / rsqrt /
    sigmoid / silu / gelu / sin / cos outputs. The step's count is the
    global one; a rank's is that over the mesh's chips, an even split (the
    port has no partitioner to say what a rank repeats). The kernels'
    wrappers see CPU fake tensors and take their plain versions, whose
    work is the kernels' function; the attention core's and the tied
    head's bf16 products take the card's form (``linear.matmul_f32``:
    bf16 operands, an f32 result, no f32 copy of the cache);
  * a realized run on ``device`` (the counterpart of ``compile()`` and
    ``memory_analysis()``): the cell's step at R=1 and R=2 with seeded
    weights, full width, bf16, through the CUDA kernels on the card; the
    global batch cut to what the card holds (the record's ``reduced``);
    the peak bytes (``torch.cuda.max_memory_allocated``, args included)
    and the step's ms (CUDA events), each extrapolated to the real depth.
    ``compile_s`` is the first call's seconds (kernel builds and loads
    included). The peak is the step's, its args resident, not the seeded
    init's. A cell that does not fit records ``status: "error"``.

Collectives. ``collectives`` holds what the port's own code
(``distributed/collectives.py``, read by ``roofline.collective_bytes``)
issued on the realized step: one card and no mesh, so nothing. That is
not the JAX package's figure, XLA's collectives over the mesh, which the
port cannot count; ``collectives_note`` says so in every record.

Usage, on a machine with a card:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch chatglm3-6b \\
      --shape decode_32k --out results/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, bmm_flop

from repro_torch.configs.registry import get_config, get_smoke_config, \
    list_archs
from repro_torch.core.quant.deploy import quantize_params_for_serving
from repro_torch.core.quant.types import QuantizedTensor
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives
from repro_torch.distributed.partitioning import _walk, rules_for_config
from repro_torch.distributed.sharding import spec_for
from repro_torch.launch.mesh import Mesh, chips_in_mesh
from repro_torch.launch.roofline import (collective_bytes, model_flops,
                                         param_shapes, roofline)
from repro_torch.launch.shapes import (SHAPES, WHISPER_ENC_LEN, input_specs,
                                       skip_reason)
from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import (encdec_decode, encdec_init_cache,
                                       encdec_loss, encdec_prefill,
                                       init_encdec)
from repro_torch.models.transformer import (init_contiguous_cache, init_lm,
                                            lm_decode, lm_prefill)
from repro_torch.optim.schedules import constant
from repro_torch.train.train_step import init_opt_state, make_train_step

COLLECTIVES_NOTE = (
    "what the port's own collectives issued on the realized step (one card, "
    "no mesh: none); not the JAX package's figure, XLA's SPMD collectives "
    "over the mesh, which the port cannot count")
# tokens the realized run starts its batch cut from, by kind (then halved
# while the card runs out of memory); decode keeps its whole batch
TOKEN_BUDGET = {"train": 16384, "prefill": 65536}
# timed steps of a realized run, after its first (compiling) one
ITERS = 2


def dry_cfg(cfg: ModelConfig, kind: str) -> ModelConfig:
    """Dry-run numerics: bf16 everywhere, remat on for training."""
    return cfg.replace(dtype="bfloat16", param_dtype="bfloat16",
                       remat=(kind == "train"))


def shape_mesh(multi_pod: bool) -> Mesh:
    """The production mesh's axes and sizes, (data 16, model 16) or (pod
    2, data 16, model 16), with no process group: for sharding specs."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, rank=0, groups={})


def _cache_names(path: str, leaf) -> tuple:
    """A cache leaf's logical names (the JAX package's rule): K/V's
    sequence or heads, the batch of everything per slot; leading (layer)
    dims whole."""
    nd = leaf.ndim
    key = path.split("/")[-1]
    lead = (None,) * max(0, nd - {"k": 4, "v": 4, "pos": 2, "len": 1,
                                  "state": 4, "conv": 3, "k_scale": 3,
                                  "v_scale": 3}.get(key, nd))
    if key in ("k_scale", "v_scale"):
        return lead + ("batch", "cache_seq", None)
    if key in ("k", "v"):
        kvh = leaf.shape[-2]
        seq_ax = "cache_seq" if kvh % 16 != 0 or kvh == 1 else None
        head_ax = "kv_heads" if kvh % 16 == 0 else None
        return lead + ("batch", seq_ax, head_ax, None)
    if key == "pos":
        return lead + ("batch", None)
    if key == "len":
        return lead + ("batch",)
    if key == "state":
        return lead + ("batch", "ssm_heads", None, None)
    if key == "conv":
        return lead + ("batch", None, None)
    return (None,) * nd


def _batch_names(path: str, leaf) -> tuple:
    base = path.split("/")[-1]
    if base in ("tokens", "labels", "positions"):
        return ("batch",) + (None,) * (leaf.ndim - 1)
    if base in ("frames", "ext_embeds"):
        return ("batch", None, None)
    return (None,) * leaf.ndim


def cell_rules(cfg: ModelConfig, mesh, variant: Optional[dict]) -> dict:
    """The cell's rules: the config's training rules, the cache's
    sequence on "model", then the variant's."""
    rules = rules_for_config(cfg, mesh)
    rules["cache_seq"] = "model"
    rules.update((variant or {}).get("rules", {}))
    return rules


def _kind(shape_name: str) -> str:
    return SHAPES[shape_name].kind


def build_cell(cfg: ModelConfig, shape_name: str, mesh, variant=None, *,
               mode: Optional[FakeTensorMode] = None, batch: int = 0,
               device="cpu"):
    """Returns (fn, args, cfg): the cell's step and its args at the
    cell's global shapes and dtypes, args made under ``mode`` (fake, no
    storage) on the CPU, or with no ``mode`` real ones on ``device``
    (seeded, at ``batch`` rows when given).

    Train: fn(params, opt_state, batch, step_idx, rng). Prefill:
    fn(params, tokens, cache), with whisper's frames or InternVL2's patch
    embeddings before the cache. Decode: fn(params, tokens, cache,
    positions). ``variant`` (hill-climbing): {"cfg": {field: value},
    "rules": {...}, "donate_cache": bool, "grad_compress_bits": int}."""
    variant = variant or {}
    shape = SHAPES[shape_name]
    cfg = dry_cfg(cfg, shape.kind)
    if variant.get("cfg"):
        cfg = cfg.replace(**variant["cfg"])
    b = batch or shape.global_batch
    fake = mode is not None
    dev = torch.device("cpu") if fake else resolve_device(device)
    ctx = mode if fake else contextlib.nullcontext()
    gen = None
    if not fake:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)

    def data(specs: dict) -> dict:
        """Real inputs like ``specs``: token ids below the vocab, frame and
        patch embeddings N(0, 1) in the config's dtype."""
        out = {}
        for k, v in specs.items():
            shp = (b,) + tuple(v.shape[1:])
            if v.is_floating_point():
                out[k] = torch.randn(shp, generator=gen, device=dev).to(
                    v.dtype)
            else:
                out[k] = torch.randint(0, cfg.vocab_size, shp,
                                       generator=gen, device=dev,
                                       dtype=torch.int64).to(v.dtype)
        return out

    specs = input_specs(cfg, shape, mode or FakeTensorMode())
    inputs = specs if fake else data(specs)
    init = init_encdec if cfg.enc_dec else init_lm
    with ctx:
        params = init(cfg, seed=0, device=dev)
        if shape.kind == "train":
            gcb = variant.get("grad_compress_bits", 0)
            step = make_train_step(
                cfg, lr_schedule=constant(1e-4), clip_norm=1.0,
                loss_fn=encdec_loss if cfg.enc_dec else None,
                grad_compress_bits=gcb)
            opt = init_opt_state(cfg, params, grad_compress_bits=gcb)
            step_idx = torch.zeros((), dtype=torch.int32, device=dev)
            key = torch.zeros((2,), dtype=torch.uint32, device=dev)

            def train_fn(p, o, bt, i, rng):
                # the schedule is constant: the step index is not read
                g = None
                if gcb:
                    g = torch.Generator(device=p_device(p))
                    g.manual_seed(0)
                return step(p, o, bt, 0, rng=g)

            return train_fn, (params, opt, inputs, step_idx, key), cfg

        params = quantize_params_for_serving(cfg, params, device=dev)
        if cfg.enc_dec:
            cache = encdec_init_cache(cfg, b, shape.seq_len,
                                      WHISPER_ENC_LEN, device=dev)
        else:
            cache = init_contiguous_cache(cfg, b, shape.seq_len, dev)
    if shape.kind == "prefill":
        if cfg.enc_dec:
            def fn(p, frames, tokens, c):
                return encdec_prefill(cfg, p, frames, tokens, c)

            return fn, (params, inputs["frames"], inputs["tokens"],
                        cache), cfg
        if cfg.frontend == "vision":
            def fn(p, tokens, ext, c):
                return lm_prefill(cfg, p, tokens, c, ext_embeds=ext)

            return fn, (params, inputs["tokens"], inputs["ext_embeds"],
                        cache), cfg

        def fn(p, tokens, c):
            return lm_prefill(cfg, p, tokens, c)

        return fn, (params, inputs["tokens"], cache), cfg

    if not fake:
        _fill_for_decode(cache, shape.seq_len)
        inputs["positions"].fill_(shape.seq_len - 1)
    decode = encdec_decode if cfg.enc_dec else lm_decode

    def fn(p, tokens, c, positions):
        return decode(cfg, p, tokens, c, positions)

    return fn, (params, inputs["tokens"], cache, inputs["positions"]), cfg


def p_device(tree):
    if isinstance(tree, dict):
        return p_device(next(iter(tree.values())))
    if isinstance(tree, QuantizedTensor):
        return tree.qw.device
    return tree.device


def _fill_for_decode(cache: dict, seq_len: int) -> None:
    """A real decode cell's cache as full as the cell says: every slot
    but the last holds a position (the decode writes the last), a cross
    cache all of the encoder's, each per-slot fill count the same."""
    for key, v in cache.items():
        if isinstance(v, dict):
            _fill_for_decode(v, WHISPER_ENC_LEN if key == "xattn"
                             else seq_len)
        elif key == "pos":
            size = v.shape[-1]
            pos = torch.arange(size, dtype=v.dtype, device=v.device)
            if size == seq_len:
                pos[-1] = -1
            v.copy_(pos.expand_as(v))
        elif key == "len":
            v.fill_(seq_len - 1)


# ------------------------------------------------------------ accounting

def _leaves(tree, prefix=""):
    """(path, tensor) of every tensor leaf, a packed weight's as
    path#qw and path#scale."""
    if isinstance(tree, QuantizedTensor):
        yield prefix + "#qw", tree.qw
        yield prefix + "#scale", tree.scale
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


def _shard_bytes(t: torch.Tensor, names, mesh, rules) -> int:
    """One rank's bytes of ``t`` split as its names' spec says."""
    spec = spec_for(tuple(t.shape), names, mesh=mesh, rules=rules)
    n = 1
    for dim, axes in zip(t.shape, spec):
        if axes is None:
            n *= dim
        else:
            flat = (axes,) if isinstance(axes, str) else axes
            n *= dim // math.prod(mesh.shape[a] for a in flat)
    return n * t.element_size()


def rank_argument_bytes(kind: str, cfg: ModelConfig, args, mesh,
                        rules) -> int:
    """One rank's bytes of a cell's args: params (and Adam's moments) by
    the param rules, the batch by "batch", caches by ``_cache_names``;
    scalars whole."""
    total = 0

    def params_of(tree):
        _walk(tree, "", lambda p, leaf, names: _add(leaf, names))

    def _add(leaf, names):
        nonlocal total
        total += _shard_bytes(leaf, names, mesh, rules)
        return leaf

    if kind == "train":
        params, opt, batch = args[:3]
        params_of(params)
        params_of(opt["adam"]["m"])
        params_of(opt["adam"]["v"])
        # Adam's step counter: a Python int here, a 4-byte int32 scalar in
        # a device-side state
        total += 4
        if "ef" in opt:
            params_of(opt["ef"])
        for path, t in _leaves(batch):
            total += _shard_bytes(t, _batch_names(path, t), mesh, rules)
        for t in args[3:]:
            total += t.numel() * t.element_size()
        return total
    params_of(args[0])
    for i, a in enumerate(args[1:]):
        if isinstance(a, dict):
            for path, t in _leaves(a):
                total += _shard_bytes(t, _cache_names(path, t), mesh, rules)
        else:
            name = "positions" if i == len(args) - 2 and kind == "decode" \
                else ("frames" if a.is_floating_point() and a.ndim == 3
                      else "tokens")
            total += _shard_bytes(a, _batch_names(name, a), mesh, rules)
    return total


_TRANSCENDENTAL = {"exp", "exp2", "log", "log1p", "tanh", "rsqrt", "sqrt",
                   "sigmoid", "silu", "gelu", "sin", "cos", "erf",
                   "_softmax", "_log_softmax", "logsumexp"}


class _BytesMode(TorchDispatchMode):
    """Sums, over the eager ops dispatched under it, each op's tensor
    inputs' and outputs' bytes (views and metadata ops excluded), and the
    output elements of transcendental ops."""

    _SKIP = {"view", "_unsafe_view", "reshape", "expand", "permute",
             "transpose", "t", "slice", "select", "unsqueeze", "squeeze",
             "as_strided", "alias", "detach", "split", "split_with_sizes",
             "unbind", "empty", "empty_like", "new_empty", "lift_fresh",
             "_to_copy_meta", "clone_meta"}

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.transcendentals = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if name not in self._SKIP:
            for t in _tensors((args, kwargs or {}, out)):
                self.bytes += t.numel() * t.element_size()
            if name in _TRANSCENDENTAL:
                for t in _tensors(out):
                    self.transcendentals += t.numel()
        return out


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _bmm_flops(a_shape, b_shape, *rest, out_shape=None, **kwargs) -> int:
    """``bmm``'s FLOPs, its ``out_dtype`` overload's too (the attention
    core's bf16 operands with an f32 result, which the library's formula
    takes for an output shape)."""
    return bmm_flop(a_shape, b_shape)


def count_cell(cfg0: ModelConfig, shape_name: str, mesh, n_repeats=None,
               variant=None) -> tuple:
    """The cell's step on fake tensors at ``n_repeats``: (cfg, its global
    cost {"flops", "bytes accessed", "transcendentals"}, one rank's
    argument bytes)."""
    cfg_in = cfg0 if n_repeats is None else cfg0.replace(n_repeats=n_repeats)
    with FakeTensorMode() as mode:
        fn, args, cfg = build_cell(cfg_in, shape_name, mesh, variant,
                                   mode=mode)
        arg_bytes = rank_argument_bytes(_kind(shape_name), cfg, args, mesh,
                                        cell_rules(cfg, mesh, variant))
        counter = _BytesMode()
        grad = _kind(shape_name) == "train"
        with torch.set_grad_enabled(grad), \
                FlopCounterMode(display=False, custom_mapping={
                    torch.ops.aten.bmm: _bmm_flops}) as flops, counter:
            fn(*args)
    cost = {"flops": float(flops.get_total_flops()),
            "bytes accessed": float(counter.bytes),
            "transcendentals": float(counter.transcendentals)}
    return cfg, cost, arg_bytes


def _extrapolate(v1, v2, r1, r2, r):
    """Linear in repeats: counted at two reduced depths, extrapolated to
    the real depth."""
    if v1 is None or v2 is None:
        return None
    slope = (v2 - v1) / (r2 - r1)
    return v1 + slope * (r - r1)


# --------------------------------------------------------- realized run

def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def realize(cfg0: ModelConfig, shape_name: str, mesh, n_repeats: int,
            variant=None, *, device="cuda", batch: int = 0) -> dict:
    """The cell's step at ``n_repeats`` on ``device`` with real seeded
    weights at ``batch`` rows: {"first_s", "step_ms", "peak_bytes"} (the
    peak, args included, only on a card)."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    train = _kind(shape_name) == "train"
    if cuda:
        torch.cuda.empty_cache()
    fn, args, _ = build_cell(cfg0.replace(n_repeats=n_repeats), shape_name,
                             mesh, variant, batch=batch, device=dev)
    if cuda:
        # the step's peak with its args resident (not the seeded init's
        # f32 draws or the deploy's)
        torch.cuda.reset_peak_memory_stats(dev)
    collectives.reset_counts()
    with torch.set_grad_enabled(train):
        t0 = time.perf_counter()
        fn(*args)
        _sync(dev)
        first = time.perf_counter() - t0
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(ITERS):
                fn(*args)
            end.record()
            _sync(dev)
            ms = start.elapsed_time(end) / ITERS
        else:
            t0 = time.perf_counter()
            for _ in range(ITERS):
                fn(*args)
            ms = (time.perf_counter() - t0) * 1e3 / ITERS
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    del fn, args
    return {"first_s": first, "step_ms": ms, "peak_bytes": peak}


def realize_cut(cfg0: ModelConfig, shape_name: str, mesh, variant=None, *,
                device="cuda", batch: int = 0) -> tuple:
    """The realized runs at R=1 and R=2 at the largest batch that fits:
    from ``batch`` if given, else the kind's token budget (decode: the
    whole batch), halved while the card runs out of memory. Returns ({1:
    run, 2: run}, batch)."""
    shape = SHAPES[shape_name]
    b = shape.global_batch
    tokens = TOKEN_BUDGET.get(shape.kind)
    if batch:
        b = min(b, batch)
    elif tokens:
        b = max(1, min(b, tokens // shape.seq_len))
    while True:
        try:
            runs = {r: realize(cfg0, shape_name, mesh, r, variant,
                               device=device, batch=b) for r in (1, 2)}
            return runs, b
        except torch.cuda.OutOfMemoryError:
            if b == 1:
                raise
            b //= 2


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             compile_only: bool = False, variant=None,
             variant_name: str = "", *, device="cuda", smoke: bool = False,
             batch: int = 0) -> dict:
    """One cell's record; written to ``out_dir`` when given.
    ``compile_only`` skips the realized run (the record's measured fields
    are then null); ``smoke`` takes the arch's SMOKE config; ``batch``
    (rows) sets where the realized run's batch cut starts (else the
    kind's ``TOKEN_BUDGET``)."""
    mesh_name = "multi" if multi_pod else "single"
    cfg0 = (get_smoke_config if smoke else get_config)(arch)
    shape = SHAPES[shape_name]
    reason = skip_reason(cfg0, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if variant_name:
        rec["variant"] = variant_name
    if reason:
        rec.update({"status": "skipped", "reason": reason})
        return rec
    t0 = time.time()
    try:
        mesh = shape_mesh(multi_pod)
        chips = chips_in_mesh(mesh)
        r = cfg0.n_repeats
        cfg, cost1, args1 = count_cell(cfg0, shape_name, mesh, 1, variant)
        _, cost2, args2 = count_cell(cfg0, shape_name, mesh, 2, variant)
        # a layer's params and caches are the same at any depth: the
        # args' bytes are linear in the repeats too, exactly
        arg_bytes = int(_extrapolate(args1, args2, 1, 2, r))
        total = {k: _extrapolate(cost1.get(k), cost2.get(k), 1, 2, r)
                 for k in ("flops", "bytes accessed", "transcendentals")}
        cost = {k: (None if v is None else v / chips)
                for k, v in total.items()}
        runs, batch = ({}, None) if compile_only else realize_cut(
            cfg0, shape_name, mesh, variant, device=device, batch=batch)
        coll = collective_bytes()
        coll_s = {k: v for k, v in coll.items() if k != "counts"}
        params = param_shapes(cfg)
        mf = model_flops(cfg, params, shape)
        terms = roofline(cost, coll, chips=chips, model_flops_total=mf)

        def extra(key):
            if not runs or runs[1][key] is None:
                return None
            return _extrapolate(runs[1][key], runs[2][key], 1, 2, r)

        rec.update({
            "status": "ok",
            "compile_s": (round(runs[1]["first_s"], 1) if runs else None),
            "chips": chips,
            "cost_uncorrected": {k: cost1.get(k) / chips for k in
                                 ("flops", "bytes accessed")},
            "memory": {
                "argument_bytes": arg_bytes,
                "output_bytes": None,
                "temp_bytes": None,
                "peak_bytes": extra("peak_bytes"),
            },
            "memory_note": (
                "argument_bytes: one rank's share of the args under the "
                "port's specs; peak_bytes: the realized run's peak on one "
                "card at the reduced batch, extrapolated to the real depth; "
                "output and temp bytes have no port counterpart"),
            "cost": cost,
            "collectives": coll_s,
            "collective_counts": coll["counts"],
            "collectives_note": COLLECTIVES_NOTE,
            "model_flops_total": mf,
            "roofline": {
                "compute_s": terms.compute_s,
                "memory_s": terms.memory_s,
                "collective_s": terms.collective_s,
                "dominant": terms.dominant,
                "useful_flops_ratio": terms.useful_flops_ratio,
                "roofline_fraction": terms.roofline_fraction,
            },
            "step_ms": extra("step_ms"),
            "device": (str(resolve_device(device)) if runs else None),
            "reduced": {
                "global_batch": shape.global_batch,
                "batch": batch,
                "depths": [1, 2] if runs else [],
                "n_repeats": r,
                "why": ("the realized run: the batch cut to what the card "
                        "holds and the step run at R=1 and R=2, its peak "
                        "and ms extrapolated to the config's depth"),
            },
        })
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]})
    rec["wall_s"] = round(time.time() - t0, 1)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        vtag = f"__{variant_name}" if variant_name else ""
        fname = f"{arch}__{shape_name}__{mesh_name}{vtag}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(rec, f, indent=2)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the archs' SMOKE configs (a quick run)")
    ap.add_argument("--batch", type=int, default=0,
                    help="rows the realized run starts its cut from")
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "multi" if mp else "single"
                fname = os.path.join(args.out,
                                     f"{arch}__{shape}__{mesh_name}.json")
                if args.skip_existing and os.path.exists(fname):
                    print(f"[skip existing] {arch} {shape} {mesh_name}")
                    continue
                rec = run_cell(arch, shape, mp, args.out, device=args.device,
                               smoke=args.smoke, batch=args.batch)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f"dom={r['dominant']} "
                             f"frac={r['roofline_fraction']:.3f} "
                             f"compile={rec['compile_s']}s")
                elif status == "error":
                    extra = rec["error"][:120]
                print(f"[{status}] {arch} {shape} {mesh_name} {extra}",
                      flush=True)


if __name__ == "__main__":
    main()
