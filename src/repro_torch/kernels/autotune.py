"""Launch-plan selection for kernels 1-5: the fixed planners, plus a
measured tuner with a persistent JSON cache (port of
``repro.kernels.autotune``).

Every launch of the dense matmuls (``dequant_matmul.py::run``), the
expert matmuls (``expert_dequant_matmul.py::launch``) and paged
attention (``paged_attention.py``) asks this module for its plan.
Resolution, governed by ``RTORCH_AUTOTUNE`` (``repro_torch.debug_flags``):

  * ``"0"``: always the fixed planners (``plan``, ``plan`` of the expert
    module, ``plan_paged``), verbatim;
  * ``""`` (default): a tuned entry for the shape class when
    ``RTORCH_AUTOTUNE_CACHE`` names a readable cache written against this
    template version and card; else the fixed planners. With no path set
    every plan is the fixed planners';
  * ``"1"``: for a cold shape class, measure the candidates of
    ``kernels/template.py``'s enumerator on the card (the fixed plan among
    them), each held against the kernel's plain version first; record the
    fastest (the fixed plan unless one beats it by MIN_GAIN) in-process,
    and in the cache file when a path is set.

Shape classes: the matmuls key as the JAX package's tuner does
(``matmul_key``: kind, M bucket, N, K, bits, group size); the paged key
carries everything ``plan_paged`` reads (slots, kv heads, table width,
page size, rows, head dims, the pool type: f32, bf16 or int8), since the port's cluster size depends
on all of them.

Entries hold choices, not plans (``template.py``): the body and K splits
of kernels 1 and 3, the capacity tile and K splits of kernels 4 and 5,
``n_split`` of kernel 2. A call's plan is rebuilt from its class's choice
at the call's real shape by the fixed planner's own code and validated;
an entry that fails is logged and ignored. Resolved plans are cached per
exact shape, as the JAX package's plans live in its compiled variants: a
flag changed later applies to shapes not yet resolved, or to all after
``reset`` (which also clears the fixed dense planner's cache); each miss
is one sanitizer event (``analysis/sanitize.py``) and the one read of the
flags, so a launch that hits the cache pays a dict lookup.

Cache file: JSON {"version": TEMPLATE_VERSION, "device": the card's name,
"entries": {key: choice}}, written to a temporary file and renamed into
place, so ranks sharing it never read half a file. A missing, corrupt,
stale or other card's file means the fixed planners, never an exception
on the serving path.
"""
from __future__ import annotations

import contextlib
import json
import logging
import math
import os
from typing import Callable

import torch

from repro_torch import debug_flags
from repro_torch.analysis.sanitize import note_trace
from repro_torch.kernels import dequant_matmul as dq
from repro_torch.kernels import expert_dequant_matmul as edq
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import template

_LOG = logging.getLogger(__name__)

# the shape-class kinds of the JAX package's tuner, by kernel
KINDS = {"dequant_matmul": "dequant", "w8a8_matmul": "w8a8",
         "expert_dequant_matmul": "expert_dequant",
         "expert_w8a8_matmul": "expert_w8a8"}
_SKINNY_M = 8


# ------------------------------------------------------- shape-class keys

def m_bucket(m: int) -> int:
    """Token-dim bucket: decode-skinny Ms collapse to one class, larger Ms
    to the next power of two."""
    if m <= _SKINNY_M:
        return _SKINNY_M
    b = 16
    while b < m:
        b *= 2
    return b


def matmul_key(kind: str, m: int, k: int, n: int, bits: int,
               group_size: int) -> str:
    return f"{kind}:m{m_bucket(m)}:n{n}:k{k}:w{bits}:g{group_size}"


def paged_key(s: int, kvh: int, w: int, page_size: int, rows: int, hd: int,
              hd_v: int, kv: str) -> str:
    """The paged class: ``kv`` the pool type, "f32", "bf16" or "int8"."""
    return (f"paged:s{s}:kvh{kvh}:w{w}:ps{page_size}:r{rows}:hd{hd}:"
            f"hdv{hd_v}:kv{pa.kv_kind(kv)}")


def _group_size(k: int, groups: int) -> int:
    return -1 if groups == 1 else k // groups


# ------------------------------------------------------------ cache state

# the in-memory view of the cache file (keyed by the path it came from;
# measured winners land here too) and the resolved plans by exact shape
_state: dict = {"path": None, "entries": None, "plans": {}}


def reset() -> None:
    """Drop the in-memory cache, the resolved plans and the fixed dense
    planner's cache (tests; after rewriting the cache file)."""
    _state["path"] = None
    _state["entries"] = None
    _state["plans"] = {}
    dq.plan.cache_clear()


def device_name() -> str:
    """The card a cache is measured on ("cpu" without one)."""
    return (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else "cpu")


def load_cache(path: str) -> dict:
    """Entries of a cache file. A missing file is cold ({}); a corrupt,
    unreadable or wrong-shape file, one of another template version, or
    one measured on another card logs a warning and is cold too."""
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        if not isinstance(data, dict) or not isinstance(
                data.get("entries"), dict):
            raise ValueError("expected {'version': ..., 'device': ..., "
                             "'entries': {...}}")
    except FileNotFoundError:
        return {}
    except (OSError, ValueError) as e:
        _LOG.warning("autotune cache %s unreadable (%s); using the fixed "
                     "planners", path, e)
        return {}
    if data.get("version") != template.TEMPLATE_VERSION:
        _LOG.warning("autotune cache %s was measured against template "
                     "version %s (current %s); ignoring it", path,
                     data.get("version"), template.TEMPLATE_VERSION)
        return {}
    if data.get("device") != device_name():
        _LOG.warning("autotune cache %s was measured on %s, not %s; "
                     "ignoring it", path, data.get("device"), device_name())
        return {}
    return data["entries"]


def save_cache(path: str, entries: dict) -> None:
    """Write the cache atomically: a temporary file, then a rename."""
    payload = {"version": template.TEMPLATE_VERSION, "device": device_name(),
               "entries": entries}
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def _entries(path: str) -> dict:
    if _state["entries"] is None or _state["path"] != path:
        _state["path"] = path
        _state["entries"] = load_cache(path) if path else {}
    return _state["entries"]


# ------------------------------------------------------- plan resolution

def _resolve(memo: tuple, key: Callable[[], str], fixed: Callable,
             rebuild: Callable, search: Callable):
    """The plan of a launch the cache of resolved plans misses (``memo``:
    the kernel and its exact shape): the fixed planner's (which raises on
    what the kernel does not take), replaced by a valid tuned entry of the
    class, or in mode "1" by a search; cached under ``memo``."""
    f = debug_flags.flags()
    note_trace("plan", kernel=memo[0], shape=memo[1:])
    plan = fixed()
    if f.autotune == "1" or (f.autotune == "" and f.autotune_cache):
        cls = key()
        entries = _entries(f.autotune_cache)
        ent = entries.get(cls)
        tuned = None if ent is None else rebuild(ent)
        if ent is not None and tuned is None:
            _LOG.warning("autotune entry %s = %r violates the kernel's "
                         "constraints; ignoring it", cls, ent)
        if tuned is None and f.autotune == "1":
            choice = search(cls)
            entries[cls] = choice
            if f.autotune_cache:
                save_cache(f.autotune_cache, entries)
            tuned = rebuild(choice)
        if tuned is not None:
            plan = tuned
    _state["plans"][memo] = plan
    return plan


def dense_plan(name: str, m: int, k: int, n: int, bits: int,
               groups: int) -> dq.DensePlan:
    """The plan of one launch of dense kernel ``name`` ("dequant_matmul"
    or "w8a8_matmul")."""
    memo = (name, m, k, n, bits, groups)
    plan = _state["plans"].get(memo)
    if plan is not None:
        return plan
    int8 = name == "w8a8_matmul"
    return _resolve(
        memo,
        lambda: matmul_key(KINDS[name], m, k, n, bits,
                           _group_size(k, groups)),
        lambda: dq.plan(m, k, n, bits, groups, int8=int8),
        lambda ch: template.valid_dense(ch, m, k, n, bits, groups,
                                        int8=int8),
        lambda cls: _search_dense(name, cls, m, k, n, bits, groups))


def expert_plan(name: str, e: int, c: int, k: int, n: int, bits: int,
                groups: int) -> edq.ExpertPlan:
    """The plan of one launch of expert kernel ``name``
    ("expert_dequant_matmul" or "expert_w8a8_matmul"): the class keys on
    the capacity C as the JAX package's keys on M."""
    memo = (name, e, c, k, n, bits, groups)
    plan = _state["plans"].get(memo)
    if plan is not None:
        return plan
    x_bytes = 1 if name == "expert_w8a8_matmul" else 4
    return _resolve(
        memo,
        lambda: matmul_key(KINDS[name], c, k, n, bits,
                           _group_size(k, groups)),
        lambda: edq.plan(e, c, k, n, bits, groups, x_bytes=x_bytes),
        lambda ch: template.valid_expert(ch, e, c, k, n, bits, groups,
                                         x_bytes=x_bytes),
        lambda cls: _search_expert(name, cls, e, c, k, n, bits, groups))


def paged_split(s: int, kvh: int, w: int, page_size: int, rows: int,
                hd: int, hd_v: int, kv: str, *, m_rows: int = 1) -> int:
    """The cluster size of one paged-attention launch (``m_rows`` shapes
    only a search's case: rows = m_rows x G); ``kv`` the pool type."""
    shape = (s, kvh, w, page_size, rows, hd, hd_v, pa.kv_kind(kv))
    memo = ("paged_attention",) + shape
    plan = _state["plans"].get(memo)
    if plan is not None:
        return plan
    return _resolve(
        memo, lambda: paged_key(*shape),
        lambda: pa.plan_paged(*shape),
        lambda ch: template.valid_paged(ch, *shape),
        lambda cls: _search_paged(cls, *shape, m_rows=m_rows))


# ------------------------------------------------------- measured search

def dense_tol(x: torch.Tensor, qt, *, int8: bool) -> float:
    """``chip_smoke.py``'s tolerances of kernels 1 and 3 (and 4 and 5,
    with a leading expert dim). Kernel 1: the kernel and the plain version
    multiply the same bf16-rounded operands (products exact in f32) and
    differ only in the order of the f32 sum: 4e-5 of the largest sum of
    |terms|. Kernel 3: both take each scale group's sum exactly and rescale
    it alike, and differ in the order of the f32 sum over groups and K
    splits: 1e-5 of the largest sum of |group terms|."""
    from repro_torch.core.quant.types import dequantize, unpack

    if not int8:
        xb = x.to(torch.bfloat16).float()
        wb = dequantize(qt).to(torch.bfloat16).float()
        return 4e-5 * float((xb.abs() @ wb.abs()).max())
    k = qt.k
    q8 = unpack(qt.qw, qt.bits, k).to(torch.int8)
    rows = torch.arange(k, device=x.device) // (k // qt.scale.shape[-2])
    wabs = q8.abs().double() * qt.scale[..., rows, :].double()
    return 1e-5 * float((x.abs().double() @ wabs).max())


class Case:
    """A search's operands on the search's device: ``args`` for the
    launcher, ``plain`` the plain version's output, ``tol`` the bound on
    |kernel - plain|."""

    def __init__(self, args: tuple, plain: torch.Tensor, tol: float):
        self.args, self.plain, self.tol = args, plain, tol


def _cuda_launch(kernel: str, case: Case, plan):
    """Launch ``kernel`` on the case's operands as ``plan`` cuts it."""
    if kernel in ("dequant_matmul", "w8a8_matmul"):
        x, qt = case.args
        return dq.launch(kernel, x, qt.qw, qt.scale, plan, bits=qt.bits,
                         k=qt.k)
    if kernel in ("expert_dequant_matmul", "expert_w8a8_matmul"):
        x, qt = case.args
        return edq.launch_plan(kernel, x, qt.qw, qt.scale, plan,
                               bits=qt.bits, k=qt.k)
    q, pools, bt, kv_len, m_rows = case.args
    out = torch.empty_like(case.plain)
    pa._launch(q, pools["k_pool"], pools["v_pool"], bt, kv_len,
               pools["k_scale_pool"], pools["v_scale_pool"], out, None,
               m_rows, plan)
    return out


_FLUSH: list = []
# a candidate replaces the fixed plan only if its median is at least this
# share faster: two plans within the timer's spread keep the fixed one
MIN_GAIN = 0.05


def time_interleaved(fns: list, rounds: int = 20) -> list[float]:
    """Median device ms of each thunk of ``fns``, timed in turns: each of
    ``rounds`` rounds times every thunk once (CUDA events, L2 flushed
    before each run, as on the serving path and in ``chip_smoke.py``'s
    timer), after 3 warm-up runs of each. Turns keep a drift of the card's
    clocks from favouring whichever thunk runs last."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(256 << 20, dtype=torch.uint8,
                                  device="cuda"))
    for fn in fns:
        for _ in range(3):
            fn()
    times: list = [[] for _ in fns]
    for _ in range(rounds):
        for fn, ts in zip(fns, times):
            _FLUSH[0].zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
    return [sorted(ts)[rounds // 2] for ts in times]


# the search's launcher, timer and device: the card's unless a caller
# installs others (``measured_by``)
_measure: dict = {"launch": None, "time": None, "device": None}


@contextlib.contextmanager
def measured_by(launch: Callable, time: Callable, device: str = "cpu"):
    """Inside the block the search builds its cases on ``device``,
    launches a candidate by ``launch(kernel, case, plan) -> output`` and
    times the candidates by ``time(thunks) -> [ms]`` (the CPU tests'
    fakes)."""
    saved = dict(_measure)
    _measure.update(launch=launch, time=time, device=device)
    try:
        yield
    finally:
        _measure.update(saved)


def _measurer():
    if _measure["launch"] is not None:
        return _measure["launch"], _measure["time"], _measure["device"]
    if not torch.cuda.is_available():
        raise RuntimeError("autotune: the search (RTORCH_AUTOTUNE=1) "
                           "measures the kernels on a CUDA device")
    return _cuda_launch, time_interleaved, "cuda"


def _search(kernel: str, cls: str, cands: list, case: Case,
            rebuild: Callable) -> dict:
    """Hold every candidate choice's output on ``case`` against the plain
    version, then time them in turns (the fixed plan's first); the fastest
    choice if it beats the fixed plan by MIN_GAIN, else the fixed plan's.
    A candidate that fails to launch or disagrees raises: a valid plan the
    kernel gets wrong is a fault, not a slow candidate."""
    note_trace("autotune_search", key=cls)
    launch, time_ms, _ = _measurer()
    plans = []
    for choice in cands:
        plan = rebuild(choice)
        if plan is None:
            raise ValueError(f"autotune {cls}: candidate {choice} is not a "
                             f"valid plan")
        err = float((launch(kernel, case, plan) - case.plain).abs().max())
        if not err <= case.tol:
            raise AssertionError(f"autotune {cls}: candidate {choice} "
                                 f"max |err| {err} > {case.tol}")
        plans.append(plan)
    times = time_ms([lambda p=p: launch(kernel, case, p) for p in plans])
    for choice, t in zip(cands, times):
        _LOG.info("autotune %s %s: %.4f ms", cls, choice, t)
    best = min(range(len(cands)), key=times.__getitem__)
    return (cands[best] if times[best] < (1.0 - MIN_GAIN) * times[0]
            else cands[0])


def _matmul_case(name: str, lead: tuple, m: int, k: int, n: int, bits: int,
                 groups: int, device: str) -> Case:
    """Seeded operands of a matmul class, drawn on ``device``: x
    (*lead, m, K) f32, quantized per token to int8 for the W8A8 kernels,
    and an RTN-packed (*lead, K, N) weight of ``groups`` scale groups."""
    from repro_torch.core.quant.types import quantize, quantize_activation
    from repro_torch.kernels import ref

    int8 = "w8a8" in name
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    x = torch.randn(lead + (m, k), generator=gen, device=device)
    w = torch.randn(lead + (k, n), generator=gen, device=device)
    qt = quantize(w / math.sqrt(k), bits, _group_size(k, groups),
                  act_bits=8 if int8 else 0)
    del w
    if int8:
        xq, _ = quantize_activation(x.reshape(-1, k))
        x = xq.reshape(x.shape).contiguous()
    plain = getattr(ref, name + "_ref")(x, qt.qw, qt.scale, bits=bits,
                                       group_size=qt.group_size, k=k)
    return Case((x, qt), plain, dense_tol(x, qt, int8=int8))


def _search_dense(name: str, cls: str, m: int, k: int, n: int, bits: int,
                  groups: int) -> dict:
    """Search a dense class at its bucket's rows."""
    int8 = name == "w8a8_matmul"
    mb = m_bucket(m)
    device = _measurer()[2]
    case = _matmul_case(name, (), mb, k, n, bits, groups, device)
    return _search(name, cls,
                   template.dense_candidates(mb, k, n, bits, groups,
                                             int8=int8), case,
                   lambda ch: template.valid_dense(ch, mb, k, n, bits,
                                                   groups, int8=int8))


def _search_expert(name: str, cls: str, e: int, c: int, k: int, n: int,
                   bits: int, groups: int) -> dict:
    """Search an expert class at the call's experts and its bucket's
    capacity rows."""
    x_bytes = 1 if name == "expert_w8a8_matmul" else 4
    cb = m_bucket(c)
    device = _measurer()[2]
    case = _matmul_case(name, (e,), cb, k, n, bits, groups, device)
    return _search(name, cls,
                   template.expert_candidates(e, cb, k, n, bits, groups,
                                              x_bytes=x_bytes), case,
                   lambda ch: template.valid_expert(ch, e, cb, k, n, bits,
                                                    groups, x_bytes=x_bytes))


def _search_paged(cls: str, s: int, kvh: int, w: int, page_size: int,
                  rows: int, hd: int, hd_v: int, kv: str, *,
                  m_rows: int) -> dict:
    """Search a paged class on ``paged_harness``'s seeded pools of its
    type, the slots' fills a ramp up to the full table (slot i holds
    (i + 1) / S of it)."""
    from repro_torch.kernels import paged_harness as ph
    from repro_torch.kernels import ref

    if hd_v != hd or rows % m_rows:
        raise ValueError(f"autotune {cls}: the search's pools take hd_v == "
                         f"hd and rows a multiple of m_rows {m_rows}")
    device = _measurer()[2]
    fills = [max(m_rows, w * page_size * (i + 1) // s) for i in range(s)]
    g = rows // m_rows
    build = ph.build_paged_case if m_rows == 1 else ph.build_verify_case
    margs = () if m_rows == 1 else (m_rows,)
    q, pools, bt, kv_len = build(0, s, *margs, w, page_size, kvh, g, hd,
                                 fills, 8 if kv == "int8" else 16,
                                 pools="bf16" if kv == "bf16" else "f32",
                                 device=device)
    q = ph.kernel_rows(q, kvh)
    plain = ref.paged_attention_ref(q, pools["k_pool"], pools["v_pool"], bt,
                                    kv_len, pools["k_scale_pool"],
                                    pools["v_scale_pool"], m_rows=m_rows)
    shape = (s, kvh, w, page_size, rows, hd, hd_v, kv)
    return _search("paged_attention", cls,
                   template.paged_candidates(*shape),
                   Case((q, pools, bt, kv_len, m_rows), plain, 1e-4),
                   lambda ch: template.valid_paged(ch, *shape))
