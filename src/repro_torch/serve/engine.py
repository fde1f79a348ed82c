"""Serving engines (port of ``repro.serve.engine``): the static-batch
``ServeEngine`` and the continuous-batching ``ContinuousEngine``.

``ServeEngine`` is the baseline: one prompt length, lockstep decode to
max_new over a contiguous cache, and ``score`` for log-likelihoods.

``ContinuousEngine`` admits requests into a fixed pool of slots backed by
a paged KV cache, by SLO class (interactive before batch, FIFO within a
class, aging against starvation; serve/scheduler.py). Each ``step()``:

  0. fires the fault plan's faults for this step, and cancels running
     requests past their deadline;
  1. admits queued requests into free slots while the page pool covers
     their whole budget, less the pages of a prefix-cache hit; with
     ``preempt`` an interactive request that does not fit evicts a batch
     request, whose owned live KV pages spill to host RAM, and a preempted
     request re-admitted gets its pages scattered back and resumes where
     it stopped;
  2. advances every slot still ingesting its prompt by one prefill chunk
     (the whole rest of the prompt unless ``chunked_prefill`` caps it):
     chunks are left-padded (pad positions -1, routed to the scratch page
     and masked everywhere) to a multiple of ``prefill_bucket`` and
     batched per (bucket, has-context) in power-of-two batches of at most
     ``prefill_batch``. A chunk that starts at position 0 attends to
     itself; a later chunk, or a suffix after shared prefix pages, reads
     its earlier context through the paged kernel's multi-row read. A
     slot whose prompt completes samples its first token and joins the
     decode set;
  3. runs one block of K decode steps over all slots with sampling on the
     device and one host sync per block. K adapts to the smallest
     remaining budget (power of two, at most ``decode_block``) so slots
     retire at a block boundary. A slot whose logits turn non-finite
     freezes inside the block and is quarantined. With ``spec_decode`` the
     block is one speculative round instead: a W2/W3 draft packed from the
     same float params proposes up to ``spec_k`` tokens a slot, the target
     scores them in one (S, k + 1)-row verify forward, and each slot emits
     its accepted prefix plus one target token. Greedy output is the
     target-only stream.

Weights may be float or packed (``quant_bits`` packs a float tree through
``quantize_params_for_serving``; ``act_bits=8`` tags it for int8
activations). On the card every quantized linear runs a CUDA matmul
kernel — the dequant matmul, or the W8A8 matmul for A8 weights, and
their expert-batched forms for MoE experts — and every paged attention
read (decode, later chunks, verify, and a restored slot's decode over its
scattered-back pages) the CUDA paged-attention kernel; with
``device="cpu"`` they run their plain versions. The spill's page gather
and scatter are library index ops (as in the JAX package, outside any
kernel). There is no fallback from a kernel to another read: a kernel
that fails raises, and an injected ``kernel_fault`` raises
``FaultInjected`` (a crash that ``serve.faults.run_resilient`` recovers
from a snapshot). An MoE's capacity is cross-token: a prefill batch
routes its padded tokens' count, so with ``prefill_batch`` > 1 which
tokens are dropped depends on the co-batched prompts.

``ContinuousEngine(tp=N)`` serves tensor-parallel over the "model" axis
of a mesh of N ranks, one process each (``launch/serve.py --tp N`` spawns
them): every rank builds the same engine, cuts its shard of the params
(``distributed/partitioning.py``: column-parallel wq/wk/wv/wi/wg, row-
parallel wo, packed weights and their scales jointly; a rank packs only
its shard), holds its kv-head slice of every page, and runs the model on
its heads with an all-reduce after each row-parallel projection. The
lm_head is replicated, so the logits, and with them the scheduler, the
page budget, the block tables and the sampling (a generator seeded alike
on every rank), are the same on every rank without any exchange.

MLA (DeepSeek) keeps a latent cache, c_kv and k_pe, in its pools, and
its decode reads them by a gather and plain f32 einsums, as in the JAX
package: the paged kernel is not on its path. Its prefill attends to the
chunk alone. A mamba layer (mamba2, Jamba) keeps its recurrent state in
slot-indexed rows beside the pools, never paged: a prefill chunk writes
each request's final state into its slot's row (``paged["slots"]``), and
every decode step steps every slot's state, idle slots included, as in
the JAX package (admission's prefill overwrites the row). So on both the
engine refuses what would resume from pages or rewind — ``preempt``,
``prefix_share``, ``chunked_prefill`` and ``spec_decode`` — with the JAX
engine's messages (``attention_only_refusal``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import zlib
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.sanitize import note_variant
from repro_torch.core.quant.deploy import (quantize_params_for_serving,
                                           to_device)
from repro_torch.core.quant.types import QuantizedTensor
from repro_torch.debug_flags import debug_enabled, sanitize_enabled
from repro_torch.device import resolve_device
from repro_torch.distributed.partitioning import (local_shard,
                                                  paged_pool_pspecs,
                                                  serve_param_shardings,
                                                  serve_tp_widths,
                                                  tp_local_cfg)
from repro_torch.distributed.sharding import TP_AXIS, _flat, sharding_ctx
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (init_cache, init_contiguous_cache,
                                            is_quantized, lm_decode,
                                            lm_forward, lm_prefill, lm_verify)
from repro_torch.serve.faults import Fault, FaultInjected, FaultPlan
from repro_torch.serve.kvcache import (POOL_KEYS, PagePool, PageSpec,
                                      default_page_spec, pool_head_dim)
from repro_torch.serve.sampling import (sample, spec_accept_greedy,
                                        spec_accept_sample)
from repro_torch.serve.scheduler import Request, Scheduler

_PAGE_AXIS = 1      # the page axis of every pool leaf (serve/kvcache.py)


def _params_sig(params: dict) -> str:
    """Coarse weight signature of the sanitizer's step keys, as the JAX
    engine's: the packed bit widths in the tree ("w2", "w4/8"), or "f32".
    Target and draft reach the same entry points with different leaves;
    without it their two variants would read as one counted twice."""
    bits: set = set()

    def walk(t):
        if isinstance(t, QuantizedTensor):
            bits.add(t.bits)
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)

    walk(params)
    return "w" + "/".join(map(str, sorted(bits))) if bits else "f32"


def _serving_params(cfg: ModelConfig, params: dict, quant_bits: int,
                    quant_group: int, act_bits: int,
                    device: torch.device) -> dict:
    """``params`` on ``device``, packed when ``quant_bits`` is set."""
    if quant_bits:
        if is_quantized(params):
            raise ValueError("params already hold packed weights; pass "
                             "quant_bits=0")
        return quantize_params_for_serving(
            cfg, params, bits=quant_bits, group_size=quant_group,
            act_bits=act_bits, device=device)
    if act_bits:
        raise ValueError("act_bits needs quant_bits (the A8 tag lives on "
                         "packed weights)")
    return to_device(params, device)


# ------------------------------------------------ tensor-parallel placement

def _leaves(tree, specs=None, prefix: str = ""):
    """(path, tensor, spec) of every tensor leaf of a param tree and its
    spec tree (specs None: nothing split); a packed leaf's qw and scale
    come as "path#qw" and "path#scale"."""
    if isinstance(tree, QuantizedTensor):
        yield (prefix + "#qw", tree.qw, None if specs is None else specs.qw)
        yield (prefix + "#scale", tree.scale,
               None if specs is None else specs.scale)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, None if specs is None else specs[k],
                               f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree, specs


def _split(spec, mesh) -> int:
    """How many ranks a leaf's spec splits it over."""
    if spec is None:
        return 1
    return math.prod(mesh.shape[a] for axes in spec for a in _flat(axes))


def _left_whole(params, specs, intent, mesh) -> list[str]:
    """The leaves the placement contract splits (their spec without a
    mesh, ``intent``, names an axis) that ``specs`` leaves whole on
    ``mesh``: a K split dropped for packed words or scale groups that do
    not divide. A per-channel (1, N) scale of a row-parallel weight and
    MLA's latent projection wdkv name no axis, so they are whole by
    design and never listed."""
    return [path for (path, _, spec), (_, _, want)
            in zip(_leaves(params, specs), _leaves(params, intent))
            if any(_flat(a) for a in want) and _split(spec, mesh) == 1]


def _tp_serving_params(cfg: ModelConfig, params: dict, quant_bits: int,
                       quant_group: int, act_bits: int,
                       device: torch.device, mesh) -> tuple[dict, dict, dict]:
    """This rank's serving params, their spec tree and the contract's
    (the specs without a mesh). The rank packs the whole tree as one
    device would, checks that every leaf the contract splits is split,
    then keeps its shard: a legal K split holds whole packed words and
    whole scale groups, so the shard's bytes are the whole tree's
    sliced."""
    packed = _serving_params(cfg, params, quant_bits, quant_group, act_bits,
                             device)
    specs = serve_param_shardings(mesh, cfg, packed)
    intent = serve_param_shardings(None, cfg, packed)
    bad = _left_whole(packed, specs, intent, mesh)
    if bad:
        raise ValueError(
            f"tp={cfg.tp}: projection leaves stayed replicated: {bad}. "
            f"For grouped quantization every shard must hold whole scale "
            f"groups — pick a group_size dividing K/tp, or per-channel "
            f"(group_size=-1)")
    return local_shard(packed, specs, mesh), specs, intent


def _tp_mesh(tp: int, mesh):
    """The serving mesh: ``mesh`` checked against ``tp``, or a ("model",)
    mesh over the whole initialised process group, whose size must be
    ``tp``."""
    from repro_torch.launch.mesh import make_mesh

    if mesh is None:
        import torch.distributed as dist

        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != tp:
            raise ValueError(
                f"tp={tp} needs {tp} ranks, the process group has {world} "
                f"(spawn them with launch/serve.py --tp, or torchrun)")
        mesh = make_mesh((tp,), (TP_AXIS,))
    if int(mesh.shape.get(TP_AXIS, 1)) != tp:
        raise ValueError(f"mesh axis {TP_AXIS!r} has size "
                         f"{mesh.shape.get(TP_AXIS)} != tp={tp}")
    return mesh


@dataclasses.dataclass
class GenerateResult:
    tokens: np.ndarray          # (B, max_new)
    n_prompt: int
    steps: int


class ServeEngine:
    """Static batch: prompts of one length prefilled together into a
    contiguous cache, then lockstep decode to ``max_new``. Its linears run
    the matmul kernels; its attention is the contiguous read (no paged
    kernel), as in the JAX package."""

    def __init__(self, cfg: ModelConfig, params: dict, *, eos_id: int = -1,
                 quant_bits: int = 0, quant_group: int = 0,
                 act_bits: int = 0, device="cuda"):
        cfg.validate()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = _serving_params(cfg, params, quant_bits, quant_group,
                                      act_bits, self.device)
        # the sanitizer's flag, read once: its sites cost nothing when off
        self._sanitize = sanitize_enabled()
        self._w_sig = _params_sig(self.params) if self._sanitize else None
        self.eos_id = eos_id

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, *, max_new: int = 32,
                 temperature: float = 0.0, top_k: int = 0,
                 generator: Optional[torch.Generator] = None
                 ) -> GenerateResult:
        """prompts (B, S) -> (B, max_new) tokens; a row that emitted
        ``eos_id`` emits it from then on. The last token needs no decode
        step, so ``max_new - 1`` steps run."""
        prompts = np.asarray(prompts, np.int32)
        b, s = prompts.shape
        if self._sanitize:
            note_variant("generate", batch=b, prompt=s, max_new=max_new,
                         temperature=temperature, top_k=top_k,
                         w=self._w_sig)
        dev = self.device
        cache = init_contiguous_cache(self.cfg, b, s + max_new, dev)
        pos = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(
            b, s)
        logits = lm_prefill(self.cfg, self.params,
                            torch.tensor(prompts, device=dev), cache, pos)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        out = []
        for t in range(max_new):
            tok = sample(logits, temperature=temperature, top_k=top_k,
                         generator=generator)
            tok = torch.where(done, self.eos_id, tok)
            if self.eos_id >= 0:
                done = done | (tok == self.eos_id)
            out.append(tok)
            if t + 1 < max_new:
                p = torch.full((b, 1), s + t, dtype=torch.int32, device=dev)
                logits = lm_decode(self.cfg, self.params, tok[:, None],
                                   cache, p)
        return GenerateResult(torch.stack(out, 1).cpu().numpy(), s, max_new)

    @torch.no_grad()
    def score(self, tokens: np.ndarray) -> np.ndarray:
        """Per-token log-likelihoods (B, S - 1) of tokens (B, S)."""
        toks = torch.tensor(np.asarray(tokens), dtype=torch.int64,
                            device=self.device)
        logits, _ = lm_forward(self.cfg, self.params, toks[:, :-1])
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, toks[:, 1:, None])[..., 0]
        return (ll - lse).cpu().numpy()


# ------------------------------------------------------ KV spill / restore
#
# Preemption moves a victim slot's owned live pages to host RAM and back,
# each pool leaf indexed along its page axis, so one call moves every
# layer's slice of the spilled pages. Both directions and the engine
# snapshot move all their leaves in one copy (``_to_host`` /
# ``_to_device``).

def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _to_host(tensors: list) -> list:
    """Host numpy copies of ``tensors`` in one synchronous device-to-host
    copy: their bytes end to end, each at a 16-byte boundary."""
    chunks, spans, off = [], [], 0
    for t in tensors:
        b = t.contiguous().view(-1).view(torch.uint8)
        pad = -b.numel() % 16
        chunks.append(b)
        if pad:
            chunks.append(b.new_zeros(pad))
        spans.append((off, b.numel()))
        off += b.numel() + pad
    flat = torch.cat(chunks).cpu().numpy()
    return [flat[o:o + n].view(_np_dtype(t.dtype)).reshape(t.shape)
            for (o, n), t in zip(spans, tensors)]


def _to_device(arrays: list, device: torch.device) -> list:
    """``_to_host``'s inverse: tensors on ``device`` from host arrays, in
    one host-to-device copy."""
    spans, off = [], 0
    for a in arrays:
        spans.append((off, a.nbytes))
        off += a.nbytes + (-a.nbytes % 16)
    flat = np.zeros(off, np.uint8)
    for (o, n), a in zip(spans, arrays):
        flat[o:o + n] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    dev = torch.from_numpy(flat).to(device)
    return [dev[o:o + n].view(torch.from_numpy(np.empty(0, a.dtype)).dtype)
            .view(a.shape) for (o, n), a in zip(spans, arrays)]


def _host_tree(tree: dict, pick: Callable) -> dict:
    """The cache tree with each leaf ``pick(key, tensor)`` copied to host
    numpy (all in one copy); a leaf ``pick`` maps to None stays None."""
    picked = []

    def walk(t, key=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        sel = pick(key, t)
        if sel is None:
            return None
        picked.append(sel)
        return len(picked) - 1
    shape = walk(tree)
    host = _to_host(picked) if picked else []

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(v) for k, v in t.items()}
        return None if t is None else host[t]
    return fill(shape)


def _put_tree(tree: dict, host: dict, put: Callable,
              device: torch.device) -> None:
    """Write the host tree's arrays into the cache tree's leaves through
    ``put(dst, src)`` (one host-to-device copy for all of them); a None
    host leaf is skipped."""
    pairs = []

    def walk(t, h):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, h[k])
        elif h is not None:
            pairs.append((t, h))
    walk(tree, host)
    if pairs:
        srcs = _to_device([np.asarray(h) for _, h in pairs], device)
        for (dst, _), src in zip(pairs, srcs):
            put(dst, src)


def _tree_checksum(tree) -> int:
    """crc32 over every array leaf of a (nested-dict) host tree, in sorted
    key order (the JAX package's): verified before a spill is scattered
    back, it catches bytes flipped while the snapshot sat in host RAM."""
    crc = 0
    if isinstance(tree, dict):
        for k in sorted(tree):
            crc = zlib.crc32(str(k).encode(), crc)
            crc = zlib.crc32(_tree_checksum(tree[k]).to_bytes(4, "little"),
                             crc)
        return crc
    if tree is None:
        return 0
    arr = np.ascontiguousarray(np.asarray(tree))
    return zlib.crc32(arr.tobytes(), zlib.crc32(str(arr.dtype).encode()))


def _corrupt_first_leaf(tree):
    """Flip one byte of the first array leaf (sorted-key walk): the
    spill_corrupt fault's damage. Returns (new tree, corrupted?)."""
    if isinstance(tree, dict):
        out, hit = {}, False
        for k in sorted(tree):
            if hit:
                out[k] = tree[k]
            else:
                out[k], hit = _corrupt_first_leaf(tree[k])
        return {k: out[k] for k in tree}, hit
    if tree is None:
        return tree, False
    arr = np.asarray(tree).copy()
    arr.view(np.uint8).reshape(-1)[0] ^= 0xFF
    return arr, True


def _decode_scan(cfg: ModelConfig, params: dict, cache: dict,
                 last_tok: torch.Tensor, cur_len: torch.Tensor,
                 active: torch.Tensor, block_table: torch.Tensor, *,
                 k_steps: int, page_size: int, temperature: float,
                 top_k: int, generator: torch.Generator,
                 with_logits: bool = False,
                 poison: Optional[torch.Tensor] = None):
    """K decode steps over all slots, sampling on the device; no host sync
    inside. Each step writes the new token's K/V first, then reads with
    kv_len = fill + 1. Inactive slots write to the scratch page and read
    kv_len 0.

    The alive mask is the non-finite sentinel: one isfinite reduction over
    each step's logits. A slot whose logits stop being finite is dropped
    from the active set inside the block (its token and fill freeze, its
    rows stop feeding the model), so it cannot perturb its co-batched
    slots on later steps; the host drops its tokens and quarantines it.
    ``poison`` (S,) bool, the fault hook, gives marked slots NaN logits on
    the first step. Returns the (K, S) sampled tokens and the (K, S) alive
    mask on the device, and with ``with_logits`` also the (K, S, V) logits
    (the speculative draft's, for the sampled acceptance rule) in between.
    """
    n_slots, max_pages = block_table.shape
    sl = torch.arange(n_slots, device=block_table.device)
    tok, clen = last_tok, cur_len
    alive = torch.ones_like(active)
    out, out_alive, out_logits = [], [], []
    for step in range(k_steps):
        act = active & alive
        page_idx = (clen // page_size).clamp(0, max_pages - 1).to(torch.int64)
        paged = {
            "block_table": block_table,
            "write_page": torch.where(
                act, block_table[sl, page_idx].clamp_min(0), 0),
            "write_off": torch.where(act, clen % page_size, 0),
            "kv_len": torch.where(act, clen + 1, 0),
        }
        pos = torch.where(act, clen, 0)[:, None]
        logits = lm_decode(cfg, params, tok[:, None], cache, pos, paged)
        if step == 0 and poison is not None:
            logits = torch.where(poison[:, None], torch.nan, logits)
        # a slot dies the step its logits stop being finite (inactive
        # slots read garbage rows: only active ones can die)
        alive = alive & (torch.isfinite(logits).all(dim=-1) | ~act)
        if temperature > 0.0:
            # a dead or idle row's draw is dropped; keep it drawable
            logits = torch.where(torch.isfinite(logits), logits, 0.0)
        nxt = sample(logits, temperature=temperature, top_k=top_k,
                     generator=generator)
        keep = act & alive
        tok = torch.where(keep, nxt, tok)
        clen = clen + keep.to(clen.dtype)
        out.append(nxt)
        out_alive.append(alive)
        if with_logits:
            out_logits.append(logits)
    if with_logits:
        return torch.stack(out), torch.stack(out_logits), torch.stack(
            out_alive)
    return torch.stack(out), torch.stack(out_alive)


def _spec_round(cfg: ModelConfig, params: dict, draft_params: dict,
                cache: dict, draft_cache: dict, last_tok: torch.Tensor,
                cur_len: torch.Tensor, active: torch.Tensor,
                block_table: torch.Tensor, *, k_steps: int, page_size: int,
                temperature: float, top_k: int,
                generator: torch.Generator):
    """One speculative round: draft-propose, target-verify, accept.

    The draft runs k_steps + 1 decode steps from the shared last_tok /
    cur_len, so its cache holds every position up to cur_len + k_steps
    whatever the target accepts (a rejected tail sits past the advanced
    fill and is masked until overwritten). Its last proposal is dropped;
    [last_tok, d_1..d_k] are the (S, k + 1) verify rows the target scores
    in one forward. Returns (out (S, M) tokens, n_emit (S,)): slot s emits
    out[s, :n_emit[s]], 0 for idle slots."""
    m = k_steps + 1
    sampled = temperature > 0.0
    draft = _decode_scan(cfg, draft_params, draft_cache, last_tok, cur_len,
                         active, block_table, k_steps=m, page_size=page_size,
                         temperature=temperature, top_k=top_k,
                         generator=generator, with_logits=sampled)
    draft_toks, draft_logits = draft[0], (draft[1] if sampled else None)
    # verify rows at positions cur_len .. cur_len + k; idle slots at -1 and
    # kv_len 0 (their writes land on the scratch page, their rows unread)
    x = torch.cat([last_tok[:, None], draft_toks[:m - 1].t()], dim=1)
    positions = torch.where(
        active[:, None],
        cur_len[:, None] + torch.arange(m, dtype=cur_len.dtype,
                                        device=cur_len.device)[None, :], -1)
    paged = {"bt_rows": block_table,
             "kv_len": torch.where(active, cur_len + m, 0),
             "verify": True}
    logits = lm_verify(cfg, params, x, cache, positions, paged)
    if sampled:
        out, n_emit = spec_accept_sample(
            logits, draft_logits[:m - 1].transpose(0, 1), x[:, 1:],
            temperature=temperature, top_k=top_k, generator=generator)
    else:
        out, n_emit = spec_accept_greedy(logits, x[:, 1:])
    return out, torch.where(active, n_emit, 0)


def attention_only_refusal(cfg: ModelConfig, *, preempt: bool = False,
                           prefix_share: bool = False,
                           chunked_prefill: int = 0,
                           spec_decode: bool = False) -> Optional[str]:
    """Why the engine refuses these features on ``cfg``, or None: the JAX
    package's refusals for models with a non-attention (SSM) layer or MLA,
    word for word. An SSM layer's recurrent state is slot-indexed, not
    page-addressed: a spill of pages, a shared page or a later chunk
    carries none of it, and a speculative verify cannot rewind it. MLA's
    non-absorbed prefill attends to the chunk alone, so a later chunk, a
    suffix after shared pages, a preempted request resumed mid-prefill and
    a speculative verify would all be silently wrong."""
    has_ssm = any(s.kind != "attn" for s in cfg.all_layer_specs())
    if not has_ssm and cfg.attention != "mla":
        return None
    if preempt:
        return ("preempt covers attention-only decoders (no SSM blocks, "
                "no MLA)")
    if prefix_share or chunked_prefill:
        return ("prefix_share/chunked_prefill cover attention-only "
                "decoders (no SSM blocks, no MLA)")
    if spec_decode:
        return ("spec_decode covers attention-only decoders: the verify "
                "forward rides the paged gathered/fused read (no SSM "
                "recurrence rewind, no MLA latent prefill)")
    return None


class ContinuousEngine:
    """Slot-stepping execution core for continuous batching.

    Holds the paged cache, the per-slot host state (fill depth, last token)
    and the prefill/decode steps; admission and request bookkeeping live in
    serve/scheduler.py. ``prefill_bucket`` trades the number of distinct
    prefill shapes against pad waste (bucket 1 pads nothing);
    ``decode_block`` trades admission latency against per-block host
    syncs.

    ``prefix_share=True`` turns on the pool's prefix index: a prompt whose
    full-page prefix an earlier request prefilled reuses those pages and
    prefills only the rest. ``chunked_prefill=N`` caps a prefill call at N
    tokens a slot (rounded down to a page multiple, at least one page), so
    a long prompt spreads over ticks while decode slots keep stepping.
    ``spec_decode=True`` replaces the decode block by speculative rounds
    (``draft_bits`` 2 or 3, up to ``spec_k`` proposals a round); the
    draft's KV lives in a second cache on the same page geometry and block
    tables, and every prefill chunk is mirrored into it.

    ``preempt=True`` arms overload discipline: ``submit(..., priority=1)``
    marks batch work, and an interactive request that cannot be admitted
    evicts a batch victim. Its exclusively owned live KV pages spill to
    host RAM (shared prefix pages stay by reference), and its restore
    re-stitches the block table and scatters the pages back, so the stream
    resumes where it stopped, mid-prefill included (a preempted request
    never prefills a token twice). ``age_promote`` bounds batch
    starvation. ``tp`` > 1 serves tensor-parallel over the "model" axis
    of ``mesh`` (by default a mesh over the whole process group, which
    must then have ``tp`` ranks); every rank builds this engine with the
    same arguments. ``faults`` is a ``FaultPlan`` fired step by step;
    ``snapshot()`` / ``restore()`` capture and reload the whole serving
    state (serve/faults.py's ``run_resilient`` drives crash recovery).
    ``debug=True`` checks the pool's invariants and the slot mirrors
    against the scheduler after every step; ``debug=None`` takes the
    RTORCH_DEBUG flag (``repro_torch.debug_flags``). Under RTORCH_SANITIZE
    each step entry point notes its shape-bucket variant
    (``analysis/sanitize.py``), keyed as the JAX engine keys its jits."""

    def __init__(self, cfg: ModelConfig, params: dict, *, n_slots: int = 8,
                 max_len: int = 512, page_size: int = 16,
                 n_pages: Optional[int] = None, eos_id: int = -1,
                 prefill_bucket: int = 16, prefill_batch: int = 8,
                 decode_block: int = 8, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0, quant_bits: int = 0,
                 quant_group: int = 0, act_bits: int = 0,
                 prefix_share: bool = False, chunked_prefill: int = 0,
                 spec_decode: bool = False, draft_bits: int = 2,
                 spec_k: int = 4, preempt: bool = False,
                 age_promote: Optional[float] = None,
                 faults: Optional[FaultPlan] = None,
                 debug: Optional[bool] = None, tp: int = 1, mesh=None,
                 device="cuda"):
        cfg.validate()
        if cfg.enc_dec:
            raise NotImplementedError("paged serving covers decoder-only LMs")
        if mesh is not None and tp == 1:
            tp = int(mesh.shape.get(TP_AXIS, 1))
        if tp > 1:
            specs = cfg.all_layer_specs()
            if any(s.kind != "attn" for s in specs) or \
                    any(s.mlp == "moe" for s in specs):
                # the placement contract covers dense attention decoders
                # only, as in the JAX package
                raise NotImplementedError(
                    "tensor-parallel serving covers dense attention "
                    "decoders (no MoE, no SSM blocks)")
            if tp not in serve_tp_widths(cfg):
                raise ValueError(
                    f"tp={tp} is illegal for {cfg.name}: GQA head groups "
                    f"must stay whole per shard and d_ff must split evenly "
                    f"— legal widths {serve_tp_widths(cfg)}")
            mesh = _tp_mesh(tp, mesh)
            cfg = cfg.replace(tp=tp)
        self.tp = tp
        self.mesh = mesh if tp > 1 else None
        why = attention_only_refusal(
            cfg, preempt=preempt, prefix_share=prefix_share,
            chunked_prefill=chunked_prefill, spec_decode=spec_decode)
        if why:
            raise NotImplementedError(why)
        self.device = resolve_device(device)
        self.cfg = cfg
        # the config the model code runs under: a rank's heads under TP
        self.model_cfg = tp_local_cfg(cfg)
        self.spec_decode = bool(spec_decode)
        self.spec_k = spec_k
        self.draft_bits = draft_bits
        self.preempt = bool(preempt)
        if self.preempt and tp > 1:
            raise NotImplementedError(
                "preempt + tensor-parallel serving is an open item "
                "(spill must gather per-shard kv-head slices)")
        if self.preempt and self.spec_decode:
            raise NotImplementedError(
                "preempt + spec_decode is not supported (the draft cache "
                "would need spilling in lockstep)")
        if self.spec_decode:
            if any(s.mlp == "moe" for s in cfg.all_layer_specs()):
                # capacity routing is cross-token: an (S, M) verify batch
                # may route otherwise than M one-token decode steps
                raise NotImplementedError(
                    "spec_decode does not cover capacity-routed MoE")
            if tp > 1 or prefix_share:
                raise NotImplementedError(
                    "spec_decode is single-device and unshared for now "
                    "(no tp>1, no prefix_share)")
            if draft_bits not in (2, 3):
                raise ValueError(f"draft_bits must be 2 or 3 (a draft at "
                                 f"the target's own width buys nothing), "
                                 f"got {draft_bits}")
            if spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
            if is_quantized(params):
                raise ValueError(
                    "spec_decode requantizes the float params into the "
                    "draft; pass float params (+ quant_bits for the "
                    "target), not a pre-packed tree")
        self._param_specs = self._param_intent = None
        if self.tp > 1:
            (self.params, self._param_specs,
             self._param_intent) = _tp_serving_params(
                cfg, params, quant_bits, quant_group, act_bits, self.device,
                self.mesh)
        else:
            self.params = _serving_params(cfg, params, quant_bits,
                                          quant_group, act_bits, self.device)
        if self.spec_decode:
            # the same params requantized harder, packed sub-byte
            self.draft_params = quantize_params_for_serving(
                cfg, params, bits=draft_bits, group_size=quant_group,
                device=self.device)
        # the sanitizer's flag, read once (its sites cost nothing when
        # off), and the weights' part of its step keys
        self._sanitize = sanitize_enabled()
        self._w_sig = _params_sig(self.params) if self._sanitize else None
        self._dw_sig = (_params_sig(self.draft_params)
                        if self._sanitize and self.spec_decode else None)
        self.n_slots = n_slots
        self.eos_id = eos_id
        self.prefill_bucket = max(1, prefill_bucket)
        self.prefill_batch = max(1, prefill_batch)
        self.decode_block = max(1, decode_block)
        self.temperature = temperature
        self.top_k = top_k
        self.prefix_share = bool(prefix_share)
        # page-aligned chunks: every chunk (and every shared-prefix
        # handoff) starts at a page start
        self.chunk_tokens = (max(1, chunked_prefill // page_size) * page_size
                             if chunked_prefill else 0)
        if n_pages is None:
            self.spec = default_page_spec(n_slots, max_len, page_size)
        else:
            self.spec = PageSpec(n_pages=n_pages, page_size=page_size,
                                 max_pages=-(-max_len // page_size))
        self.pool = PagePool(self.spec, n_slots,
                             prefix_cache=self.prefix_share)
        self.sched = Scheduler(n_slots, self.pool,
                               prefix_share=self.prefix_share, tp=self.tp,
                               age_promote=age_promote,
                               preempt_hook=(self._spill_slot
                                             if self.preempt else None))
        self.cache = init_cache(self.model_cfg, self.spec, self.device,
                                n_slots)
        if self.tp > 1:
            # the whole cache's shapes (meta tensors, no memory) and the
            # pools' kv-head split: each rank's pools must be exactly its
            # slice, the page geometry whole
            self._global_cache = init_cache(cfg, self.spec, "meta", n_slots)
            self._assert_pool_placement()
        if self.spec_decode:
            self.draft_cache = init_cache(self.model_cfg, self.spec,
                                          self.device, n_slots)
        # host mirrors are int32, the dtype the device steps consume
        self.cur_len = np.zeros(n_slots, np.int32)   # tokens in cache
        self.last_tok = np.zeros(n_slots, np.int32)  # next token to feed
        self.active = np.zeros(n_slots, bool)
        self._prefilling: dict[int, Request] = {}    # slot -> mid-prompt
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._next_rid = 0
        # the virtual clock is engine state, so a restored engine resumes
        # arrival gating mid-trace
        self.t = 0
        self.n_steps_total = 0       # step() calls: the faults' step index
        # ------------------------------------------------ fault tolerance
        self.faults = faults
        self.debug = debug_enabled() if debug is None else bool(debug)
        self.n_spill_corruptions = 0     # corruption faults injected
        self.n_spill_checksum_fails = 0  # ... caught at restore
        self.n_nonfinite = 0         # slots the isfinite sentinel killed
        self.n_faults_applied = 0    # injected faults fired
        self._poison_slots: set[int] = set()  # NaN at the next decode
        self._kernel_fault: Optional[Fault] = None  # fails the next decode
        self._spill_corrupt = False  # corrupt the next spill payload
        self._fault_holds: list[list] = []    # [release step, [pages]]
        self.n_decode_steps = 0
        self.n_prefills = 0
        self.n_prefill_tokens = 0    # prompt tokens actually prefilled
        self.n_shared_tokens = 0     # prompt tokens from the prefix cache
        # pages moved by preemption (kept-by-reference pages never count)
        self.n_spilled_pages = 0     # owned live pages copied to host RAM
        self.n_restored_pages = 0    # pages scattered back on re-admission
        # speculative acceptance accounting (spec_stats)
        self.n_spec_rounds = 0       # draft + verify rounds
        self.n_draft_tokens = 0      # proposals over active slots
        self.n_spec_emitted = 0      # tokens emitted by rounds
        self.spec_accept_sum = np.zeros(n_slots, np.int64)   # per-slot emits
        self.spec_round_count = np.zeros(n_slots, np.int64)  # per-slot rounds

    def _agreed_clock(self, clock: Callable[[], float]) -> Callable:
        """``clock`` as the TP axis's first rank reads it, on every rank
        (one host broadcast a tick): a wall clock differs between ranks,
        and their schedulers must decide alike."""
        import torch.distributed as dist

        group = self.mesh.host_group(TP_AXIS)

        def agreed() -> float:
            t = torch.tensor([clock()], dtype=torch.float64)
            dist.broadcast(t, group=group, group_src=0)
            return float(t)
        return agreed

    # -------------------------------------------------------- TP placement
    def _cache_leaves(self, tree=None, key=None):
        """(key, leaf) of every cache leaf, in tree order."""
        tree = self.cache if tree is None else tree
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from self._cache_leaves(v, k)
        else:
            yield key, tree

    def _assert_pool_placement(self) -> None:
        """Every pool leaf of this rank is exactly its kv-head slice of the
        whole pool (a head dim the axis cannot divide, MLA's latent, whole)
        and keeps every page; raises otherwise."""
        specs = paged_pool_pspecs(self._global_cache, self.mesh)
        flat_specs = [sp for _, sp in self._cache_leaves(specs)]
        for (key, leaf), (_, whole), spec in zip(
                self._cache_leaves(), self._cache_leaves(self._global_cache),
                flat_specs):
            want = list(whole.shape)
            if key in POOL_KEYS:
                hdim = pool_head_dim(key, whole.ndim)
                want[hdim] //= _split(spec, self.mesh)
            if tuple(leaf.shape) != tuple(want):
                raise RuntimeError(
                    f"{key}: the rank holds {tuple(leaf.shape)}, its slice "
                    f"of {tuple(whole.shape)} is {tuple(want)}")

    def tp_placement_report(self) -> dict:
        """What each rank holds: the bytes of its params and of its paged
        KV pools against the whole trees', and any packed projection leaf
        or pool leaf left whole that the contract splits (MLA's latent
        projection wdkv and its KVH-1 latent pool are whole by design and
        are not listed)."""
        rep = {"tp": self.tp,
               "params": {"global_bytes": 0, "per_device_bytes": 0},
               "kv": {"global_bytes": 0, "per_device_bytes": 0},
               "replicated_quant_leaves": [],
               "replicated_pool_leaves": []}
        for path, leaf, spec in _leaves(self.params, self._param_specs):
            n = leaf.numel() * leaf.element_size()
            split = _split(spec, self.mesh) if self.tp > 1 else 1
            rep["params"]["global_bytes"] += n * split
            rep["params"]["per_device_bytes"] += n
        if self.tp > 1:
            rep["replicated_quant_leaves"] = [
                path for path in _left_whole(self.params, self._param_specs,
                                             self._param_intent, self.mesh)
                if "#" in path]
        whole = self._global_cache if self.tp > 1 else self.cache
        for (key, leaf), (_, g) in zip(self._cache_leaves(),
                                       self._cache_leaves(whole)):
            rep["kv"]["global_bytes"] += g.numel() * g.element_size()
            rep["kv"]["per_device_bytes"] += leaf.numel() * \
                leaf.element_size()
            if key in POOL_KEYS and self.tp > 1:
                hdim = pool_head_dim(key, g.ndim)
                if (tuple(leaf.shape) == tuple(g.shape)
                        and g.shape[hdim] % self.tp == 0):
                    rep["replicated_pool_leaves"].append(key)
        return rep

    # ------------------------------------------------------------- intake
    def submit(self, prompt, *, max_new: int = 32, arrival: float = 0.0,
               priority: int = 0,
               deadline: Optional[float] = None) -> Request:
        """Queue a request. ``priority``: 0 interactive (may preempt batch
        work when ``preempt``), 1 batch. ``deadline``: absolute time past
        which the request is shed from the queue or cancelled mid-run."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size + max_new > self.spec.max_len:
            raise ValueError(
                f"request budget {prompt.size + max_new} exceeds per-slot "
                f"capacity {self.spec.max_len}")
        need = self.spec.pages_for(prompt.size + max_new)
        if need > self.spec.n_pages - 1:
            raise ValueError(
                f"request needs {need} pages but the pool only has "
                f"{self.spec.n_pages - 1} allocatable pages")
        req = Request(rid=self._next_rid, prompt=prompt, max_new=max_new,
                      arrival=arrival, priority=priority, deadline=deadline)
        self._next_rid += 1
        self.sched.submit(req)
        return req

    # -------------------------------------------------- preemption support
    def _spill_slot(self, slot: int, req: Request, now: float):
        """The scheduler's preempt hook: spill ``slot``'s owned live pages
        (every pool leaf's slice, gathered along the page axis and copied
        to host numpy at once), checksum them, and clear the slot's
        mirrors."""
        n_live = int(self.cur_len[slot])

        def copy_out(pages):
            if self._sanitize:
                note_variant("spill_gather", pages=len(pages))
            idx = torch.tensor(pages, dtype=torch.int64, device=self.device)
            host = _host_tree(self.cache, lambda key, t: (
                t.index_select(_PAGE_AXIS, idx) if key in POOL_KEYS
                else None))
            self.n_spilled_pages += len(pages)
            return host

        req.prefill_done = slot not in self._prefilling
        snap = self.pool.spill(slot, n_live, copy_out)
        if snap.host is not None:
            # the checksum of the data as it left the device, before any
            # injected corruption
            snap.checksum = _tree_checksum(snap.host)
            if self._spill_corrupt:
                self._spill_corrupt = False
                snap.host, hit = _corrupt_first_leaf(snap.host)
                if hit:
                    self.n_spill_corruptions += 1
        self._clear_slot(slot)
        return snap

    def _restore_slot(self, slot: int, req: Request, now: float) -> None:
        """Finish a scheduler restore: verify the payload's checksum (a
        mismatch quarantines the request instead of resuming it on garbage
        KV), scatter it into the fresh pages the pool picked, and re-enter
        the request where it stopped: decoding with its last token pending,
        or mid-prefill at its old progress."""
        snap = req.spill
        if (snap.copied and snap.checksum is not None
                and _tree_checksum(snap.host) != snap.checksum):
            self.n_spill_checksum_fails += 1
            req.spill = None
            # restore() turned the kept references into the slot's; the
            # quarantine releases them with the fresh pages
            self.sched.quarantine(slot, now, "spill_corrupt")
            return
        if snap.copied:
            if self._sanitize:
                note_variant("spill_scatter", pages=len(snap.restored))
            idx = torch.tensor(snap.restored, dtype=torch.int64,
                               device=self.device)
            _put_tree(self.cache, snap.host,
                      lambda dst, src: dst.index_copy_(_PAGE_AXIS, idx, src),
                      self.device)
            self.n_restored_pages += len(snap.copied)
        req.spill = None
        self.cur_len[slot] = snap.n_live
        if req.prefill_done:
            self.last_tok[slot] = req.tokens[-1]
            self.active[slot] = True
        else:
            self._prefilling[slot] = req

    def _clear_slot(self, slot: int) -> None:
        self._prefilling.pop(slot, None)
        self.active[slot] = False
        self.cur_len[slot] = 0
        self.last_tok[slot] = 0

    # -------------------------------------------- engine snapshot / restore
    _SNAP_COUNTERS = ("n_decode_steps", "n_prefills", "n_prefill_tokens",
                      "n_shared_tokens", "n_spilled_pages",
                      "n_restored_pages", "n_spec_rounds", "n_draft_tokens",
                      "n_spec_emitted", "n_spill_corruptions",
                      "n_spill_checksum_fails", "n_nonfinite",
                      "n_faults_applied")

    def _fingerprint(self) -> dict:
        """The serving configuration a snapshot belongs to; ``restore``
        refuses a snapshot of another (its cache shapes and scheduling would
        silently diverge)."""
        return {
            "cfg": repr(self.cfg),
            "n_slots": self.n_slots,
            "spec": (self.spec.n_pages, self.spec.page_size,
                     self.spec.max_pages),
            "eos_id": self.eos_id,
            "prefill_bucket": self.prefill_bucket,
            "prefill_batch": self.prefill_batch,
            "decode_block": self.decode_block,
            "temperature": self.temperature, "top_k": self.top_k,
            "prefix_share": self.prefix_share,
            "chunk_tokens": self.chunk_tokens,
            "tp": self.tp,
            "spec_decode": self.spec_decode,
            "draft_bits": self.draft_bits, "spec_k": self.spec_k,
            "preempt": self.preempt,
            "age_promote": self.sched.age_promote,
        }

    def snapshot(self) -> dict:
        """The whole serving state as a nested dict of host values: every
        cache leaf (one device-to-host copy), the allocator (free-list
        order included), the scheduler (requests, queues, events,
        counters), the slot mirrors, the generator state, the virtual clock
        and the pending fault one-shots. Self-contained, serializable with
        ``checkpoint.store.save_snapshot``, and taken by ``restore`` on a
        fresh engine of the same configuration, which then continues with
        the same greedy tokens. The FaultPlan is not captured: the crash
        driver owns it."""
        kf = self._kernel_fault
        snap = {
            "fingerprint": self._fingerprint(),
            "t": self.t,
            "n_steps_total": self.n_steps_total,
            "next_rid": self._next_rid,
            "rng": self._gen.get_state().numpy().copy(),
            "mirrors": {"cur_len": self.cur_len.copy(),
                        "last_tok": self.last_tok.copy(),
                        "active": self.active.copy()},
            "prefilling": {int(s): r.rid
                           for s, r in self._prefilling.items()},
            "cache": _host_tree(self.cache, lambda key, t: t),
            "pool": self.pool.state_dict(),
            "sched": self.sched.state_dict(),
            "counters": {k: getattr(self, k) for k in self._SNAP_COUNTERS},
            "spec_accept_sum": self.spec_accept_sum.copy(),
            "spec_round_count": self.spec_round_count.copy(),
            "fault_state": {
                "poison_slots": sorted(self._poison_slots),
                "kernel_fault": (None if kf is None
                                 else list(dataclasses.astuple(kf))),
                "spill_corrupt": self._spill_corrupt,
                "fault_holds": [[int(s), [int(p) for p in pages]]
                                for s, pages in self._fault_holds],
            },
        }
        if self.spec_decode:
            snap["draft_cache"] = _host_tree(self.draft_cache,
                                             lambda key, t: t)
        return snap

    def restore(self, snap: dict) -> None:
        """Load a ``snapshot()`` into this engine (same configuration,
        checked against the fingerprint) and resume: the next ``step()``
        continues the interrupted trace with the same greedy tokens.

        A pending kernel fault that this engine's plan no longer holds was
        the crash being recovered (``run_resilient`` drops the crashing
        fault from the plan): it is not restored, and its count goes with
        it."""
        fp, got = self._fingerprint(), dict(snap["fingerprint"])
        if got != fp:
            bad = sorted(k for k in set(fp) | set(got)
                         if fp.get(k) != got.get(k))
            raise ValueError(f"snapshot fingerprint mismatch on {bad}: "
                             f"snapshot from a different engine config")
        self.t = int(snap["t"])
        self.n_steps_total = int(snap["n_steps_total"])
        self._next_rid = int(snap["next_rid"])
        self._gen.set_state(torch.from_numpy(
            np.asarray(snap["rng"], np.uint8).copy()))
        self.cur_len = np.asarray(snap["mirrors"]["cur_len"],
                                  np.int32).copy()
        self.last_tok = np.asarray(snap["mirrors"]["last_tok"],
                                   np.int32).copy()
        self.active = np.asarray(snap["mirrors"]["active"], bool).copy()
        _put_tree(self.cache, snap["cache"],
                  lambda dst, src: dst.copy_(src), self.device)
        if self.spec_decode:
            _put_tree(self.draft_cache, snap["draft_cache"],
                      lambda dst, src: dst.copy_(src), self.device)
        self.pool.load_state_dict(snap["pool"])
        by_rid = self.sched.load_state_dict(snap["sched"])
        self._prefilling = {int(s): by_rid[int(r)]
                            for s, r in snap["prefilling"].items()}
        for k in self._SNAP_COUNTERS:
            setattr(self, k, int(snap["counters"][k]))
        self.spec_accept_sum = np.asarray(snap["spec_accept_sum"],
                                          np.int64).copy()
        self.spec_round_count = np.asarray(snap["spec_round_count"],
                                           np.int64).copy()
        fs = snap["fault_state"]
        self._poison_slots = {int(s) for s in fs["poison_slots"]}
        kf = fs["kernel_fault"]
        self._kernel_fault = None if kf is None else Fault(*kf)
        if (self._kernel_fault is not None and self.faults is not None
                and self._kernel_fault not in self.faults.faults):
            self._kernel_fault = None
            self.n_faults_applied -= 1
        self._spill_corrupt = bool(fs["spill_corrupt"])
        self._fault_holds = [[int(s), [int(p) for p in pages]]
                             for s, pages in fs["fault_holds"]]
        if self.debug:
            self._debug_check()

    def fault_stats(self) -> dict:
        """Fault accounting: injections fired, sentinel and checksum
        catches, the scheduler's deadline and quarantine counters, pages
        still held. (The JAX package's also counts kernel fallbacks and
        names its attention path: the port has neither.)"""
        return {
            "n_steps": self.n_steps_total,
            "n_faults_applied": self.n_faults_applied,
            "n_nonfinite": self.n_nonfinite,
            "n_spill_corruptions": self.n_spill_corruptions,
            "n_spill_checksum_fails": self.n_spill_checksum_fails,
            "n_quarantined": self.sched.n_quarantined,
            "n_shed": self.sched.n_shed,
            "n_cancelled": self.sched.n_cancelled,
            "held_pages": sum(len(h[1]) for h in self._fault_holds),
        }

    def _debug_check(self) -> None:
        """The per-step check under ``debug``: the pool's invariants, and
        each slot's mirrors against the scheduler's state (host arithmetic
        only, no device sync), so a fault run fails at the step where the
        state goes wrong."""
        self.pool.check_invariants()

        def check(ok, msg):
            if not ok:
                raise AssertionError(msg)
        for slot in range(self.n_slots):
            req = self.sched.slots[slot]
            if req is None:
                check(not self.active[slot],
                      f"slot {slot}: active with no request")
                check(slot not in self._prefilling,
                      f"slot {slot}: prefilling with no request")
                check(np.all(self.pool.tables[slot] == -1),
                      f"slot {slot}: pages mapped with no request")
                continue
            check(req.slot == slot,
                  f"slot {slot}: request {req.rid} thinks it is in "
                  f"{req.slot}")
            fill = int(self.cur_len[slot])
            mapped = int(np.sum(self.pool.tables[slot] >= 0))
            if slot in self._prefilling:
                check(not self.active[slot],
                      f"slot {slot}: both prefilling and decoding")
                check(fill <= req.n_prompt,
                      f"slot {slot}: prefill fill beyond the prompt")
            else:
                check(self.active[slot], f"slot {slot}: occupied but "
                      f"neither prefilling nor decoding")
                check(fill == req.n_prompt + len(req.tokens) - 1,
                      f"slot {slot}: fill count disagrees with the token "
                      f"stream ({fill} vs {req.n_prompt}+"
                      f"{len(req.tokens)}-1)")
            check(mapped >= self.spec.pages_for(fill),
                  f"slot {slot}: fill {fill} exceeds its {mapped} mapped "
                  f"pages")

    # ------------------------------------------------- fault-plan plumbing
    def _apply_faults(self, step_idx: int, now: float) -> None:
        """Fire every fault scheduled for this step (serve/faults.py).
        Expired pool_exhaust holds release first, so a plan never shrinks
        the pool for good."""
        due = [h for h in self._fault_holds if h[0] <= step_idx]
        for h in due:
            self.pool.release_hold(h[1])
            self._fault_holds.remove(h)
        if self.faults is None:
            return
        for f in self.faults.at(step_idx):
            self.n_faults_applied += 1
            if f.kind == "step_exception":
                raise FaultInjected(f)
            elif f.kind == "nan_logits":
                self._poison_slots.add(max(0, f.slot) % self.n_slots)
            elif f.kind == "pool_exhaust":
                pages = self.pool.hold(f.pages)
                if pages:
                    self._fault_holds.append(
                        [step_idx + max(1, f.duration), pages])
            elif f.kind == "latency_spike":
                # the virtual clock jumps; run() reads now from self.t, so
                # queues and deadlines age from the next tick on
                self.t += max(1, f.duration)
            elif f.kind == "kernel_fault":
                self._kernel_fault = f
            elif f.kind == "spill_corrupt":
                self._spill_corrupt = True

    def _dispatch_fault(self) -> None:
        """A pending kernel fault fails this decode dispatch: it raises
        instead of launching (no fallback read exists)."""
        if self._kernel_fault is not None:
            fault, self._kernel_fault = self._kernel_fault, None
            raise FaultInjected(fault)

    def _enforce_deadlines(self, now: float) -> bool:
        """Cancel running or prefilling requests past their deadline
        (queued ones are shed in the scheduler's admit)."""
        did = False
        for slot, req in enumerate(self.sched.slots):
            if (req is not None and req.deadline is not None
                    and now > req.deadline):
                self._clear_slot(slot)
                self.sched.cancel(slot, now)
                did = True
        return did

    def _quarantine(self, slot: int, req: Request, reason: str,
                    now: float) -> None:
        """Retire a slot the sentinel flagged; the other slots' tokens came
        out of the same block, already shielded inside it."""
        self.n_nonfinite += reason == "nonfinite_logits"
        self._clear_slot(slot)
        self.sched.quarantine(slot, now, reason)

    # ------------------------------------------------------------ serving
    @torch.no_grad()
    def step(self, now: float = 0.0) -> bool:
        """One scheduler tick: fire this step's faults and cancel expired
        requests, admit (restoring preempted ones), advance every
        mid-prefill slot by one chunk, then one block of decode steps (or
        one speculative round). Returns False when there was nothing to
        do. Under TP the tick runs with the engine's mesh active, where
        the row-parallel projections find their process group."""
        ctx = (sharding_ctx(self.mesh) if self.mesh is not None
               else contextlib.nullcontext())
        with ctx:
            return self._step(now)

    def _step(self, now: float) -> bool:
        step_idx = self.n_steps_total
        self.n_steps_total += 1
        self._apply_faults(step_idx, now)        # may raise FaultInjected
        did = self._enforce_deadlines(now)
        for slot, req in self.sched.admit(now):
            if req.spill is not None:
                # a preempted request: its KV goes back, nothing is
                # prefilled again
                did = True
                self._restore_slot(slot, req, now)
                continue
            # a prefix hit starts the prefill past the shared pages
            self.cur_len[slot] = req.n_shared
            self.n_shared_tokens += req.n_shared
            self._prefilling[slot] = req
        if self._prefilling:
            did = True
            self._prefill_tick(now)
        act = np.nonzero(self.active)[0]
        if act.size and self.spec_decode:
            did = True
            self._spec_block(self.active.copy(), now)
        elif act.size:
            did = True
            toks, alive = self._decode_block()          # (K, n_slots) each
            for t in range(toks.shape[0]):
                for slot in act:
                    req = self.sched.slots[slot]
                    if req is None:                     # retired
                        continue
                    if not alive[t, slot]:
                        # the sentinel fired: this step's token and the
                        # rest are garbage, the slot froze in the block
                        self._quarantine(slot, req, "nonfinite_logits", now)
                        continue
                    self._emit(slot, req, int(toks[t, slot]), now)
        if self.debug:
            self._debug_check()
        return did

    def run(self, *, clock=None, max_steps: Optional[int] = None):
        """Drain every submitted request; returns the requests that finished
        during this call, in submit order.

        ``clock``: callable giving the current time for arrival gating and
        latency stamps; default is the virtual step counter ``self.t`` (so
        ``arrival`` is then measured in scheduler steps), which a restored
        engine continues from and latency_spike faults advance. Under TP a
        ``clock`` is read on the axis's first rank and broadcast every
        tick, so every rank admits alike. An injected crash
        (``FaultInjected``) propagates."""
        if clock is not None and self.tp > 1:
            clock = self._agreed_clock(clock)
        steps = 0
        while not self.sched.all_done():
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(f"serve loop exceeded {max_steps} steps")
            now = clock() if clock is not None else float(self.t)
            did = self.step(now)
            if did or clock is None:
                steps += 1
                self.t += 1
            else:
                time.sleep(1e-3)
        return sorted(self.sched.drain_finished(), key=lambda r: r.rid)

    # ----------------------------------------------------------- internals
    def _bucket(self, n: int) -> int:
        b = self.prefill_bucket
        return -(-n // b) * b

    def _read_width(self, n_tokens: int) -> int:
        """Pow2 page count covering n_tokens, capped at the table width."""
        need = self.spec.pages_for(n_tokens)
        width = 1
        while width < need:
            width *= 2
        return min(width, self.spec.max_pages)

    def _prefill_tick(self, now: float) -> None:
        """Advance every mid-prefill slot by one page-aligned chunk, batched
        per (length bucket, has context) in pow2 batch sizes (bounding the
        distinct prefill shapes). A chunk starting at position 0 attends to
        itself; a later chunk or a suffix after shared pages reads its
        earlier context from the pages."""
        groups: dict[tuple[int, bool], list] = {}
        for slot in sorted(self._prefilling):
            req = self._prefilling[slot]
            start = int(self.cur_len[slot])
            end = req.n_prompt
            if self.chunk_tokens and end - start > self.chunk_tokens:
                end = start + self.chunk_tokens
            groups.setdefault((self._bucket(end - start), start > 0),
                              []).append((slot, req, start, end))
        for (padded, has_ctx), items in sorted(groups.items()):
            i = 0
            while i < len(items):
                size = min(1 << ((len(items) - i).bit_length() - 1),
                           self.prefill_batch)
                self._prefill_chunk(items[i:i + size], padded, has_ctx, now)
                i += size

    def _prefill_chunk(self, items: Sequence[tuple], padded: int,
                       has_ctx: bool, now: float) -> None:
        """Prefill one same-bucket batch of (slot, req, start, end) chunks;
        a row that completes its prompt samples its first token and joins
        the decode set, unless its logits are non-finite (quarantined
        before it decodes or publishes a page)."""
        batch = len(items)
        toks = np.zeros((batch, padded), np.int32)
        pos = np.full((batch, padded), -1, np.int32)
        for row, (slot, req, start, end) in enumerate(items):
            n = end - start
            toks[row, padded - n:] = req.prompt[start:end]
            pos[row, padded - n:] = np.arange(start, end, dtype=np.int32)
        slots = [slot for slot, _, _, _ in items]
        dev = self.device
        # the slots, where a mamba layer writes each row's final state
        paged = {"slots": torch.tensor(slots, dtype=torch.int32, device=dev)}
        if has_ctx:
            # the pow2 read width over the deepest chunk end: the walk
            # scales with the fill, not the provisioned max_len
            kv_end = [end for _, _, _, end in items]
            width = self._read_width(max(kv_end))
            paged["bt_rows"] = torch.tensor(self.pool.tables[slots, :width],
                                            dtype=torch.int32, device=dev)
            paged["kv_len"] = torch.tensor(kv_end, dtype=torch.int32,
                                           device=dev)
        else:
            paged["bt_rows"] = torch.tensor(self.pool.tables[slots],
                                            dtype=torch.int32, device=dev)
        toks_d = torch.tensor(toks, device=dev)
        pos_d = torch.tensor(pos, device=dev)
        if self._sanitize:
            width = paged["bt_rows"].shape[1]
            sigs = [self._w_sig] + ([self._dw_sig] if self.spec_decode
                                    else [])
            for sig in sigs:
                note_variant("paged_prefill", batch=batch, bucket=padded,
                             ctx=has_ctx, width=width, w=sig)
        logits = lm_prefill(self.model_cfg, self.params, toks_d, self.cache,
                            pos_d, paged)
        if self.spec_decode:
            # the draft cache takes the same chunk, so draft decode starts
            # from the same fill (the first token is the target's)
            lm_prefill(self.model_cfg, self.draft_params, toks_d,
                       self.draft_cache, pos_d, paged)
        self.n_prefills += 1
        self.n_prefill_tokens += sum(end - start for _, _, start, end in items)
        finish = []
        for row, (slot, req, start, end) in enumerate(items):
            self.cur_len[slot] = end
            if end >= req.n_prompt:
                finish.append(row)
        if not finish:
            return
        last = logits[finish]
        if self._sanitize:
            note_variant("sample_first", batch=len(finish),
                         temperature=self.temperature, top_k=self.top_k)
        first = sample(last, temperature=self.temperature, top_k=self.top_k,
                       generator=self._gen)
        ok = torch.isfinite(last).all(dim=-1).to(first.dtype)
        first, ok = torch.stack([first, ok]).cpu().numpy()   # one host sync
        for tok, okf, row in zip(first, ok, finish):
            slot, req, _, _ = items[row]
            del self._prefilling[slot]
            if not okf:
                self._quarantine(slot, req, "nonfinite_logits", now)
                continue
            self.active[slot] = True
            # publish the prompt's full pages before _emit can retire the
            # slot (max_new 1 or an immediate EOS unmaps it)
            self.pool.register_prefix(req.prompt, slot)
            self._emit(slot, req, int(tok), now)

    def _decode_block(self) -> tuple[np.ndarray, np.ndarray]:
        """One block of decode steps; returns (K, n_slots) tokens and the
        (K, n_slots) alive mask (False from the step a slot's logits went
        non-finite: its tokens from there on are garbage)."""
        self._dispatch_fault()
        act = self.active.copy()
        remaining = min(req.max_new - len(req.tokens)
                        for slot, req in enumerate(self.sched.slots)
                        if req is not None and act[slot])
        k_steps = min(self.decode_block,
                      1 << (max(remaining, 1).bit_length() - 1))
        # pow2 read width over the deepest slot at block end: shallow
        # traffic does not pay for the provisioned max_len
        width = self._read_width(int(self.cur_len[act].max()) + k_steps)
        poison = None
        if self._poison_slots:
            mask = np.zeros(self.n_slots, bool)
            mask[sorted(self._poison_slots)] = True
            self._poison_slots.clear()
            poison = torch.tensor(mask, device=self.device)
        dev = self.device
        if self._sanitize:
            note_variant("paged_decode_scan", k=k_steps, slots=self.n_slots,
                         width=width, temperature=self.temperature,
                         top_k=self.top_k, w=self._w_sig)
        toks, alive = _decode_scan(
            self.model_cfg, self.params, self.cache,
            torch.tensor(self.last_tok, device=dev),
            torch.tensor(self.cur_len, device=dev),
            torch.tensor(act, device=dev),
            torch.tensor(self.pool.tables[:, :width], dtype=torch.int32,
                         device=dev),
            k_steps=k_steps, page_size=self.spec.page_size,
            temperature=self.temperature, top_k=self.top_k,
            generator=self._gen, poison=poison)
        self.cur_len[act] += k_steps
        self.n_decode_steps += k_steps
        # the block's one host sync
        toks, alive = torch.stack([toks, alive.to(toks.dtype)]).cpu().numpy()
        return toks, alive.astype(bool)

    def _spec_block(self, act: np.ndarray, now: float) -> None:
        """One speculative round over all decoding slots. k adapts to the
        smallest remaining budget (pow2, at most spec_k; 0 is a one-row
        verify, plain decode); each slot emits its accepted prefix plus the
        target's token at the first mismatch."""
        self._dispatch_fault()
        remaining = min(req.max_new - len(req.tokens)
                        for slot, req in enumerate(self.sched.slots)
                        if req is not None and act[slot])
        k_eff = min(self.spec_k, max(remaining - 1, 0))
        if k_eff:
            k_eff = 1 << (k_eff.bit_length() - 1)
        m = k_eff + 1
        width = self._read_width(int(self.cur_len[act].max()) + m)
        if self._sanitize:
            note_variant("spec_block", k=k_eff, slots=self.n_slots,
                         width=width, temperature=self.temperature,
                         top_k=self.top_k, w=self._w_sig, dw=self._dw_sig)
        dev = self.device
        out, n_emit = _spec_round(
            self.model_cfg, self.params, self.draft_params, self.cache,
            self.draft_cache, torch.tensor(self.last_tok, device=dev),
            torch.tensor(self.cur_len, device=dev),
            torch.tensor(act, device=dev),
            torch.tensor(self.pool.tables[:, :width], dtype=torch.int32,
                         device=dev),
            k_steps=k_eff, page_size=self.spec.page_size,
            temperature=self.temperature, top_k=self.top_k,
            generator=self._gen)
        out = out.cpu().numpy()                   # the round's one host sync
        n_emit = n_emit.cpu().numpy()
        act_idx = np.nonzero(act)[0]
        self.n_spec_rounds += 1
        self.n_decode_steps += 1                  # one target forward a round
        self.n_draft_tokens += k_eff * act_idx.size
        for slot in act_idx:
            n = int(n_emit[slot])
            self.spec_accept_sum[slot] += n
            self.spec_round_count[slot] += 1
            self.n_spec_emitted += n
            # the cache holds the old pending token and the accepted drafts;
            # the last emitted token is next round's pending one, and the
            # rejected tail past the new fill is masked
            self.cur_len[slot] += n
            for t in range(n):
                req = self.sched.slots[slot]
                if req is None:                   # retired (EOS or max_new)
                    break
                self._emit(slot, req, int(out[slot, t]), now)

    def spec_stats(self) -> dict:
        """Speculative acceptance: the overall rate, the mean tokens a
        slot-round emits, and the per-slot means."""
        slot_rounds = int(self.spec_round_count.sum())
        accepted = int(self.n_spec_emitted) - slot_rounds
        per_slot = np.where(
            self.spec_round_count > 0,
            self.spec_accept_sum / np.maximum(self.spec_round_count, 1), 0.0)
        return {
            "rounds": int(self.n_spec_rounds),
            "slot_rounds": slot_rounds,
            "draft_tokens": int(self.n_draft_tokens),
            "emitted_tokens": int(self.n_spec_emitted),
            "accepted_draft_tokens": accepted,
            "acceptance_rate": (accepted / self.n_draft_tokens
                                if self.n_draft_tokens else 0.0),
            "mean_accepted_len": (self.n_spec_emitted / slot_rounds
                                  if slot_rounds else 0.0),
            "per_slot_mean_accepted_len": [round(float(x), 4)
                                           for x in per_slot],
        }

    def _emit(self, slot: int, req: Request, tok: int, now: float) -> None:
        if req.first_token_at is None:
            req.first_token_at = now
        req.tokens.append(tok)
        self.last_tok[slot] = tok
        if len(req.tokens) >= req.max_new or tok == self.eos_id:
            self.active[slot] = False
            self.sched.retire(slot, now)
