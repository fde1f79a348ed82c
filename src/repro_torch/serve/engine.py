"""Continuous-batching serving engine (port of ``repro.serve.engine``'s
``ContinuousEngine`` core).

Requests are admitted FIFO into a fixed pool of slots backed by a paged KV
cache; each ``step()``:

  1. admits queued requests into free slots while the page pool covers
     their whole budget (serve/scheduler.py);
  2. prefills every newly admitted prompt: prompts are left-padded (pad
     positions -1, routed to the scratch page and masked everywhere) to a
     multiple of ``prefill_bucket`` and batched per bucket in power-of-two
     batches of at most ``prefill_batch``; each samples its first token
     and joins the decode set;
  3. runs one block of K decode steps over all slots with sampling on the
     device and one host sync per block. K adapts to the smallest
     remaining budget (power of two, at most ``decode_block``) so slots
     retire at a block boundary.

Weights may be float or packed (``quant_bits`` packs a float tree through
``quantize_params_for_serving``; ``act_bits=8`` tags it for int8
activations). On the card every quantized linear runs a CUDA matmul
kernel — the dequant matmul, or the W8A8 matmul for A8 weights, and
their expert-batched forms for MoE experts — and every decode attention
read the CUDA paged-attention kernel; with ``device="cpu"`` they run
their plain versions. An MoE's capacity is cross-token: a prefill batch
routes its padded tokens' count, so with ``prefill_batch`` > 1 which
tokens are dropped depends on the co-batched prompts. Prefix sharing, chunked prefill, tensor parallelism, speculative
decoding, preemption, fault injection and snapshots come in later slices
and are not accepted here.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.quant.deploy import (quantize_params_for_serving,
                                           to_device)
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (init_cache, is_quantized,
                                            lm_decode, lm_prefill)
from repro_torch.serve.kvcache import PagePool, PageSpec, default_page_spec
from repro_torch.serve.sampling import sample
from repro_torch.serve.scheduler import Request, Scheduler


def _decode_scan(cfg: ModelConfig, params: dict, cache: dict,
                 last_tok: torch.Tensor, cur_len: torch.Tensor,
                 active: torch.Tensor, block_table: torch.Tensor, *,
                 k_steps: int, page_size: int, temperature: float,
                 top_k: int, generator: torch.Generator) -> torch.Tensor:
    """K decode steps over all slots, sampling on the device; no host sync
    inside. Each step writes the new token's K/V first, then reads with
    kv_len = fill + 1. Inactive slots write to the scratch page and read
    kv_len 0. Returns the (K, S) sampled tokens on the device."""
    n_slots, max_pages = block_table.shape
    sl = torch.arange(n_slots, device=block_table.device)
    tok, clen = last_tok, cur_len
    out = []
    for _ in range(k_steps):
        page_idx = (clen // page_size).clamp(0, max_pages - 1).to(torch.int64)
        paged = {
            "block_table": block_table,
            "write_page": torch.where(
                active, block_table[sl, page_idx].clamp_min(0), 0),
            "write_off": torch.where(active, clen % page_size, 0),
            "kv_len": torch.where(active, clen + 1, 0),
        }
        pos = torch.where(active, clen, 0)[:, None]
        logits = lm_decode(cfg, params, tok[:, None], cache, pos, paged)
        nxt = sample(logits, temperature=temperature, top_k=top_k,
                     generator=generator)
        tok = torch.where(active, nxt, tok)
        clen = clen + active.to(clen.dtype)
        out.append(nxt)
    return torch.stack(out)


class ContinuousEngine:
    """Slot-stepping execution core for continuous batching.

    Holds the paged cache, the per-slot host state (fill depth, last token)
    and the prefill/decode steps; admission and request bookkeeping live in
    serve/scheduler.py. ``prefill_bucket`` trades the number of distinct
    prefill shapes against pad waste (bucket 1 pads nothing);
    ``decode_block`` trades admission latency against per-block host
    syncs."""

    def __init__(self, cfg: ModelConfig, params: dict, *, n_slots: int = 8,
                 max_len: int = 512, page_size: int = 16,
                 n_pages: Optional[int] = None, eos_id: int = -1,
                 prefill_bucket: int = 16, prefill_batch: int = 8,
                 decode_block: int = 8, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0, quant_bits: int = 0,
                 quant_group: int = 0, act_bits: int = 0, device="cuda"):
        cfg.validate()
        self.device = resolve_device(device)
        self.cfg = cfg
        if quant_bits:
            if is_quantized(params):
                raise ValueError("params already hold packed weights; pass "
                                 "quant_bits=0")
            self.params = quantize_params_for_serving(
                cfg, params, bits=quant_bits, group_size=quant_group,
                act_bits=act_bits, device=self.device)
        elif act_bits:
            raise ValueError("act_bits needs quant_bits (the A8 tag lives on "
                             "packed weights)")
        else:
            self.params = to_device(params, self.device)
        self.n_slots = n_slots
        self.eos_id = eos_id
        self.prefill_bucket = max(1, prefill_bucket)
        self.prefill_batch = max(1, prefill_batch)
        self.decode_block = max(1, decode_block)
        self.temperature = temperature
        self.top_k = top_k
        if n_pages is None:
            self.spec = default_page_spec(n_slots, max_len, page_size)
        else:
            self.spec = PageSpec(n_pages=n_pages, page_size=page_size,
                                 max_pages=-(-max_len // page_size))
        self.pool = PagePool(self.spec, n_slots)
        self.sched = Scheduler(n_slots, self.pool)
        self.cache = init_cache(cfg, self.spec, self.device)
        # host mirrors are int32, the dtype the device steps consume
        self.cur_len = np.zeros(n_slots, np.int32)   # tokens in cache
        self.last_tok = np.zeros(n_slots, np.int32)  # next token to feed
        self.active = np.zeros(n_slots, bool)
        self._prefilling: dict[int, Request] = {}
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._next_rid = 0
        self.t = 0                   # virtual clock (scheduler steps)
        self.n_decode_steps = 0
        self.n_prefills = 0
        self.n_prefill_tokens = 0

    # ------------------------------------------------------------- intake
    def submit(self, prompt, *, max_new: int = 32, arrival: float = 0.0,
               priority: int = 0,
               deadline: Optional[float] = None) -> Request:
        """Queue a request. ``priority`` labels its SLO class for the
        traffic report; admission stays FIFO. Deadlines come with the
        overload slice and are refused."""
        if deadline is not None:
            raise NotImplementedError("request deadlines are not ported yet")
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
                      arrival=arrival, priority=priority)
        self._next_rid += 1
        self.sched.submit(req)
        return req

    # ------------------------------------------------------------ serving
    @torch.no_grad()
    def step(self, now: float = 0.0) -> bool:
        """One scheduler tick: admit, prefill the admitted prompts, then one
        block of decode steps. Returns False when there was nothing to do."""
        did = False
        for slot, req in self.sched.admit(now):
            self.cur_len[slot] = 0
            self._prefilling[slot] = req
        if self._prefilling:
            did = True
            self._prefill_tick(now)
        act = np.nonzero(self.active)[0]
        if act.size:
            did = True
            toks = self._decode_block()                       # (K, n_slots)
            for t in range(toks.shape[0]):
                for slot in act:
                    req = self.sched.slots[slot]
                    if req is None:                           # retired
                        continue
                    self._emit(slot, req, int(toks[t, slot]), now)
        return did

    def run(self, *, clock=None, max_steps: Optional[int] = None):
        """Drain every submitted request; returns the requests that finished
        during this call, in submit order.

        ``clock``: callable giving the current time for arrival gating and
        latency stamps; default is the virtual step counter ``self.t``, so
        ``arrival`` is then measured in scheduler steps."""
        import time as _time

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
                _time.sleep(1e-3)
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
        """Prefill every admitted prompt, batched per length bucket in pow2
        batch sizes (bounding the distinct prefill shapes)."""
        groups: dict[int, list] = {}
        for slot in sorted(self._prefilling):
            req = self._prefilling[slot]
            groups.setdefault(self._bucket(req.n_prompt), []).append(
                (slot, req))
        for padded, items in sorted(groups.items()):
            i = 0
            while i < len(items):
                size = min(1 << ((len(items) - i).bit_length() - 1),
                           self.prefill_batch)
                self._prefill_chunk(items[i:i + size], padded, now)
                i += size

    def _prefill_chunk(self, items: Sequence[tuple], padded: int,
                       now: float) -> None:
        """Prefill one same-bucket batch of (slot, req); each row samples
        its first token and joins the decode set."""
        batch = len(items)
        toks = np.zeros((batch, padded), np.int32)
        pos = np.full((batch, padded), -1, np.int32)
        for row, (slot, req) in enumerate(items):
            n = req.n_prompt
            toks[row, padded - n:] = req.prompt
            pos[row, padded - n:] = np.arange(n, dtype=np.int32)
        slots = [slot for slot, _ in items]
        dev = self.device
        paged = {"bt_rows": torch.tensor(self.pool.tables[slots],
                                         dtype=torch.int32, device=dev)}
        logits = lm_prefill(self.cfg, self.params,
                            torch.tensor(toks, device=dev), self.cache,
                            torch.tensor(pos, device=dev), paged)
        first = sample(logits, temperature=self.temperature,
                       top_k=self.top_k, generator=self._gen).cpu().numpy()
        self.n_prefills += 1
        self.n_prefill_tokens += sum(req.n_prompt for _, req in items)
        for row, (slot, req) in enumerate(items):
            self.cur_len[slot] = req.n_prompt
            del self._prefilling[slot]
            self.active[slot] = True
            self._emit(slot, req, int(first[row]), now)

    def _decode_block(self) -> np.ndarray:
        """One block of decode steps; returns (K, n_slots) tokens."""
        act = self.active.copy()
        remaining = min(req.max_new - len(req.tokens)
                        for slot, req in enumerate(self.sched.slots)
                        if req is not None and act[slot])
        k_steps = min(self.decode_block,
                      1 << (max(remaining, 1).bit_length() - 1))
        # pow2 read width over the deepest slot at block end: shallow
        # traffic does not pay for the provisioned max_len
        width = self._read_width(int(self.cur_len[act].max()) + k_steps)
        dev = self.device
        toks = _decode_scan(
            self.cfg, self.params, self.cache,
            torch.tensor(self.last_tok, device=dev),
            torch.tensor(self.cur_len, device=dev),
            torch.tensor(act, device=dev),
            torch.tensor(self.pool.tables[:, :width], dtype=torch.int32,
                         device=dev),
            k_steps=k_steps, page_size=self.spec.page_size,
            temperature=self.temperature, top_k=self.top_k,
            generator=self._gen)
        self.cur_len[act] += k_steps
        self.n_decode_steps += k_steps
        return toks.cpu().numpy()                 # the block's one host sync

    def _emit(self, slot: int, req: Request, tok: int, now: float) -> None:
        if req.first_token_at is None:
            req.first_token_at = now
        req.tokens.append(tok)
        self.last_tok[slot] = tok
        if len(req.tokens) >= req.max_new or tok == self.eos_id:
            self.active[slot] = False
            self.sched.retire(slot, now)
