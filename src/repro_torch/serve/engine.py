"""Continuous-batching serving engine (port of ``repro.serve.engine``'s
``ContinuousEngine`` core).

Requests are admitted FIFO into a fixed pool of slots backed by a paged KV
cache; each ``step()``:

  1. admits queued requests into free slots while the page pool covers
     their whole budget, less the pages of a prefix-cache hit
     (serve/scheduler.py);
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
     retire at a block boundary. With ``spec_decode`` the block is one
     speculative round instead: a W2/W3 draft packed from the same float
     params proposes up to ``spec_k`` tokens a slot, the target scores
     them in one (S, k + 1)-row verify forward, and each slot emits its
     accepted prefix plus one target token. Greedy output is the
     target-only stream.

Weights may be float or packed (``quant_bits`` packs a float tree through
``quantize_params_for_serving``; ``act_bits=8`` tags it for int8
activations). On the card every quantized linear runs a CUDA matmul
kernel — the dequant matmul, or the W8A8 matmul for A8 weights, and
their expert-batched forms for MoE experts — and every paged attention
read (decode, later chunks, verify) the CUDA paged-attention kernel; with
``device="cpu"`` they run their plain versions. There is no fallback from
a kernel to another read: a kernel that fails raises. An MoE's capacity
is cross-token: a prefill batch routes its padded tokens' count, so with
``prefill_batch`` > 1 which tokens are dropped depends on the co-batched
prompts. Tensor parallelism, preemption, fault injection and snapshots
come in later slices and are not accepted here.
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
                                            lm_decode, lm_prefill, lm_verify)
from repro_torch.serve.kvcache import PagePool, PageSpec, default_page_spec
from repro_torch.serve.sampling import (sample, spec_accept_greedy,
                                        spec_accept_sample)
from repro_torch.serve.scheduler import Request, Scheduler


def _decode_scan(cfg: ModelConfig, params: dict, cache: dict,
                 last_tok: torch.Tensor, cur_len: torch.Tensor,
                 active: torch.Tensor, block_table: torch.Tensor, *,
                 k_steps: int, page_size: int, temperature: float,
                 top_k: int, generator: torch.Generator,
                 with_logits: bool = False):
    """K decode steps over all slots, sampling on the device; no host sync
    inside. Each step writes the new token's K/V first, then reads with
    kv_len = fill + 1. Inactive slots write to the scratch page and read
    kv_len 0. Returns the (K, S) sampled tokens on the device, and with
    ``with_logits`` also the (K, S, V) logits they were sampled from (the
    speculative draft's, for the sampled acceptance rule)."""
    n_slots, max_pages = block_table.shape
    sl = torch.arange(n_slots, device=block_table.device)
    tok, clen = last_tok, cur_len
    out, out_logits = [], []
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
        if with_logits:
            out_logits.append(logits)
    if with_logits:
        return torch.stack(out), torch.stack(out_logits)
    return torch.stack(out)


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
    draft_toks, draft_logits = draft if sampled else (draft, None)
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
    tables, and every prefill chunk is mirrored into it."""

    def __init__(self, cfg: ModelConfig, params: dict, *, n_slots: int = 8,
                 max_len: int = 512, page_size: int = 16,
                 n_pages: Optional[int] = None, eos_id: int = -1,
                 prefill_bucket: int = 16, prefill_batch: int = 8,
                 decode_block: int = 8, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0, quant_bits: int = 0,
                 quant_group: int = 0, act_bits: int = 0,
                 prefix_share: bool = False, chunked_prefill: int = 0,
                 spec_decode: bool = False, draft_bits: int = 2,
                 spec_k: int = 4, device="cuda"):
        cfg.validate()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.spec_decode = bool(spec_decode)
        self.spec_k = spec_k
        self.draft_bits = draft_bits
        if self.spec_decode:
            if any(s.mlp == "moe" for s in cfg.all_layer_specs()):
                # capacity routing is cross-token: an (S, M) verify batch
                # may route otherwise than M one-token decode steps
                raise NotImplementedError(
                    "spec_decode does not cover capacity-routed MoE")
            if prefix_share:
                raise NotImplementedError(
                    "spec_decode is unshared for now (no prefix_share)")
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
        if self.spec_decode:
            # the same params requantized harder, packed sub-byte
            self.draft_params = quantize_params_for_serving(
                cfg, params, bits=draft_bits, group_size=quant_group,
                device=self.device)
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
                               prefix_share=self.prefix_share)
        self.cache = init_cache(cfg, self.spec, self.device)
        if self.spec_decode:
            self.draft_cache = init_cache(cfg, self.spec, self.device)
        # host mirrors are int32, the dtype the device steps consume
        self.cur_len = np.zeros(n_slots, np.int32)   # tokens in cache
        self.last_tok = np.zeros(n_slots, np.int32)  # next token to feed
        self.active = np.zeros(n_slots, bool)
        self._prefilling: dict[int, Request] = {}    # slot -> mid-prompt
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._next_rid = 0
        self.t = 0                   # virtual clock (scheduler steps)
        self.n_decode_steps = 0
        self.n_prefills = 0
        self.n_prefill_tokens = 0    # prompt tokens actually prefilled
        self.n_shared_tokens = 0     # prompt tokens from the prefix cache
        # speculative acceptance accounting (spec_stats)
        self.n_spec_rounds = 0       # draft + verify rounds
        self.n_draft_tokens = 0      # proposals over active slots
        self.n_spec_emitted = 0      # tokens emitted by rounds
        self.spec_accept_sum = np.zeros(n_slots, np.int64)   # per-slot emits
        self.spec_round_count = np.zeros(n_slots, np.int64)  # per-slot rounds

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
        """One scheduler tick: admit, advance every mid-prefill slot by one
        chunk, then one block of decode steps (or one speculative round).
        Returns False when there was nothing to do."""
        did = False
        for slot, req in self.sched.admit(now):
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
        the decode set."""
        batch = len(items)
        toks = np.zeros((batch, padded), np.int32)
        pos = np.full((batch, padded), -1, np.int32)
        for row, (slot, req, start, end) in enumerate(items):
            n = end - start
            toks[row, padded - n:] = req.prompt[start:end]
            pos[row, padded - n:] = np.arange(start, end, dtype=np.int32)
        slots = [slot for slot, _, _, _ in items]
        dev = self.device
        if has_ctx:
            # the pow2 read width over the deepest chunk end: the walk
            # scales with the fill, not the provisioned max_len
            kv_end = [end for _, _, _, end in items]
            width = self._read_width(max(kv_end))
            paged = {"bt_rows": torch.tensor(self.pool.tables[slots, :width],
                                             dtype=torch.int32, device=dev),
                     "kv_len": torch.tensor(kv_end, dtype=torch.int32,
                                            device=dev)}
        else:
            paged = {"bt_rows": torch.tensor(self.pool.tables[slots],
                                             dtype=torch.int32, device=dev)}
        toks_d = torch.tensor(toks, device=dev)
        pos_d = torch.tensor(pos, device=dev)
        logits = lm_prefill(self.cfg, self.params, toks_d, self.cache, pos_d,
                            paged)
        if self.spec_decode:
            # the draft cache takes the same chunk, so draft decode starts
            # from the same fill (the first token is the target's)
            lm_prefill(self.cfg, self.draft_params, toks_d, self.draft_cache,
                       pos_d, paged)
        self.n_prefills += 1
        self.n_prefill_tokens += sum(end - start for _, _, start, end in items)
        finish = []
        for row, (slot, req, start, end) in enumerate(items):
            self.cur_len[slot] = end
            if end >= req.n_prompt:
                finish.append(row)
        if not finish:
            return
        first = sample(logits[finish], temperature=self.temperature,
                       top_k=self.top_k, generator=self._gen).cpu().numpy()
        for tok, row in zip(first, finish):
            slot, req, _, _ = items[row]
            del self._prefilling[slot]
            self.active[slot] = True
            # publish the prompt's full pages before _emit can retire the
            # slot (max_new 1 or an immediate EOS unmaps it)
            self.pool.register_prefix(req.prompt, slot)
            self._emit(slot, req, int(tok), now)

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

    def _spec_block(self, act: np.ndarray, now: float) -> None:
        """One speculative round over all decoding slots. k adapts to the
        smallest remaining budget (pow2, at most spec_k; 0 is a one-row
        verify, plain decode); each slot emits its accepted prefix plus the
        target's token at the first mismatch."""
        remaining = min(req.max_new - len(req.tokens)
                        for slot, req in enumerate(self.sched.slots)
                        if req is not None and act[slot])
        k_eff = min(self.spec_k, max(remaining - 1, 0))
        if k_eff:
            k_eff = 1 << (k_eff.bit_length() - 1)
        m = k_eff + 1
        width = self._read_width(int(self.cur_len[act].max()) + m)
        dev = self.device
        out, n_emit = _spec_round(
            self.cfg, self.params, self.draft_params, self.cache,
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
