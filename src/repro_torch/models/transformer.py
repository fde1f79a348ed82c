"""Decoder-only LM (port of ``repro.models.transformer``).

Params keep the JAX package's key paths: "embed", "final_norm",
"lm_head" (untied models only), the unstacked "prefix/0", "prefix/1", ...
blocks of ``cfg.prefix_pattern`` (DeepSeek's dense first layer) and the
scan-stacked "stack/p0" blocks, whose leaves carry a leading layer dim.
The JAX package scans over that dim; here ``_run_stack`` is a Python loop
that runs the prefix blocks, then hands each stacked layer a view of its
params and cache. A pattern may mix attention and mamba layers (Jamba);
each position's cache is its layer kind's: page pools or contiguous KV
for attention, slot-indexed recurrent state for mamba. The caches have the same "prefix" and "stack" subtrees;
a prefix block's cache is a stack of one (leading dim 1), so every pool
leaf has its page axis at 1. Per-layer access for the quantization
pipeline goes through ``num_blocks`` / ``block_spec`` / ``get_block``, in
the JAX package's order: the prefix blocks, then the repeats. A VLM
(InternVL2) takes its stub frontend's patch embeddings as ``ext_embeds``,
prepended to the token embeddings, with positions running over both. An
enc-dec decoder (models/encdec.py) runs the same stack with the encoder's
output for its cross-attention.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.quant.types import QuantizedTensor
from repro_torch.device import resolve_device
from repro_torch.models.blocks import apply_block, init_block, \
    init_block_cache
from repro_torch.models.config import ModelConfig
from repro_torch.models.linear import dense, matmul_f32
from repro_torch.models.norms import apply_norm, init_norm
from repro_torch.serve.kvcache import PageSpec
from repro_torch.utils.tree import tree_index, tree_map


def init_lm(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Seeded float params, drawn from a ``torch.Generator`` on ``device``
    in f32 and cast to ``cfg.pdtype``: N(0, 0.02^2) embeddings (and learned
    position table), N(0, 1/K) linear weights, zero biases, unit norm
    scales and zero norm biases (a MoE router and mamba's A_log, D and
    dt_bias stay f32, as in the JAX package)."""
    cfg.validate()
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def table(rows, cols):
        return {"w": (torch.randn((rows, cols), generator=gen, device=dev)
                      * 0.02).to(cfg.pdtype)}

    params: dict = {"embed": table(cfg.vocab_size, cfg.d_model),
                    "final_norm": init_norm(cfg, cfg.d_model, dev)}
    if cfg.pos_emb == "learned":
        params["pos"] = table(cfg.max_position, cfg.d_model)
    if not cfg.tie_embeddings:
        params["lm_head"] = table(cfg.d_model, cfg.vocab_size)
    if cfg.prefix_pattern:
        params["prefix"] = {str(i): init_block(cfg, spec, gen, dev)
                            for i, spec in enumerate(cfg.prefix_pattern)}
    params["stack"] = {f"p{j}": _init_stacked(cfg, spec, gen, dev)
                       for j, spec in enumerate(cfg.pattern)}
    return params


def _init_stacked(cfg: ModelConfig, spec, gen: torch.Generator,
                  dev) -> dict:
    """``cfg.n_repeats`` blocks drawn in turn, each copied into its layer of
    the stacked leaves as it is drawn: the draws of ``tree_stack`` over a
    list of blocks, at a peak of the stack and one block (a 16-layer
    DeepSeek stack is 35 GB in f32). A stack of one is the block itself
    with a leading dim, no copy (one Jamba MoE block is 38.7 GB)."""
    block = init_block(cfg, spec, gen, dev)
    if cfg.n_repeats == 1:
        return tree_map(lambda t: t.unsqueeze(0), block)
    stacked = tree_map(lambda t: t.new_empty((cfg.n_repeats,) + t.shape),
                       block)
    for r in range(cfg.n_repeats):
        if r:
            block = init_block(cfg, spec, gen, dev)
        tree_map(lambda dst, src: dst[r].copy_(src), stacked, block)
    return stacked


def _caches(cfg: ModelConfig, device, **kw) -> dict:
    """The "prefix" (one stack of one per prefix block) and "stack" cache
    subtrees, each built by ``init_block_cache`` for its position's layer
    kind with ``**kw``."""
    cache = {}
    if cfg.prefix_pattern:
        cache["prefix"] = {str(i): init_block_cache(cfg, spec, device, 1,
                                                    **kw)
                           for i, spec in enumerate(cfg.prefix_pattern)}
    cache["stack"] = {f"p{j}": init_block_cache(cfg, spec, device,
                                                cfg.n_repeats, **kw)
                      for j, spec in enumerate(cfg.pattern)}
    return cache


def init_cache(cfg: ModelConfig, spec: PageSpec, device,
               n_slots: int = 0) -> dict:
    """Page pools for the continuous-batching engine; a mamba layer's
    recurrent state has one row per slot (``n_slots``, which a model with
    mamba layers needs)."""
    if n_slots <= 0 and any(s.kind == "mamba"
                            for s in cfg.all_layer_specs()):
        raise ValueError(f"{cfg.name}: mamba layers keep per-slot state; "
                         f"pass n_slots")
    return _caches(cfg, device, paged=spec, batch=n_slots)


def init_contiguous_cache(cfg: ModelConfig, batch: int, max_len: int,
                          device, enc_len: int = 0) -> dict:
    """Contiguous caches for ``lm_decode`` without pages (the calibration
    generator's and the static engine's; the JAX package's
    ``init_cache(cfg, batch, max_len, enc_len)``); a cross-attention layer
    also gets a cross cache of ``enc_len`` encoder positions."""
    return _caches(cfg, device, batch=batch, max_len=max_len,
                   enc_len=enc_len)


def num_blocks(cfg: ModelConfig) -> int:
    return cfg.n_layers


def block_spec(cfg: ModelConfig, i: int):
    return cfg.all_layer_specs()[i]


def get_block(cfg: ModelConfig, params: dict, i: int) -> dict:
    """Block i's params: a prefix block's own tree, or views into the
    stacked leaves."""
    n_pre = len(cfg.prefix_pattern)
    if i < n_pre:
        return params["prefix"][str(i)]
    r, j = divmod(i - n_pre, len(cfg.pattern))
    return tree_index(params["stack"][f"p{j}"], r)


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
           positions: torch.Tensor,
           ext_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings, after ``ext_embeds`` (B, P, d) where given (a VLM's
    patch embeddings, prepended), plus the learned position table's rows
    at ``positions`` (over the whole sequence) clipped to the table (a
    left pad's -1 reads row 0, as in the JAX package), in ``cfg.adtype``."""
    dt = cfg.adtype
    x = params["embed"]["w"][tokens.to(torch.int64)].to(dt)
    if ext_embeds is not None:
        x = torch.cat([ext_embeds.to(dt), x], dim=1)
    if cfg.pos_emb == "learned":
        idx = positions.to(torch.int64).clamp(0, cfg.max_position - 1)
        x = x + params["pos"]["w"][idx].to(dt)
    return x


# the ops whose outputs "dots" keeps for the backward pass: the JAX
# package's dots_with_no_batch_dims_saveable, the matmuls without a batch
# dim (every linear of a repeat; not the attention core's batched score
# and value products, nor the expert stacks')
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, fn):
    """``fn`` (one repeat of the pattern) under ``torch.utils.checkpoint``
    with the config's policy: "nothing" saves nothing of the repeat, so
    its backward pass recomputes it; "dots" keeps the matmul outputs and
    recomputes the rest (selective activation checkpointing)."""
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)


def _run_stack(cfg: ModelConfig, params: dict, x: torch.Tensor, *,
               positions: torch.Tensor, cache: Optional[dict] = None,
               paged: Optional[dict] = None, decode: bool = False,
               causal: bool = True,
               enc_out: Optional[torch.Tensor] = None, train: bool = False):
    """The prefix blocks, then the pattern repeats in order, layer by
    layer. ``cache`` is updated in place through each layer's view of its
    pools. ``causal`` False runs an encoder; ``enc_out`` is the encoder
    output a decoder's cross-attention reads. ``train`` (the JAX package's
    mode "train": ``lm_forward``, a decoder's teacher-forced pass) runs each
    repeat under the config's remat while autograd records. Returns (x,
    the sum of the blocks' aux losses: a tensor, or 0.0 when no block is
    an MoE)."""
    kw = dict(positions=positions, paged=paged, decode=decode, causal=causal,
              enc_out=enc_out)
    aux_total = 0.0
    for i in range(len(cfg.prefix_pattern)):
        c = (tree_index(cache["prefix"][str(i)], 0)
             if cache is not None else None)
        x, aux = apply_block(cfg, params["prefix"][str(i)], x, cache=c, **kw)
        aux_total = aux_total + aux
    pat = cfg.pattern

    def one_repeat(x, r):
        aux_sum = 0.0
        for j in range(len(pat)):
            p = tree_index(params["stack"][f"p{j}"], r)
            c = (tree_index(cache["stack"][f"p{j}"], r)
                 if cache is not None else None)
            x, aux = apply_block(cfg, p, x, cache=c, **kw)
            aux_sum = aux_sum + aux
        return x, aux_sum

    if train and cfg.remat and torch.is_grad_enabled():
        one_repeat = _remat(cfg, one_repeat)
    for r in range(cfg.n_repeats):
        x, aux = one_repeat(x, r)
        aux_total = aux_total + aux
    return x, aux_total


def _head(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """f32 logits: a tied head sums x's products with the embedding (cast
    to x's dtype) in f32, an untied one is a ``dense`` in x's dtype, then
    upcast (the JAX package's rules); ``logit_softcap`` > 0 caps them
    smoothly at +-c."""
    x = apply_norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        # a plain product outside any kernel, as in the JAX package
        w = params["embed"]["w"].to(x.dtype)
        logits = matmul_f32(x.reshape(-1, x.shape[-1]), w.t()).reshape(
            *x.shape[:-1], w.shape[0])
    else:
        logits = dense(params["lm_head"], x).to(torch.float32)
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _arange_positions(tokens: torch.Tensor,
                      ext_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """Positions 0..S-1 of each row, S counting ``ext_embeds``' rows."""
    b, s = tokens.shape
    s += 0 if ext_embeds is None else ext_embeds.shape[1]
    return torch.arange(s, dtype=torch.int32,
                        device=tokens.device)[None].expand(b, s)


def lm_forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
               ext_embeds: Optional[torch.Tensor] = None):
    """Full-sequence causal forward. tokens (B, S) -> (logits (B, P + S, V)
    f32, the MoE aux loss), P the rows of ``ext_embeds`` (0 without)."""
    positions = _arange_positions(tokens, ext_embeds)
    x = _embed(cfg, params, tokens, positions, ext_embeds)
    x, aux = _run_stack(cfg, params, x, positions=positions, train=True)
    return _head(cfg, params, x), torch.as_tensor(aux, dtype=torch.float32,
                                                  device=x.device)


def lm_prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
               cache: dict, positions: Optional[torch.Tensor] = None,
               paged: Optional[dict] = None,
               ext_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Prompt ingestion into the cache. tokens, positions (B, S), pads left
    with position -1 so the real last token sits at index -1. With page
    pools, paged holds the slots' block-table rows ("bt_rows"), the slots
    themselves ("slots": the rows a mamba layer's state lands in) and, for a
    later chunk or a suffix after shared prefix pages, the fill counts
    after this call ("kv_len"); without ``paged`` the cache is contiguous
    (``init_contiguous_cache``, the static engine's). ``ext_embeds`` (B, P,
    d): a VLM's patch embeddings ahead of the tokens, and ``positions``
    then defaults to 0..P + S - 1. Returns the logits of the last row, the
    chunk's last real token (B, V)."""
    if positions is None:
        positions = _arange_positions(tokens, ext_embeds)
    x = _embed(cfg, params, tokens, positions, ext_embeds)
    x, _ = _run_stack(cfg, params, x, positions=positions, cache=cache,
                      paged=paged)
    return _head(cfg, params, x[:, -1:, :])[:, 0, :]


def lm_verify(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
              cache: dict, positions: torch.Tensor,
              paged: dict) -> torch.Tensor:
    """The speculative verify forward: score M tokens a slot in one pass.
    tokens (B, M) = [the pending token, d_1..d_{M-1}]; positions (B, M),
    -1 for idle slots; paged holds "bt_rows", "kv_len" (the fill counting
    all M tokens) and the "verify" marker. Returns the logits of all M
    rows (B, M, V): row m is the next-token distribution after the prefix
    and tokens[:, :m + 1]."""
    x = _embed(cfg, params, tokens, positions)
    x, _ = _run_stack(cfg, params, x, positions=positions, cache=cache,
                      paged=paged)
    return _head(cfg, params, x)


def lm_decode(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
              cache: dict, positions: torch.Tensor,
              paged: Optional[dict] = None) -> torch.Tensor:
    """One decode step. tokens, positions (B, 1). With page pools, B is the
    slot count and ``paged`` holds the block tables, per-slot write
    targets and fill counts; without ``paged`` the cache is contiguous
    (``init_contiguous_cache``). Returns logits (B, V)."""
    x = _embed(cfg, params, tokens, positions)
    x, _ = _run_stack(cfg, params, x, positions=positions, cache=cache,
                      paged=paged, decode=True)
    return _head(cfg, params, x)[:, 0, :]


def lm_loss(cfg: ModelConfig, params: dict, batch: dict):
    """Next-token cross-entropy plus the MoE aux loss. batch: tokens,
    labels, optional mask and ``ext_embeds`` (a VLM's patch rows, not
    scored). Returns (loss, {"nll", "aux"})."""
    ext = batch.get("ext_embeds")
    logits, aux = lm_forward(cfg, params, batch["tokens"], ext)
    if ext is not None:
        logits = logits[:, ext.shape[1]:]
    return token_loss(logits, batch, aux)


def token_loss(logits: torch.Tensor, batch: dict, aux):
    """Mean next-token cross-entropy of ``logits`` against batch["labels"]
    under the optional batch["mask"], plus ``aux``. Returns (loss, {"nll",
    "aux"})."""
    labels = batch["labels"].to(torch.int64)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = lse - ll
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.to(nll.dtype)
    loss = (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return loss + aux, {"nll": loss, "aux": aux}


def is_quantized(params: dict) -> bool:
    def walk(t):
        if isinstance(t, QuantizedTensor):
            return True
        return isinstance(t, dict) and any(walk(v) for v in t.values())
    return walk(params)
