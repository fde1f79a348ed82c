"""Transformer / Mamba block: attention (GQA or MLA) or a Mamba2 mixer,
then an enc-dec decoder's cross-attention, then a dense MLP, an MoE or
nothing (port of ``repro.models.blocks``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.attention import (apply_attention,
                                          apply_cross_attention,
                                          init_attention, init_cross_cache,
                                          init_kv_cache, init_paged_kv_cache)
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.mamba2 import (apply_mamba, init_mamba,
                                       init_mamba_cache)
from repro_torch.models.mla import (apply_mla, init_mla, init_mla_cache,
                                    init_paged_mla_cache)
from repro_torch.models.mlp_moe import apply_mlp, apply_moe, init_mlp, init_moe
from repro_torch.models.norms import apply_norm, init_norm
from repro_torch.serve.kvcache import PageSpec


def init_block(cfg: ModelConfig, spec: LayerSpec, gen: torch.Generator,
               device) -> dict:
    p = {"ln1": init_norm(cfg, cfg.d_model, device)}
    if spec.kind == "mamba":
        p["mamba"] = init_mamba(cfg, gen, device)
    else:
        attn = init_mla if cfg.attention == "mla" else init_attention
        p["attn"] = attn(cfg, gen, device)
        if spec.cross_attn:
            p["lnx"] = init_norm(cfg, cfg.d_model, device)
            p["xattn"] = init_attention(cfg, gen, device)
    if spec.mlp != "none":
        p["ln2"] = init_norm(cfg, cfg.d_model, device)
    if spec.mlp == "moe":
        p["moe"] = init_moe(cfg, gen, device)
    elif spec.mlp == "dense":
        p["mlp"] = init_mlp(cfg, gen, cfg.d_ff, device)
    return p


def init_block_cache(cfg: ModelConfig, spec: LayerSpec, device,
                     n_layers: int, *, paged: Optional[PageSpec] = None,
                     batch: int = 0, max_len: int = 0,
                     enc_len: int = 0) -> dict:
    """One layer kind's caches for ``n_layers`` stacked blocks: an
    attention layer's page pools with ``paged``, else its contiguous
    caches of (batch, max_len); a mamba layer's recurrent state of
    ``batch`` rows either way (the serving slots with ``paged``: the
    state is slot-indexed, never paged). A decoder layer with
    cross-attention has {"attn": its contiguous cache, "xattn": a cross
    cache of (batch, enc_len)}; it has no paged form."""
    if spec.kind == "mamba":
        return init_mamba_cache(cfg, batch, device, n_layers=n_layers)
    if paged is not None and spec.cross_attn:
        raise NotImplementedError(
            "paged serving does not cover enc-dec cross-attention")
    if spec.cross_attn:
        return {"attn": init_block_cache(
                    cfg, LayerSpec(kind=spec.kind, mlp=spec.mlp), device,
                    n_layers, batch=batch, max_len=max_len),
                "xattn": init_cross_cache(cfg, batch, enc_len, device,
                                          n_layers=n_layers)}
    if paged is not None:
        if cfg.attention == "mla":
            return init_paged_mla_cache(cfg, paged, device, n_layers)
        return init_paged_kv_cache(cfg, paged, device, n_layers)
    if cfg.attention == "mla":
        return init_mla_cache(cfg, batch, max_len, device, n_layers=n_layers)
    return init_kv_cache(cfg, batch, max_len, device, n_layers=n_layers,
                         window=cfg.attn_window)


def _moe_valid(paged: Optional[dict],
               positions: torch.Tensor) -> Optional[torch.Tensor]:
    """Which tokens may compete for expert capacity: paged serving carries
    junk tokens that must not — left-padding in prefill (position -1) and
    idle slots in decode (kv_len 0). Unpaged calls carry none (None)."""
    if paged is None:
        return None
    if "bt_rows" in paged:                                    # prefill
        return positions >= 0
    return (paged["kv_len"] > 0)[:, None]                      # decode


def apply_block(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                positions: torch.Tensor, cache: Optional[dict] = None,
                paged: Optional[dict] = None, decode: bool = False,
                causal: bool = True,
                enc_out: Optional[torch.Tensor] = None,
                taps: Optional[dict] = None, tap_prefix: str = ""):
    """Pre-norm residual block; ``cache`` (this layer's pools or contiguous
    cache) is updated in place. ``taps`` (calibration) receives every
    linear's input under the JAX package's keys ("attn/wq", ...,
    "mlp/wo", "moe/router", "moe/experts", ...). Returns (x, aux): the
    MoE's load-balancing loss, a plain 0.0 for a dense block (no device
    op on the serving path). ``decode`` marks ``lm_decode``'s calls: MLA
    then takes its absorbed form, a mamba mixer its recurrent step (GQA
    reads its cache alike either way). The layer's kind and MLP come from
    its params: "mamba" or "attn", then "moe", "mlp" or neither (no
    "ln2"). A mamba prefill on page pools writes its final state into
    the rows of ``paged["slots"]``.

    ``causal`` False is whisper's encoder (its ``encode``; the JAX
    package's mode "encode"). A block with "xattn" (an enc-dec decoder
    layer) adds a cross-attention sub-layer after self-attention, normed by
    "lnx", its taps under "xattn/": over ``enc_out`` where given (filling
    the cache's "xattn" part at prefill), else over the cache's "xattn"
    (decode); with neither (the tweak's loss, as in the JAX package) it
    attends non-causally over its own normed input."""
    cross_cache = None
    if "xattn" in p and cache is not None:
        cache, cross_cache = cache["attn"], cache["xattn"]
    h = apply_norm(cfg, p["ln1"], x)
    if "mamba" in p:
        x = x + apply_mamba(
            cfg, p["mamba"], h, cache=cache, decode=decode,
            positions=positions,
            slots=None if paged is None else paged.get("slots"),
            taps=taps, tap_prefix=tap_prefix + "mamba/")
    else:
        kw = dict(positions=positions, cache=cache, paged=paged, taps=taps,
                  tap_prefix=tap_prefix + "attn/")
        if cfg.attention == "mla":
            x = x + apply_mla(cfg, p["attn"], h, decode=decode, **kw)
        else:
            x = x + apply_attention(cfg, p["attn"], h, causal=causal, **kw)
    if "xattn" in p:
        x = x + apply_cross_attention(
            cfg, p["xattn"], apply_norm(cfg, p["lnx"], x),
            positions=positions, enc_out=enc_out, cache=cross_cache,
            taps=taps, tap_prefix=tap_prefix + "xattn/")
    if "ln2" not in p:
        return x, 0.0
    h2 = apply_norm(cfg, p["ln2"], x)
    if "moe" in p:
        y, aux = apply_moe(cfg, p["moe"], h2, taps, tap_prefix + "moe/",
                           valid=_moe_valid(paged, positions))
        return x + y, aux
    return x + apply_mlp(cfg, p["mlp"], h2, taps, tap_prefix + "mlp/"), 0.0
