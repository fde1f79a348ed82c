"""Mamba2 (SSD, state-space duality) block: chunk-parallel prefill and the
recurrent decode (port of ``repro.models.mamba2``).

Training and prefill run the chunk-parallel SSD form (arXiv:2405.21060
§6): an intra-chunk quadratic term plus an inter-chunk state recurrence,
here a Python loop over the chunks. Decode is the O(1) recurrence over the
(H, P, N) state. The JAX package computes all of it in plain jnp, outside
any Pallas kernel; so does the port, in plain PyTorch. Only ``in_proj``
and ``out_proj`` go through ``models/linear.py::dense`` (the matmul kernels
when packed).

Params per layer: in_proj -> [z (di), xBC (di + 2*G*N), dt (H)], a
depthwise causal conv over xBC, A_log / D / dt_bias per head, the gated
RMSNorm "gnorm" (a tweakable norm), out_proj.

Caches are slot- (or batch-) indexed, never paged: "state" (B, H, P, N)
f32, "conv" (B, d_conv - 1, conv_dim), the last raw xBC rows, and "len"
(B,). ``apply_mamba`` updates them in place (``copy_`` / index writes), so
a layer's view of a stacked cache writes through to the stacked leaf.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.linear import dense, init_dense
from repro_torch.models.norms import apply_gated_rmsnorm


def _dims(cfg: ModelConfig):
    m = cfg.mamba
    di = m.d_inner(cfg.d_model)
    h = m.n_heads(cfg.d_model)
    conv_dim = di + 2 * m.n_groups * m.d_state
    return m, di, h, conv_dim


def init_mamba(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """Seeded params: N(0, 1/K) projections, N(0, 0.1^2) conv taps, zero
    conv bias and dt_bias, A_log = log(linspace(1, 16, H)), unit D and
    gnorm scale (the JAX package's init)."""
    m, di, h, conv_dim = _dims(cfg)
    d_in_proj = 2 * di + 2 * m.n_groups * m.d_state + h
    f32 = dict(dtype=torch.float32, device=device)
    pd = dict(dtype=cfg.pdtype, device=device)
    return {
        "in_proj": init_dense(gen, cfg.d_model, d_in_proj, device,
                              dtype=cfg.pdtype),
        "conv_w": (torch.randn((m.d_conv, conv_dim), generator=gen,
                               device=device) * 0.1).to(cfg.pdtype),
        "conv_b": torch.zeros((conv_dim,), **pd),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        "D": torch.ones((h,), **f32),
        "dt_bias": torch.zeros((h,), **f32),
        "gnorm": {"scale": torch.ones((di,), **pd)},
        "out_proj": init_dense(gen, di, cfg.d_model, device,
                               dtype=cfg.pdtype),
    }


def init_mamba_cache(cfg: ModelConfig, batch: int, device, *,
                     n_layers: int) -> dict:
    """Recurrent caches for ``n_layers`` stacked mamba blocks of ``batch``
    rows (the serving engine's slots): "state" (L, B, H, P, N) f32,
    "conv" (L, B, d_conv - 1, conv_dim) in ``cfg.adtype``, "len" (L, B)."""
    m, di, h, conv_dim = _dims(cfg)
    lead = (n_layers, batch)
    return {
        "state": torch.zeros(lead + (h, m.head_dim, m.d_state),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (m.d_conv - 1, conv_dim),
                            dtype=cfg.adtype, device=device),
        "len": torch.zeros(lead, dtype=torch.int32, device=device),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    m, di, h, conv_dim = _dims(cfg)
    gn = m.n_groups * m.d_state
    return torch.split(zxbcdt, [di, di + 2 * gn, h], dim=-1)


def _causal_conv(cfg: ModelConfig, p: dict, xbc: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d over (B, L, C), from ``conv_state`` (the
    previous d_conv - 1 raw rows) or zero padding. Returns (silu(y), the
    new conv state: the last d_conv - 1 rows of the padded input)."""
    kk = cfg.mamba.d_conv
    w = p["conv_w"].to(torch.float32)                            # (K, C)
    xf = xbc.to(torch.float32)
    if conv_state is not None:
        xf = torch.cat([conv_state.to(torch.float32), xf], dim=1)
    else:
        xf = F.pad(xf, (0, 0, kk - 1, 0))
    n = xbc.shape[1]
    # y[t] = sum_k w[k] * x[t + k] over the padded sequence
    y = sum(xf[:, i:i + n, :] * w[i] for i in range(kk))
    y = y + p["conv_b"].to(torch.float32)
    new_state = xf[:, -(kk - 1):, :].to(xbc.dtype) if kk > 1 else None
    return F.silu(y).to(xbc.dtype), new_state


def _ssd_chunked(cfg: ModelConfig, x: torch.Tensor, dt: torch.Tensor,
                 a: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor):
    """Chunk-parallel SSD from a zero state.

    x (B, L, H, P) head inputs; dt (B, L, H) post-softplus; a (H,)
    negative; bm, cm (B, L, G, N). Returns (y (B, L, H, P), the final
    state (B, H, P, N) f32)."""
    b, l0, h, pdim = x.shape
    g, n = bm.shape[2], bm.shape[3]
    q = min(cfg.mamba.chunk, l0)
    pad = (-l0) % q
    if pad:  # zero pads: dt 0 -> decay 1, x 0 -> no state contribution
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, 0, 0, pad))
    nc = (l0 + pad) // q
    rep = h // g

    xc = x.reshape(b, nc, q, h, pdim).to(torch.float32)
    dtc = dt.reshape(b, nc, q, h).to(torch.float32)
    bc = bm.reshape(b, nc, q, g, n).repeat_interleave(rep, dim=3).to(
        torch.float32)
    cc = cm.reshape(b, nc, q, g, n).repeat_interleave(rep, dim=3).to(
        torch.float32)

    cs = torch.cumsum(dtc * a, dim=2)                            # (B,nc,Q,H)
    xdt = xc * dtc[..., None]                                    # (B,nc,Q,H,P)

    # intra-chunk: att[q, t] = exp(cs_q - cs_t) for t <= q. The mask goes
    # in before exp: the upper triangle's cs_q - cs_t is large and
    # positive, and exp-then-mask would give inf * 0 = NaN (in the
    # tweak's backward too)
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]            # (B,nc,Q,T,H)
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    seg = seg.masked_fill(~tri[None, None, :, :, None], -math.inf)
    att = torch.exp(seg) * torch.einsum("bcqhn,bcthn->bcqth", cc, bc)
    y_diag = torch.einsum("bcqth,bcthp->bcqhp", att, xdt)

    # per-chunk end states: S_c = sum_t exp(cs_last - cs_t) B_t x_t dt_t
    decay = torch.exp(cs[:, :, -1:, :] - cs)                     # (B,nc,Q,H)
    states = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", decay, bc, xdt)
    chunk_decay = torch.exp(cs[:, :, -1, :])                     # (B,nc,H)

    # inter-chunk recurrence; s_befores[c] is the state entering chunk c
    s = torch.zeros((b, h, pdim, n), dtype=torch.float32, device=x.device)
    befores = []
    for c in range(nc):
        befores.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    s_befores = torch.stack(befores, dim=1)                      # (B,nc,H,P,N)

    # y_off[q] = exp(cs_q) * C_q . S_before
    y_off = torch.einsum("bcqh,bcqhn,bchpn->bcqhp", torch.exp(cs), cc,
                         s_befores)
    y = (y_diag + y_off).reshape(b, nc * q, h, pdim)[:, :l0]
    return y.to(x.dtype), s


def apply_mamba(cfg: ModelConfig, p: dict, u: torch.Tensor, *,
                cache: Optional[dict] = None, decode: bool = False,
                positions: Optional[torch.Tensor] = None,
                slots: Optional[torch.Tensor] = None,
                taps: Optional[dict] = None,
                tap_prefix: str = "") -> torch.Tensor:
    """u (B, L, d_model) -> (B, L, d_model); ``cache`` is updated in place.

    Four paths: ``decode`` (L 1) steps every row's recurrence (idle
    serving slots included, as in the JAX package: admission's
    slot-prefill overwrites the row); a prefill with ``slots`` (B,)
    starts each request fresh (zero conv padding, zero state) and writes
    its final state, conv tail and real length into those rows of an
    (n_slots, ...) cache; a prefill without ``slots`` continues the
    batch's conv and replaces its state (the contiguous cache); with no
    cache, the forward. ``positions`` < 0 marks left pads: their xBC and
    dt are zeroed before the conv, so they neither move the state nor leak
    through the conv window, and a left-padded prompt yields the state of
    the unpadded one."""
    m, di, h, conv_dim = _dims(cfg)
    b, l, _ = u.shape
    g, n, pdim = m.n_groups, m.d_state, m.head_dim

    if taps is not None:
        taps[tap_prefix + "in_proj"] = u
    z, xbc, dt = _split_proj(cfg, dense(p["in_proj"], u))
    a = -torch.exp(p["A_log"])                                   # (H,)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])         # (B,L,H)
    if positions is not None and not decode:
        valid = (positions >= 0)[..., None]
        xbc = xbc * valid.to(xbc.dtype)
        dt = dt * valid.to(dt.dtype)

    if decode:
        if cache is None or l != 1:
            raise ValueError("mamba decode takes one token and a cache")
        # the conv's window: the d_conv - 1 cached raw rows, then this one
        window = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)],
                           dim=1)                                # (B,K,C)
        # the conv in f32, its silu rounded to xBC's dtype (``_causal_conv``)
        xbc_f = F.silu((window.to(torch.float32)
                        * p["conv_w"].to(torch.float32)).sum(dim=1)
                       + p["conv_b"].to(torch.float32)).to(xbc.dtype)
        x, bm, cm = torch.split(xbc_f, [di, g * n, g * n], dim=-1)
        # heads by group, (B, G, H/G, ...): a group's B and C broadcast
        # over its heads
        hg = h // g
        xg = x.reshape(b, g, hg, pdim)
        dtg = dt.reshape(b, g, hg)
        dec = torch.exp(dtg * a.reshape(g, hg))
        s = (cache["state"].reshape(b, g, hg, pdim, n) * dec[..., None, None]
             + (dtg[..., None] * xg)[..., None] * bm.reshape(b, g, 1, 1, n))
        y = ((s * cm.reshape(b, g, 1, 1, n)).sum(dim=-1)
             + p["D"].reshape(g, hg, 1) * xg)
        y = y.reshape(b, 1, di).to(u.dtype)
        cache["conv"].copy_(window[:, 1:])
        cache["state"].copy_(s.reshape(b, h, pdim, n))
        cache["len"].add_(1)
    else:
        fresh = slots is not None
        conv_state = (cache["conv"] if cache is not None and not fresh
                      else None)
        xbc_f, conv_tail = _causal_conv(cfg, p, xbc, conv_state)
        x, bm, cm = torch.split(xbc_f, [di, g * n, g * n], dim=-1)
        xh = x.reshape(b, l, h, pdim)
        y, final_state = _ssd_chunked(cfg, xh, dt, a, bm.reshape(b, l, g, n),
                                      cm.reshape(b, l, g, n))
        y = y + p["D"][:, None] * xh.to(torch.float32)
        y = y.reshape(b, l, di).to(u.dtype)
        if cache is not None and fresh:
            idx = slots.to(torch.int64)
            n_real = ((positions >= 0).sum(dim=1).to(torch.int32)
                      if positions is not None
                      else torch.full((b,), l, dtype=torch.int32,
                                      device=u.device))
            cache["state"][idx] = final_state
            cache["conv"][idx] = conv_tail.to(cache["conv"].dtype)
            cache["len"][idx] = n_real
        elif cache is not None:
            cache["state"].copy_(final_state)
            cache["conv"].copy_(conv_tail)
            cache["len"].add_(l)

    y = apply_gated_rmsnorm(cfg, p["gnorm"], y, z)
    if taps is not None:
        taps[tap_prefix + "out_proj"] = y
    return dense(p["out_proj"], y)
