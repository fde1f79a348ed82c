"""Expert-parallel MoE dispatch over ``all_to_all`` (port of
``repro.models.moe_shardmap``).

The JAX package writes this under ``shard_map``; the port runs one process
per rank, and this function is what each rank of the "model" axis runs:

  * the rank holds its data shard's tokens, the same on every model rank,
    and dispatches a distinct 1/M slice of them (M model ranks);
  * each expert's slots go through ``all_to_all`` to the rank that owns
    the expert (E % M == 0, E/M experts a rank);
  * the expert FFNs run on the rank's own experts;
  * a reverse ``all_to_all``, the local combine and an ``all_gather``
    rebuild the token-major output on every model rank.

Capacity comes from the slice (``moe_capacity`` of its T/M tokens), the
load-balancing aux loss is the ranks' mean, and shared experts (DeepSeek)
run on the whole local batch. ``apply_moe`` takes this path under its
rule (``moe_impl="shard_map"``, float experts, E % M == 0, tokens
divisible by M), which is the JAX package's rule as it stands.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.models.config import ModelConfig

# dispatches through this path in this process (the card phase asserts
# that the expert-parallel path ran); reset by assigning 0
dispatches = 0


def _positions_in_expert(flat_idx: torch.Tensor, e: int) -> torch.Tensor:
    """Each entry's rank among the entries routed to its expert, in token
    order (a stable sort by expert)."""
    order = torch.argsort(flat_idx, stable=True)
    sorted_e = flat_idx[order]
    starts = torch.searchsorted(sorted_e,
                                torch.arange(e, device=flat_idx.device))
    pos_sorted = (torch.arange(flat_idx.shape[0], device=flat_idx.device)
                  - starts[sorted_e])
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    return pos


def _local_experts(w: torch.Tensor, e: int, e_loc: int,
                   rank: int) -> torch.Tensor:
    """The rank's E/M experts of an expert stack: the stack itself when it
    is already the rank's shard, else its slice (a view)."""
    if w.shape[0] == e_loc:
        return w
    if w.shape[0] != e:
        raise ValueError(f"expert stack of {w.shape[0]} experts is neither "
                         f"the {e} experts nor a rank's {e_loc}")
    return w[rank * e_loc:(rank + 1) * e_loc]


def moe_ep_shardmap(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    axis: str = "model"):
    """x: (B, S, d), this rank's data shard (the same on every rank of
    ``axis``). ``p["experts"]`` holds all E experts or the rank's E/M.
    Returns (y (B, S, d), aux scalar), the same on every rank of
    ``axis``."""
    global dispatches
    m = cfg.moe
    e, k = m.n_experts, m.top_k
    b, s, d = x.shape
    msize = coll.axis_size(axis)
    rank = coll.axis_index(axis)
    e_loc = e // msize
    t_loc = b * s
    if t_loc % msize:
        raise ValueError(f"{t_loc} tokens do not split over {msize} ranks")
    t_r = t_loc // msize
    xf = x.reshape(t_loc, d)
    xr = xf[rank * t_r:(rank + 1) * t_r]

    logits = torch.matmul(xr.to(torch.float32),
                          p["router"]["w"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)

    from repro_torch.models.mlp_moe import apply_mlp, moe_capacity, silu
    cap = moe_capacity(cfg, t_r)
    flat_idx = idx.reshape(t_r * k)
    pos = _positions_in_expert(flat_idx, e)
    keep = pos < cap
    safe_e = torch.where(keep, flat_idx, e)
    safe_pos = torch.where(keep, pos, 0)
    xk = xr.repeat_interleave(k, dim=0)
    buf = torch.zeros((e + 1, cap, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((safe_e, safe_pos), xk, accumulate=True)[:e]

    # expert e's slots to the rank owning e: (E, cap, d) -> from each
    # source rank its (E/M, cap, d), concatenated along the slots in
    # source-rank order: (E/M, M * cap, d)
    recv = coll.all_to_all(buf, axis).reshape(msize, e_loc, cap, d)
    recv = recv.transpose(0, 1).reshape(e_loc, msize * cap, d)

    wi, wg, wo = (_local_experts(p["experts"][n]["w"], e, e_loc, rank)
                  for n in ("wi", "wg", "wo"))
    h = (silu(torch.matmul(recv, wg.to(torch.float32)))
         * torch.matmul(recv, wi.to(torch.float32)))
    out = torch.matmul(h, wo.to(torch.float32))      # (E/M, M * cap, d)

    # the results back to their source ranks: each rank's cap slots of
    # every local expert, then every rank's experts in rank order
    out = out.reshape(e_loc, msize, cap, d).transpose(0, 1)
    out = coll.all_to_all(out, axis).reshape(e, cap, d)

    gathered = out[safe_e.clamp_max(e - 1), safe_pos]
    live = (keep & (safe_e < e)).to(x.dtype)
    gathered = gathered * live[:, None] * gate.reshape(t_r * k, 1).to(
        x.dtype)
    y_r = gathered.reshape(t_r, k, d).sum(dim=1)
    # every model rank's slice: the whole local token set again
    y = coll.all_gather(y_r, axis).reshape(b, s, d)

    # load-balance aux (the slice's estimate, averaged over model ranks)
    me = probs.mean(dim=0)
    counts = torch.bincount(flat_idx, minlength=e).to(torch.float32)
    aux = m.router_aux_weight * e * torch.sum(me * counts / t_r)
    aux = coll.all_reduce(aux, axis, op="mean")
    dispatches += 1

    if "shared" in p:
        y = y + apply_mlp(cfg, p["shared"], x)
    return y, aux
