"""Parameter partitioning (port of ``repro.distributed.partitioning``):
every param leaf gets logical axis names by its path, then a
``ShardSpec`` through the rules table; ``local_shard`` cuts a rank's
shard out of a whole tree by those specs.

Stacked (scan) leaves keep their leading layer dim whole. A
``QuantizedTensor``'s qw and scale inherit the weight's output-dim split,
and its K split only jointly (see ``_qt_serve_spec``). The tables, rules
and guards are the JAX package's; this module also carries what the port
needs because it runs one process per rank: ``local_shard`` (the JAX
package places a whole tree with ``device_put`` instead).
"""
from __future__ import annotations

import re

import torch

from repro_torch.core.quant.types import QuantizedTensor, pack_layout
from repro_torch.distributed.sharding import (DEFAULT_RULES, TP_AXIS,
                                              ShardSpec, _axis_size,
                                              _flat, spec_for)
from repro_torch.models.config import ModelConfig

# (path regex, logical names per trailing dim). First match wins. Names are
# for the *unstacked* leaf; a leading scan/repeats dim is padded with None.
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed/w$", ("vocab", "embed")),
    (r"pos/w$", ("pos", "embed")),
    (r"lm_head/w$", ("embed_fsdp", "vocab")),
    # attention
    (r"attn/wq/w$", ("embed_fsdp", "heads_flat")),
    (r"attn/wk/w$", ("embed_fsdp", "kv_flat")),
    (r"attn/wv/w$", ("embed_fsdp", "kv_flat")),
    (r"attn/wo/w$", ("heads_flat", "embed_fsdp")),
    (r"attn/wq/b$", ("heads_flat",)),
    (r"attn/w[kv]/b$", ("kv_flat",)),
    (r"attn/wo/b$", ("embed",)),
    # MLA
    (r"attn/wdkv/w$", ("embed_fsdp", "kv_lora")),
    (r"attn/wukv/w$", ("kv_lora", "heads_flat")),
    # MoE: "expert"/"expert_ff" resolve to EP or expert-TP per config
    (r"moe/router/w$", ("embed", None)),
    (r"moe/experts/w[ig]/w$", ("expert", "embed_fsdp", "expert_ff")),
    (r"moe/experts/wo/w$", ("expert", "expert_ff", "embed_fsdp")),
    (r"(moe/shared/|)w[ig]/w$", ("embed_fsdp", "mlp")),
    (r"(moe/shared/|)wo/w$", ("mlp", "embed_fsdp")),
    (r"w[ig]/b$", ("mlp",)),
    (r"wo/b$", ("embed",)),
    # mamba2
    (r"mamba/in_proj/w$", ("embed_fsdp", "mamba_inner")),
    (r"mamba/out_proj/w$", ("mamba_inner", "embed_fsdp")),
    (r"mamba/conv_w$", ("conv", None)),
    (r"mamba/conv_b$", (None,)),
    (r"mamba/(A_log|D|dt_bias)$", (None,)),
    # norms and anything else 1-D: replicated
    (r"(scale|bias)$", (None,)),
]

# logical names used only in param specs
PARAM_RULES_EXTRA = {
    "heads_flat": "model",
    "kv_flat": "model",
    "mamba_inner": "model",
    "embed_fsdp": "data",
}


def rules_for_config(cfg: ModelConfig, mesh=None) -> dict:
    """The training rules for ``cfg``: with ``cfg.fsdp`` a weight's embed
    dim ("embed_fsdp") splits over "data", else it stays whole; MoE
    experts split over "model" (expert parallelism) when their count
    divides the axis, else their hidden dim and the dispatch capacity
    (expert tensor parallelism). The dry run sizes a rank's params from
    these; a data-parallel train step under ``fsdp`` raises
    (``train/train_step.py``)."""
    rules = dict(DEFAULT_RULES)
    rules.update(PARAM_RULES_EXTRA)
    rules["expert_ff"] = None
    if not cfg.fsdp:
        rules["embed_fsdp"] = None
    if cfg.moe is not None:
        model_size = mesh.shape.get("model", 16) if mesh is not None else 16
        if cfg.moe.n_experts % model_size != 0:
            rules["expert"] = None
            rules["expert_ff"] = "model"
            rules["capacity"] = "model"
    return rules


def logical_axes_for(path: str, ndim: int) -> tuple:
    for pat, names in _PARAM_RULES:
        if re.search(pat, path):
            if len(names) == ndim:
                return names
            if len(names) == ndim - 1:        # stacked (scan) leaf
                return (None,) + names
    return (None,) * ndim                     # unknown: replicated


def _walk(tree, prefix, fn):
    """``fn(path, leaf, names)`` over every leaf; a QuantizedTensor's qw
    shares the weight's names, its scale the output-dim split always and
    the K split on its group dim when it has more than one group."""
    if isinstance(tree, QuantizedTensor):
        wnames = logical_axes_for(prefix, len(tree.shape))
        pad = tree.qw.ndim - len(wnames)
        qw_names = ((None,) * pad + wnames if pad >= 0
                    else wnames[-tree.qw.ndim:])
        gdim = tree.scale.shape[-2]
        sc_names = qw_names[:-2] + ((qw_names[-2] if gdim > 1 else None),
                                    qw_names[-1])
        return QuantizedTensor(fn(prefix + "#qw", tree.qw, qw_names),
                               fn(prefix + "#scale", tree.scale, sc_names),
                               tree.bits, tree.group_size, tree.shape,
                               tree.act_bits)
    if isinstance(tree, dict):
        return {k: _walk(v, f"{prefix}/{k}" if prefix else k, fn)
                for k, v in tree.items()}
    names = logical_axes_for(prefix, tree.ndim)
    return fn(prefix, tree, names)


def param_specs(cfg: ModelConfig, params) -> dict:
    """The logical names of every leaf (a tree like ``params``)."""
    return _walk(params, "", lambda p, leaf, n: n)


# --------------------------------------------------- tensor-parallel serving
#
# Placement contract of tensor-parallel serving (axis TP_AXIS = "model"):
#
#   column-parallel (output dim on "model"):  attn wq/wk/wv (+ their biases),
#       mlp wi/wg (+ biases), mla wq/wukv
#   row-parallel (input dim on "model", all-reduced after the matmul, bias
#       added after the reduce):  attn wo, mlp wo, mla wo
#   replicated:  embed, lm_head, pos, norms, mla wdkv/kvnorm, all output
#       biases; so logits come out the same on every rank and sampling
#       needs no vocab collective
#   paged KV pools split along their kv-head dim (``paged_pool_pspecs``)
#
# QuantizedTensor leaves split qw and scale *jointly*: a K split (row-
# parallel) is legal only when the packed rows split evenly AND the scale
# groups split with them (per-channel scales stay whole: every K shard
# needs the whole (1, N) row). When the joint constraint fails the K split
# is dropped from both, never from one.

def serve_tp_rules(cfg: ModelConfig) -> dict:
    """Logical -> mesh rules for TP serving on a 1-D ("model",) mesh: no
    FSDP or data axes, embed / lm_head / pos replicated (the same logits
    on every rank), the MoE and Mamba axes neutralised (TP serving covers
    dense attention decoders)."""
    rules = dict(DEFAULT_RULES)
    rules.update(PARAM_RULES_EXTRA)
    rules["embed_fsdp"] = None
    rules["vocab"] = None
    rules["pos"] = None
    rules["expert"] = None
    rules["expert_ff"] = None
    rules["mamba_inner"] = None
    rules["ssm_heads"] = None
    return rules


def _qt_serve_spec(qt: QuantizedTensor, wnames: tuple, mesh, rules):
    """Joint (qw, scale) PartitionSpecs of one quantized leaf."""
    full = spec_for(qt.shape, wnames, mesh=mesh, rules=rules)
    k_ax, n_ax = full[-2], full[-1]
    n_groups = qt.scale.shape[-2]
    if k_ax is not None and mesh is not None:
        tp = _axis_size(mesh, k_ax)
        bpg, vpg = pack_layout(qt.bits)
        # each K shard holds whole packed groups (bpg bytes / vpg values),
        # so a shard boundary never splits a multi-byte word
        packed_ok = (qt.qw.shape[-2] % (tp * bpg) == 0
                     and qt.shape[-2] % (tp * vpg) == 0)
        groups_ok = n_groups == 1 or n_groups % tp == 0
        if not (packed_ok and groups_ok):
            k_ax = None                      # drop jointly
    lead = (None,) * (qt.qw.ndim - 2)
    qw_spec = ShardSpec(*lead, k_ax, n_ax)
    sc_spec = ShardSpec(*lead, k_ax if n_groups > 1 else None, n_ax)
    return qw_spec, sc_spec


def serve_param_shardings(mesh, cfg: ModelConfig, params) -> dict:
    """The ShardSpec tree of TP-serving placement (a QuantizedTensor
    of specs for a packed leaf). ``mesh`` gives the axis sizes for the
    divisibility checks; with None every named axis is kept."""
    rules = serve_tp_rules(cfg)

    def walk(tree, prefix):
        if isinstance(tree, QuantizedTensor):
            wnames = logical_axes_for(prefix, len(tree.shape))
            qw_spec, sc_spec = _qt_serve_spec(tree, wnames, mesh, rules)
            return QuantizedTensor(qw_spec, sc_spec, tree.bits,
                                   tree.group_size, tree.shape,
                                   tree.act_bits)
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in tree.items()}
        names = logical_axes_for(prefix, tree.ndim)
        return spec_for(tree.shape, names, mesh=mesh, rules=rules)

    return walk(params, "")


def tp_local_cfg(cfg: ModelConfig) -> ModelConfig:
    """A rank's view of a TP-serving config: head counts divided by tp
    with head_dim pinned first, so ``cfg.hd`` does not change when it was
    derived from d_model / n_heads. ``tp`` stays > 1: that is how
    row-parallel linears know to reduce over TP_AXIS."""
    if cfg.tp <= 1:
        return cfg
    if cfg.n_heads % cfg.tp:
        raise ValueError(f"n_heads {cfg.n_heads} does not split over "
                         f"tp={cfg.tp}")
    return cfg.replace(head_dim=cfg.hd,
                       n_heads=cfg.n_heads // cfg.tp,
                       n_kv_heads=max(1, cfg.n_kv_heads // cfg.tp))


def serve_tp_widths(cfg: ModelConfig) -> list[int]:
    """Legal TP widths: every rank holds whole kv heads with all their
    grouped query heads, and the MLP hidden dim splits evenly. (MLA's KV
    is a per-token latent, so only its query/output heads constrain it.)"""
    def ok(tp):
        if cfg.n_heads % tp or cfg.d_ff % tp:
            return False
        if cfg.attention != "mla" and cfg.n_kv_heads % tp:
            return False
        return True

    return [tp for tp in range(1, cfg.n_heads + 1) if ok(tp)]


def moe_ep_dispatch_pspecs(daxes: tuple):
    """The specs of the expert-parallel MoE dispatch
    (models/moe_shardmap.py): tokens batch-split over the data axes and
    whole over "model" (each model rank takes its 1/M of the tokens), the
    router whole, the expert stacks split over "model" on the expert dim,
    the output token-major like the input with a whole aux scalar."""
    tok = ShardSpec(daxes or None, None, None)
    expert = ShardSpec("model", None, None)
    in_specs = (tok, ShardSpec(None, None), expert, expert, expert)
    out_specs = (tok, ShardSpec())
    return in_specs, out_specs


def paged_pool_pspecs(cache, mesh, axis: str = TP_AXIS):
    """ShardSpec tree splitting every paged KV pool along its kv-head
    dim: value pools (..., P, page, KVH, hd) and scale pools (..., P,
    page, KVH). The page axes are never split: every rank holds its head
    slice of every page, so block tables, fill counts and the scheduler's
    page budget are the same on every rank. A pool whose head dim the
    axis cannot divide (MLA's latent pool, KVH 1) and every leaf that is
    not a pool come out whole."""
    from repro_torch.serve.kvcache import POOL_KEYS, pool_head_dim

    size = mesh.shape[axis]

    def leaf_spec(key, leaf):
        nd = leaf.ndim
        if key not in POOL_KEYS:
            return ShardSpec()
        hdim = pool_head_dim(key, nd)
        if leaf.shape[hdim] % size:
            return ShardSpec()
        return ShardSpec(*(axis if d == hdim else None
                               for d in range(nd)))

    def walk(tree, key=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return leaf_spec(key, tree)

    return walk(cache)


# ------------------------------------------------------ a rank's own shard

def shard_of(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (a view): each split dim
    cut into equal parts, the part at the rank's coordinate on the
    splitting axes (row-major over them when a dim splits over
    several)."""
    for dim, axes in enumerate(spec):
        flat = _flat(axes)
        if not flat:
            continue
        n, idx = 1, 0
        for a in flat:
            n *= mesh.shape[a]
            idx = idx * mesh.shape[a] + mesh.coords[a]
        size = t.shape[dim] // n
        t = t.narrow(dim, idx * size, size)
    return t


def local_shard(tree, specs, mesh):
    """The rank's shard of ``tree`` (float tensors and QuantizedTensors)
    under the spec tree ``specs`` (``serve_param_shardings``):
    contiguous copies, so the whole tree can be freed. A packed leaf's
    ``shape`` becomes the shard's logical shape."""
    if isinstance(tree, QuantizedTensor):
        qw = shard_of(tree.qw, specs.qw, mesh).contiguous()
        scale = shard_of(tree.scale, specs.scale, mesh).contiguous()
        shape = list(tree.shape)
        for dim, axes in zip(range(len(shape) - 2, len(shape)),
                             tuple(specs.qw)[-2:]):
            shape[dim] //= _axis_size(mesh, axes) if _flat(axes) else 1
        return QuantizedTensor(qw, scale, tree.bits, tree.group_size,
                               tuple(shape), tree.act_bits)
    if isinstance(tree, dict):
        return {k: local_shard(v, specs[k], mesh) for k, v in tree.items()}
    return shard_of(tree, specs, mesh).contiguous()

