"""The port's sharding rules, partitioning, meshes and elastic planning
against the JAX package's (``repro.distributed``, ``repro.launch.mesh``,
``repro.launch.elastic``): the cases of tests/test_sharding.py (all but
``test_input_specs_all_cells``, which needs ``launch/shapes.py``), the
partitioning cases of tests/test_tp_serve.py, every config's rules and
every SMOKE param leaf's names and specs beside the JAX package's, a
rank's shard of the whole packed tree (``local_shard``) against its block
of every leaf, bytes and dequantized values, and a (2, 2) mesh's
coordinates and groups across four ``gloo`` ranks. Exact comparisons
throughout (specs are names)."""
import jax
import numpy as np
import pytest
import torch

import repro.configs as jc
import repro_torch.configs as tc
from repro.core.quant.types import quantize as jquantize
from repro.distributed import partitioning as JP
from repro.distributed import sharding as JS
from repro.launch import elastic as jelastic
from repro.models.transformer import init_cache as jinit_cache
from repro.serve.kvcache import PageSpec as JPageSpec
from repro_torch.core.quant.types import QuantizedTensor, dequantize, quantize
from repro_torch.distributed import partitioning as P
from repro_torch.distributed.sharding import (DEFAULT_RULES, ShardSpec,
                                              spec_for)
from repro_torch.launch.elastic import ElasticCoordinator, plan_mesh
from repro_torch.launch.mesh import Mesh, make_mesh, make_production_mesh
from repro_torch.launch.spawn import run_ranks
from repro_torch.models.transformer import init_cache
from repro_torch.serve.engine import _leaves
from repro_torch.serve.kvcache import PageSpec
# rank functions live in a module the ranks import without JAX
from test_torch_tp_serve import _fail_on_rank_1, _mesh_rank


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


MESH = FakeMesh({"pod": 2, "data": 16, "model": 16})
ARCHS = ["tiny"] + jc.list_archs()


def _cfgs(name, smoke=False):
    """(port cfg, JAX cfg) of an arch, each with its own ``fsdp`` (the
    configs of deepseek, granite, jamba and mixtral set it)."""
    if name == "tiny":
        return tc.TINY, jc.TINY
    if smoke:
        return tc.get_smoke_config(name), jc.get_smoke_config(name)
    return tc.get_config(name), jc.get_config(name)


# ------------------------------------------- tests/test_sharding.py's cases

def test_spec_for_divisibility_guard():
    rules = dict(DEFAULT_RULES)
    s = spec_for((14, 64), ("heads", "embed"), mesh=MESH, rules=rules)
    assert s == ShardSpec(None, None)   # 14 % 16 != 0 -> dropped
    s2 = spec_for((32, 64), ("heads", "embed"), mesh=MESH, rules=rules)
    assert s2[0] == "model"


def test_spec_for_duplicate_axis_guard():
    rules = {"a": "model", "b": "model"}
    s = spec_for((32, 32), ("a", "b"), mesh=MESH, rules=rules)
    assert s[0] == "model" and s[1] is None


def test_spec_for_missing_axis_dropped():
    single = FakeMesh({"data": 16, "model": 16})
    rules = {"batch": ("pod", "data")}
    s = spec_for((256, 8), ("batch", None), mesh=single, rules=rules)
    assert s[0] == "data"


def test_param_rules_attention():
    assert P.logical_axes_for("stack/p0/attn/wq/w", 3) == \
        (None, "embed_fsdp", "heads_flat")
    assert P.logical_axes_for("prefix/0/mlp/wo/w", 2) == ("mlp",
                                                          "embed_fsdp")
    assert P.logical_axes_for("stack/p0/ln1/scale", 2) == (None, None)


def test_moe_rules_switch_on_divisibility():
    ds = tc.get_config("deepseek-v2-lite-16b")     # 64 experts: EP
    r = P.rules_for_config(ds, MESH)
    assert r["expert"] == "model" and r["expert_ff"] is None
    mx = tc.get_config("mixtral-8x22b")            # 8 experts: expert-TP
    r2 = P.rules_for_config(mx, MESH)
    assert r2["expert"] is None and r2["expert_ff"] == "model"
    assert r2["capacity"] == "model"


def test_elastic_plan_full_and_degraded():
    p = plan_mesh(512, model_parallel=16, chips_per_pod=256)
    assert p.shape == (2, 16, 16) and p.accum_steps == 1
    # lose a host (8 chips): data axis shrinks, accumulation covers batch
    p2 = plan_mesh(512, model_parallel=16, chips_per_pod=256,
                   healthy_chips=504)
    assert int(np.prod(p2.shape)) <= 504
    assert p2.accum_steps >= 1


def test_elastic_coordinator_eviction():
    coord = ElasticCoordinator(512, model_parallel=16, chips_per_pod=256,
                               straggler_tolerance=2)
    assert coord.straggler(10, 3.0) is None
    plan = coord.straggler(11, 3.1)
    assert plan is not None  # evicted after repeated strikes
    assert coord.healthy < 512
    assert len(coord.events) == 3  # 2 straggler + 1 node_down


# ------------------------------------------ the same answers as the JAX's

@pytest.mark.parametrize("total,healthy,mp,cpp", [
    (512, None, 16, 256), (512, 504, 16, 256), (512, 256, 16, 256),
    (256, 200, 16, 256), (64, 48, 8, 32), (16, 16, 16, 256)])
def test_plan_mesh_matches_jax(total, healthy, mp, cpp):
    kw = dict(model_parallel=mp, chips_per_pod=cpp, healthy_chips=healthy)
    want = jelastic.plan_mesh(total, **kw)
    got = plan_mesh(total, **kw)
    assert (got.shape, got.axes, got.accum_steps, got.dropped_hosts) == (
        want.shape, want.axes, want.accum_steps, want.dropped_hosts)


def test_plan_mesh_refuses_fewer_chips_than_tp():
    with pytest.raises(ValueError, match="cannot satisfy TP degree"):
        plan_mesh(512, model_parallel=16, healthy_chips=8)


def test_coordinator_matches_jax():
    """The same straggler and node-down sequence gives the same plans and
    events in both packages."""
    kw = dict(model_parallel=16, chips_per_pod=256, straggler_tolerance=3)
    jco, tco = jelastic.ElasticCoordinator(512, **kw), \
        ElasticCoordinator(512, **kw)
    for step in range(7):
        a, b = jco.straggler(step, 1.0 + step), tco.straggler(step,
                                                              1.0 + step)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.shape, a.accum_steps) == (b.shape, b.accum_steps)
    a, b = jco.node_down(9, 64), tco.node_down(9, 64)
    assert (a.shape, a.accum_steps, a.dropped_hosts) == (
        b.shape, b.accum_steps, b.dropped_hosts)
    assert [(e.step, e.kind, e.detail) for e in jco.events] == \
        [(e.step, e.kind, e.detail) for e in tco.events]


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_rules_match_jax(arch, fsdp):
    """``rules_for_config`` with ``fsdp`` set either way equals the JAX
    package's on the production meshes and a small one: with it the embed
    dims ("embed_fsdp") split over "data"."""
    tcfg, jcfg = _cfgs(arch)
    tcfg, jcfg = tcfg.replace(fsdp=fsdp), jcfg.replace(fsdp=fsdp)
    for mesh in (MESH, FakeMesh({"data": 16, "model": 16}),
                 FakeMesh({"data": 2, "model": 4})):
        rules = P.rules_for_config(tcfg, mesh)
        assert rules == JP.rules_for_config(jcfg, mesh)
        assert rules["embed_fsdp"] == ("data" if fsdp else None)


@pytest.mark.parametrize("arch", ARCHS)
def test_rules_match_jax(arch):
    """Every config's training rules on the production mesh and a small
    one, its serving-TP rules, legal TP widths and each width's rank-local
    head counts equal the JAX package's."""
    tcfg, jcfg = _cfgs(arch)
    for mesh in (MESH, FakeMesh({"data": 2, "model": 4})):
        assert P.rules_for_config(tcfg, mesh) == \
            JP.rules_for_config(jcfg, mesh)
    assert P.serve_tp_rules(tcfg) == JP.serve_tp_rules(jcfg)
    widths = JP.serve_tp_widths(jcfg)
    assert P.serve_tp_widths(tcfg) == widths
    for tp in widths:
        a = JP.tp_local_cfg(jcfg.replace(tp=tp))
        b = P.tp_local_cfg(tcfg.replace(tp=tp))
        assert (b.n_heads, b.n_kv_heads, b.hd, b.tp) == (
            a.n_heads, a.n_kv_heads, a.hd, a.tp)


def _trees(arch, bits, group):
    """(port params, the same as a JAX tree) of the SMOKE config, packed by
    the port's deploy when ``bits``: specs read paths, shapes, bits and
    groups only, which the two packages' ``init_lm`` and deploy give
    alike (their values' parity has tests of its own)."""
    from repro.core.quant.types import QuantizedTensor as JQT
    from repro_torch.core.quant.deploy import quantize_params_for_serving
    from repro_torch.models.transformer import init_lm

    tcfg, _ = _cfgs(arch, smoke=True)
    tparams = init_lm(tcfg, seed=0, device="cpu")
    if bits:
        tparams = quantize_params_for_serving(tcfg, tparams, bits=bits,
                                              group_size=group,
                                              device="cpu")

    def to_jax(t):
        if isinstance(t, QuantizedTensor):
            return JQT(t.qw.numpy(), t.scale.numpy(), t.bits, t.group_size,
                       tuple(t.shape), t.act_bits)
        if isinstance(t, dict):
            return {k: to_jax(v) for k, v in t.items()}
        return t.numpy()

    return tparams, to_jax(tparams)


def _flat_names(tree, prefix=""):
    """{path: names} of a ``param_specs`` tree ("path#qw" / "#scale" for a
    packed leaf, as ``_walk`` names them)."""
    if isinstance(tree, QuantizedTensor):
        return {prefix + "#qw": tuple(tree.qw),
                prefix + "#scale": tuple(tree.scale)}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_names(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tuple(tree)}


def _walk_names(walk, tree, mesh, rules, spec_fn):
    out = {}

    def fn(path, leaf, names):
        out[path] = (tuple(names), tuple(spec_fn(leaf.shape, names,
                                                 mesh=mesh, rules=rules)))
        return leaf

    walk(tree, "", fn)
    return out


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if a != "whisper-medium"])
@pytest.mark.parametrize("bits", [0, 4])
def test_param_specs_match_jax(arch, bits):
    """Each leaf of the SMOKE params (float, and RTN W4 g32 packed) gets the
    JAX package's logical names and training spec on the production mesh,
    packed qw / scale leaves included. (whisper's param tree is the
    enc-dec's, which the rules see as the same leaf names.)"""
    tcfg, jcfg = _cfgs(arch, smoke=True)
    tparams, jparams = _trees(arch, bits, 32)
    rules_j = JP.rules_for_config(jcfg, MESH)
    rules_t = P.rules_for_config(tcfg, MESH)
    want = _walk_names(JP._walk, jparams, MESH, rules_j, JS.spec_for)
    got = _walk_names(P._walk, tparams, MESH, rules_t, spec_for)
    assert got == want
    names = {p: n for p, (n, _) in want.items()}
    assert _flat_names(P.param_specs(tcfg, tparams)) == names


# every legal TP width above 1 of each SMOKE config with dense attention
# or MLA blocks (config logic only: the same cases on every worker)
SERVE_CASES = [(arch, tp) for arch in ["llama3.2-1b", "qwen2-0.5b",
                                       "chatglm3-6b", "granite-20b",
                                       "deepseek-v2-lite-16b"]
               for tp in JP.serve_tp_widths(jc.get_smoke_config(arch))
               if tp in (2, 4)]


@pytest.mark.parametrize("arch,tp", SERVE_CASES)
@pytest.mark.parametrize("bits,group", [(0, 0), (4, 32), (4, -1),
                                        (3, -1), (2, 16)])
def test_serve_specs_match_jax(arch, tp, bits, group):
    """The serving-TP specs of every SMOKE leaf, packed or float, equal
    the JAX package's on a ("model",) mesh, K splits dropped jointly
    alike."""
    tcfg, jcfg = _cfgs(arch, smoke=True)
    mesh = FakeMesh({"model": tp})
    tparams, jparams = _trees(arch, bits, group)
    want = JP.serve_param_shardings(mesh, jcfg, jparams, specs_only=True)
    got = P.serve_param_shardings(mesh, tcfg, tparams)

    def flat(tree, is_qt):
        if is_qt(tree):
            return {"#qw": tuple(tree.qw), "#scale": tuple(tree.scale)}
        if isinstance(tree, dict):
            return {k: flat(v, is_qt) for k, v in tree.items()}
        return tuple(tree)

    from repro.core.quant.types import QuantizedTensor as JQT
    assert flat(got, lambda t: isinstance(t, QuantizedTensor)) == \
        flat(want, lambda t: isinstance(t, JQT))


@pytest.mark.parametrize("kv_bits", [0, 8])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-v2-lite-16b"])
def test_pool_specs_match_jax(arch, kv_bits):
    """Every pool leaf splits its kv-head dim as the JAX package's does
    (MLA's KVH-1 latent pool whole), page axes never."""
    tcfg, jcfg = _cfgs(arch, smoke=True)
    tcfg, jcfg = (c.replace(kv_cache_bits=kv_bits) for c in (tcfg, jcfg))
    mesh = FakeMesh({"model": 2})
    want = JP.paged_pool_pspecs(
        jinit_cache(jcfg, 2, 64, paged=JPageSpec(9, 16, 4)), mesh)
    got = P.paged_pool_pspecs(
        init_cache(tcfg, PageSpec(9, 16, 4), "meta", 2), mesh)
    def flat(tree, path=""):
        # the JAX cache nests a layer's pools under "attn"; the port's
        # holds them in the layer's own dict
        if isinstance(tree, dict):
            return [x for k, v in sorted(tree.items())
                    for x in flat(v, path if k == "attn" else f"{path}/{k}")]
        return [(path, tuple(tree))]

    assert flat(got) == flat(want)


def test_ep_dispatch_specs_match_jax():
    for daxes in [(), ("data",), ("pod", "data")]:
        a_in, a_out = JP.moe_ep_dispatch_pspecs(daxes)
        b_in, b_out = P.moe_ep_dispatch_pspecs(daxes)
        assert [tuple(s) for s in b_in] == [tuple(s) for s in a_in]
        assert [tuple(s) for s in b_out] == [tuple(s) for s in a_out]


# ------------------- tests/test_tp_serve.py's grouped-quant scale cases

MESH_TP = FakeMesh({"data": 2, "model": 4})
BASE = tc.TINY.replace(n_repeats=2, d_model=64, head_dim=16, d_ff=128)


def _specs(tree, rules, mesh=MESH_TP):
    return P._walk(tree, "", lambda path, leaf, names: spec_for(
        leaf.shape, names, mesh=mesh, rules=rules))


def _qt(k, n, gs, lead=()):
    gen = torch.Generator().manual_seed(0)
    return quantize(torch.randn(lead + (k, n), generator=gen), 4, gs)


def test_param_rules_scale_inherits_output_dim_sharding():
    """For every dense rule the grouped-quant scale leaf (K/gs, N) splits
    its output dim exactly like the packed weight."""
    rules = P.rules_for_config(BASE)
    tree = {"stack": {"p0": {
        "attn": {"wq": {"w": _qt(64, 64, 16)}, "wk": {"w": _qt(64, 32, 16)},
                 "wv": {"w": _qt(64, 32, 16)}, "wo": {"w": _qt(64, 64, 16)}},
        "mlp": {"wi": {"w": _qt(64, 128, 16)}, "wo": {"w": _qt(128, 64, 16)}},
    }}}
    specs = _specs(tree, rules)
    for name in ("wq", "wk", "wv"):
        qt = specs["stack"]["p0"]["attn"][name]["w"]
        assert qt.qw[-1] == "model" and qt.scale[-1] == "model", name
    mlp = specs["stack"]["p0"]["mlp"]
    assert mlp["wi"]["w"].qw[-1] == "model"
    assert mlp["wi"]["w"].scale[-1] == "model"
    # row-parallel wo: K dim split on qw -> group dim split on scale
    assert mlp["wo"]["w"].qw[0] == "model"
    assert mlp["wo"]["w"].scale[0] == "model"


def test_param_rules_scale_sharding_moe_expert_slabs():
    """Stacked MoE expert slabs (L, E, K, N): the scale inherits the expert
    / output split of the packed weight in the EP regime (expert dim on
    model) and the expert-TP regime (expert_ff on model)."""
    tree = {"stack": {"p0": {"moe": {"experts": {
        "wi": {"w": _qt(64, 128, 8, lead=(2, 4))},
        "wo": {"w": _qt(128, 64, 8, lead=(2, 4))},
    }}}}}
    ep_rules = P.rules_for_config(tc.get_config("deepseek-v2-lite-16b"),
                                  MESH_TP)
    wi = _specs(tree, ep_rules)["stack"]["p0"]["moe"]["experts"]["wi"]["w"]
    assert wi.qw[1] == "model" and wi.scale[1] == "model"      # expert dim
    assert wi.qw[-1] == wi.scale[-1]
    mesh16 = FakeMesh({"data": 2, "model": 16})
    etp_rules = P.rules_for_config(tc.get_config("mixtral-8x22b"), mesh16)
    specs = _specs(tree, etp_rules, mesh16)["stack"]["p0"]["moe"]["experts"]
    wi, wo = specs["wi"]["w"], specs["wo"]["w"]
    assert wi.qw[-1] == "model" and wi.scale[-1] == "model"    # expert_ff
    assert wo.qw[-2] == "model" and wo.scale[-2] == "model"    # K -> groups


def test_per_channel_scale_stays_whole_on_row_parallel():
    rules = P.rules_for_config(BASE)
    tree = {"stack": {"p0": {"mlp": {"wo": {"w": _qt(128, 64, -1)}}}}}
    wo = _specs(tree, rules)["stack"]["p0"]["mlp"]["wo"]["w"]
    assert wo.qw[0] == "model" and wo.scale[0] is None


def test_serve_specs_drop_k_sharding_jointly():
    """When the scale groups do not divide the TP width, the serving specs
    drop the K split from qw AND scale together."""
    mesh = FakeMesh({"model": 4})
    qw_spec, sc_spec = P._qt_serve_spec(
        _qt(128, 64, 64), ("mlp", "embed_fsdp"), mesh,
        P.serve_tp_rules(BASE))                 # G=2, tp=4: indivisible
    assert qw_spec[0] is None and sc_spec[0] is None
    qw_spec, sc_spec = P._qt_serve_spec(
        _qt(128, 64, 16), ("mlp", "embed_fsdp"), mesh,
        P.serve_tp_rules(BASE))                 # G=8: divisible
    assert qw_spec[0] == "model" and sc_spec[0] == "model"


# ----------------------------------------------- a rank's own packed shard

@pytest.mark.parametrize("bits,group", [(4, 32), (4, -1), (3, -1), (2, 64),
                                        (8, 16)])
@pytest.mark.parametrize("tp", [2, 4])
def test_rank_packs_its_shard_to_the_whole_trees_bytes(bits, group, tp):
    """A rank's shard of the whole packed tree (``local_shard`` of the
    port's deploy, whose bytes are the JAX package's:
    tests/test_torch_model.py::test_port_packing_runs_in_jax_and_back)
    is its block of every leaf: the ranks' shards of a split leaf put end
    to end along its split dim are the whole leaf byte for byte, a whole
    leaf is the same on every rank, and each packed shard dequantizes to
    its block of the whole weight (whole packed words and scale groups;
    a row-parallel per-channel scale is the whole column's). Its logical
    shape is the block's."""
    from repro_torch.core.quant.deploy import quantize_params_for_serving
    from repro_torch.models.transformer import init_lm

    cfg = tc.TINY.replace(n_repeats=2, d_model=128, n_heads=8, n_kv_heads=4,
                          head_dim=16, d_ff=256, tp=tp)
    whole = quantize_params_for_serving(cfg, init_lm(cfg, seed=1,
                                                     device="cpu"),
                                        bits=bits, group_size=group,
                                        device="cpu")
    specs = P.serve_param_shardings(FakeMesh({"model": tp}), cfg, whole)
    shards = [P.local_shard(whole, specs, Mesh((tp,), ("model",), rank=r,
                                                groups={}))
              for r in range(tp)]

    def split_dim(spec):
        dims = [d for d, a in enumerate(spec) if a is not None]
        assert len(dims) <= 1, spec
        return dims[0] if dims else None

    n_split = 0
    for (path, leaf, spec), *per_rank in zip(
            _leaves(whole, specs), *(_leaves(sh) for sh in shards)):
        d = split_dim(spec)
        if d is None:
            for _, t, _ in per_rank:
                assert torch.equal(t, leaf), path
            continue
        n_split += 1
        assert all(t.shape[d] * tp == leaf.shape[d] for _, t, _ in per_rank)
        assert torch.equal(torch.cat([t for _, t, _ in per_rank], d),
                           leaf), path

    def qts(tree, prefix=""):
        if isinstance(tree, QuantizedTensor):
            yield prefix, tree
        elif isinstance(tree, dict):
            for k, v in tree.items():
                yield from qts(v, f"{prefix}/{k}")

    n_packed = 0
    for (path, qt), (_, qspec) in zip(qts(whole), qts(specs)):
        d = split_dim(qspec.qw)
        full = dequantize(qt)
        for r, sh in enumerate(shards):
            part = dict(qts(sh))[path]
            want = (full if d is None else
                    full.narrow(d, r * full.shape[d] // tp,
                                full.shape[d] // tp))
            assert part.shape == tuple(want.shape), path
            assert torch.equal(dequantize(part), want), (r, path)
        n_packed += 1
    assert n_packed == 7 and n_split >= 7


def test_jax_quantize_of_a_row_slice_is_the_slice_of_its_bytes():
    """The premise of packing per rank, on the JAX package's own
    quantizer: W4 g32 codes of rows 64-127 are rows 32-63 of the packed
    bytes of all 128 rows."""
    w = np.random.default_rng(0).standard_normal((128, 48), np.float32)
    whole = jquantize(jax.numpy.asarray(w), 4, 32)
    part = jquantize(jax.numpy.asarray(w[64:]), 4, 32)
    np.testing.assert_array_equal(np.asarray(whole.qw)[32:],
                                  np.asarray(part.qw))
    np.testing.assert_array_equal(np.asarray(whole.scale)[2:],
                                  np.asarray(part.scale))


# ------------------------------------------------------------------- meshes

def test_make_mesh_needs_the_world():
    """A mesh needs exactly its ranks, as jax.make_mesh needs its devices:
    the 2 x 16 x 16 production mesh raises on a world of 1."""
    with pytest.raises(ValueError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True)
    one = make_mesh((1, 1), ("data", "model"))
    assert one.shape == {"data": 1, "model": 1} and one.group("data") is None


def test_mesh_groups_across_ranks(tmp_path):
    """Ranks lay out row-major, the last axis fastest (jax.make_mesh's
    order), and each axis's collectives stay inside its line: rank r sits
    at (r // 2, r % 2); "model" groups {0,1}, {2,3}; "data" groups {0,2},
    {1,3}."""
    out = run_ranks(_mesh_rank, 4, backend="gloo", timeout=120,
                    store_dir=str(tmp_path))
    for r, (coords, idx, sums, gathered, a2a) in enumerate(out):
        d, m = r // 2, r % 2
        assert coords == idx == {"data": d, "model": m}
        assert sums["model"] == (2 * d + 1) + (2 * d + 2)
        assert sums["data"] == (m + 1) + (m + 3)
        assert gathered == [2 * d + 1.0, 2 * d + 2.0]
        # chunk j of "data" rank i goes to rank j: rank d receives
        # element d of each source in source order
        assert a2a == [10. * m + d, 10. * (2 + m) + d]


def test_collective_outside_a_mesh_raises():
    from repro_torch.distributed import collectives as coll

    with pytest.raises(RuntimeError, match="needs an active mesh"):
        coll.all_reduce(torch.ones(2), "model")


def test_a_failing_rank_fails_the_run(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        run_ranks(_fail_on_rank_1, 2, backend="gloo", timeout=60,
                  store_dir=str(tmp_path))
