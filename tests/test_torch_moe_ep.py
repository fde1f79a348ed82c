"""Expert-parallel MoE dispatch in the port (models/moe_shardmap.py, one
process a rank under ``gloo``) against the JAX package's
``moe_ep_shardmap`` (under ``jax.jit``, as the JAX package's model
step runs it), which runs in one subprocess on four forced host
devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
tests/test_tp_serve.py runs the JAX package's TP; the JAX package is not
touched), and against the port's own ``spmd`` ``apply_moe`` on each
rank's token slice. A float MoE of 8 experts top-2 with a shared expert,
at a capacity factor of 0.5 so that tokens are dropped; M = 2 and 4.
Then ``apply_moe``'s rule for taking the expert-parallel path.

Tolerances: outputs within 2e-6 absolute (f32 matmuls whose shapes, and
so whose summation order, differ; the values are O(1)); the aux loss
within 1e-6 relative. The routing is the same on both sides (equal
router products within one f32 matmul), so no token is compared across a
different expert choice.

The JAX package is imported inside the functions that run it: the ranks
import this module to find their function.
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch

import repro_torch.configs as tc
from repro_torch.launch.spawn import run_ranks
from repro_torch.models.config import LayerSpec, MoEConfig

MOE = dict(n_experts=8, top_k=2, n_shared=1, d_ff_expert=32,
           capacity_factor=0.5)
D = 64
CFG = tc.TINY.replace(d_model=D, pattern=(LayerSpec(mlp="moe"),),
                      moe=MoEConfig(**MOE), moe_impl="shard_map")
B, S = 4, 32
ATOL, AUX_RTOL = 2e-6, 1e-6


def inputs(seed=0):
    """The MoE block's params and input, as numpy, from a seed."""
    rng = np.random.default_rng(seed)
    e, f = MOE["n_experts"], MOE["d_ff_expert"]

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)
    arrays = {"router": w(D, e), "wi": w(e, D, f), "wg": w(e, D, f),
              "wo": w(e, f, D), "s_wi": w(D, f), "s_wg": w(D, f),
              "s_wo": w(f, D),
              "x": rng.standard_normal((B, S, D)).astype(np.float32)}
    return arrays


def tree(a, lib):
    """The MoE param tree of ``inputs``' arrays, as ``lib`` tensors."""
    return {"router": {"w": lib(a["router"])},
            "experts": {n: {"w": lib(a[n])} for n in ("wi", "wg", "wo")},
            "shared": {n: {"w": lib(a["s_" + n])}
                       for n in ("wi", "wg", "wo")}}


JAX_SCRIPT = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
import repro.configs as jc
from repro.models.config import LayerSpec, MoEConfig
from repro.models.moe_shardmap import moe_ep_shardmap

a = dict(np.load(sys.argv[1]))
moe = json.loads(sys.argv[3])
cfg = jc.TINY.replace(d_model=a["x"].shape[-1],
                      pattern=(LayerSpec(mlp="moe"),), moe=MoEConfig(**moe),
                      moe_impl="shard_map")
p = {"router": {"w": jnp.asarray(a["router"])},
     "experts": {n: {"w": jnp.asarray(a[n])} for n in ("wi", "wg", "wo")},
     "shared": {n: {"w": jnp.asarray(a["s_" + n])}
                for n in ("wi", "wg", "wo")}}
out = {}
for m in (2, 4):
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:m]), ("model",))
    ep = jax.jit(lambda p, x, mesh=mesh: moe_ep_shardmap(cfg, p, x, mesh))
    y, aux = ep(p, jnp.asarray(a["x"]))
    out[f"y{m}"], out[f"aux{m}"] = np.asarray(y), np.asarray(aux)
np.savez(sys.argv[2], **out)
"""


def jax_ep(arrays, tmp_path):
    """The JAX package's EP outputs at M 2 and 4, from a subprocess with
    four host devices: started here, read by calling the returned
    function (the port's ranks run meanwhile)."""
    inp, out = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inp, **arrays)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.abspath(src))
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(inp),
                             str(out), json.dumps(MOE)], env=env)

    def result():
        try:
            rc = proc.wait(timeout=300)
        finally:
            proc.kill()
        assert rc == 0, f"the JAX subprocess exited {rc}"
        return dict(np.load(out))
    return result


# ------------------------------------------------------------- rank side

def _ep_rank(rank, world, arrays):
    """On a ("model",) mesh of ``world`` ranks: the EP output through
    apply_moe (the rule takes EP), its dispatch count, and the spmd
    apply_moe on this rank's token slice with all experts."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.distributed.sharding import sharding_ctx
    from repro_torch.models import moe_shardmap
    from repro_torch.models.mlp_moe import apply_moe

    p = tree(arrays, torch.from_numpy)
    x = torch.from_numpy(arrays["x"])
    mesh = make_mesh((world,), ("model",))
    moe_shardmap.dispatches = 0
    with sharding_ctx(mesh):
        y, aux = apply_moe(CFG, p, x)
        # the rank's own experts only, as a rank holds them
        e_loc = MOE["n_experts"] // world
        local = dict(p, experts={n: {"w": v["w"][rank * e_loc:
                                                  (rank + 1) * e_loc]}
                                 for n, v in p["experts"].items()})
        y_local, aux_local = apply_moe(CFG, local, x)
    t = B * S // world
    xs = x.reshape(B * S, D)[rank * t:(rank + 1) * t].reshape(1, t, D)
    y_slice, aux_slice = apply_moe(CFG.replace(moe_impl="spmd"), p, xs)
    roomy = CFG.replace(moe_impl="spmd", moe=MoEConfig(
        **dict(MOE, capacity_factor=8.0)))
    y_roomy, _ = apply_moe(roomy, p, xs)
    return dict(dropped=not torch.allclose(y_slice, y_roomy), y=y.numpy(),
                aux=float(aux), y_local=y_local.numpy(),
                aux_local=float(aux_local),
                dispatches=moe_shardmap.dispatches,
                y_slice=y_slice.numpy(), aux_slice=float(aux_slice))


def _rule_rank(rank, world, arrays):
    """Which path apply_moe takes under each of the rule's conditions
    (the number of EP dispatches each call made)."""
    from repro_torch.core.quant.deploy import quantize_params_for_serving
    from repro_torch.distributed.sharding import sharding_ctx
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe_shardmap
    from repro_torch.models.mlp_moe import apply_moe

    p = tree(arrays, torch.from_numpy)
    x = torch.from_numpy(arrays["x"])
    mesh = make_mesh((world,), ("model",))
    packed = quantize_params_for_serving(CFG, {"moe": p}, bits=4,
                                         group_size=-1, device="cpu")["moe"]
    six = CFG.replace(moe=MoEConfig(**dict(MOE, n_experts=6)))
    p6 = dict(p, router={"w": p["router"]["w"][:, :6]},
              experts={n: {"w": v["w"][:6]}
                       for n, v in p["experts"].items()})
    cases = {
        "float experts, E % M == 0, tokens % M == 0": (CFG, p, x, {}),
        "packed experts": (CFG, packed, x, {}),
        "E % M != 0": (six, p6, x, {}),
        "tokens % M != 0": (CFG, p, x[:1, :3], {}),
        "taps": (CFG, p, x, dict(taps={})),
        "valid": (CFG, p, x, dict(valid=torch.ones(B, S, dtype=torch.bool))),
        "moe_impl spmd": (CFG.replace(moe_impl="spmd"), p, x, {}),
    }
    out = {}
    for name, (cfg, prm, xx, kw) in cases.items():
        moe_shardmap.dispatches = 0
        with sharding_ctx(mesh):
            apply_moe(cfg, prm, xx, **kw)
        out[name] = moe_shardmap.dispatches
    moe_shardmap.dispatches = 0
    apply_moe(CFG, p, x)                      # no mesh active
    out["no mesh"] = moe_shardmap.dispatches
    return out


def test_ep_matches_jax_and_spmd(tmp_path):
    """At M 2 and 4 every rank's EP output equals the JAX package's
    ``moe_ep_shardmap`` (within ATOL; the aux loss within AUX_RTOL), with
    all experts given or only the rank's own; each rank's rows equal the
    port's spmd ``apply_moe`` on that rank's token slice (capacity from
    the slice, as the JAX package's EP sizes it), and the aux loss is the
    mean of the slices'. The path ran once a call."""
    arrays = inputs()
    jax_result = jax_ep(arrays, tmp_path)
    outs = {m: run_ranks(_ep_rank, m, backend="gloo", args=(arrays,),
                         timeout=180, store_dir=str(tmp_path))
            for m in (2, 4)}
    want = jax_result()
    for m, out in outs.items():
        t = B * S // m
        for rank, res in enumerate(out):
            assert res["dispatches"] == 2
            for key in ("y", "y_local"):
                np.testing.assert_allclose(res[key], want[f"y{m}"],
                                           atol=ATOL, rtol=0)
            for key in ("aux", "aux_local"):
                np.testing.assert_allclose(res[key], want[f"aux{m}"],
                                           rtol=AUX_RTOL)
            rows = res["y"].reshape(B * S, D)[rank * t:(rank + 1) * t]
            np.testing.assert_allclose(rows, res["y_slice"][0], atol=ATOL,
                                       rtol=0)
        np.testing.assert_allclose(
            out[0]["aux"], np.mean([r["aux_slice"] for r in out]),
            rtol=AUX_RTOL)
        # the capacity binds: a roomier one changes some rank's output
        assert any(r["dropped"] for r in out)


def test_ep_dispatch_rule(tmp_path):
    """``apply_moe`` takes the EP path only under the JAX package's rule:
    ``moe_impl="shard_map"``, a mesh with a "model" axis, float experts, E
    and the tokens divisible by the axis, and no taps or valid mask;
    every other case runs the spmd path (no dispatch counted)."""
    out = run_ranks(_rule_rank, 4, backend="gloo",
                    args=(inputs(),), timeout=180, store_dir=str(tmp_path))
    want = {"float experts, E % M == 0, tokens % M == 0": 1,
            "packed experts": 0, "E % M != 0": 0, "tokens % M != 0": 0,
            "taps": 0, "valid": 0, "moe_impl spmd": 0, "no mesh": 0}
    assert out == [want] * 4


def test_capacity_rule_is_the_jax_packages():
    """The slice's capacity (``moe_capacity``) is the JAX EP body's
    ``max(8, ceil8(int(cf * t_r * k / e)))`` at every slice size here."""
    from repro_torch.models.mlp_moe import moe_capacity

    m = CFG.moe
    for t_r in (1, 7, 8, 16, 32, 100, 1000):
        jax_rule = max(8, -(-int(m.capacity_factor * t_r * m.top_k
                                 / m.n_experts) // 8) * 8)
        assert moe_capacity(CFG, t_r) == jax_rule
