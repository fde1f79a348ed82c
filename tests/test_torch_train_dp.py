"""Gradient compression and data-parallel training in the port
(optim/compression.py, train/train_step.py, launch/train.py) against the
JAX package's: ``compress_decompress`` on JAX's own rounding noise, a
5-step trajectory with ``grad_compress_bits`` 8 against ``make_train_step``
on JAX's noise, two ``gloo`` ranks against one at the same global batch
(float and compressed), the launcher's ``--grad-compress-bits`` and
``--multi-pod`` over two ranks, and its straggler callback through the
elastic coordinator.

The JAX package is imported inside the functions that run it: the ranks
import this module to find their function.
"""
import numpy as np
import pytest
import torch

import repro_torch.configs as tc
from repro_torch.launch.spawn import run_ranks
from repro_torch.optim.compression import compress_decompress
from repro_torch.utils.tree import tree_leaves, tree_map

TCFG = tc.TINY.replace(n_repeats=2)
SCHED = dict(peak=3e-3, warmup=2, total=5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs (several test processes
    share the machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed, b=4, s=32):
    toks = np.random.default_rng(seed).integers(4, 256, (b, s + 1)).astype(
        np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def jax_noise(grads, key):
    """The JAX step's rounding noise for ``grads`` (a JAX tree) under
    ``key``, as the port's tree of tensors: one key a leaf in JAX's leaf
    order, uniform on [-0.5, 0.5)."""
    import jax

    leaves, treedef = jax.tree.flatten(grads)
    keys = jax.random.split(key, len(leaves))
    noise = treedef.unflatten([
        jax.random.uniform(k, g.shape, minval=-0.5, maxval=0.5)
        for k, g in zip(keys, leaves)])
    return jax.tree_util.tree_map(lambda t: torch.from_numpy(np.array(t)),
                                  noise)


@pytest.mark.parametrize("bits", [8, 4])
def test_compress_decompress_matches_jax_bit_for_bit(bits):
    """On JAX's noise, the decompressed gradients and the new residuals
    equal the JAX package's exactly (the same f32 operations in the same
    order), a residual from an earlier step included."""
    import jax
    import jax.numpy as jnp

    from repro.optim.compression import compress_decompress as jcompress

    rng = np.random.default_rng(bits)
    grads = {"b": {"w": rng.normal(size=(7, 5)).astype(np.float32)},
             "a": (rng.normal(size=33) * 1e-3).astype(np.float32)}
    ef = tree_map(lambda g: (rng.normal(size=g.shape) * 1e-2).astype(
        np.float32), grads)
    key = jax.random.PRNGKey(7)
    jg = jax.tree_util.tree_map(jnp.asarray, grads)
    want_g, want_ef = jcompress(jg, jax.tree_util.tree_map(jnp.asarray, ef),
                                bits=bits, rng=key)
    got_g, got_ef = compress_decompress(
        tree_map(torch.from_numpy, grads), tree_map(torch.from_numpy, ef),
        bits=bits, noise=jax_noise(jg, key))
    for got, want in ((got_g, want_g), (got_ef, want_ef)):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_compression_draws_from_its_generator():
    """Without noise given, the same generator state gives the same
    result, and the rounding is stochastic: its mean over draws is the
    value (error feedback aside)."""
    g = {"w": torch.linspace(-1, 1, 1001)}
    ef = {"w": torch.zeros(1001)}
    a = compress_decompress(g, ef, bits=4,
                            rng=torch.Generator().manual_seed(3))
    b = compress_decompress(g, ef, bits=4,
                            rng=torch.Generator().manual_seed(3))
    assert torch.equal(a[0]["w"], b[0]["w"])
    gen = torch.Generator().manual_seed(4)
    mean = torch.stack([compress_decompress(g, ef, bits=4, rng=gen)[0]["w"]
                        for _ in range(400)]).mean(0)
    assert float((mean - g["w"]).abs().max()) < 0.03   # a step is 1/7
    with pytest.raises(ValueError, match="rng or noise"):
        compress_decompress(g, ef, bits=8)


def test_compressed_trajectory_matches_jax():
    """Five steps of ``make_train_step(grad_compress_bits=8)`` in both
    packages, the port on the JAX step's noise: losses within 1e-4
    relative (the float trajectory's bar in tests/test_torch_train.py:
    a gradient element within the packages' noise of a rounding boundary
    may round to the next int8 step), and the residuals stay finite."""
    import jax
    import jax.numpy as jnp

    import repro.configs as jc
    from repro.models.transformer import init_lm as jinit
    from repro.models.transformer import lm_loss as jlm_loss
    from repro.optim import schedules as jsched
    from repro.train.train_step import init_opt_state as jinit_opt
    from repro.train.train_step import make_train_step as jmake_step
    from repro_torch.checkpoint.convert import params_from_numpy
    from repro_torch.optim import schedules
    from repro_torch.train.train_step import init_opt_state, make_train_step

    jcfg = jc.TINY.replace(n_repeats=2)
    np_params = jax.tree_util.tree_map(np.array,
                                       jinit(jcfg, jax.random.PRNGKey(0)))
    jp = jax.tree_util.tree_map(jnp.array, np_params)
    jstep = jmake_step(jcfg, lr_schedule=jsched.warmup_cosine(**SCHED),
                       grad_compress_bits=8, donate=False)
    jstate = jinit_opt(jcfg, jp, grad_compress_bits=8)
    tp = params_from_numpy(np_params, device="cpu")
    tstep = make_train_step(TCFG, lr_schedule=schedules.warmup_cosine(
        **SCHED), grad_compress_bits=8)
    tstate = init_opt_state(TCFG, tp, grad_compress_bits=8)
    assert set(tstate) == {"adam", "ef"}
    jl, tl = [], []
    # the shapes and leaf order of the JAX step's gradients, for its noise
    grads = jax.eval_shape(
        jax.grad(lambda p, b: jlm_loss(jcfg, p, b)[0]), jp,
        {k: jnp.asarray(v) for k, v in _batch(10).items()})
    for s in range(5):
        batch = _batch(10 + s)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        key = jax.random.PRNGKey(100 + s)
        noise = jax_noise(grads, key)
        jp, jstate, jm = jstep(jp, jstate, jb, jnp.asarray(s), key)
        tp, tstate, tm = tstep(tp, tstate, {k: torch.from_numpy(v)
                                            for k, v in batch.items()}, s,
                               noise=noise)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    for e in tree_leaves(tstate["ef"]):
        assert torch.isfinite(e).all()


# ------------------------------------------------ data parallel over ranks

def _dp_rank(rank, world, bits, steps):
    """``steps`` steps of the train step under a (world, 1) ("data",
    "model") mesh on the global batch; returns the losses and every
    param as one flat array."""
    from repro_torch.distributed.partitioning import rules_for_config
    from repro_torch.distributed.sharding import sharding_ctx
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import init_lm
    from repro_torch.optim import schedules
    from repro_torch.train.train_step import init_opt_state, make_train_step
    from repro_torch.train.trainer import step_generator

    params = init_lm(TCFG, seed=0, device="cpu")
    step = make_train_step(TCFG, lr_schedule=schedules.warmup_cosine(
        **SCHED), grad_compress_bits=bits)
    state = init_opt_state(TCFG, params, grad_compress_bits=bits)
    mesh = make_mesh((world, 1), ("data", "model"))
    losses = []
    with sharding_ctx(mesh, rules_for_config(TCFG, mesh)):
        for s in range(steps):
            batch = {k: torch.from_numpy(v)
                     for k, v in _batch(10 + s, b=8).items()}
            params, state, m = step(params, state, batch, s,
                                    step_generator(0, s, "cpu"))
            losses.append(float(m["loss"]))
    return losses, torch.cat([t.reshape(-1)
                              for t in tree_leaves(params)]).numpy()


@pytest.mark.parametrize("bits", [0, 8])
def test_two_ranks_match_one(bits, tmp_path):
    """Two data ranks, each on its half of the global batch of 8, give the
    params bit for bit on both ranks, and the one-rank run's losses
    within 1e-5 relative (the mean gradient summed in another order).
    The params: Adam's first moves are nearly sign(g) * lr, so an element
    whose mean gradient is within summation noise of 0 (or, compressed,
    of an int8 rounding boundary) may move the other way, by at most 2 lr
    a step; every param stays within that, and all but 0.1% (float) or
    0.5% (int8) of them within 1e-5."""
    steps = 4
    one = _dp_rank(0, 1, bits, steps)
    two = run_ranks(_dp_rank, 2, backend="gloo", args=(bits, steps),
                    timeout=180, store_dir=str(tmp_path))
    np.testing.assert_array_equal(two[0][1], two[1][1])
    assert two[0][0] == two[1][0]
    np.testing.assert_allclose(two[0][0], one[0], rtol=1e-5)
    diff = np.abs(two[0][1] - one[1])
    assert diff.max() <= 2 * SCHED["peak"] * steps
    assert (diff <= 1e-5).mean() >= (0.999 if bits == 0 else 0.995)


def _launcher_rank(rank, world, argv):
    from repro_torch.launch import train as launcher

    trainer, result, _ = launcher.main(argv, log=lambda s: None)
    return result["final_loss"], torch.cat([
        t.reshape(-1) for t in tree_leaves(trainer.params)]).numpy()


def test_launcher_compressed_dp_over_two_ranks(tmp_path):
    """``launch.train --grad-compress-bits 8`` on two gloo ranks: the mesh
    is (2, 1) over ("data", "model"), both ranks end on the same params,
    and rank 0 and rank 1 checkpoint into --ckpt-dir and its rank1/."""
    argv = ["--device", "cpu", "--arch", "tiny", "--steps", "3",
            "--batch", "4", "--seq", "16", "--ckpt-every", "0",
            "--grad-compress-bits", "8", "--ckpt-dir", str(tmp_path)]
    out = run_ranks(_launcher_rank, 2, backend="gloo", args=(argv,),
                    timeout=240, store_dir=str(tmp_path))
    assert out[0][0] == out[1][0]
    np.testing.assert_array_equal(out[0][1], out[1][1])
    assert (tmp_path / "step_2").is_dir()
    assert (tmp_path / "rank1" / "step_2").is_dir()


def _multi_pod_rank(rank, world, argv):
    from repro_torch.launch import train as launcher

    try:
        launcher.main(argv, log=lambda s: None)
    except ValueError as e:
        return str(e)
    return None


def test_launcher_multi_pod_needs_512_ranks(tmp_path):
    """``--multi-pod`` builds the 2 x 16 x 16 mesh, which a world of two
    ranks cannot hold: every rank raises, as jax.make_mesh does."""
    argv = ["--device", "cpu", "--arch", "tiny", "--steps", "1",
            "--multi-pod", "--ckpt-dir", str(tmp_path)]
    out = run_ranks(_multi_pod_rank, 2, backend="gloo", args=(argv,),
                    timeout=120, store_dir=str(tmp_path))
    assert all(e is not None and "needs 512 ranks" in e for e in out)


def test_straggler_handler_logs_the_remesh_plan():
    """The launcher's straggler callback passes each straggler to the
    elastic coordinator and logs the plan it returns on the third strike
    (the JAX launcher's line), without remeshing."""
    import repro.launch.elastic as jelastic
    from repro_torch.launch.elastic import ElasticCoordinator
    from repro_torch.launch.train import straggler_handler

    lines = []
    coord = ElasticCoordinator(512)
    on_straggler = straggler_handler(coord, lines.append)
    for step in (10, 11, 12):
        on_straggler(step, 2.0)
    plan = jelastic.ElasticCoordinator(512)
    for step in (10, 11):
        assert plan.straggler(step, 2.0) is None
    want = plan.straggler(12, 2.0)
    assert lines[-1] == (f"!! evicting slow host: remesh plan {want.shape},"
                         f" grad-accum x{want.accum_steps} (logged, not "
                         f"remeshed)")
    assert sum(line.startswith("straggler:") for line in lines) == 3
    assert coord.healthy == plan.healthy < 512


def test_a_small_worlds_stragglers_do_not_end_the_run():
    """The launcher's coordinator fits its mesh: on one chip or two, three
    stragglers in a row log a remesh plan instead of failing the plan (the
    JAX launcher's default coordinator, TP 16 over 256-chip pods, fails it
    there)."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import coordinator_for, straggler_handler

    for shape in ((1, 1), (2, 1)):
        mesh = Mesh(shape, ("data", "model"), rank=0, groups={})
        lines = []
        on_straggler = straggler_handler(coordinator_for(mesh),
                                         lines.append)
        for step in range(3):
            on_straggler(step, 2.0)
        assert lines[-1].startswith(f"!! evicting slow host: remesh plan "
                                    f"{shape}")
