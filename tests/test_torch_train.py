"""The port's trainer against the JAX package's on the same inputs: the
learning-rate schedules, gradient clipping, one training step (loss,
gradients, Adam state, params; with and without microbatch accumulation),
a 5-step loss trajectory, perplexity on float and packed TINY, the step-time
monitor; and on the port alone the checkpoint manager, a crash-and-resume
run, and the training launcher."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jc
from repro.core.quant.deploy import quantize_params_for_serving as jquant
from repro.models.transformer import init_lm as jinit
from repro.models.transformer import lm_loss as jlm_loss
from repro.optim import schedules as jsched
from repro.optim.adam import clip_by_global_norm as jclip
from repro.train.evaluate import perplexity as jperplexity
from repro.train.train_step import init_opt_state as jinit_opt
from repro.train.train_step import make_train_step as jmake_step
from repro.train.trainer import StepTimeMonitor as JaxStepTimeMonitor
import repro_torch.configs as tc
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import make_corpus
from repro_torch.launch import train as launcher
from repro_torch.models.transformer import init_lm, lm_loss
from repro_torch.optim import schedules
from repro_torch.optim.adam import clip_by_global_norm
from repro_torch.train.evaluate import perplexity
from repro_torch.train.train_step import (_grads_of, init_opt_state,
                                          make_train_step)
from repro_torch.train.trainer import StepTimeMonitor, Trainer
from repro_torch.utils.tree import tree_leaves, tree_map

JCFG = jc.TINY.replace(n_repeats=2)
TCFG = tc.TINY.replace(n_repeats=2)
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs (several test processes
    share the machine; see tests/test_torch_launch.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree_util.tree_map(np.array, jinit(JCFG,
                                                  jax.random.PRNGKey(0)))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _batch(seed, b=4, s=32):
    toks = np.random.default_rng(seed).integers(4, 256, (b, s + 1)).astype(
        np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _jstep_args(np_params, batch):
    jp = jax.tree_util.tree_map(jnp.array, np_params)
    return jp, {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-3,)), ("warmup_cosine", (3e-3, 20, 700)),
    ("warmup_cosine", (1e-2, 5, 60, 1e-4)), ("linear_decay", (3e-3, 700)),
    ("linear_decay", (1e-3, 50, 1e-5))])
def test_schedules_match_jax(name, args):
    got, want = getattr(schedules, name)(*args), getattr(jsched, name)(*args)
    for step in [0, 1, 4, 5, 19, 20, 21, 37, 100, 349, 699, 700, 800]:
        w = float(want(jnp.asarray(step)))
        np.testing.assert_allclose(got(step), w, rtol=1e-6, atol=0)


@pytest.mark.parametrize("max_norm", [1e-3, 1.0, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(2)
    tree = {"b": {"w": rng.normal(size=(7, 5)).astype(np.float32)},
            "a": rng.normal(size=33).astype(np.float32) * 0.1}
    jg, jn = jclip(jax.tree_util.tree_map(jnp.asarray, tree), max_norm)
    tg, tn = clip_by_global_norm(tree_map(torch.from_numpy, tree), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    want, got = _flat(jg), _flat(tree_map(lambda x: x.numpy(), tg))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0)


def _assert_step_matches(tparams, tstate, jparams, jstate, grads, lr):
    """Adam's first moves are nearly sign(g) * lr, so an element whose
    gradient is within the two packages' gradient noise of 0 can move by
    up to 2 lr the other way; every other element must move within 1e-3 lr
    of the reference. Near 0 means |g| <= 100 x the gradient tolerance
    (1e-5 of the leaf's largest |g|, see below)."""
    got, want = _flat(tree_map(lambda x: x.numpy(), tparams)), _flat(jparams)
    g = _flat(grads)
    for k in want:
        near0 = np.abs(g[k]) <= 100 * 1e-5 * np.abs(g[k]).max()
        err = np.abs(got[k] - want[k])
        assert err[~near0].max(initial=0) <= 1e-3 * lr, k
        assert err[near0].max(initial=0) <= 2 * lr + 1e-6, k
    for mom in ("m", "v"):
        got = _flat(tree_map(lambda x: x.numpy(), tstate["adam"][mom]))
        want = _flat(jstate["adam"][mom])
        for k in want:
            assert np.abs(got[k] - want[k]).max() <= \
                1e-5 * np.abs(want[k]).max() + 1e-30, (mom, k)
    assert tstate["adam"]["step"] == int(jstate["adam"]["step"])


@pytest.mark.parametrize("accum", [1, 2])
def test_one_train_step_matches_jax(np_params, accum):
    batch = _batch(0)
    jp, jb = _jstep_args(np_params, batch)
    jstep = jmake_step(JCFG, lr_schedule=jsched.constant(LR),
                       accum_steps=accum)
    jnew, jstate, jm = jstep(jp, jinit_opt(JCFG, jp), jb, jnp.asarray(0),
                             jax.random.PRNGKey(0))
    tp = params_from_numpy(np_params, device="cpu")
    tstep = make_train_step(TCFG, lr_schedule=schedules.constant(LR),
                            accum_steps=accum)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tnew, tstate, tm = tstep(tp, init_opt_state(TCFG, tp), tb, 0)
    # f32 forward and backward, sums in other orders: ~2e-7 relative loss
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-7)
    # the gradients (of one full batch: accumulation sums the halves'):
    # measured within 2e-6 of each leaf's largest |g|
    jgrads = jax.grad(lambda p: jlm_loss(JCFG, p, jb)[0])(
        jax.tree_util.tree_map(jnp.asarray, np_params))
    _, _, tgrads = _grads_of(TCFG, lm_loss,
                             params_from_numpy(np_params, device="cpu"), tb)
    want, got = _flat(jgrads), _flat(tree_map(lambda x: x.numpy(), tgrads))
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= \
            1e-5 * np.abs(want[k]).max(), k
    # the clip does not bind at a norm of ~1; accumulation's update uses
    # the mean of the halves' gradients, which is the full batch's only to
    # f32 rounding, so the near-0 rule below covers it too
    _assert_step_matches(tnew, tstate, jnew, jstate,
                         jax.tree_util.tree_map(np.asarray, jgrads), LR)


def test_five_step_trajectory_matches_jax(np_params):
    sched = dict(peak=3e-3, warmup=2, total=5)
    jp, _ = _jstep_args(np_params, _batch(0))
    jstep = jmake_step(JCFG, lr_schedule=jsched.warmup_cosine(**sched))
    jstate = jinit_opt(JCFG, jp)
    tp = params_from_numpy(np_params, device="cpu")
    tstep = make_train_step(TCFG, lr_schedule=schedules.warmup_cosine(
        **sched))
    tstate = init_opt_state(TCFG, tp)
    jl, tl = [], []
    for s in range(5):
        batch = _batch(10 + s)
        jp, jstate, jm = jstep(jp, jstate, {k: jnp.asarray(v)
                                            for k, v in batch.items()},
                               jnp.asarray(s), jax.random.PRNGKey(0))
        tp, tstate, tm = tstep(tp, tstate, {k: torch.from_numpy(v)
                                            for k, v in batch.items()}, s)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    # a near-0 gradient's sign flip moves one element by 2 lr (see
    # _assert_step_matches); later losses feel such moves: 1e-4 relative
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


@pytest.fixture(scope="module")
def heldout():
    corpus, _ = make_corpus(256, 20_000, seed=0)
    return corpus[-3000:]


EVAL = dict(seq_len=32, batch_size=4, max_windows=10)


def test_perplexity_float_tiny_matches_jax(heldout):
    jp = jinit(jc.TINY, jax.random.PRNGKey(1))
    want = jperplexity(jc.TINY, jp, heldout, **EVAL)
    got = perplexity(tc.TINY, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu"), heldout,
        **EVAL)
    for k in ("ppl", "nll"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    assert got["last_acc"] == want["last_acc"]


def test_perplexity_packed_tiny_matches_jax(heldout, monkeypatch):
    # the JAX package's packed linears on its kernel path (Pallas in
    # interpret mode): bf16 operands, f32 sums, as the port computes
    monkeypatch.setenv("REPRO_DEQUANT_IMPL", "pallas")
    jq = jquant(jc.TINY, jinit(jc.TINY, jax.random.PRNGKey(1)), bits=4,
                group_size=64)
    ev = dict(EVAL, max_windows=4)
    want = jperplexity(jc.TINY, jq, heldout, **ev)
    got = perplexity(tc.TINY, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jq), device="cpu"), heldout, **ev)
    # a last-ulp difference flips a bf16 input rounding and cascades with
    # depth (tests/test_torch_model.py: logits within 2e-2, mean 2e-3);
    # averaged over 128 tokens the nll moves far less
    np.testing.assert_allclose(got["nll"], want["nll"], rtol=1e-4)
    np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=1e-4)


def test_step_time_monitor_matches_jax():
    rng = np.random.default_rng(3)
    dts = list(rng.uniform(0.09, 0.11, 40))
    dts[12] = dts[25] = 0.5
    dts[30] = 0.16
    got, want = StepTimeMonitor(), JaxStepTimeMonitor()
    flags = [(got.update(dt), want.update(dt)) for dt in dts]
    assert [a for a, _ in flags] == [b for _, b in flags]
    assert [i for i, (a, _) in enumerate(flags) if a] == [12, 25]


def test_checkpoint_manager_retention_and_async(tmp_path):
    params = {"w": torch.arange(6, dtype=torch.float32)}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    try:
        for step in range(5):
            mgr.save(step, params, {"step": step})
            # the host copy is taken at save(): a later in-place change
            # does not reach the background write
            params["w"] += 1
        mgr.wait()
        assert mgr.steps() == [3, 4]
        step, got, opt, extra = mgr.restore(device="cpu")
        assert (step, opt, extra) == (4, {"step": 4}, {"step": 4})
        assert torch.equal(got["w"], torch.arange(6.0) + 4)
        assert mgr.restore(step=3, device="cpu")[1]["w"][0] == 3
    finally:
        mgr.close()
    assert CheckpointManager(str(tmp_path / "empty")).restore(
        device="cpu") is None


def _trainer(tmp_path):
    corpus, _ = make_corpus(256, 20_000, seed=0)
    params = init_lm(TCFG, seed=0, device="cpu")
    step_fn = make_train_step(TCFG, lr_schedule=schedules.warmup_cosine(
        3e-3, 2, 8))
    return Trainer(TCFG, params, init_opt_state(TCFG, params), step_fn,
                   DataPipeline(corpus, batch_size=4, seq_len=16, seed=0),
                   CheckpointManager(str(tmp_path), keep=2))


def test_trainer_crash_and_resume_is_bit_exact_on_cpu(tmp_path):
    straight = _trainer(tmp_path / "a")
    straight.run(8, ckpt_every=2, log_every=0)
    crashed = _trainer(tmp_path / "b")
    with pytest.raises(RuntimeError, match="injected failure at step 4"):
        crashed.run(8, ckpt_every=2, log_every=0, crash_at=4)
    resumed = _trainer(tmp_path / "b")
    assert resumed.maybe_resume() == 4        # the checkpoint of step 3
    result = resumed.run(8, ckpt_every=2, log_every=0)
    assert result["steps_run"] == 4
    assert [h["loss"] for h in resumed.history] == \
        [h["loss"] for h in straight.history[4:]]
    for a, b in zip(tree_leaves(resumed.params),
                    tree_leaves(straight.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(resumed.opt_state),
                    tree_leaves(straight.opt_state)):
        assert a == b if isinstance(a, int) else torch.equal(a, b)
    for t in (straight, crashed, resumed):
        t.ckpt.close()


def test_train_launcher_runs_and_resumes_on_cpu(tmp_path):
    argv = ["--device", "cpu", "--arch", "tiny", "--steps", "3",
            "--batch", "4", "--seq", "16", "--ckpt-every", "1",
            "--ckpt-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="injected failure at step 1"):
        launcher.main(argv + ["--crash-at", "1"], log=lambda s: None)
    lines = []
    trainer, result, held = launcher.main(argv, log=lines.append)
    assert "resumed at step 2" in lines
    assert result["steps_run"] == 1 and np.isfinite(result["final_loss"])
    assert sorted(os.listdir(tmp_path)) == ["step_0", "step_1", "step_2"]
    assert held["ppl"] > 1 and 0 <= held["last_acc"] <= 1


@pytest.mark.parametrize("flag", [["--grad-compress-bits", "8"],
                                  ["--multi-pod"]])
def test_train_launcher_refuses_later_flags(flag, tmp_path):
    """Both flags are ported now (tests/test_torch_train_dp.py runs them):
    the launcher takes them, and refuses only what the JAX launcher
    fails on: --multi-pod on a world that is not the 512 ranks of its
    2 x 16 x 16 mesh (jax.make_mesh's device count)."""
    argv = ["--device", "cpu", "--arch", "tiny", "--steps", "1",
            "--batch", "4", "--seq", "16", "--ckpt-dir", str(tmp_path)]
    args = launcher.parse_args(argv + flag)
    if flag == ["--multi-pod"]:
        assert args.multi_pod
        with pytest.raises(ValueError, match="needs 512 ranks"):
            launcher.main(argv + flag, log=lambda s: None)
    else:
        assert args.grad_compress_bits == 8
        _, result, _ = launcher.main(argv + flag, log=lambda s: None)
        assert result["steps_run"] == 1
