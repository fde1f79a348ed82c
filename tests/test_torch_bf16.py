"""bf16 compute in the port against the JAX package's bf16 path, on every
config's SMOKE variant (``dtype`` and ``param_dtype`` "bfloat16", as the
JAX package's dry run sets them): ``lm_forward``, ``lm_prefill`` then
``lm_decode`` on a contiguous cache, whisper's ``encdec_prefill`` /
``encdec_decode``, InternVL2's patch rows through ``ext_embeds``, one
train step's loss and gradients, and a W4-packed forward (the JAX side on
its kernel path, ``REPRO_DEQUANT_IMPL=pallas``, whose bf16 operands the
port's kernels take).

Both packages start from the same numpy f32 draws, every leaf cast to the
dtype the JAX package's bf16 init gives it (the MoE router and mamba's
A_log, D and dt_bias stay f32), so the params are equal bit for bit.

The JAX side is compiled with XLA's excess precision off (``nominal``):
every bf16 rounding its ops name then takes place, as in its eager ops.
With it on (XLA's default), the CPU fusions keep some sums in f32 past a
bf16 cast (a residual add read by the next norm), which moves each
layer's output by about a bf16 step from the package's own op-by-op
result.

Tolerance. Each package rounds its activations to bf16 after every
matmul, norm, activation op and residual add at the same points; only a
sum taken in another order can land on the other side of a rounding
boundary, and such a step of 2^-8 carries through the layers that follow.
So the logits are held to TOL_STEPS bf16 steps per layer, of the largest
logit: ``2^-8 * TOL_STEPS * (n_layers + 1) * max|logits|``, and greedy
tokens must be equal wherever JAX's top-2 margin exceeds twice that.
TOL_STEPS is set from a measurement on the CPU: of the forward and
prefill logits here, the port's bf16 ones sit at most 0.19 of these
units from JAX's (qwen2's forward; every other reading 0 or below 1e-5),
while the port run in f32 on the same bf16 params and inputs sits
0.64-12.8 units away on every config's forward; each forward test holds
that control too (``assert_f32_control``). A decode step reads the whole
cache through the single-shot core, whose f32 sums run in another order
than XLA's; where one lands on the other side of a bf16 rounding, the
step is carried by the layers after. The decode steps are held to
DECODE_TOL_STEPS: measured at most 0.29 (whisper's first step; 0.20
mamba2's, 0.02 llama's, every other 0 or below 1e-5), and 0.6 on
whisper's first step with the port's own init draws in place of the JAX
package's.

The gradients are held to GRAD_TOL_STEPS of the same units, relative to
each leaf's norm: autograd rounds the backward pass's bf16 cotangents at
other points than JAX's transposes, so they are not as close (measured:
at most 0.96 units on a leaf). The port's f32 gradients' farthest leaf
sits 0.83-3.7 units away, not beyond that bound on every config, so the
gradient control is an order: the median leaf of the f32 port (0.61-1.22
units) is farther from JAX's bf16 gradients than the bf16 port's median
leaf.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jc
from repro.core.quant.deploy import quantize_params_for_serving as jquant
from repro.models import encdec as jed
from repro.models import transformer as jtr
import repro_torch.configs as tc
from repro_torch.configs.registry import list_archs
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.core.quant.deploy import quantize_params_for_serving
from repro_torch.models import encdec as ted
from repro_torch.models import transformer as ttr
from repro_torch.optim import schedules
from repro_torch.train.train_step import (_grads_of, init_opt_state,
                                          make_train_step)

ARCHS = list_archs()
DECODERS = [a for a in ARCHS if a != "whisper-medium"]
BF16_STEP = 2.0 ** -8
# measured (module docstring): forward and prefill, the bf16 port at most
# 0.19, the f32 port at least 0.64; decode steps at most 0.6
TOL_STEPS = 0.45
DECODE_TOL_STEPS = 1.0
# measured: the bf16 port's gradients at most 0.96 on a leaf
GRAD_TOL_STEPS = 1.5
B, S, NEW = 2, 12, 3
# XLA's compile option that keeps every bf16 rounding the ops name
NOMINAL = {"xla_allow_excess_precision": False}


def nominal(fn):
    """``fn`` jitted and compiled once (at its first call's shapes) with
    ``NOMINAL``."""
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jax.jit(fn).lower(*args).compile(
                compiler_options=NOMINAL))
        return compiled[0](*args)

    return call


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(cfg):
    return cfg.replace(dtype="bfloat16", param_dtype="bfloat16")


def _perturbed(tree, seed=0):
    """Biases N(0, 0.02^2), norm scales 1 + N(0, 0.02^2): each reaches the
    logits (an init leaves them at 0 and 1)."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        key = path[-1].key
        if key in ("b", "bias"):
            return (0.02 * rng.normal(size=x.shape)).astype(np.float32)
        if key == "scale":
            return (1.0 + 0.02 * rng.normal(size=x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(draw, tree)


_TORCH = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32}


def _cast_port(tree, dtypes):
    if isinstance(tree, dict):
        return {k: _cast_port(v, dtypes[k]) for k, v in tree.items()}
    return tree.to(_TORCH[jnp.dtype(dtypes)])


@functools.lru_cache(maxsize=None)
def pair(arch):
    """(port cfg, JAX cfg, port params, JAX params), both bf16 and equal."""
    jcfg = _bf16(jc.get_smoke_config(arch))
    tcfg = _bf16(tc.get_smoke_config(arch))
    init = jed.init_encdec if jcfg.enc_dec else jtr.init_lm
    key = jax.random.PRNGKey(0)
    cfg32 = jcfg.replace(dtype="float32", param_dtype="float32")
    # jitted: the same draws for both packages, in half the eager time
    tree32 = _perturbed(jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda k: init(cfg32, k))(key)))
    dtypes = jax.tree_util.tree_map_with_path(_bf16_init_dtype, tree32)
    jparams = jax.tree_util.tree_map(lambda a, dt: jnp.asarray(a).astype(dt),
                                     tree32, dtypes)
    tparams = _cast_port(params_from_numpy(tree32, device="cpu"), dtypes)
    return tcfg, jcfg, tparams, jparams


# the leaves the JAX package's bf16 init keeps in f32 (models/mlp_moe.py's
# router, models/mamba2.py's A_log, D and dt_bias)
F32_LEAVES = ("router", "A_log", "D", "dt_bias")


def _bf16_init_dtype(path, _):
    keys = [p.key for p in path]
    return jnp.float32 if any(k in F32_LEAVES for k in keys) else \
        jnp.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_init_dtypes_are_the_references(arch):
    """``pair``'s dtype rule is the JAX package's bf16 init, leaf by leaf,
    and the port's ``init_lm`` / ``init_encdec`` at pdtype bf16 gives the
    same dtypes."""
    jcfg = _bf16(jc.get_smoke_config(arch)).replace(n_repeats=1)
    init = jed.init_encdec if jcfg.enc_dec else jtr.init_lm
    want = jax.eval_shape(lambda: init(jcfg, jax.random.PRNGKey(0)))
    rule = jax.tree_util.tree_map_with_path(_bf16_init_dtype, want)
    assert all(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda sd, dt: jnp.dtype(sd.dtype) == jnp.dtype(dt), want, rule)))
    tcfg = _bf16(tc.get_smoke_config(arch)).replace(n_repeats=1)
    tinit = ted.init_encdec if tcfg.enc_dec else ttr.init_lm
    got = tinit(tcfg, device="cpu")
    flat_want = {k: _TORCH[jnp.dtype(v)] for k, v in _flat(rule).items()}
    assert {k: v.dtype for k, v in _flat(got).items()} == flat_want


def tol(cfg, ref, steps=TOL_STEPS):
    return (BF16_STEP * steps * (cfg.n_layers + 1)
            * float(np.abs(ref).max()))


def _rows(got, want):
    return (got.float().numpy().reshape(-1, want.shape[-1]),
            np.asarray(want, np.float32).reshape(-1, want.shape[-1]))


def assert_logits(cfg, got, want, steps=TOL_STEPS):
    """Within ``tol`` at every position, and greedy tokens equal where
    JAX's top-2 margin exceeds twice it."""
    got, want = _rows(got, want)
    bound = tol(cfg, want, steps)
    assert np.abs(got - want).max() <= bound, (np.abs(got - want).max(),
                                               bound)
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * bound
    assert np.array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


def _f32(tcfg, tree):
    """The port's config and params in f32 (the bf16 values, upcast)."""
    def up(t):
        return {k: up(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.float()
    return tcfg.replace(dtype="float32", param_dtype="float32"), up(tree)


def assert_f32_control(cfg, got32, want):
    """The control: the port computing in f32 lands outside ``tol`` of
    JAX's bf16 logits, so the bound tells a bf16 port from one that skips
    the bf16 roundings."""
    got, want = _rows(got32, want)
    assert np.abs(got - want).max() > tol(cfg, want)


def _tokens(cfg, seed=1, s=S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, s)).astype(np.int32)


def _patches(cfg, seed=2):
    if cfg.frontend != "vision":
        return None
    return (0.02 * np.random.default_rng(seed).normal(
        size=(B, 4, cfg.d_model))).astype(np.float32)


def _j(x, dt=None):
    return None if x is None else jnp.asarray(x if dt is None
                                              else x.astype(dt))


def _t(x, dt=None):
    if x is None:
        return None
    t = torch.from_numpy(np.asarray(x))
    return t if dt is None else t.to(dt)


@pytest.mark.parametrize("arch", DECODERS)
def test_forward_prefill_decode_match_jax(arch):
    """``lm_forward``'s logits, then ``lm_prefill`` and NEW ``lm_decode``
    steps on a contiguous bf16 cache, both packages fed JAX's greedy
    tokens (InternVL2 with its patch rows through ``ext_embeds``)."""
    tcfg, jcfg, tp, jp = pair(arch)
    toks, ext = _tokens(jcfg), _patches(jcfg)
    jext = _j(ext, jnp.bfloat16) if ext is not None else None
    want, _ = nominal(lambda p, t, e: jtr.lm_forward(jcfg, p, t, e))(
        jp, _j(toks), jext)
    with torch.no_grad():
        got, _ = ttr.lm_forward(tcfg, tp, _t(toks),
                                _t(ext, torch.bfloat16))
        c32, p32 = _f32(tcfg, tp)
        e32 = None if ext is None else _t(ext, torch.bfloat16).float()
        got32, _ = ttr.lm_forward(c32, p32, _t(toks), e32)
    assert got.dtype == torch.float32
    assert_logits(tcfg, got, want)
    assert_f32_control(tcfg, got32, want)

    p0 = 0 if ext is None else ext.shape[1]
    max_len = p0 + S + NEW
    jcache = jtr.init_cache(jcfg, B, max_len)
    want, jcache = nominal(lambda p, t, c, e: jtr.lm_prefill(
        jcfg, p, t, c, ext_embeds=e))(jp, _j(toks), jcache, jext)
    tcache = ttr.init_contiguous_cache(tcfg, B, max_len, "cpu")
    assert all(v.dtype == torch.bfloat16 for v in _float_leaves(tcache))
    with torch.no_grad():
        got = ttr.lm_prefill(tcfg, tp, _t(toks), tcache,
                             ext_embeds=_t(ext, torch.bfloat16))
    assert_logits(tcfg, got, want)
    step = nominal(lambda p, t, c, pos: jtr.lm_decode(jcfg, p, t, c, pos))
    for i in range(NEW):
        nxt = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
        pos = np.full((B, 1), p0 + S + i, np.int32)
        want, jcache = step(jp, _j(nxt), jcache, _j(pos))
        with torch.no_grad():
            got = ttr.lm_decode(tcfg, tp, _t(nxt), tcache, _t(pos))
        assert_logits(tcfg, got, want, DECODE_TOL_STEPS)


def _float_leaves(tree, key=""):
    """A cache's float leaves but mamba's recurrent "state", which stays
    f32 in the JAX package too."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _float_leaves(v, k)
    elif tree.is_floating_point() and key != "state":
        yield tree


def test_whisper_encdec_prefill_decode_match_jax():
    arch = "whisper-medium"
    tcfg, jcfg, tp, jp = pair(arch)
    rng = np.random.default_rng(3)
    frames = (0.5 * rng.normal(size=(B, 24, jcfg.d_model))).astype(np.float32)
    toks = _tokens(jcfg, s=6)
    jcache = jed.encdec_init_cache(jcfg, B, 6 + NEW, 24)
    want, jcache = nominal(lambda p, f, t, c: jed.encdec_prefill(
        jcfg, p, f, t, c))(jp, _j(frames, jnp.bfloat16), _j(toks), jcache)
    tcache = ted.encdec_init_cache(tcfg, B, 6 + NEW, 24, device="cpu")
    with torch.no_grad():
        got = ted.encdec_prefill(tcfg, tp, _t(frames, torch.bfloat16),
                                 _t(toks), tcache)
        c32, p32 = _f32(tcfg, tp)
        got32 = ted.encdec_prefill(
            c32, p32, _t(frames, torch.bfloat16).float(), _t(toks),
            ted.encdec_init_cache(c32, B, 6 + NEW, 24, device="cpu"))
    assert_logits(tcfg, got, want)
    assert_f32_control(tcfg, got32, want)
    step = nominal(lambda p, t, c, pos: jed.encdec_decode(jcfg, p, t, c,
                                                          pos))
    for i in range(NEW):
        nxt = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
        pos = np.full((B, 1), 6 + i, np.int32)
        want, jcache = step(jp, _j(nxt), jcache, _j(pos))
        with torch.no_grad():
            got = ted.encdec_decode(tcfg, tp, _t(nxt), tcache, _t(pos))
        assert_logits(tcfg, got, want, DECODE_TOL_STEPS)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_loss_and_grads_match_jax(arch):
    """One train step at pdtype bf16 with the config's remat: the loss
    within the logits' bound, every gradient leaf within GRAD_TOL_STEPS
    per layer of its norm (a floor of 1e-2 of the largest leaf's norm
    covers leaves whose gradient vanishes, as a key bias's does under
    softmax); the control: the f32 port's median leaf farther from JAX's
    gradients than the bf16 port's."""
    tcfg, jcfg, tp, jp = pair(arch)
    rng = np.random.default_rng(4)
    toks = _tokens(jcfg, seed=5, s=8)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if jcfg.enc_dec:
        batch["frames"] = (0.5 * rng.normal(size=(B, 16, jcfg.d_model))
                           ).astype(np.float32)
    ext = _patches(jcfg)
    if ext is not None:
        batch["ext_embeds"] = ext
    loss_j = jed.encdec_loss if jcfg.enc_dec else jtr.lm_loss
    loss_t = ted.encdec_loss if tcfg.enc_dec else ttr.lm_loss
    jb = {k: _j(v, jnp.bfloat16) if v.dtype == np.float32 else _j(v)
          for k, v in batch.items()}
    tb = {k: _t(v, torch.bfloat16) if v.dtype == np.float32 else _t(v)
          for k, v in batch.items()}
    (jl, _), jg = nominal(jax.value_and_grad(
        lambda p: loss_j(jcfg, p, jb), has_aux=True))(jp)
    tl, _, tg = _grads_of(tcfg, loss_t, tp, tb)
    bound = BF16_STEP * TOL_STEPS * (tcfg.n_layers + 1)
    assert abs(float(tl) - float(jl)) <= bound * max(1.0, abs(float(jl)))
    jflat = {k: np.asarray(v.astype(jnp.float32))
             for k, v in _flat(jg).items()}
    tflat = _flat(tg)
    assert set(jflat) == set(tflat)
    assert all(tflat[k].dtype == _flat(tp)[k].dtype for k in tflat)
    # each leaf's distance from JAX's, in bf16 steps per layer of its norm
    unit = BF16_STEP * (tcfg.n_layers + 1)
    floor = 1e-2 * max(np.linalg.norm(v) for v in jflat.values())

    def steps(flat):
        return np.array([np.linalg.norm(flat[k].float().numpy() - jflat[k])
                         / (unit * (np.linalg.norm(jflat[k]) + floor))
                         for k in jflat])

    got = steps(tflat)
    assert got.max() <= GRAD_TOL_STEPS, \
        [k for k, g in zip(jflat, got) if g > GRAD_TOL_STEPS]
    c32, p32 = _f32(tcfg, tp)
    tb32 = {k: v.float() if v.is_floating_point() else v
            for k, v in tb.items()}
    _, _, tg32 = _grads_of(c32, loss_t, p32, tb32)
    assert np.median(steps(_flat(tg32))) > np.median(got)

def test_packed_w4_forward_matches_jax_kernel_path(monkeypatch):
    """llama3.2-1b SMOKE at bf16, every linear RTN W4 g32 packed by both
    packages (equal bytes): the port's kernels read the bf16 activations
    as they are; the JAX side runs its Pallas kernel path."""
    monkeypatch.setenv("REPRO_DEQUANT_IMPL", "pallas")
    arch = "llama3.2-1b"
    tcfg, jcfg, tp, jp = pair(arch)
    tq = quantize_params_for_serving(tcfg.replace(serve_quant_bits=4,
                                                  serve_quant_group=32), tp,
                                     device="cpu")
    jq = jquant(jcfg.replace(serve_quant_bits=4, serve_quant_group=32), jp)
    toks = _tokens(jcfg)
    want, _ = nominal(lambda p, t: jtr.lm_forward(jcfg, p, t))(jq,
                                                                 _j(toks))
    with torch.no_grad():
        got, _ = ttr.lm_forward(tcfg, tq, _t(toks))
    assert_logits(tcfg, got, want)


def test_make_train_step_keeps_bf16_params():
    """The port's ``make_train_step`` at pdtype bf16 with remat: the step's
    loss is the gradients' loss, bf16 params stay bf16 (and f32 leaves
    f32), Adam's moments are f32, and every param moved (the first Adam
    step moves each by about the learning rate, 1e-2: above half a bf16
    step of the norm scales near 1, which 1e-3 would not be)."""
    tcfg, _, tp, _ = pair("llama3.2-1b")
    toks = _tokens(tcfg, seed=5, s=8)
    tb = {"tokens": _t(toks), "labels": _t(np.roll(toks, -1, axis=1))}
    tl, _, _ = _grads_of(tcfg, ttr.lm_loss, tp, tb)
    step = make_train_step(tcfg, lr_schedule=schedules.constant(1e-2))
    opt = init_opt_state(tcfg, tp)
    new, opt, metrics = step(tp, opt, tb, 0)
    assert float(metrics["loss"]) == float(tl)
    for k, leaf in _flat(new).items():
        assert leaf.dtype == _flat(tp)[k].dtype
        assert not torch.equal(leaf, _flat(tp)[k])
    assert all(m.dtype == torch.float32
               for m in _flat(opt["adam"]["m"]).values())
