"""The paper's plugin on whisper: ``norm_tweak_ptq_encdec`` (the encoder's
layers tweaked on the frame stream, then the decoder's on the token
stream with its cross-attention on the quantized encoder's output) in the
port against the JAX package on the SMOKE config, with RTN W4 + NT, GPTQ
W4 + NT and SmoothQuant W4A8 + NT, on the same seeded weights (LayerNorm
biases and scales set from a numpy seed) and calibration (seeded frames
and random tokens). Every LayerNorm leaf the tweak moves is held: ln1 and
ln2 of both stacks and the decoder's lnx, γ ("scale") and β ("bias").

Two behaviours of the reference are pinned: its tweak runs every block
causally, the encoder's too, and its tweak loss runs a decoder block
without the encoder output. Running the encoder non-causally in the
pipeline, or passing the encoder output into the loss, moves the norms
away from the JAX package's."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.normtweak import pipeline as jpipe
from repro.models import encdec as jed
from repro.models.blocks import apply_block as japply
from repro.models.norms import apply_norm as japply_norm
from repro.models.rope import sinusoidal_positions as jsinus
from repro.models.transformer import _embed as jembed
from repro.models.transformer import get_block as jget
import repro_torch.core.quant.types as tt
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.core.normtweak import pipeline as tpipe
from repro_torch.core.quant import blockquant as tbq
from repro_torch.kernels import ops
from repro_torch.models import encdec as ted
from repro_torch.models.blocks import apply_block
from repro_torch.models.transformer import get_block
from repro_torch.utils.tree import tree_get
from test_torch_dense_variants_pipeline import _code_diff, _objective
from test_torch_encdec import JCFG, TCFG, perturbed_encdec_numpy, to_jax

N_SAMPLES, S_ENC, SEQ = 8, 24, 16
NT_KW = dict(lr0=1e-3, iters=1, sample_batch=4, bits=4, group_size=32)
ENC_LINEARS = ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/wi",
               "mlp/wo")
DEC_LINEARS = ENC_LINEARS + ("xattn/wq", "xattn/wk", "xattn/wv",
                             "xattn/wo")
LEAVES = ("scale", "bias")
N_ENC = JCFG.n_enc_repeats
METHODS = {"rtn": 0, "gptq": 0, "smoothquant": 8}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (GPTQ's row loop issues many small ops; see
    tests/test_torch_normtweak.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.fixture(scope="module")
def setup():
    tree = perturbed_encdec_numpy(JCFG)
    rng = np.random.default_rng(7)
    frames = (0.3 * rng.normal(size=(N_SAMPLES, S_ENC, JCFG.d_model))
              ).astype(np.float32)
    tokens = rng.integers(0, JCFG.vocab_size, (N_SAMPLES, SEQ))
    return {"tree": tree, "frames": frames, "tokens": tokens, "jax": {}}


def _nt(method, **kw):
    return dict(method=method, act_bits=METHODS[method], **NT_KW, **kw)


def _jax_run(setup, method):
    """The JAX package's pipeline, once per method for the module."""
    if method not in setup["jax"]:
        setup["jax"][method] = jpipe.norm_tweak_ptq_encdec(
            JCFG, to_jax(setup["tree"]), jnp.asarray(setup["frames"]),
            jnp.asarray(setup["tokens"]),
            jpipe.NTConfig(**_nt(method)))
    return setup["jax"][method]


def _port_run(setup, method, monkeypatch, **kw):
    """The port's pipeline on the JAX CPU path's function for packed
    linears (f32 x times the f32 dequantized weight; the JAX package cannot
    differentiate its kernel)."""
    monkeypatch.setattr(ops, "dequant_matmul",
                        lambda x, qt: torch.matmul(x, tt.dequantize(qt)))
    return tpipe.norm_tweak_ptq_encdec(
        TCFG, params_from_numpy(setup["tree"], device="cpu"),
        torch.from_numpy(setup["frames"]), torch.from_numpy(setup["tokens"]),
        tpipe.NTConfig(**_nt(method, **kw)))


def _blocks(cfg, q, li):
    """Layer li of the joined order (encoder first) of a quantized tree
    (the port's, or the JAX package's as numpy)."""
    sub, i = ("enc", li) if li < N_ENC else ("dec", li - N_ENC)
    part = ted.enc_config(cfg) if sub == "enc" else ted.dec_config(cfg)
    if isinstance(cfg, type(TCFG)):
        return get_block(part, q[sub], i)
    return _np(jget(part, q[sub], i))


def _norm_err(tq, jq, li, lr):
    """Per norm and leaf of layer li, |port - JAX| in units of lr."""
    tb, jb = _blocks(TCFG, tq, li), _blocks(JCFG, jq, li)
    return {f"{norm}/{leaf}": np.abs(tb[norm][leaf].numpy()
                                     - jb[norm][leaf]) / lr
            for norm in ("ln1", "lnx", "ln2") if norm in tb
            for leaf in LEAVES}


def _enc_layer0_taps(setup):
    """The encoder's layer-0 calibration inputs, as the port's pipeline
    sees them (a causal apply of the float block on the frame stream)."""
    x = setup["frames"] + np.asarray(jsinus(S_ENC, JCFG.d_model))[None]
    pos = np.broadcast_to(np.arange(S_ENC, dtype=np.int32),
                          (N_SAMPLES, S_ENC)).copy()
    ecfg = ted.enc_config(TCFG)
    block = params_from_numpy(
        _np(jget(jed.enc_config(JCFG), to_jax(setup["tree"]["enc"]), 0)),
        device="cpu")
    taps = {}
    apply_block(ecfg, block, torch.from_numpy(x), taps=taps,
                positions=torch.from_numpy(pos))
    return taps


@pytest.mark.parametrize("method", list(METHODS))
def test_pipeline_matches_jax(setup, method, monkeypatch):
    """``norm_tweak_ptq_encdec`` on the whole model in both packages, each
    on its own quantized streams; tests/test_torch_dense_variants_pipeline
    .py's bars. The layer lrs are equal (Eq. 3 over the 4 layers as one
    depth, the decoder's from layer 2 on).

    RTN W4: every layer's packed linears, the decoder's cross-attention
    included, >= 99.9% of codes equal and none more than a step apart; the
    tweaked γ and β of ln1, ln2 and lnx within 1e-2 lr of JAX's; the
    losses within 1e-3.

    SmoothQuant W4A8 (RTN after the fold) to the same bars on the encoder's
    layers, whose streams the two packages share to the last bits, and on
    the codes of the decoder's first layer. Past the encoder the two
    streams part: W4A8's per-token int8 rounding turns the encoder
    output's last-bit difference into whole int8 steps of the cross
    K/V's inputs (measured: the decoder's layers 0 and 1 norms 0.26 and
    0.86 lr apart, layer 1's smoothing and so 0.6% of its codes set
    apart), as tests/test_torch_mamba_pipeline.py found for Jamba. The
    decoder's tweak is held on equal inputs instead, in
    ``test_tweak_matches_jax_layer_by_layer``.

    GPTQ W4 runs its row loop in f32 in the JAX package and in f64 in the
    port, so flips set the streams apart after layer 0: layer 0 (the
    encoder's first) keeps >= 99% of its codes equal and the GPTQ
    objective within 1% of JAX's, its loss within 5% and its γ and β
    within a mean of 0.5 lr."""
    act_bits = METHODS[method]
    jq, jstats = _jax_run(setup, method)
    tq, tstats = _port_run(setup, method, monkeypatch)
    assert tstats["layer_lr"] == jstats["layer_lr"]
    assert len(tstats["layer_lr"]) == N_ENC + JCFG.n_repeats
    layers = range(len(tstats["layer_lr"]))
    tweak_layers_held = layers
    if method == "smoothquant":
        tweak_layers_held = range(N_ENC)
        layers = range(N_ENC + 1)
        np.testing.assert_allclose(tstats["layer_loss"][:N_ENC],
                                   jstats["layer_loss"][:N_ENC], rtol=1e-3)
    elif method == "gptq":
        layers = [0]
        taps = _enc_layer0_taps(setup)
        np.testing.assert_allclose(tstats["layer_loss"][0],
                                   jstats["layer_loss"][0], rtol=5e-2)
    else:
        np.testing.assert_allclose(tstats["layer_loss"],
                                   jstats["layer_loss"], rtol=1e-3)
    for li in layers:
        lr = tstats["layer_lr"][li]
        tb, jb = _blocks(TCFG, tq, li), _blocks(JCFG, jq, li)
        for path in ENC_LINEARS if li < N_ENC else DEC_LINEARS:
            tw, jw = tree_get(tb, path)["w"], tree_get(jb, path)["w"]
            assert isinstance(tw, tt.QuantizedTensor)
            assert tw.act_bits == act_bits
            diff = _code_diff(tw, jw)
            if method == "gptq":
                assert (diff == 0).mean() >= 0.99, path
                enc0 = _np(jget(jed.enc_config(JCFG),
                                to_jax(setup["tree"]["enc"]), 0))
                obj = _objective(taps[tbq.tap_key_for(path)], tw, jw,
                                 tree_get(enc0, path)["w"])
                assert abs(obj[0] - obj[1]) <= 1e-2 * obj[1], (path, obj)
            else:
                assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, path
        if li not in tweak_layers_held:
            continue
        for key, err in _norm_err(tq, jq, li, lr).items():
            if method == "gptq":
                assert err.mean() <= 0.5, key
            else:
                assert err.max() <= 1e-2, (li, key, err.max())


@pytest.mark.parametrize("method", ["gptq", "smoothquant"])
def test_tweak_matches_jax_layer_by_layer(setup, method, monkeypatch):
    """Both packages tweak the same quantized blocks (the JAX package's
    untweaked ones, ``quantize_block`` replaced in both pipelines), layer
    by layer on the same inputs: the JAX package's tweaked stream, and for
    the decoder's layers the JAX package's encoder output. ln1, ln2 and
    lnx move the same channels, within 1e-3 lr of JAX's, each by more
    than 0.5 lr somewhere; the layer's loss agrees to 1e-4."""
    act_bits = METHODS[method]
    kw = _nt(method)
    jcfgs = (jed.enc_config(JCFG), jed.dec_config(JCFG))
    tcfgs = (ted.enc_config(TCFG), ted.dec_config(TCFG))
    untweaked, _ = jpipe.norm_tweak_ptq_encdec(
        JCFG, to_jax(setup["tree"]), jnp.asarray(setup["frames"]),
        jnp.asarray(setup["tokens"]), jpipe.NTConfig(**_nt(method,
                                                           tweak=False)))
    monkeypatch.setattr(ops, "dequant_matmul",
                        lambda x, qt: torch.matmul(x, tt.dequantize(qt)))
    total = N_ENC + JCFG.n_repeats
    x = jnp.asarray(setup["frames"]) + jsinus(S_ENC, JCFG.d_model)[None]
    enc_out = None
    for li in range(total):
        half = int(li >= N_ENC)
        sub, i = ("enc", "dec")[half], li - N_ENC * half
        if li == N_ENC:
            enc_out = japply_norm(jcfgs[0],
                                  to_jax(setup["tree"]["enc"]["final_norm"]),
                                  x)
            pos = jnp.broadcast_to(jnp.arange(SEQ, dtype=jnp.int32)[None],
                                   (N_SAMPLES, SEQ))
            x = jembed(jcfgs[1], to_jax(setup["tree"]["dec"]),
                       jnp.asarray(setup["tokens"]), None, pos)
        qb = _np(jget(jcfgs[half], untweaked[sub], i))
        fb = _np(jget(jcfgs[half], to_jax(setup["tree"][sub]), i))
        monkeypatch.setattr(jpipe, "quantize_block",
                            lambda *a, **k: to_jax(qb))
        monkeypatch.setattr(tpipe, "quantize_block",
                            lambda *a, **k: params_from_numpy(
                                qb, device="cpu"))
        (jb,), x_next, jstats = jpipe.tweak_layers(
            jcfgs[half], [jcfgs[half].pattern[0]], [to_jax(fb)], x,
            jpipe.NTConfig(**kw), enc_out=enc_out, layer_offset=li,
            total_layers=total)
        (tb,), _, tstats = tpipe.tweak_layers(
            tcfgs[half], [params_from_numpy(fb, device="cpu")],
            torch.from_numpy(np.array(x)), tpipe.NTConfig(**kw),
            enc_out=(None if enc_out is None
                     else torch.from_numpy(np.array(enc_out))),
            layer_offset=li, total_layers=total)
        assert tstats["layer_lr"] == jstats["layer_lr"]
        np.testing.assert_allclose(tstats["layer_loss"],
                                   jstats["layer_loss"], rtol=1e-4)
        lr = tstats["layer_lr"][0]
        jb = _np(jb)
        for norm in ("ln1", "lnx", "ln2"):
            if norm not in qb:
                continue
            for leaf in LEAVES:
                jd = jb[norm][leaf] - qb[norm][leaf]
                td = tb[norm][leaf].numpy() - qb[norm][leaf]
                np.testing.assert_array_equal(td != 0, jd != 0)
                assert np.abs(td - jd).max() <= 1e-3 * lr, (li, norm, leaf)
                assert np.abs(jd).max() > 0.5 * lr, (li, norm, leaf)
        x = x_next


def _lnx_and_enc_err(tq, jq, stats):
    """The largest |port - JAX| in units of lr over the encoder's norms
    and over the decoder's norms."""
    enc = max(err.max() for li in range(N_ENC)
              for err in _norm_err(tq, jq, li, stats["layer_lr"][li])
              .values())
    dec = max(err.max() for li in range(N_ENC, N_ENC + JCFG.n_repeats)
              for err in _norm_err(tq, jq, li, stats["layer_lr"][li])
              .values())
    return enc, dec


def test_encoder_tweaked_as_a_causal_stack(setup, monkeypatch):
    """The reference's tweak applies every block with mode "train", so the
    encoder's float stream, taps, qX advance and tweak loss are causal,
    while ``encode`` is not. The port matches (RTN + NT: its encoder norms
    within 1e-2 lr of JAX's, as above); the same pipeline with the encoder
    blocks run non-causally moves them by more than 0.1 lr."""
    jq, _ = _jax_run(setup, "rtn")
    tq, stats = _port_run(setup, "rtn", monkeypatch)
    assert _lnx_and_enc_err(tq, jq, stats)[0] <= 1e-2

    def non_causal_encoder(cfg, bp, x, **kw):
        return apply_block(cfg, bp, x, causal="xattn" in bp, **kw)

    monkeypatch.setattr(tpipe, "apply_block", non_causal_encoder)
    tq, stats = _port_run(setup, "rtn", monkeypatch)
    assert _lnx_and_enc_err(tq, jq, stats)[0] > 0.1


def test_tweak_loss_runs_the_decoder_without_the_encoder(setup,
                                                          monkeypatch):
    """The reference's tweak loss calls ``apply_block`` without
    ``enc_out``: a decoder block's cross sub-layer then attends
    (non-causally) over its own normed input through the xattn weights,
    while fOut, the taps and the qX advance read the encoder output. The
    port matches (RTN + NT: its decoder norms, lnx included, within 1e-2
    lr of JAX's); the same pipeline with each chunk's encoder output
    passed into the loss moves them by more than 0.1 lr."""
    jq, _ = _jax_run(setup, "rtn")
    tq, stats = _port_run(setup, "rtn", monkeypatch)
    assert _lnx_and_enc_err(tq, jq, stats)[1] <= 1e-2

    real_layers, real_update = tpipe.tweak_layers, tpipe._tweak_update
    enc = {}

    def tweak_layers(*a, enc_out=None, **kw):
        enc["out"], enc["at"] = enc_out, 0
        return real_layers(*a, enc_out=enc_out, **kw)

    def tweak_update(cfg, loss_name, norms, rest, opt_state, x, *a):
        if enc["out"] is None:
            return real_update(cfg, loss_name, norms, rest, opt_state, x, *a)
        n, s0 = enc["out"].shape[0], enc["at"]
        enc["at"] = (s0 + x.shape[0]) % n
        with monkeypatch.context() as m:
            m.setattr(tpipe, "apply_block", functools.partial(
                apply_block, enc_out=enc["out"][s0:s0 + x.shape[0]]))
            return real_update(cfg, loss_name, norms, rest, opt_state, x,
                               *a)

    monkeypatch.setattr(tpipe, "tweak_layers", tweak_layers)
    monkeypatch.setattr(tpipe, "_tweak_update", tweak_update)
    tq, stats = _port_run(setup, "rtn", monkeypatch)
    enc_err, dec_err = _lnx_and_enc_err(tq, jq, stats)
    assert enc_err <= 1e-2 and dec_err > 0.1


def test_smoothquant_smooths_only_xattn_wq_from_lnx(setup):
    """SmoothQuant on a whisper decoder block: the ("lnx", ["xattn/wq"])
    row folds lnx into xattn/wq alone; xattn/wk and xattn/wv read the
    encoder output and keep their float rows; the folded leaves equal the
    JAX package's to 1e-6 relative."""
    from repro.core.quant import blockquant as jbq

    dcfg, jdcfg = ted.dec_config(TCFG), jed.dec_config(JCFG)
    block = _np(jget(jdcfg, to_jax(setup["tree"]["dec"]), 0))
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, SEQ, JCFG.d_model))).astype(np.float32)
    enc_out = (rng.normal(size=(2, S_ENC, JCFG.d_model))).astype(np.float32)
    pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32), (2, SEQ)).copy()
    jtaps, ttaps = {}, {}
    spec = jdcfg.pattern[0]
    japply(jdcfg, spec, to_jax(block), jnp.asarray(x),
           positions=jnp.asarray(pos), enc_out=jnp.asarray(enc_out),
           taps=jtaps)
    apply_block(dcfg, params_from_numpy(block, device="cpu"),
                torch.from_numpy(x), positions=torch.from_numpy(pos),
                enc_out=torch.from_numpy(enc_out), taps=ttaps)
    assert sorted(ttaps) == sorted(jtaps)
    np.testing.assert_array_equal(ttaps["xattn/wk"].numpy(), enc_out)
    jb = jbq.smooth_block(to_jax(block), jtaps, 0.5)
    tb = tbq.smooth_block(params_from_numpy(block, device="cpu"), ttaps, 0.5)
    for leaf in LEAVES:
        np.testing.assert_allclose(tb["lnx"][leaf].numpy(),
                                   np.asarray(jb["lnx"][leaf]), rtol=1e-6,
                                   atol=0)
        assert not np.allclose(tb["lnx"][leaf].numpy(), block["lnx"][leaf])
    np.testing.assert_allclose(tb["xattn"]["wq"]["w"].numpy(),
                               np.asarray(jb["xattn"]["wq"]["w"]),
                               rtol=1e-6, atol=0)
    assert not np.allclose(tb["xattn"]["wq"]["w"].numpy(),
                           block["xattn"]["wq"]["w"])
    for name in ("wk", "wv", "wo"):
        np.testing.assert_array_equal(tb["xattn"][name]["w"].numpy(),
                                      block["xattn"][name]["w"])
