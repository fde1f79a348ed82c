"""Kernels 7 (channel statistics) and 6 (quantize-pack) on the CPU: their
planners (``kernels/channel_stats.py::plan_stats``,
``kernels/quantize_pack.py::plan_pack``) against the constants and launch
rules of ``csrc/channel_stats.cu`` and ``csrc/quantize_pack.cu``, and a
plain PyTorch emulation of each kernel's work split.

Kernel 7's emulation follows the kernel's order of sums: every rank of a
strip's cluster takes every ranks-th stage, each row thread its rows of a
stage as one tile (two-pass, shifted by row 0), merged into the thread's
partial by Chan's formula in a frame (the first tile's mean) plus an
offset; then the row threads pairwise in a fixed tree, then the ranks in
rank order. It is held against the JAX package's reference, the JAX
loss's statistics and its Pallas kernel in interpret mode. Kernel 6's
emulation walks the tiles as the grid does and writes the packed bytes
run by run, on the vector or the scalar path; it is held byte for byte to
the JAX reference and the Pallas kernel in interpret mode.

The CUDA kernels run only on the card (tests/test_torch_cuda.py,
chip_smoke.py); the sources' constants are read from the ``.cu`` files.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.normtweak import losses as jl
from repro.core.quant import types as jt
from repro.kernels import ref as jref
from repro.kernels.channel_stats import channel_stats_pallas
from repro.kernels.quantize import quantize_pack_pallas
from repro_torch.core.quant.types import pack_layout, packed_rows
from repro_torch.kernels import channel_stats as cs
from repro_torch.kernels import quantize_pack as qp
from repro_torch.kernels import ref
from repro_torch.kernels.packed_operands import MAX_SMEM, SMS

CSRC = Path(cs.__file__).resolve().parent / "csrc"
STATS_SRC = (CSRC / "channel_stats.cu").read_text()
PACK_SRC = (CSRC / "quantize_pack.cu").read_text()
# the SM's shared memory (228 KB) and what the card keeps of it per block
SM_SMEM, BLOCK_RESERVED = 233472, 1024
F32 = torch.float32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: several test processes share the cores, and
    their thread pools would contend for them (see
    tests/test_torch_normtweak.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


# ------------------------------------------------------------- planners

def test_stats_constants_are_the_kernels():
    for name in ("THREADS", "STRIP", "TILE", "STAGES", "MAX_RANKS", "SLOT"):
        assert getattr(cs, name) == _const(STATS_SRC, name), name
    assert cs.MAX_RANKS == 8                     # the portable cluster size
    for line in (
            "constexpr int STAGE_BYTES = TILE * THREADS * SLOT;",
            "constexpr int SMEM = STAGES * STAGE_BYTES;",
            "constexpr int CH = SLOT / (int)sizeof(T);",
            "constexpr int LANES = STRIP / CH;",
            "constexpr int RT = THREADS / LANES;",
            "constexpr int STAGE_ROWS = RT * TILE;",
            "const int stages = (all_stages - rank + ranks - 1) / ranks;",
            "return (long long)(rank + s * ranks) * STAGE_ROWS + ty;",
            "const int stage_rows = THREADS / (STRIP / width) * TILE;",
            "(long long)(ranks - 1) * stage_rows >= T_rows ||"):
        assert line in STATS_SRC, line


@pytest.mark.parametrize("bf16", [False, True])
def test_stats_shared_memory_fits(bf16):
    """Two blocks an SM fit the ring, and the row threads' partials (four
    f32 a channel) fit in the ring they reuse."""
    smem = cs.STAGES * cs.TILE * cs.THREADS * cs.SLOT
    assert smem <= MAX_SMEM
    assert 2 * (smem + BLOCK_RESERVED) <= SM_SMEM
    rt = cs.THREADS // (cs.STRIP // cs.width(bf16))
    assert 4 * rt * cs.STRIP * 4 <= smem
    assert cs.plan_stats(1, 1, bf16).stage_rows == rt * cs.TILE


# (T, C): the tweak step's 16,384 x 2048 and the 128 x 2048 calibration
# set, TINY's d 192, ragged and tiny shapes, wide C
STATS_PLAN_SHAPES = [(16384, 2048), (262144, 2048), (320, 192), (1000, 70),
                     (257, 33), (1, 5), (5, 1), (129, 6), (4097, 1030),
                     (3000, 2047), (40, 8192), (100000, 96)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("t,c", STATS_PLAN_SHAPES)
def test_stats_plan_rules(t, c, bf16):
    p = cs.plan_stats(t, c, bf16)
    assert p.strips == -(-c // cs.STRIP)
    assert p.stages == -(-t // p.stage_rows)
    assert 1 <= p.ranks <= min(cs.MAX_RANKS, p.stages)
    # what the C entry point takes: every rank has a stage
    assert (p.ranks - 1) * p.stage_rows < t
    if p.ranks < min(cs.MAX_RANKS, p.stages):
        assert p.ranks * p.strips >= cs.TARGET_BLOCKS    # target reached
    if p.ranks > 1:
        assert (p.ranks - 1) * p.strips < cs.TARGET_BLOCKS   # not past it


def test_stats_plan_main_cases():
    """A tweak step's (16384, 2048) and the calibration set's (262144,
    2048): 32 strips of 3 ranks, 96 blocks (tools/stats_pack_sweep.py)."""
    assert cs.TARGET_BLOCKS == SMS // 2
    for t, bf16 in ((16384, False), (262144, False), (16384, True)):
        p = cs.plan_stats(t, 2048, bf16)
        assert (p.strips, p.ranks) == (32, 3)
    with pytest.raises(ValueError, match="empty"):
        cs.plan_stats(0, 8, False)


def test_stats_vector_rule():
    assert cs.width(False) == 4 and cs.width(True) == 8
    assert cs.vector_ok(2048, False, 1 << 20)
    assert not cs.vector_ok(70, False, 1 << 20)       # C % 4
    assert not cs.vector_ok(1028, True, 1 << 20)      # C % 8
    assert not cs.vector_ok(2048, False, (1 << 20) + 4)   # off 16 bytes


def test_pack_constants_are_the_kernels():
    for name in ("QUADS", "RUNS", "COLS", "RUN_ROWS"):
        assert getattr(qp, name) == _const(PACK_SRC, name), name
    for line in (
            "constexpr int RUN = RUN_ROWS / VALUES;",
            "const int quad_blocks = (N + QUADS * COLS - 1) / (QUADS * COLS);",
            "const int run_blocks = (packed_groups + RUN * RUNS - 1) / "
            "(RUN * RUNS);",
            "const int n = (qb * QUADS + (int)threadIdx.x) * COLS;",
            "const int p0 = (rb * RUNS + (int)threadIdx.y) * RUN;"):
        assert line in PACK_SRC, line
    # a W3 word (8 values) fits a run: every width has a whole packed
    # group a run
    for bits in (2, 3, 4, 8):
        assert qp.RUN_ROWS % pack_layout(bits)[1] == 0


# (B, K, N): serve_w4's deploy stack (the main case), a Mixtral expert
# stack, llama's single weights, K = 2050, K = 100, odd N
PACK_PLAN_SHAPES = [(16, 2048, 8192), (8, 6144, 16384), (1, 2048, 8192),
                    (1, 2048, 2048), (1, 2050, 512), (1, 768, 512),
                    (2, 100, 24), (3, 64, 33), (1, 8, 1)]


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("b,k,n", PACK_PLAN_SHAPES)
def test_pack_plan_rules(b, k, n, bits):
    p = qp.plan_pack(b, k, n, bits)
    values = pack_layout(bits)[1]
    pg = -(-k // values)
    assert p.run * values == qp.RUN_ROWS
    assert (p.run_blocks - 1) * qp.RUNS * p.run < pg <= (
        p.run_blocks * qp.RUNS * p.run)
    assert (p.quad_blocks - 1) * qp.QUADS * qp.COLS < n <= (
        p.quad_blocks * qp.QUADS * qp.COLS)
    assert p.tiles == b * p.run_blocks * p.quad_blocks
    assert p.blocks == min(p.tiles, qp.GRID_BLOCKS)


def test_pack_plan_main_case():
    """serve_w4's deploy of the (16, 2048, 8192) W4 g128 stack: 32,768
    tiles walked by 16 blocks an SM."""
    assert qp.GRID_BLOCKS == 16 * SMS
    p = qp.plan_pack(16, 2048, 8192, 4)
    assert (p.run, p.quad_blocks, p.run_blocks) == (4, 64, 32)
    assert (p.tiles, p.blocks) == (32768, 2112)


# ------------------------------------------------- kernel 7, emulated

def _f(v):
    return torch.tensor(v, dtype=F32)


def _merge(a, b):
    """csrc/channel_stats.cu::chan_merge: (n, frame, off, m2) partials,
    b into a in a's frame."""
    n_a, f_a, o_a, q_a = a
    n_b, f_b, o_b, q_b = b
    if float(n_b) == 0.0:
        return a
    if float(n_a) == 0.0:
        return b
    n = n_a + n_b
    frac = n_b / n
    delta = (f_b - f_a) + (o_b - o_a)
    return (n, f_a, o_a + delta * frac,
            q_a + (q_b + delta * delta * n_a * frac))


def stats_walk(x):
    """What kernel 7 computes, in its order, in plain PyTorch (f32): the
    plan's ranks, each row thread's tiles through Chan merges in a frame
    plus an offset, the row threads pairwise, the ranks in rank order.
    Also counts how often each row is read (must be once)."""
    t, c = x.shape
    bf16 = x.dtype == torch.bfloat16
    p = cs.plan_stats(t, c, bf16)
    rt = p.stage_rows // cs.TILE
    xf = x.to(F32)
    shift = xf[0]
    seen = torch.zeros(t, dtype=torch.int64)
    zero = torch.zeros(c)
    blocks = []
    for rank in range(p.ranks):
        threads = []
        for ty in range(rt):
            part = (_f(0.0), zero, zero, zero)
            for g in range(rank, p.stages, p.ranks):
                r = g * p.stage_rows + ty
                rows = [r + i * rt for i in range(cs.TILE) if r + i * rt < t]
                if not rows:
                    continue
                seen[rows] += 1
                tm = zero
                for row in rows:
                    tm = tm + (xf[row] - shift)
                tm = tm * (_f(1.0) / _f(len(rows)))
                dev = zero
                for row in rows:
                    d = (xf[row] - shift) - tm
                    dev = dev + d * d
                n, frame, off, m2 = part
                fc = _f(len(rows))
                if float(n) == 0.0:
                    part = (fc, tm, zero, dev)
                else:
                    nn = n + fc
                    frac = fc / nn
                    wgt = n * frac
                    delta = (tm - frame) - off
                    part = (nn, frame, off + delta * frac,
                            m2 + (dev + delta * delta * wgt))
            threads.append(part)
        step = 1
        while step < rt:
            for a in range(0, rt, 2 * step):
                threads[a] = _merge(threads[a], threads[a + step])
            step *= 2
        blocks.append(threads[0])
    acc = blocks[0]
    for part in blocks[1:]:
        acc = _merge(acc, part)
    _, frame, off, m2 = acc
    return shift + (frame + off), m2 / _f(t), seen


def _x(t, c, seed, mean=1.0, std=3.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(t, c)) * std + mean).astype(np.float32)


def _hold(mu, var, m_ref, v_ref):
    """chip_smoke.py's limits: the mean within 1e-6 of max(|mean|, std)
    and the variance within 1e-5 relative, each channel."""
    m_ref = np.asarray(m_ref, dtype=np.float64)
    v_ref = np.asarray(v_ref, dtype=np.float64)
    scale = np.maximum(np.abs(m_ref), np.sqrt(v_ref))
    assert np.all(np.abs(mu.numpy() - m_ref) <= 1e-6 * scale + 1e-30)
    assert np.all(np.abs(var.numpy() - v_ref) <= 1e-5 * v_ref + 1e-30)


# (T, C, mean, std): one row; T under one thread tile and under one stage;
# T not a multiple of a stage (f32 128 rows, bf16 256), over 8 ranks and
# several stages a rank; C not a multiple of the vector width (4 f32, 8
# bf16); a mean of 1e3 at std 1, where one-pass sums fail
STATS_CASES = [(1, 5, 0.5, 1.0), (5, 9, 0.5, 1.0), (100, 33, 1.0, 3.0),
               (1000, 70, 0.5, 1.0), (2500, 12, -2.0, 0.5),
               (4096, 48, 1e3, 1.0)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("t,c,mean,std", STATS_CASES)
def test_stats_walk_matches_jax(t, c, mean, std, bf16):
    """The emulated order against the JAX reference, the JAX loss's
    statistics and the port's plain version, within chip_smoke.py's
    limits; every row read exactly once."""
    x = _x(t, c, t + c, mean, std)
    xt = torch.from_numpy(x)
    xj = jnp.asarray(x)
    if bf16:
        xt = xt.to(torch.bfloat16)
        xj = xj.astype(jnp.bfloat16)
    mu, var, seen = stats_walk(xt)
    assert torch.all(seen == 1)
    if t == 1:
        assert torch.equal(mu, xt[0].float()) and torch.all(var == 0)
        return
    for m_ref, v_ref in (jref.channel_stats_ref(xj), jl.channel_stats(xj),
                         ref.channel_stats_ref(xt)):
        _hold(mu, var, m_ref, v_ref)


# tests/test_torch_channel_stats.py's shapes and Pallas tiles
@pytest.mark.parametrize("t,c,bt,bc", [(256, 128, 64, 64), (128, 64, 128, 64),
                                       (512, 32, 256, 32)])
@pytest.mark.parametrize("bf16", [False, True])
def test_stats_walk_matches_pallas(t, c, bt, bc, bf16):
    """Mean 1, std 3, with the tolerances of
    test_channel_stats_matches_jax_ref_and_pallas: against the JAX
    reference 1e-6 relative, against the Pallas kernel's one-pass formula
    2e-5 of the largest variance."""
    x = _x(t, c, t + c)
    xj = jnp.asarray(x)
    xt = torch.from_numpy(x)
    if bf16:
        xj = xj.astype(jnp.bfloat16)
        xt = xt.to(torch.bfloat16)
    mu, var, _ = stats_walk(xt)
    m_r, v_r = jref.channel_stats_ref(xj)
    m_p, v_p = channel_stats_pallas(xj, bt=bt, bc=bc, interpret=True)
    scale = float(np.asarray(v_r).max())
    np.testing.assert_allclose(mu.numpy(), np.asarray(m_r), rtol=0,
                               atol=1e-6 * np.sqrt(scale))
    np.testing.assert_allclose(var.numpy(), np.asarray(v_r), rtol=1e-6,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(mu.numpy(), np.asarray(m_p), rtol=0,
                               atol=1e-6 * np.sqrt(scale))
    np.testing.assert_allclose(var.numpy(), np.asarray(v_p), rtol=0,
                               atol=2e-5 * scale)


def test_stats_cases_have_power():
    """The cases reach what they are meant to: a plan of several ranks
    and of the most, a rank with several stages, a last stage and a last
    thread tile cut short, C off the vector width for both types."""
    plans = [(t, c, cs.plan_stats(t, c, bf16))
             for t, c, *_ in STATS_CASES for bf16 in (False, True)]
    assert any(p.ranks == cs.MAX_RANKS for *_, p in plans)
    assert any(p.stages >= 2 * p.ranks > 2 for *_, p in plans)
    assert any(t % p.stage_rows and t > p.stage_rows for t, _, p in plans)
    assert any(c % 8 and c % 4 for _, c, _ in plans)
    assert any(c % 8 and c % 4 == 0 for _, c, _ in plans)


# ------------------------------------------------- kernel 6, emulated

def pack_walk(w, scale, bits, vec):
    """What kernel 6 writes, tile by tile as the grid walks them, in plain
    PyTorch: a run of RUN_ROWS rows x 4 columns a thread (here all of a
    warp's 32 quads at once), the run's scales from one row or stepped
    down it, IEEE f32 quotients rounded half to even and clipped, packed
    offset-binary. Returns the bytes and how often each was written."""
    lead, (k, n) = w.shape[:-2], w.shape[-2:]
    b_n = math.prod(lead)
    g = scale.shape[-2]
    w = w.reshape(b_n, k, n).to(F32)
    scale = scale.reshape(b_n, g, n)
    nbytes, values = pack_layout(bits)
    qmax = (1 << (bits - 1)) - 1
    pg = -(-k // values)
    rpg = k // g
    p = qp.plan_pack(b_n, k, n, bits)
    out = torch.zeros((b_n, pg * nbytes, n), dtype=torch.int64)
    writes = torch.zeros_like(out)
    for block in range(p.blocks):
        for tile in range(block, p.tiles, p.blocks):
            qb = tile % p.quad_blocks
            rest = tile // p.quad_blocks
            rb, b = rest % p.run_blocks, rest // p.run_blocks
            n0 = qb * qp.QUADS * qp.COLS
            n1 = min(n, n0 + qp.QUADS * qp.COLS)
            if n0 >= n:
                continue
            if vec:   # every thread's 4 columns in range: no scalar tail
                assert (n1 - n0) % qp.COLS == 0
            for ry in range(qp.RUNS):
                p0 = (rb * qp.RUNS + ry) * p.run
                if p0 >= pg:
                    continue
                k0 = p0 * values
                gi = k0 // rpg
                left = (gi + 1) * rpg - k0
                q = torch.zeros((qp.RUN_ROWS, n1 - n0), dtype=torch.int64)
                for i in range(qp.RUN_ROWS):
                    if k0 + i >= k:
                        break
                    if left == 0:
                        gi, left = gi + 1, rpg
                    left -= 1
                    qv = torch.round(w[b, k0 + i, n0:n1]
                                     / scale[b, gi, n0:n1])
                    q[i] = qv.clamp(-qmax, qmax).to(torch.int64) + qmax
                for pp in range(p.run):
                    if p0 + pp >= pg:
                        break
                    word = torch.zeros(n1 - n0, dtype=torch.int64)
                    for vi in range(values):
                        if k0 + pp * values + vi < k:
                            word |= q[pp * values + vi] << (bits * vi)
                    for byte in range(nbytes):
                        row = (p0 + pp) * nbytes + byte
                        out[b, row, n0:n1] = (word >> (8 * byte)) & 0xFF
                        writes[b, row, n0:n1] += 1
    return (out.to(torch.uint8).reshape(lead + (pg * nbytes, n)),
            writes.reshape(lead + (pg * nbytes, n)))


def _w(shape, seed):
    return (np.random.default_rng(seed).normal(size=shape) * 0.2).astype(
        np.float32)


# (shape, group, Pallas tiles (bk, bn) or None where no Pallas tiling
# exists): K = 2050 (not a multiple of a W2 or W3 packed group), groups of
# 3 (runs cross scale rows) with N not a multiple of 4, groups of 32 and
# 128 and per-channel on full quads, a stack of weights, N = 6 and 33
PACK_CASES = [((2050, 22), -1, (410, 22)), ((96, 22), 3, (48, 22)),
              ((256, 64), 32, (64, 32)), ((256, 64), 128, (64, 32)),
              ((256, 40), -1, (64, 40)), ((2, 3, 64, 12), 16, None),
              ((64, 33), 4, (32, 33)), ((48, 6), 3, (48, 6))]


def _pallas_fits(shape, bits, tiles):
    if tiles is None:
        return False
    bk = tiles[0]
    return shape[-2] % bk == 0 and bk % pack_layout(bits)[1] == 0


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("shape,group,tiles", PACK_CASES)
def test_pack_walk_matches_jax(shape, group, tiles, bits):
    """Byte for byte against the JAX reference (each stacked weight on
    its own) and, where the shape tiles, the Pallas kernel in interpret
    mode; every (stack index, packed row, column) written exactly once;
    the scalar path writes what the vector path writes."""
    w = _w(shape, sum(shape) + bits)
    lead, (k, n) = shape[:-2], shape[-2:]
    flat = w.reshape((-1, k, n))
    scales = np.stack([np.array(jt.compute_scales(jnp.asarray(wi), bits,
                                                  group)) for wi in flat])
    want = np.stack([np.asarray(jref.quantize_pack_ref(
        jnp.asarray(wi), jnp.asarray(si), bits=bits))
        for wi, si in zip(flat, scales)]).reshape(
            lead + (packed_rows(k, bits), n))
    s = torch.from_numpy(scales.reshape(lead + scales.shape[-2:]))
    vec = n % qp.COLS == 0
    got, writes = pack_walk(torch.from_numpy(w), s, bits, vec)
    assert torch.all(writes == 1)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ref.quantize_pack_ref(torch.from_numpy(w), s, bits=bits).numpy(),
        want)
    if vec:
        scalar, _ = pack_walk(torch.from_numpy(w), s, bits, False)
        assert torch.equal(scalar, got)
    if _pallas_fits(shape, bits, tiles):
        pallas = np.asarray(quantize_pack_pallas(
            jnp.asarray(w), jnp.asarray(scales[0]), bits=bits,
            group_size=group, bk=tiles[0], bn=tiles[1], interpret=True))
        np.testing.assert_array_equal(got.numpy(), pallas)


def test_pack_cases_have_power():
    """Both scale rules, both paths, a run past K and a run cut by the
    last packed group, every width against Pallas, groups 3/32/128/-1."""
    plans, crosses = [], set()
    for shape, group, tiles in PACK_CASES:
        lead, (k, n) = shape[:-2], shape[-2:]
        g = 1 if group == -1 else k // group
        for bits in (2, 3, 4, 8):
            plans.append((shape, bits, group, tiles,
                          qp.plan_pack(math.prod(lead), k, n, bits)))
        # whether a group ends inside a run, so the scale row steps
        crosses.add(g > 1 and (k // g) % qp.RUN_ROWS != 0)
    assert crosses == {True, False}
    assert any(s[-1] % qp.COLS for s, *_ in plans)
    assert any(s[-1] % qp.COLS == 0 for s, *_ in plans)
    assert any(s[-2] % qp.RUN_ROWS for s, *_ in plans)
    assert {gr for _, _, gr, *_ in plans} >= {3, 32, 128, -1}
    for bits in (2, 3, 4, 8):
        assert any(_pallas_fits(s, bits, t) and s[-1] % qp.COLS
                   for s, b, _, t, _ in plans if b == bits)
    assert any(s[-2] == 2050 and _pallas_fits(s, b, t)
               for s, b, _, t, _ in plans)
