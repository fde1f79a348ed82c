"""Kernel 2's split walk (``csrc/paged_attention.cu``) on the CPU: the
planner ``kernels/paged_attention.py::plan_paged``, the shared-memory
layout ``geometry`` mirrors, and a plain PyTorch emulation of what each
block of a cluster does (the live page range from kv_len and the window,
its n_split shares, each share's tiles through an online softmax, the
merge in rank order) held against the JAX package's Pallas kernel in
interpret mode and its jnp oracle.

The CUDA kernel runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py); the source's constants are read from the ``.cu`` file to
hold the planner and the emulation to the geometry it was built with.
"""
import functools
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention_pallas
from repro.kernels.paged_harness import build_paged_case, build_verify_case
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.kernels.packed_operands import MAX_SMEM

SOURCE = (Path(pa.__file__).resolve().parent / "csrc" /
          "paged_attention.cu").read_text()
NEG = -1e30
# the SM's shared memory (228 KB) and what the card keeps of it per block
SM_SMEM, BLOCK_RESERVED = 233472, 1024


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: several test processes share the cores, and
    their thread pools would contend for them (see
    tests/test_torch_normtweak.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def test_planner_constants_are_the_kernels():
    assert pa.THREADS == _const("THREADS")
    assert pa.WARPS * 32 == pa.THREADS
    assert pa.TILE_TOKENS == _const("TT")
    assert pa.STAGES == _const("STAGES")
    assert pa.MAX_SPLIT == _const("MAX_SPLIT") == 8
    assert pa.MAX_HDV == _const("MAX_HDV")
    assert MAX_SMEM == _const("MAX_SMEM")
    assert "constexpr int RED = 3 * WARPS + 3 + MAX_SPLIT;" in SOURCE
    # the pool types' kinds and element bytes, as the wrapper passes them
    assert "constexpr int KV_F32 = 0, KV_INT8 = 1, KV_BF16 = 2;" in SOURCE
    assert ("const int es = kind == KV_INT8 ? 1 : kind == KV_BF16 ? 2 : 4;"
            in SOURCE)
    assert pa.POOLS == {"f32": (4, 0), "int8": (1, 1), "bf16": (2, 2)}
    assert ("const int mult = kind == KV_INT8 ? 16 : kind == KV_BF16 ? 8 : 4;"
            in SOURCE)
    assert pa.HD_MULTIPLE == {"f32": 4, "bf16": 8, "int8": 16}
    # the layout rules `geometry` mirrors, as the source writes them
    for line in (
            "g.ksb = 16 * (u0 + (12 - u0 % 8) % 8);",
            "g.vsb = HDV * es;",
            "g.stage = TT * (g.ksb + g.vsb) + (quant ? 2 * TT * 4 : 0);",
            "g.rc = R <= 2 ? 2 : R <= 4 ? 4 : R <= 6 ? 6 : 8;",
            "const long long part = (long long)WARPS * g.rc * HDV * 4;",
            "g.q_off = align16(ring > part ? ring : part);",
            "g.pw_off = g.q_off + align16((long long)g.rc * HD * 4);",
            "g.red_off = g.pw_off + WARPS * TW * ((g.rc + 3) / 4 * 4) * 4;",
            "g.tab_off = g.red_off + align16(RED * g.rc * 4);",
            "g.bt_off = g.tab_off + (STAGES + 1) * TT * 4;",
            "g.smem = g.bt_off + align16(4LL * W);"):
        assert line in SOURCE, line


# a case's pool type by its "quant" parameter (False f32, True int8), the
# ids the cases have always had
POOL = {False: "f32", True: "int8", "bf16": "bf16"}


@pytest.mark.parametrize("hd", [16, 48, 64, 128])
@pytest.mark.parametrize("quant", [False, True, "bf16"])
def test_k_rows_avoid_bank_conflicts(hd, quant):
    """A quarter warp reads 2 tokens x 4 consecutive 16-byte units of K:
    a row pitch of 4 mod 8 units puts them in 8 distinct bank groups."""
    if hd % pa.HD_MULTIPLE[POOL[quant]]:
        pytest.skip("int8 pools take hd in multiples of 16")
    es = pa.POOLS[POOL[quant]][0]
    u0 = hd * es // 16
    pitch = u0 + (12 - u0 % 8) % 8
    assert pitch % 8 == 4 and pitch >= u0
    units = {(t * pitch + d) % 8 for t in range(2) for d in range(4)}
    assert len(units) == 8


# (S, KVH, W, page, rows, hd, hd_v): llama3.2-1b serving (8 slots, GQA
# 32/8, hd 64, 20 pages of 16) at m_rows 1 and 4; Mixtral (GQA 48/8, hd
# 128) over its 4096-token window (W 288) at m_rows 1 and 4; TINY (MHA,
# hd 48) and the SMOKE configs (hd 16); the card tests' shapes; ragged
# slot counts and tables
PLAN_SHAPES = [(8, 8, 20, 16, 4, 64, 64), (8, 8, 20, 16, 16, 64, 64),
               (8, 8, 288, 16, 6, 128, 128), (8, 8, 288, 16, 24, 128, 128),
               (8, 4, 64, 16, 1, 48, 48), (4, 2, 8, 16, 2, 16, 16),
               (5, 2, 6, 8, 4, 64, 64), (5, 2, 6, 8, 12, 64, 64),
               (6, 8, 72, 16, 6, 128, 128), (3, 2, 40, 8, 8, 64, 64),
               (1, 8, 512, 16, 4, 64, 64), (128, 8, 64, 16, 4, 64, 64),
               (7, 3, 11, 32, 5, 48, 48), (2, 1, 3, 16, 1, 16, 16)]


@pytest.mark.parametrize("quant", [False, True, "bf16"])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_rules(shape, quant):
    s, kvh, w, ps, rows, hd, hd_v = shape
    n = pa.plan_paged(s, kvh, w, ps, rows, hd, hd_v, POOL[quant])
    geo = pa.geometry(rows, hd, hd_v, w, POOL[quant])
    clusters = s * kvh * geo.chunks
    assert 1 <= n <= pa.MAX_SPLIT
    if w * ps < 2 * pa.MIN_SPLIT_TOKENS:
        assert n == 1                       # a short table is not split
    if n > 1:
        # every split keeps at least MIN_SPLIT_TOKENS of table
        assert w * ps // n >= pa.MIN_SPLIT_TOKENS
        # no more splits than the block target needs
        assert (n - 1) * clusters < pa.TARGET_BLOCKS
    if n < pa.MAX_SPLIT and w * ps // (n + 1) >= pa.MIN_SPLIT_TOKENS:
        # stopped short only where the target was reached
        assert n * clusters >= pa.TARGET_BLOCKS
    assert geo.smem <= MAX_SMEM
    assert geo.rc * geo.chunks >= rows > geo.rc * (geo.chunks - 1)


def test_plan_main_cases():
    """llama3.2-1b's decode read gets 5 splits of 4 pages (320 blocks);
    Mixtral's window 7 (448 blocks), 32 llama slots 2, and each keeps at
    least 2 blocks an SM resident (bytes in flight on every SM)."""
    assert pa.plan_paged(8, 8, 20, 16, 4, 64, 64, "f32") == 5
    assert pa.plan_paged(8, 8, 288, 16, 6, 128, 128, "f32") == 7
    assert pa.plan_paged(32, 8, 20, 16, 4, 64, 64, "f32") == 2
    for rows, hd, w, kv in ((4, 64, 20, "f32"), (4, 64, 20, "int8"),
                            (6, 128, 288, "f32"), (6, 128, 288, "int8")):
        smem = pa.geometry(rows, hd, hd, w, kv).smem
        assert 2 * (smem + BLOCK_RESERVED) <= SM_SMEM


# every case chip_smoke.py's kernel phase and tests/test_torch_cuda.py run:
# (S, KVH, W, page, G, hd, m_rows)
CARD_CASES = [(8, 8, 20, 16, 4, 64, 1), (8, 8, 20, 16, 4, 64, 4),
              (8, 8, 288, 16, 6, 128, 1), (5, 2, 6, 8, 4, 64, 1),
              (5, 2, 6, 8, 4, 64, 4), (5, 2, 6, 8, 2, 16, 1),
              (5, 2, 6, 8, 2, 16, 3), (5, 2, 6, 8, 1, 48, 1),
              (4, 2, 72, 16, 6, 128, 1), (6, 2, 16, 16, 4, 64, 1),
              (6, 2, 16, 16, 4, 64, 4)]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("case", CARD_CASES)
def test_card_cases_fit(case, quant):
    s, kvh, w, ps, g, hd, m_rows = case
    rows = g * m_rows
    pa.plan_paged(s, kvh, w, ps, rows, hd, hd, POOL[quant])  # raises if not
    assert pa.geometry(rows, hd, hd, w, POOL[quant]).smem <= MAX_SMEM


def test_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        pa.plan_paged(8, 8, 20, 16, 4, 64, 256, "f32")
    with pytest.raises(ValueError, match="shared memory"):
        pa.plan_paged(8, 8, 60000, 16, 4, 128, 128, "f32")


# ------------------------------------------------ the split walk, emulated

def _merge(parts):
    """Partials (m, l, acc) merged in list order, as the kernel merges its
    warps and then its ranks: weights exp(m - max m), 0 where l = 0."""
    m_tot = torch.full_like(parts[0][0], NEG)
    for m, _, _ in parts:
        m_tot = torch.maximum(m_tot, m)
    l_tot = torch.zeros_like(parts[0][1])
    a_tot = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        wk = torch.where(l > 0, torch.exp(m - m_tot), 0.0)
        l_tot = l_tot + wk * l
        a_tot = a_tot + wk[:, None] * acc
    return m_tot, l_tot, a_tot


def split_walk(q, k_pool, v_pool, bt, kv_len, k_scale, v_scale, *, window,
               m_rows, n_split, tile=pa.TILE_TOKENS, warps=pa.WARPS):
    """What the kernel computes, block by block, in plain PyTorch (f32):
    per (slot, kv head) the live page range from kv_len and the window,
    rank k's pages [lo + k n / n_split, lo + (k + 1) n / n_split), its
    tokens in tiles of ``tile``, each warp's share of every tile (tokens
    [w tile / warps, (w + 1) tile / warps)) through the warp's own online
    softmax (the int8 K scale on the dot product, the V scale on the
    probability), the warps merged in warp order, then the ranks in rank
    order, a partial with l = 0 at weight 0."""
    s_n, kvh, rows, hd = q.shape
    ps = k_pool.shape[1]
    w = bt.shape[1]
    g = rows // m_rows
    tw = tile // warps
    quant = k_scale is not None
    sm_scale = 1.0 / math.sqrt(hd)
    hd_v = v_pool.shape[-1]
    out = torch.zeros((s_n, kvh, rows, hd_v))
    r_idx = torch.arange(rows)
    for s in range(s_n):
        kl = int(kv_len[s])
        w_lo = 0
        if window is not None:
            x = kl - (m_rows - 1) - window
            if x > 0:
                w_lo = x // ps
        w_hi = min(w, -(-kl // ps))
        n_live = max(0, w_hi - w_lo)
        lim = kl - (m_rows - 1 - r_idx // g)                       # (R,)
        for h in range(kvh):
            ranks = []
            for rank in range(n_split):
                p_a = w_lo + rank * n_live // n_split
                p_b = w_lo + (rank + 1) * n_live // n_split
                ts, te = p_a * ps, min(p_b * ps, kl)
                state = [(torch.full((rows,), NEG), torch.zeros(rows),
                          torch.zeros((rows, hd_v))) for _ in range(warps)]
                for t0 in range(ts, te, tile):
                    for wp in range(warps):
                        m, l, acc = state[wp]
                        pos = torch.arange(t0 + wp * tw, t0 + (wp + 1) * tw)
                        inside = pos < te
                        wi = torch.where(inside, pos // ps, 0)
                        page = torch.where(inside, bt[s, wi].long(), -1)
                        tok = page >= 0
                        pg, off = page.clamp_min(0), pos % ps
                        kt = torch.where(tok[:, None],
                                         k_pool[pg, off, h].float(), 0.0)
                        vt = torch.where(tok[:, None],
                                         v_pool[pg, off, h].float(), 0.0)
                        ksc = vsc = torch.ones(tw)
                        if quant:
                            ksc = torch.where(tok, k_scale[pg, off, h], 0.0)
                            vsc = torch.where(tok, v_scale[pg, off, h], 0.0)
                        dot = q[s, h] @ kt.T                      # (R, tw)
                        valid = tok[None] & (pos[None] < lim[:, None])
                        if window is not None:
                            valid &= pos[None] > lim[:, None] - 1 - window
                        sc = torch.where(valid, dot * ksc[None] * sm_scale,
                                         NEG)
                        m_new = torch.maximum(m, sc.amax(1))
                        p = torch.where(valid,
                                        torch.exp(sc - m_new[:, None]), 0.0)
                        c = torch.exp(m - m_new)
                        state[wp] = (m_new, l * c + p.sum(1),
                                     acc * c[:, None] + (p * vsc[None]) @ vt)
                ranks.append(_merge(state))
            _, l_tot, a_tot = _merge(ranks)
            out[s, h] = a_tot / l_tot.clamp_min(1e-30)[:, None]
    return out


# (S, W, page, KVH, G, hd, fills, window, kv_bits, m_rows, holes): decode
# over llama's hd 64 with an empty slot, fills that leave most splits with
# no live page (n_split up to 8 over 1-12 pages) and shares of several
# tiles; int8 pools under a window that cuts a page; m_rows 4 rows under a
# window, so some rows have no valid token in a share; the SMOKE-size hd
# 16 at m_rows 3 with int8; TINY's MHA hd 48; unheld (-1) pages inside a
# fill ("holes": (slot, page index)), which are dead
SPLIT_CASES = [
    (4, 12, 8, 2, 4, 64, [0, 5, 40, 96], None, 0, 1, ()),
    (4, 12, 8, 2, 4, 64, [0, 9, 50, 96], 20, 8, 1, ()),
    (4, 12, 8, 2, 2, 64, [0, 4, 33, 90], 13, 0, 4, ()),
    (3, 10, 8, 2, 2, 16, [0, 30, 77], 12, 8, 3, ()),
    (3, 6, 16, 4, 1, 48, [17, 0, 96], None, 0, 1, ()),
    (3, 12, 8, 2, 4, 64, [60, 0, 96], None, 8, 1, ((0, 2), (2, 5))),
]


def _to_torch(x):
    if x is None:
        return None
    x = np.array(x)
    if x.dtype == np.int8:
        return torch.from_numpy(x)
    return torch.from_numpy(x.astype(np.float32))


@functools.lru_cache(maxsize=None)
def _split_case(idx):
    """Inputs of SPLIT_CASES[idx] (torch) and the JAX package's Pallas
    kernel (interpret mode) and jnp oracle on them, once per case."""
    s, w, ps, kvh, g, hd, fills, window, kv_bits, m, holes = SPLIT_CASES[idx]
    if m == 1:
        qj, pools, bt, kv_len = build_paged_case(23, s, w, ps, kvh, g, hd,
                                                 fills, kv_bits)
        qg = qj.reshape(s, kvh, g, hd)
    else:
        qj, pools, bt, kv_len = build_verify_case(23, s, m, w, ps, kvh, g,
                                                  hd, fills, kv_bits)
        qg = qj.reshape(s, m, kvh, g, hd).transpose(0, 2, 1, 3, 4).reshape(
            s, kvh, m * g, hd)
    bt = np.array(bt)
    for si, wi in holes:
        bt[si, wi] = -1
    bt = jnp.asarray(bt)
    args = (qg, pools["k_pool"], pools["v_pool"], bt, kv_len,
            pools["k_scale_pool"], pools["v_scale_pool"])
    o_p = np.asarray(paged_attention_pallas(*args, window=window, m_rows=m,
                                            interpret=True))
    o_r = np.asarray(jref.paged_attention_ref(*args, window=window,
                                              m_rows=m))
    t_args = tuple(_to_torch(a) for a in args)
    return t_args, o_p, o_r


@pytest.mark.parametrize("n_split", range(1, 9))
@pytest.mark.parametrize("idx", range(len(SPLIT_CASES)))
def test_split_walk_matches_pallas(idx, n_split):
    *_, fills, window, _, m, _ = SPLIT_CASES[idx]
    (q, kp, vp, bt, kv_len, ks, vs), o_p, o_r = _split_case(idx)
    got = split_walk(q, kp, vp, bt, kv_len, ks, vs, window=window,
                     m_rows=m, n_split=n_split).numpy()
    # f32 on every side; the shares and the tiles reorder the online
    # softmax's sums and the int8 scales apply to the dot product and the
    # probability instead of the values: rounding only, outputs O(1)
    np.testing.assert_allclose(got, o_p, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, o_r, rtol=0, atol=1e-5)
    plain = ref.paged_attention_ref(q, kp, vp, bt, kv_len, ks, vs,
                                    window=window, m_rows=m).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5)
    for si, f in enumerate(fills):
        if f == 0:
            assert np.all(got[si] == 0.0)      # an empty slot: exact zeros


def test_split_cases_have_power():
    """The cases reach what they are meant to: shares with no live page,
    shares of several tiles, a window cutting a page, rows of a share
    with no valid token, holes inside a fill."""
    def live(fill, w, ps, window, m):
        lo = max(0, (fill - (m - 1) - window) // ps) if window else 0
        return max(0, min(w, -(-fill // ps)) - lo)

    lives = [live(c[6][i], c[1], c[2], c[7], c[9])
             for c in SPLIT_CASES for i in range(len(c[6]))]
    assert any(0 < n < 8 for n in lives)          # n_split 8 > live pages
    assert max(c[6][i] for c in SPLIT_CASES
               for i in range(len(c[6]))) >= 3 * pa.TILE_TOKENS
    assert any(c[7] is not None and c[7] % c[2] for c in SPLIT_CASES)
    assert any(c[9] > 1 and c[7] is not None for c in SPLIT_CASES)
    assert any(c[10] for c in SPLIT_CASES)
