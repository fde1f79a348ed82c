"""The dense kernels' planner (``kernels/dequant_matmul.py::plan`` and its
two sub-planners, ``plan_stream`` and ``plan_tile``): how
the (M, K) x (K, N) products of kernels 1 and 3 pick a body (the
weight-streaming kernel at decode, the tensor-core tile at prefill) and
are cut into blocks and K splits.

Runs on the CPU: the plan is plain arithmetic, and the CUDA sources'
constants are read from ``csrc/prefill_tile.cuh`` to hold the planner to
the geometry the kernels were built with.
"""
import re
from pathlib import Path

import pytest

from repro_torch.kernels import dequant_matmul as dq
from repro_torch.kernels import expert_dequant_matmul as edq
from repro_torch.kernels import packed_operands as po
from repro_torch.kernels.dequant_matmul import STREAM, TILE, plan

HEADER = (Path(dq.__file__).resolve().parent / "csrc" /
          "prefill_tile.cuh").read_text()

BITS = (2, 3, 4, 8)
# llama3.2-1b's four linear shapes (K, N), Mixtral's two attention shapes,
# TINY's and ragged ones
LLAMA = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]
SHAPES = LLAMA + [(6144, 6144), (6144, 1024), (192, 576), (576, 192),
                  (200, 272), (384, 100)]
MS = [1, 5, 8, 16, 17, 32, 33, 64, 65, 96, 97, 128, 512, 2048, 16384]


def _header_int(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", HEADER).group(1))


def _groups(k, group):
    return 1 if group == -1 else k // group


# (K, N, group) for every group that divides K; each case runs every M
# of MS on both kernels
CASES = [(k, n, group) for k, n in SHAPES for group in (-1, 16, 32, 64, 128)
         if group == -1 or k % group == 0]


def _plans(k, n, group):
    """(m, int8, plan) for every M of MS on both kernels."""
    for int8 in (False, True):
        for m in MS:
            yield m, int8, plan(m, k, n, 4, _groups(k, group), int8=int8)


def test_planner_constants_are_the_kernels():
    assert dq.TILE_M == _header_int("BM")
    assert dq.TILE_K == _header_int("BK")
    assert po.MAX_SMEM == _header_int("MAX_SMEM")
    assert po.MAX_GRID_Z == _header_int("MAX_GRID_Z")
    assert _header_int("THREADS") == 256 and _header_int("WM") == 64
    # the header's geometry rules, as tile_geometry mirrors them
    assert "NI = INT8 && GROUPED ? 4 : 8;" in HEADER
    assert "WRS = BN + 16;" in HEADER
    assert "XRS = BK * XB + 16;" in HEADER
    assert "5 * STAGE + 2 * OP_BYTES <= MAX_SMEM ? 4 : 3;" in HEADER
    assert ("STAGE = ROWS * WRS + BM * XRS + SROWS * BN * 4;" in HEADER)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("int8,grouped", [(False, False), (False, True),
                                          (True, False), (True, True)])
def test_tile_shared_memory_fits(bits, int8, grouped):
    """Every tile variant's ring and operand buffers fit the 232,448 bytes
    a block may take, four stages ahead where they fit, else three."""
    geo = dq.tile_geometry(bits, int8=int8, grouped=grouped)
    assert geo.smem <= po.MAX_SMEM
    assert geo.columns == (128 if int8 and grouped else 256)
    x_row = dq.TILE_K * (1 if int8 else 2) + 16
    srows = 0 if int8 and not grouped else 1
    stage = (dq.TILE_K // 8 * bits * (geo.columns + 16) + dq.TILE_M * x_row
             + srows * geo.columns * 4)
    assert geo.smem == (geo.look + 1) * stage + 2 * geo.columns * x_row
    assert geo.look == (4 if 5 * stage + 2 * geo.columns * x_row
                        <= po.MAX_SMEM else 3)


def test_stream_shared_memory_fits():
    for bits in BITS:
        for m in (1, 8, 16, 32, 64):
            for int8 in (False, True):
                p = dq.plan_stream(m, 2048, 8192, bits, 16, int8=int8)
                assert p.body == STREAM and p.smem <= po.MAX_SMEM


@pytest.mark.parametrize("m", MS)
def test_body_by_m(m):
    """The streaming body up to the kernel's STREAM_MAX_M rows (96 for
    the dequant matmul, 32 for W8A8), the tile above, for per-channel
    scales and groups of whole stages; groups the tile does not take (16
    or 32 rows) stream at any M."""
    assert dq.STREAM_MAX_M == {"dequant_matmul": 96, "w8a8_matmul": 32}
    for int8 in (False, True):
        most = dq.STREAM_MAX_M["w8a8_matmul" if int8 else "dequant_matmul"]
        for k, n in LLAMA:
            want = STREAM if m <= most else TILE
            assert plan(m, k, n, 4, 1, int8=int8).body == want
            assert plan(m, k, n, 4, k // 128, int8=int8).body == want
            assert plan(m, k, n, 4, k // 64, int8=int8).body == want
            assert plan(m, k, n, 4, k // 16, int8=int8).body == STREAM
            assert plan(m, k, n, 4, k // 32, int8=int8).body == STREAM


@pytest.mark.parametrize("k,n,group", CASES)
def test_splits_cover_k_in_whole_stages(k, n, group):
    """Every K row is in exactly one split, splits are whole ring stages
    of the body (128 rows streaming, 64 the tile), none is empty; the
    W8A8 kernel's grouped splits hold whole scale groups."""
    for _, int8, p in _plans(k, n, group):
        step = edq.STAGE_K if p.body == STREAM else dq.TILE_K
        assert p.splits >= 1 and p.k_per_split % step == 0
        assert (p.splits - 1) * p.k_per_split < k <= p.splits * p.k_per_split
        if int8 and group != -1:
            assert p.k_per_split % group == 0 or p.splits == 1
        assert p.splits <= po.MAX_GRID_Z


@pytest.mark.parametrize("k,n,group", CASES)
def test_forced_splits_cover_k(k, n, group):
    """``split_k`` (the sweep's cuts of either body) covers K in equal
    whole units with no empty split, and gives the planners' own cuts
    back when asked for their split counts."""
    groups = _groups(k, group)
    for int8 in (False, True):
        for m in (8, 512):
            bases = [dq.plan_stream(m, k, n, 4, groups, int8=int8)]
            if dq.tile_takes(k, groups):
                bases.append(dq.plan_tile(m, k, n, 4, groups, int8=int8))
            for base in bases:
                unit = dq.k_unit(base.body, k, groups, int8=int8)
                assert dq.split_k(base, k, groups, base.splits,
                                  int8=int8) == base
                for s in (1, 2, 3, 8, 64):
                    p = dq.split_k(base, k, groups, s, int8=int8)
                    assert 1 <= p.splits <= s and p.k_per_split % unit == 0
                    assert ((p.splits - 1) * p.k_per_split < k
                            <= p.splits * p.k_per_split)


@pytest.mark.parametrize("k,n,group", CASES)
def test_blocks_cover_the_output(k, n, group):
    for m, int8, p in _plans(k, n, group):
        if p.body == STREAM:
            assert p.nt in edq.CAPACITY_TILES
            rows, cols = 8 * p.nt, edq.STRIP
        else:
            rows = dq.TILE_M
            cols = dq.tile_geometry(4, int8=int8,
                                    grouped=group != -1).columns
        assert (p.row_blocks - 1) * rows < m <= p.row_blocks * rows
        assert (p.col_blocks - 1) * cols < n <= p.col_blocks * cols


@pytest.mark.parametrize("m", [8, 16, 32, 64, 128, 512, 2048, 16384])
@pytest.mark.parametrize("k,n", LLAMA)
def test_enough_blocks_at_llama_shapes(m, k, n):
    """The streaming body splits K toward STREAM_TARGET_BLOCKS blocks
    (at least half of them, splits of equal whole stages) or one stage a
    split; the tile splits K while its tiles leave SMs idle, down to
    TILE_MIN_STAGES stages a split."""
    for int8, groups in ((False, k // 128), (True, 1)):
        p = plan(m, k, n, 4, groups, int8=int8)
        tiles = p.row_blocks * p.col_blocks
        if p.body == STREAM:
            stages = -(-k // edq.STAGE_K)
            assert (2 * p.blocks >= dq.STREAM_TARGET_BLOCKS
                    or p.splits == stages)
            assert (p.splits - 1) * tiles < dq.STREAM_TARGET_BLOCKS
        else:
            stages = -(-k // dq.TILE_K)
            assert (p.blocks >= po.SMS // 2 or tiles >= po.SMS
                    or p.splits >= stages // dq.TILE_MIN_STAGES)
            assert p.blocks <= max(po.SMS, tiles)


def test_decode_plans_of_the_sweep():
    """The sweep's best splits at M = 8 (PERF.md §6): 8 on 2048 x
    8192, 16 on 2048 x 2048 and 2048 x 512, 32 on 8192 x 2048."""
    for (k, n), splits in zip(LLAMA, (16, 16, 8, 32)):
        for int8, groups in ((False, k // 128), (True, 1)):
            p = plan(8, k, n, 4, groups, int8=int8)
            assert (p.body, p.nt, p.splits) == (STREAM, 1, splits)


def test_prefill_plans():
    # M = 512 on 2048 x 8192: 4 x 32 tiles of 128 x 256, one wave, no split
    p = plan(512, 2048, 8192, 4, 16, int8=False)
    assert (p.body, p.row_blocks, p.col_blocks, p.splits) == (TILE, 4, 32, 1)
    # the tweak's M = 16,384: 128 row tiles
    p = plan(16384, 8192, 2048, 4, 64, int8=False)
    assert (p.body, p.row_blocks, p.col_blocks, p.splits) == (TILE, 128, 8,
                                                              1)
    # grouped W8A8 takes 128-column tiles, whole groups a split
    p = plan(128, 2048, 2048, 4, 16, int8=True)
    assert (p.body, p.col_blocks) == (TILE, 16)
    assert p.k_per_split % 128 == 0


def test_w8a8_int32_guard_counts_all_of_k():
    """Per-channel K splits add their exact sums in int32, so the guard
    counts all of K, not one split's rows: 127 * 127 * K must stay below
    2^31 at W8 (K < 133,144), whatever the split."""
    plan(8, 131072, 256, 8, 1, int8=True)
    with pytest.raises(ValueError, match="could overflow"):
        plan(8, 133248, 256, 8, 1, int8=True)
    # a group bounds the sum: g128 is safe at any K
    plan(8, 133248, 256, 8, 133248 // 128, int8=True)
    # W4 per-channel: 127 * 7 * K < 2^31 up to K = 2,415,919
    plan(8, 2 ** 21, 256, 4, 1, int8=True)
    # the dequant matmul takes no int32 sums
    plan(8, 133248, 256, 8, 1, int8=False)


def test_workspace_holds_bf16_x_and_partials():
    p = plan(512, 2048, 8192, 4, 16, int8=False)
    assert dq.workspace_bytes(p, 512, 2048, 8192, int8=False) == (
        512 * 2048 * 2)
    p = plan(128, 2048, 2048, 4, 16, int8=False)
    assert p.splits > 1
    assert dq.workspace_bytes(p, 128, 2048, 2048, int8=False) == (
        128 * 2048 * 2 + p.splits * 128 * 2048 * 4)
    p = plan(8, 2048, 8192, 4, 1, int8=True)
    assert dq.workspace_bytes(p, 8, 2048, 8192, int8=True) == (
        p.splits * 8 * 8192 * 4)
    p = plan(512, 2048, 8192, 4, 1, int8=True)
    assert dq.workspace_bytes(p, 512, 2048, 8192, int8=True) == 0
