"""The expert kernels' planner (``kernels/expert_dequant_matmul.py::plan``):
how the (E, C, K) x (E, K, N) products of kernels 4 and 5 are cut into
blocks of a strip of columns, a chunk of capacity rows and a range of K.

Runs on the CPU: the plan is plain arithmetic, and the CUDA sources'
constants are read from ``csrc/expert_stream.cuh`` to hold the planner to
the geometry the kernels were built with.
"""
import math
import re
from pathlib import Path

import pytest

from repro_torch.kernels import expert_dequant_matmul as edq
from repro_torch.kernels.expert_dequant_matmul import (plan, scale_rows,
                                                       stage_bytes)

HEADER = (Path(edq.__file__).resolve().parent / "csrc" /
          "expert_stream.cuh").read_text()

DQ = dict(x_bytes=4)
W8 = dict(x_bytes=1)

# (E, C, K, N): Mixtral's wi/wg decode shape, wo's, a 256-token prefill's
# capacity, a ragged capacity, a capacity beyond every chunk, TINY's
# widths, a lone expert, ragged N and K, and many experts of one strip
SHAPES = [(8, 8, 6144, 16384), (8, 8, 16384, 6144), (8, 80, 6144, 16384),
          (8, 5, 6144, 16384), (8, 200, 6144, 16384), (4, 8, 192, 576),
          (1, 1, 64, 160), (2, 8, 256, 100), (2, 8, 200, 128),
          (20000, 8, 16384, 256)]


def _groups(k, group):
    return 1 if group == -1 else k // group


BITS = (2, 3, 4, 8)
# (E, C, K, N, group) with every group that divides K: per-channel, a
# 16-row group (one K step), g128 (one stage), 8 rows (no whole K step:
# the dequant matmul only) and 96 rows (neither divides the stage)
CASES = [(e, c, k, n, group) for e, c, k, n in SHAPES
         for group in (-1, 16, 128, 8, 96)
         if group == -1 or k % group == 0]


def _plans(e, c, k, n, group):
    """(bits, kernel kwargs, plan) for every bit width, on both kernels
    where the W8A8 one takes the group."""
    for bits in BITS:
        for kw in (DQ, W8):
            if kw is W8 and group != -1 and group % 16:
                continue
            yield bits, kw, plan(e, c, k, n, bits, _groups(k, group), **kw)


def _header_int(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", HEADER).group(1))


def test_planner_constants_are_the_kernels():
    assert edq.STRIP == _header_int("BN")
    assert edq.STAGE_K == _header_int("KS")
    assert edq.STAGES == _header_int("STAGES")
    assert edq.MAX_SMEM == _header_int("MAX_SMEM")
    assert edq.MAX_GRID_Z == _header_int("MAX_GRID_Z")
    pad = re.search(r"PAD = BITS == 4 \|\| BITS == 8 \? (\d+) : (\d+);",
                    HEADER)
    assert pad, "the header's row padding rule moved"
    assert edq.ROW_PAD == {4: int(pad.group(1)), 8: int(pad.group(1)),
                           2: int(pad.group(2)), 3: int(pad.group(2))}


@pytest.mark.parametrize("e,c,k,n,group", CASES)
def test_splits_cover_k_in_whole_stages(e, c, k, n, group):
    """Every K row is in exactly one split, splits are whole ring stages,
    none is empty."""
    for _, _, p in _plans(e, c, k, n, group):
        assert p.splits >= 1 and p.k_per_split % edq.STAGE_K == 0
        assert (p.splits - 1) * p.k_per_split < k <= p.splits * p.k_per_split


@pytest.mark.parametrize("e,c,k,n,group", [
    cs for cs in CASES if cs[-1] in (16, 96, 128)])
def test_w8a8_splits_fall_on_whole_scale_groups(e, c, k, n, group):
    for bits in BITS:
        p = plan(e, c, k, n, bits, k // group, **W8)
        assert p.k_per_split % group == 0 or p.splits == 1


@pytest.mark.parametrize("e,c,k,n,group", CASES)
def test_capacity_chunks_cover_c(e, c, k, n, group):
    for bits, kw, p in _plans(e, c, k, n, group):
        rows = 8 * p.nt
        assert p.nt in edq.CAPACITY_TILES
        assert (p.chunks - 1) * rows < c <= p.chunks * rows
        # one chunk whenever the largest tile that fits holds C
        if c <= 8 * max(t for t in edq.CAPACITY_TILES
                        if edq.STAGES * stage_bytes(
                            bits, t, kw["x_bytes"],
                            scale_rows(k, _groups(k, group)))
                        <= edq.MAX_SMEM):
            assert p.chunks == 1


@pytest.mark.parametrize("e,c,k,n,group", CASES)
def test_grid_and_shared_memory_stay_in_bounds(e, c, k, n, group):
    for _, _, p in _plans(e, c, k, n, group):
        assert e * p.splits <= edq.MAX_GRID_Z
        assert p.smem <= edq.MAX_SMEM
        assert p.strips == -(-n // edq.STRIP)


@pytest.mark.parametrize("k,group", [(6144, 128), (6144, -1), (192, 16),
                                     (192, 96), (576, 32), (256, 64),
                                     (16384, 128), (640, 80), (384, 192)])
def test_scale_rows_hold_every_group_a_stage_touches(k, group):
    groups = _groups(k, group)
    rows = scale_rows(k, groups)
    size = k // groups
    for k0 in range(0, k, edq.STAGE_K):
        touched = {r // size for r in range(k0, min(k, k0 + edq.STAGE_K))}
        assert len(touched) <= rows
    assert rows <= edq.STAGE_K // 16


def test_groups_of_no_whole_k_step_stage_no_scale_rows():
    assert scale_rows(192, 24) == 0       # groups of 8 rows
    assert scale_rows(192, 1) == 1
    assert scale_rows(6144, 48) == 1      # g128: one group a stage
    assert scale_rows(6144, 192) == 5     # g32: four touched, the bound 5


def test_w8a8_per_channel_scales_skip_the_ring():
    p = plan(8, 8, 6144, 16384, 4, 1, **W8)
    assert p.smem == edq.STAGES * stage_bytes(4, 1, 1, 0)


def test_stage_bytes_of_the_main_case():
    # W4: 64 packed rows of 256 + 16 bytes, 8 f32 x rows of 128 + 16
    # values, 1 scale row of 256 f32 (g128)
    assert stage_bytes(4, 1, 4, 1) == 64 * 272 + 8 * 576 + 1024
    assert scale_rows(6144, 48) == 1
    # W3: 48 packed rows (16 groups of 3 bytes) of 256 + 32 bytes
    assert stage_bytes(3, 1, 1, 1) == 48 * 288 + 8 * 144 + 1024


# the blocks of the four expert shapes of the card's kernel phase: 256
# columns a strip gives wi/wg 64 strips x 8 experts = 512 tiles, split 3
# ways in whole stages to 1536 blocks (about 11.6 an SM, 3 resident at a
# time); wo's 24 strips x 8 experts = 192 tiles, split 6 ways (1152
# blocks); the prefill capacity 80 takes 3 chunks of 32 rows (no
# split); a ragged capacity of 5 one chunk
@pytest.mark.parametrize("kw,shape,groups,want", [
    (DQ, (8, 8, 6144, 16384), 48, (1, 1, 3, 1536)),
    (W8, (8, 8, 6144, 16384), 1, (1, 1, 3, 1536)),
    (DQ, (8, 8, 16384, 6144), 128, (1, 1, 6, 1152)),
    (W8, (8, 8, 16384, 6144), 1, (1, 1, 6, 1152)),
    (DQ, (8, 80, 6144, 16384), 48, (4, 3, 1, 1536)),
    (W8, (8, 80, 6144, 16384), 1, (4, 3, 1, 1536)),
    (DQ, (8, 5, 6144, 16384), 48, (1, 1, 3, 1536)),
    (W8, (8, 5, 6144, 16384), 1, (1, 1, 3, 1536))])
def test_block_counts_of_the_mixtral_shapes(kw, shape, groups, want):
    p = plan(*shape, 4, groups, **kw)
    assert (p.nt, p.chunks, p.splits, p.blocks) == want
    assert p.blocks >= edq.TARGET_BLOCKS >= 3 * edq.SMS


@pytest.mark.parametrize("e,c,k,n,group", CASES)
def test_splits_only_until_the_grid_is_full(e, c, k, n, group):
    """K is split only while the grid holds fewer than TARGET_BLOCKS
    blocks, and never below MIN_STAGES_PER_SPLIT stages a split."""
    for bits in BITS:
        p = plan(e, c, k, n, bits, _groups(k, group), **DQ)
        tiles = p.blocks // p.splits
        if p.splits > 1:
            assert (p.splits - 1) * tiles < edq.TARGET_BLOCKS
            assert p.k_per_split >= edq.MIN_STAGES_PER_SPLIT * edq.STAGE_K
        elif tiles < edq.TARGET_BLOCKS:
            assert k <= 2 * edq.MIN_STAGES_PER_SPLIT * edq.STAGE_K - 1 or (
                e * 2 > edq.MAX_GRID_Z)


def test_w8a8_grouped_splits_take_whole_groups_and_stages():
    p = plan(1, 8, 1920, 512, 4, 1920 // 96, **W8)
    assert p.splits > 1
    assert p.k_per_split % math.lcm(edq.STAGE_K, 96) == 0
