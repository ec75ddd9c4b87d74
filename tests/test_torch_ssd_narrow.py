"""The SSD kernels' layout at head dims below 16 on the CPU: the wrapper's
copies of the rules of ``csrc/ssd_scan.cuh`` (heads a packed tile, tiles of
a group, tiles a block) at H/G of 6, 24 and 128 and ragged S, and the
scratch sizes at mamba2-130m's split shape.

The kernels themselves, and the copies against the C library's own counts,
run on the card only (``tests/test_torch_cuda.py``, marker ``cuda``).
"""
from __future__ import annotations

import pytest

from repro_torch.kernels import ssd_scan as ss

L = ss.CHUNK


def test_heads_per_tile_fill_sixteen_columns():
    for p in (1, 2, 4, 8):
        assert ss.heads_per_tile(p) * p == 16
    for p in (16, 32, 64, 128):
        assert ss.heads_per_tile(p) == 1
    assert ss.DIMS[:4] == (1, 2, 4, 8)


# (B, S, H, G, P, heads a tile, tiles of a group, tiles a block): H/G of 6, 24
# and 128, ragged S among them
NARROW = [
    (4, 4096, 24, 1, 4, 4, 6, 6),      # mamba2-130m's train shape on one of 16 'model' ranks
    (4, 4096, 24, 1, 1, 16, 2, 2),
    (4, 4096, 24, 1, 2, 8, 3, 3),
    (4, 4096, 24, 1, 8, 2, 12, 12),
    (2, 1000, 24, 1, 4, 4, 6, 1),      # too few chunks for 256 blocks of more than one tile
    (8, 8190, 6, 1, 4, 4, 2, 2),       # 6 heads at Q = 4: a ragged last tile of 2 heads
    (1, 4097, 6, 1, 4, 4, 2, 1),
    (2, 300, 12, 2, 1, 16, 1, 1),      # 6 heads a group in one tile of 16 columns
    (2, 1000, 128, 1, 4, 4, 32, 4),    # the most tiles that leave 256 blocks: 4 of 32
    (2, 3000, 256, 2, 8, 2, 64, 32),
]


@pytest.mark.parametrize("b,s,h,g,p,k,tiles,kt", NARROW)
def test_narrow_blocks_rule(b, s, h, g, p, k, tiles, kt):
    """``narrow_blocks``: K = 16 / P heads a tile, ceil(H/G / K) tiles a group,
    and the most tiles a block that divide them and leave 256 blocks."""
    nc = -(-s // L)
    assert ss.narrow_blocks(b, s, h, g, p) == (k, tiles, kt)
    assert tiles % kt == 0
    if kt > 1:
        assert b * g * tiles * nc // kt >= 256
    assert not any(tiles % more == 0 and b * g * tiles * nc // more >= 256
                   for more in range(kt + 1, tiles + 1))


def test_scratch_at_mamba2_split_shape():
    """mamba2-130m's train shape on one of 16 'model' ranks (P = 4): the
    saved forward scratch is 4 / 16 of the tiles' of 16 columns (12.6 MB
    against 50.4 MB), the backward's own 16.8 MB against 100.7 MB."""
    b, s, h, g, p, n = 4, 4096, 24, 1, 4, 128
    assert 4 * ss.scratch_floats(b, s, h, p, n) == 4 * 4 * 24 * 64 * (128 * 4 + 1) == 12_607_488
    assert 4 * ss.bwd_scratch_floats(b, s, h, g, p, n) == 12_607_488 + 4 * 4 * 64 * L * L
    # from head dim 16 on nothing changed
    assert ss.scratch_floats(b, s, h, 64, n) == 4 * 24 * 64 * (128 * 64 + 1)
    assert ss.bwd_scratch_floats(b, s, h, g, 64, n) == (
        4 * 24 * 64 * (128 * 64 + 1) + 2 * 4 * 4096 * 3 * 128)

