"""The pure-Python plans beside the port's CUDA kernels, on the CPU: how
``decode_attention`` splits each (batch, kv head) cache over a
thread-block cluster, and how ``ssd_scan`` cuts the sequence into chunks.
No card and no compiler are needed: the plans are arithmetic on shapes."""
import math

import pytest

pytest.importorskip("torch")

from repro_torch.kernels.decode_attention.ops import plan  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import chunk_plan  # noqa: E402

# groups (B x Hkv), cache slots, slots per tile, blocks the card runs at
# once (SMs x blocks per SM), most blocks of a cluster
PLAN_CASES = [
    (16, 4648, 32, 264, 8),       # gemma2-9b, global layers
    (16, 4096, 32, 264, 8),       # gemma2-9b, local layers
    (16, 4136, 64, 264, 8),       # granite-moe-3b-a800m
    (64, 4136, 64, 264, 8),       # zamba2-1.2b's shared block
    (1, 20, 64, 132, 8),          # below one tile
    (1, 65, 64, 132, 8),          # one slot past a tile
    (3, 1000, 64, 132, 8),
    (512, 4096, 64, 264, 8),      # more groups than the card runs at once
    (2, 100000, 16, 132, 8),
]


@pytest.mark.parametrize("groups,c,tile,slots,max_cluster", PLAN_CASES)
def test_decode_plan_covers_the_cache(groups, c, tile, slots, max_cluster):
    cluster, per = plan(groups, c, tile, slots, max_cluster)
    tiles = math.ceil(c / tile)
    assert 1 <= cluster <= max_cluster
    assert cluster * per >= tiles               # every tile has a block
    assert (cluster - 1) * per < tiles          # and every block a tile
    if groups * cluster > slots:                # only when nothing smaller
        assert cluster == 1


@pytest.mark.parametrize("groups,c,tile,slots,max_cluster", PLAN_CASES)
def test_decode_plan_is_the_widest_that_fits(groups, c, tile, slots,
                                             max_cluster):
    """No wider cluster would still fit the card in one wave and keep a
    tile for every block."""
    cluster, _ = plan(groups, c, tile, slots, max_cluster)
    tiles = math.ceil(c / tile)
    wider = cluster + 1
    assert (wider > max_cluster or groups * wider > slots
            or wider > tiles or math.ceil(tiles / math.ceil(tiles / wider))
            <= cluster)


def test_decode_plan_at_the_served_shapes():
    """Two blocks to an SM (264 at once): gemma2-9b's 16 groups (146 tiles
    of 32 slots) and granite's (65 tiles of 64) take clusters of 8, one
    block to an SM; zamba2's 64 groups take clusters of 4."""
    assert plan(16, 4648, 32, 264, 8) == (8, 19)
    assert plan(16, 4136, 64, 264, 8) == (8, 9)
    assert plan(64, 4136, 64, 264, 8) == (4, 17)


@pytest.mark.parametrize("s,chunk,want", [
    (4096, 256, 16), (100, 256, 1), (257, 256, 2), (8192, 256, 32),
    (1344, 256, 6), (1, 256, 1),
])
def test_ssd_chunk_plan(s, chunk, want):
    """Every step in exactly one chunk, the last one possibly shorter."""
    n = chunk_plan(s, chunk)
    assert n == want
    assert (n - 1) * chunk < s <= n * chunk
