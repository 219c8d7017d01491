"""The pure-Python plans beside the port's CUDA kernels, on the CPU: how
``decode_attention`` splits each (batch, kv head) cache over a
thread-block cluster, how ``ssd_scan`` cuts the sequence into chunks, how
``queue_booking`` spreads a trial's workers over lanes and registers and
how ``maxplus_scan`` lays a column over lanes and registers; and the
reading of a kernel's SASS that ``chip_smoke.py`` takes its chain model
from.  No card and no compiler are needed: the plans are arithmetic on
shapes, the reading is text."""
import math

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import sass  # noqa: E402
from repro_torch.kernels.decode_attention.ops import plan  # noqa: E402
from repro_torch.kernels.maxplus_scan.ops import (  # noqa: E402
    REG_BLOCKS, scan_plan)
from repro_torch.kernels.queue_booking.ops import (  # noqa: E402
    MAX_LANES, MAX_SLOTS, booking_plan)
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


def _pow2(n):
    return n > 0 and n & (n - 1) == 0


@pytest.mark.parametrize("W,want", [
    (1, (1, 1)), (3, (1, 3)), (15, (1, 15)), (16, (1, 16)), (17, (2, 16)),
    (31, (2, 16)), (32, (2, 16)), (33, (4, 16)), (100, (8, 16)),
    (256, (16, 16)),
])
def test_booking_plan_at_the_edges(W, want):
    """The engine's 15 workers take one lane of 15 slots (no shuffle, no
    padding); a lane holds at most 16 workers, so W = 17 takes two and
    W = 256 sixteen."""
    assert booking_plan(W) == want


def test_booking_plan_covers_every_pool():
    """Every W from 1 to 256: the lanes hold the pool, within the kernel's
    limits, and the plan is the narrowest that fits (half the lanes would
    need more than 16 slots); one lane holds exactly the pool, several
    hold 16 each, the last ones padded."""
    for W in range(1, MAX_LANES * MAX_SLOTS + 1):
        lanes, slots = booking_plan(W)
        assert _pow2(lanes) and lanes <= MAX_LANES
        assert 1 <= slots <= MAX_SLOTS
        assert lanes * slots >= W
        assert lanes == 1 or math.ceil(W / (lanes // 2)) > MAX_SLOTS
        assert slots == (W if lanes == 1 else MAX_SLOTS)


@pytest.mark.parametrize("W", [0, MAX_LANES * MAX_SLOTS + 1])
def test_booking_plan_refuses_what_the_kernel_does_not_take(W):
    with pytest.raises(ValueError):
        booking_plan(W)


@pytest.mark.parametrize("nb,want", [
    (1, (1, 1)), (2, (2, 1)), (16, (16, 1)), (31, (32, 1)), (32, (32, 1)),
    (33, (32, 2)), (64, (32, 2)), (65, (32, 4)), (700, (32, 32)),
    (1024, (32, 32)), (1025, (0, 0)), (14528, (0, 0)),
])
def test_scan_plan_at_the_edges(nb, want):
    """The log-depth route's 16 blocks take half a warp in one register;
    past 32 blocks a whole warp, and past 1,024 the shared-memory kernel."""
    assert scan_plan(nb) == want


def test_scan_plan_covers_every_tape():
    """Every nb the launcher takes (nb * W <= 14,528 at W = 1): the
    register kernel's lanes and registers hold the tape and are the
    fewest that do; only tapes past REG_BLOCKS go to shared memory."""
    for nb in range(1, 14529):
        lanes, regs = scan_plan(nb)
        if nb > REG_BLOCKS:
            assert (lanes, regs) == (0, 0)
            continue
        assert _pow2(lanes) and lanes <= 32 and _pow2(regs)
        assert lanes * regs >= nb
        if regs == 1:
            assert lanes == 1 or lanes // 2 < nb
        else:
            assert lanes == 32 and 32 * (regs // 2) < nb


# a loop of three dependent instructions per pass (FSETP -> FSEL -> FADD,
# carried in R8), a counter beside it and a load that feeds nothing
_SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_16kernelILi1EEEvPKfPf
        /*0000*/                   MOV R1, c[0x0][0x28] ;         /* 0x0 */
        /*0010*/                   LDG.E.128 R4, [R2.64] ;
        /*0020*/                   FSETP.GTU.AND P0, PT, R8, R4, PT ;
        /*0030*/                   FSEL R9, R8, -R8, !P0 ;
        /*0040*/                   FADD R8, R9, R5 ;
        /*0050*/                   IADD3 R10, R10, 0x1, RZ ;
        /*0060*/                   ISETP.GE.AND P1, PT, R10, R11, PT ;
        /*0070*/               @!P1 BRA 0x20 ;
        /*0080*/                   STG.E [R2.64], R8 ;
        /*0090*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_16kernelILi2EEEvPKfPf
        /*0000*/                   EXIT ;
"""


def test_sass_reads_operands():
    body = sass.function(_SASS, "kernelILi1E")
    by_op = {ins.op: ins for ins in body}
    assert by_op["LDG.E.128"].dests == ["R4", "R5", "R6", "R7"]
    assert by_op["LDG.E.128"].srcs == ["R2", "R3"]
    assert by_op["FSETP.GTU.AND"].dests == ["P0"]
    assert by_op["FSEL"].srcs == ["R8", "R8", "P0"]
    assert by_op["STG.E"].dests == [] and "R8" in by_op["STG.E"].srcs
    assert by_op["BRA"].target == 0x20 and by_op["BRA"].srcs == ["P1"]


@pytest.mark.parametrize("form", ["address", "label"])
def test_sass_chain_of_a_loop(form):
    """The loop is FSETP .. BRA; one pass adds FSETP, FSEL and FADD to the
    chain carried in R8: 3, whichever way the branch names its target."""
    text = _SASS
    if form == "label":
        text = text.replace("@!P1 BRA 0x20", "@!P1 BRA `(.L_x_0)").replace(
            "        /*0020*/", ".L_x_0:\n        /*0020*/")
    body = sass.function(text, "kernelILi1E")
    assert sass.loops(body) == [(2, 7)]
    loop = sass.hottest_loop(body)
    assert len(loop) == 6
    assert sass.chain(loop) == 3


def test_sass_guarded_write_reads_its_destination():
    """A predicated move may leave its register as it was, so the chain
    runs through both the guard and the old value."""
    text = """
\t\tFunction : k
        /*0000*/                   FADD R2, R2, R3 ;
        /*0010*/                   FSETP.GT.AND P0, PT, R2, R4, PT ;
        /*0020*/               @P0 MOV R5, R2 ;
        /*0030*/                   FADD R5, R5, 1 ;
        /*0040*/                   BRA 0x0 ;
"""
    loop = sass.hottest_loop(sass.function(text, "k"))
    ins = loop[2]
    assert set(ins.srcs) == {"P0", "R2", "R5"}
    # R5 is carried through the guarded move and the add: 2 a pass, more
    # than R2's add alone
    assert sass.chain(loop) == 2
