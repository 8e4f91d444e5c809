"""Golden-bytes tests for the 21-bit Maxwell control-word packing."""

import pytest

from repro_torch.binary.ctrlwords import (
    BUNDLE_GROUP,
    CTRL_BITS,
    NOP_CTRL,
    CtrlWordError,
    pack_bundle,
    pack_ctrl,
    pack_stream,
    unpack_bundle,
    unpack_ctrl,
    unpack_stream,
)
from repro_torch.core.isa import NUM_BARRIERS, Ctrl

# field shifts pinned by the format doc (SASSOverlay [5,3,3,6,3,1] layout)
YIELD_BIT = 1 << 4
WBAR_SHIFT, RBAR_SHIFT, WAIT_SHIFT = 5, 8, 11


def test_golden_default_ctrl():
    # stall=1, no yield (bit set), no barriers (7/7), empty wait mask
    assert pack_ctrl(Ctrl()) == 0x0007F1


def test_golden_branch_ctrl():
    # the scheduler's branch control: stall=5, nothing else
    assert pack_ctrl(Ctrl(stall=5)) == 0x0007F5


def test_golden_max_stall_all_barriers():
    ctrl = Ctrl(
        stall=15,
        yield_flag=True,
        write_bar=0,
        read_bar=5,
        wait=set(range(NUM_BARRIERS)),
    )
    expected = 15 | (0 << WBAR_SHIFT) | (5 << RBAR_SHIFT) | (0x3F << WAIT_SHIFT)
    assert pack_ctrl(ctrl) == expected == 0x01FD0F
    assert expected < (1 << CTRL_BITS)


def test_golden_yield_inversion():
    # yield ON means the hardware bit is CLEAR
    assert pack_ctrl(Ctrl(stall=0, yield_flag=True)) & YIELD_BIT == 0
    assert pack_ctrl(Ctrl(stall=0, yield_flag=False)) & YIELD_BIT == YIELD_BIT


@pytest.mark.parametrize(
    "ctrl",
    [
        Ctrl(),
        Ctrl(stall=15, yield_flag=True, write_bar=0, read_bar=5, wait=set(range(6))),
        Ctrl(stall=0, write_bar=3),
        Ctrl(stall=7, read_bar=0, wait={0, 2, 4}),
        Ctrl(stall=4, yield_flag=True, wait={5}),
    ],
)
def test_pack_unpack_identity(ctrl):
    back = unpack_ctrl(pack_ctrl(ctrl))
    assert (back.stall, back.yield_flag, back.write_bar, back.read_bar, back.wait) == (
        ctrl.stall,
        ctrl.yield_flag,
        ctrl.write_bar,
        ctrl.read_bar,
        ctrl.wait,
    )


def test_exhaustive_barrier_field_roundtrip():
    for wb in [None, 0, 1, 5]:
        for rb in [None, 0, 5]:
            for stall in (0, 1, 15):
                c = Ctrl(stall=stall, write_bar=wb, read_bar=rb)
                b = unpack_ctrl(pack_ctrl(c))
                assert (b.write_bar, b.read_bar, b.stall) == (wb, rb, stall)


def test_bundle_golden_layout():
    w = [pack_ctrl(Ctrl()), pack_ctrl(Ctrl(stall=5)), pack_ctrl(Ctrl(stall=2))]
    bundle = pack_bundle(w)
    assert bundle == w[0] | (w[1] << CTRL_BITS) | (w[2] << 2 * CTRL_BITS)
    assert bundle < (1 << 64)
    assert unpack_bundle(bundle) == w


def test_bundle_pads_with_nop():
    w = [pack_ctrl(Ctrl())]
    bundle = pack_bundle(w)
    assert unpack_bundle(bundle) == [w[0], NOP_CTRL, NOP_CTRL]
    nop = unpack_ctrl(NOP_CTRL)
    assert nop.stall == 0 and not nop.yield_flag
    assert nop.write_bar is None and nop.read_bar is None and nop.wait == set()


def test_stream_roundtrip_non_multiple_of_three():
    ctrls = [Ctrl(stall=i % 16, wait={i % 6}) for i in range(7)]
    bundles = pack_stream(ctrls)
    assert len(bundles) == (7 + BUNDLE_GROUP - 1) // BUNDLE_GROUP
    back = unpack_stream(bundles, 7)
    assert [c.stall for c in back] == [c.stall for c in ctrls]
    assert [c.wait for c in back] == [c.wait for c in ctrls]


@pytest.mark.parametrize(
    "bad",
    [
        Ctrl(stall=16),
        Ctrl(stall=-1),
        Ctrl(write_bar=6),
        Ctrl(read_bar=-1),
        Ctrl(wait={6}),
    ],
)
def test_unrepresentable_ctrl_raises(bad):
    with pytest.raises(CtrlWordError):
        pack_ctrl(bad)


def test_bundle_errors():
    with pytest.raises(CtrlWordError):
        pack_bundle([0, 0, 0, 0])
    with pytest.raises(CtrlWordError):
        pack_bundle([1 << CTRL_BITS])
    with pytest.raises(CtrlWordError):
        unpack_stream([], 1)
