"""Kernel E's window layout and its cached table, on the CPU.

Kernel E (ops/swin_band.py, csrc/swin_block.cu) stores each token's q/k/v
row at its window slot and reads the attention output back from there
through one int32 index per grid (``window_index``), in place of
models/swin.py's roll and partition copies. The index must gather exactly
what ``window_partition`` gives and scatter back exactly what
``window_reverse`` gives, shifted or not, on grids with h != w, and match
an index written out by hand on two tiny grids. The
additive table a SwinBlock caches beside its cast operands must follow an
in-place change of the relative-position bias.
"""

import pytest
import torch

from mvlt_tpu_torch.models.pvlt import SwinBlock
from mvlt_tpu_torch.models.swin import window_partition, window_reverse
from mvlt_tpu_torch.ops.swin_band import window_index
from tests.test_torch_port_train import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


@pytest.mark.parametrize("hw,ws,shift", [((8, 8), 4, 0), ((8, 8), 4, 2), ((8, 12), 4, 2),
                                         ((12, 4), 4, 0), ((6, 12), 6, 3)])
def test_window_index_matches_partition_and_reverse(hw, ws, shift):
    h, w = hw
    x = torch.randn(2, h * w, 3, generator=torch.Generator().manual_seed(h * w + shift))
    index = window_index(hw, ws, shift, torch.device("cpu"))
    assert index.dtype == torch.int32 and sorted(index.tolist()) == list(range(h * w))
    index = index.long()
    slots = torch.empty_like(x)
    slots[:, index] = x                      # the q/k/v epilogue's store
    windows = window_partition(x, hw, ws, shift)
    assert torch.equal(slots.reshape(windows.shape), windows)
    back = windows.reshape(2, h * w, 3)[:, index]   # the projection's gather
    assert torch.equal(back, window_reverse(windows, hw, ws, shift))


# Written out by hand: token (y, x) sits at (y', x') = ((y - shift) % h,
# (x - shift) % w) of the rolled grid, in window (y' // ws) * (w // ws) +
# x' // ws at position (y' % ws) * ws + x' % ws.
@pytest.mark.parametrize("hw,ws,shift,want", [
    ((4, 4), 2, 1, [15, 10, 11, 14, 5, 0, 1, 4, 7, 2, 3, 6, 13, 8, 9, 12]),
    ((2, 4), 2, 0, [0, 1, 4, 5, 2, 3, 6, 7]),
])
def test_window_index_by_hand(hw, ws, shift, want):
    assert window_index(hw, ws, shift, torch.device("cpu")).tolist() == want


def test_cached_band_table_follows_the_bias_table():
    blk = SwinBlock(32, 1, 2.0, True, 4, True, 4).eval().requires_grad_(False)
    gen = torch.Generator().manual_seed(0)
    xv, xt = torch.randn(2, 64, 32, generator=gen), torch.randn(2, 3, 32, generator=gen)

    def cached():
        blk((xv, xt), (8, 8))
        return blk._operands[2][("band", (8, 8), 3)]

    first = cached()
    assert torch.equal(first, blk.attn.add_table((8, 8), 3))
    with torch.no_grad():
        blk.attn.relative_position_bias_table.add_(0.5)
    second = cached()
    assert torch.equal(second, blk.attn.add_table((8, 8), 3))
    assert not torch.equal(first, second)
