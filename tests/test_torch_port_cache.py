"""The serving operands a block caches (models/pvlt.py:CastOperands) follow
the parameters through training, on the CPU.

A micro v1 Block serves once in eval mode (filling its bf16-operand cache
the way the card's kernels read it), takes one AdamW step in training mode,
and serves again: the output equals, exactly in fp32, that of the same block
with its cache cleared. A fused AdamW update writes the parameters without
moving their ``_version``; the foreach update moves it. Both must refresh
the cache.
"""

import pytest
import torch

from mvlt_tpu_torch.models.pvlt import Block
from tests.test_torch_port_train import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


@pytest.mark.parametrize("impl", ["fused", "foreach"])
def test_serving_operands_refresh_after_an_optimizer_step(impl):
    gen = torch.Generator().manual_seed(0)
    blk = Block(16, 2, 2.0, 2, True)
    x = torch.randn(3, 16 + 5, 16, generator=gen)
    opt = torch.optim.AdamW(blk.parameters(), lr=0.05, **{impl: True})
    with torch.no_grad():
        before = blk.eval()(x, (4, 4))
    blk.train()(x, (4, 4)).square().sum().backward()
    opt.step()
    with torch.no_grad():
        after = blk.eval()(x, (4, 4))
        blk._operands = None
        fresh = blk(x, (4, 4))
    assert not torch.equal(after, before)
    torch.testing.assert_close(after, fresh, rtol=0, atol=0)
