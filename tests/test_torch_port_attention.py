"""The training attention core's plain twins of the kernels' interface, and
the backward's split planner.

The Hopper kernels (csrc/attention.cu) return the rows' logsumexp beside o
and take o and lse back in the backward; their plain versions
(``attention_stats_reference``, ``attention_stats_bwd_reference``) are held
here to the Pallas kernels they replace (mvlt_tpu/ops/pallas_attention.py,
run in interpret mode) in fp32 at rtol = atol = 1e-4, and the
differentiable Function over them passes gradcheck in fp64. The planner
that cuts N into ranges for the backward is a plain function, held at the
pvlt_tiny stage shapes at B = 150 and a ragged one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu_torch.ops.pallas_attention import (TILE, attention_fwd,
                                                 attention_stats_bwd_reference,
                                                 attention_stats_reference, fused_attention,
                                                 plan_splits, split_ranges)
from tests.kernel_utils import run_interpret
from tests.test_torch_port_train import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

TOL = dict(rtol=1e-4, atol=1e-4)
T = torch.from_numpy
SHAPES = [(2, 2, 96, 48, 32),    # stage-like
          (1, 2, 40, 20, 16)]    # ragged M


def _inputs(b, h, n, m, hd):
    rng = np.random.default_rng(n + m)
    q, k, v, do = (rng.normal(size=s).astype(np.float32)
                   for s in ((b, h, n, hd), (b, h, m, hd), (b, h, m, hd), (b, h, n, hd)))
    return q, k, v, do, 1.5 * hd ** -0.5      # peaked softmax, not near uniform


@pytest.mark.parametrize("b,h,n,m,hd", SHAPES)
def test_stats_forward_matches_pallas(b, h, n, m, hd):
    from mvlt_tpu.ops.pallas_attention import fused_attention_vjp

    q, k, v, _, scale = _inputs(b, h, n, m, hd)
    o, lse = attention_stats_reference(T(q), T(k), T(v), scale)
    want_o = run_interpret(fused_attention_vjp, q, k, v, scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
    logits = torch.matmul(T(q), T(k).transpose(-1, -2)) * scale
    assert lse.dtype == torch.float32 and lse.shape == (b, h, n)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(logits, -1).numpy(), **TOL)
    # the CPU wrapper is the plain twin
    got_o, got_lse = attention_fwd(T(q), T(k), T(v), scale)
    assert torch.equal(got_o, o) and torch.equal(got_lse, lse)


@pytest.mark.parametrize("b,h,n,m,hd", SHAPES)
def test_stats_backward_matches_pallas_vjp(b, h, n, m, hd):
    from mvlt_tpu.ops.pallas_attention import fused_attention_vjp

    q, k, v, do, scale = _inputs(b, h, n, m, hd)

    def loss(q, k, v):
        return jnp.sum(fused_attention_vjp(q, k, v, scale) * do)

    want = run_interpret(jax.grad(loss, argnums=(0, 1, 2)), q, k, v)
    o, lse = attention_stats_reference(T(q), T(k), T(v), scale)
    got = attention_stats_bwd_reference(T(q), T(k), T(v), o, lse, T(do), scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=name)


def test_function_with_saved_stats_passes_gradcheck():
    """o and lse saved by the forward feed the backward: ragged M and N."""
    gen = torch.Generator().manual_seed(1)
    r = lambda *s: torch.randn(*s, generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda q, k, v: fused_attention(q, k, v, 0.7),
                                    (r(1, 3, 9, 4), r(1, 3, 6, 4), r(1, 3, 6, 4)))


# (B * H, N) at B = 150: the four pvlt_tiny stages at 256 input; a ragged
# B = 4 shape (TRAIN_RAGGED of chip_smoke.py); stage 1 at B = 4
@pytest.mark.parametrize("bh,n,want", [(150, 4224, 4), (300, 1152, 2), (750, 384, 1),
                                       (1200, 192, 1), (12, 67, 1), (4, 4224, 16)])
def test_split_planner(bh, n, want):
    splits = plan_splits(bh, n, 132)
    assert splits == want
    tiles = -(-n // TILE)
    ranges = split_ranges(tiles, splits)
    covered = [t for lo, hi in ranges for t in range(lo, hi)]
    assert covered == list(range(tiles))                 # every tile exactly once, in order
    assert all(hi - lo >= min(4, tiles) for lo, hi in ranges)
    # about four waves of one block an SM, unless the ranges would grow short
    assert splits == 1 or bh * splits >= 4 * 132 or splits == tiles // 4
