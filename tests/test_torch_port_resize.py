"""The port's positional-table resize against the JAX package's, on the CPU.

models/pvlt.py:resize_pos_embed resamples a [1, gh*gw, C] table with two
fixed half-pixel bilinear matrices (ops/upsample.py:half_pixel_matrix), so
that its backward is two products and deterministic on the card. It is held
to mvlt_tpu/models/pvlt.py:_resize_pos_embed (jax.image.resize, bilinear,
no antialias) in fp32 at atol 1e-6 at the four stage grids of a 224 model
run at 256, one downsample and one non-square grid; its gradient is the
transposed matrices' product, and it agrees with F.interpolate's bilinear
resize (align_corners=False), the form it replaces.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mvlt_tpu.models.pvlt import _resize_pos_embed
from mvlt_tpu_torch.models.pvlt import resize_pos_embed
from mvlt_tpu_torch.ops.upsample import half_pixel_matrix
from tests.test_torch_port_train import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

GRIDS = [((7, 7), (8, 8)), ((14, 14), (16, 16)), ((28, 28), (32, 32)), ((56, 56), (64, 64)),
         ((8, 8), (7, 7)), ((4, 6), (5, 9))]
C = 6


def _table(native, seed=0):
    gen = np.random.default_rng(seed)
    return gen.standard_normal((1, native[0] * native[1], C)).astype(np.float32)


@pytest.mark.parametrize("native,hw", GRIDS)
def test_resize_matches_jax(native, hw):
    pos = _table(native)
    want = np.asarray(_resize_pos_embed(pos, native, hw))
    got = resize_pos_embed(torch.from_numpy(pos), native, hw)
    assert tuple(got.shape) == (1, hw[0] * hw[1], C)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    grid = torch.from_numpy(pos).reshape(1, *native, C).permute(0, 3, 1, 2)
    ref = F.interpolate(grid, size=hw, mode="bilinear", align_corners=False, antialias=False)
    np.testing.assert_allclose(got.numpy(), ref.permute(0, 2, 3, 1).reshape(1, -1, C).numpy(),
                               rtol=0, atol=2e-6)


@pytest.mark.parametrize("native,hw", GRIDS)
def test_resize_gradient_is_the_transposed_product(native, hw):
    """d pos = M_h^T dY M_w over each channel, M the [out, in] matrices."""
    pos = torch.from_numpy(_table(native, seed=1)).requires_grad_(True)
    dy = np.random.default_rng(2).standard_normal((hw[0], hw[1], C)).astype(np.float32)
    resize_pos_embed(pos, native, hw).backward(torch.from_numpy(dy).reshape(1, -1, C))
    mh = half_pixel_matrix(native[0], hw[0]).astype(np.float64)
    mw = half_pixel_matrix(native[1], hw[1]).astype(np.float64)
    assert np.allclose(mh.sum(1), 1.0) and np.allclose(mw.sum(1), 1.0)
    want = np.einsum("oh,opc,pw->hwc", mh, dy.astype(np.float64), mw)
    np.testing.assert_allclose(pos.grad.reshape(*native, C).numpy(), want, rtol=0, atol=2e-6)
