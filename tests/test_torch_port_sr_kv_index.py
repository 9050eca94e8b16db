"""Kernel A's space-to-depth gather, on the CPU.

Kernel A (ops/sr_kv.py, csrc/sr_kv.cu) runs the SR conv as one product
whose A operand it gathers from LN1(x) in device memory: contraction column
k of reduced pixel (b, py, px) is normed[b, (py*sr + r)*w + px*sr + s, c]
with (r, s, c) = unravel(k, (sr, sr, D)), against the conv weight laid out
as [D_out, (r, s, c_in)]. ``s2d_operand`` writes that operand out by the
same arithmetic; here it is held to F.conv2d on square and non-square grids
at sr = 2 and 4 and D = 24 and 96 (where a 64-column stage of the
contraction spans two pixels), to a layout written out by hand, and, through
LN1, SR-LN and the K/V projection, to the JAX package's fused_ln_sr_kv
(Pallas, interpret mode) at fp32 with rtol = atol = 1e-4 (the JAX kernel
takes one-pass LayerNorm statistics).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mvlt_tpu_torch.ops.kernel_math import layer_norm_fp32, linear
from mvlt_tpu_torch.ops.sr_kv import s2d_operand, split_kv
from tests.kernel_utils import run_interpret


def _flat(weight: torch.Tensor) -> torch.Tensor:
    """Conv weight OIHW [D, D, sr, sr] -> [D_out, (r, s, c_in)], the wrapper's
    layout."""
    d = weight.shape[0]
    return weight.permute(0, 2, 3, 1).reshape(d, -1)


@pytest.mark.parametrize("hw,sr,d", [((8, 8), 2, 24), ((4, 12), 2, 96), ((8, 4), 4, 24),
                                     ((8, 16), 4, 96), ((12, 8), 2, 24)])
def test_s2d_operand_times_weight_is_the_conv(hw, sr, d):
    h, w = hw
    gen = torch.Generator().manual_seed(h * w + sr + d)
    normed = torch.randn(2, h * w + 5, d, generator=gen, dtype=torch.float64)
    weight = torch.randn(d, d, sr, sr, generator=gen, dtype=torch.float64)
    operand = s2d_operand(normed, hw, sr)
    assert operand.shape == (2 * (h // sr) * (w // sr), sr * sr * d)
    grid = normed[:, : h * w].reshape(2, h, w, d).permute(0, 3, 1, 2)
    want = F.conv2d(grid, weight, stride=sr).flatten(2).transpose(1, 2).reshape(-1, d)
    torch.testing.assert_close(operand @ _flat(weight).T, want, rtol=1e-12, atol=1e-12)


def test_s2d_operand_by_hand():
    # a 2x4 grid of one channel, sr = 2: reduced pixel 0 takes tokens 0, 1
    # (row 0) and 4, 5 (row 1); pixel 1 takes 2, 3 and 6, 7; the text row
    # (token 8) is not in the operand
    normed = torch.arange(9.0).reshape(1, 9, 1)
    assert s2d_operand(normed, (2, 4), 2).tolist() == [[0, 1, 4, 5], [2, 3, 6, 7]]
    # two channels: (r, s, c) with c fastest
    normed = torch.arange(18.0).reshape(1, 9, 2)
    assert s2d_operand(normed, (2, 4), 2)[0].tolist() == [0, 1, 2, 3, 8, 9, 10, 11]


@pytest.mark.parametrize("hw,sr,d,heads,t", [((4, 8), 2, 24, 2, 3), ((8, 4), 4, 96, 3, 5)])
def test_kv_through_s2d_matches_jax_fused_ln_sr_kv(hw, sr, d, heads, t):
    from mvlt_tpu.ops.sr_kv import fused_ln_sr_kv as jax_fused_ln_sr_kv

    h, w = hw
    rng = np.random.default_rng(h * w + d)
    mk = lambda *s, std=0.2: (std * rng.standard_normal(s)).astype(np.float32)
    x = mk(2, h * w + t, d, std=1.0)
    g1, b1 = 1.0 + mk(d), mk(d)
    sr_hwio, bsr = mk(sr, sr, d, d, std=(sr * sr * d) ** -0.5), mk(d)
    gs, bs = 1.0 + mk(d), mk(d)
    wkv, bkv = mk(d, 2 * d, std=d ** -0.5), mk(2 * d)
    d_pad = -(-d // 128) * 128
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (0, d_pad - d)))
    k_j, v_j, _ = run_interpret(jax_fused_ln_sr_kv, xp, g1, b1, sr_hwio, bsr, gs, bs, wkv, bkv,
                                dim=d, hw=hw, t=t, sr=sr, heads=heads, eps1=1e-6,
                                eps_sr=1e-5)

    tt = torch.from_numpy
    normed = layer_norm_fp32(tt(x), tt(g1), tt(b1), 1e-6)
    conv_w = tt(sr_hwio).permute(3, 2, 0, 1)          # HWIO -> OIHW
    red = (s2d_operand(normed, hw, sr) @ _flat(conv_w).T + tt(bsr)).reshape(2, -1, d)
    red = layer_norm_fp32(red, tt(gs), tt(bs), 1e-5)
    kv_in = torch.cat([red, normed[:, h * w:]], dim=1)
    k, v = split_kv(linear(kv_in, tt(wkv).T, tt(bkv)), heads)
    m, hd = kv_in.shape[1], d // heads
    np.testing.assert_allclose(k.numpy(), np.asarray(k_j)[:, :, :m, :hd], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j)[:, :, :m, :hd], rtol=1e-4, atol=1e-4)
