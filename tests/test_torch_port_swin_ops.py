"""The plain versions of the port's Swin kernels against the Pallas kernels
they replace, and the port's copies of the Swin helpers against the JAX
module's.

swin_attention_reference (mvlt_tpu_torch/ops/swin_attention.py) and
swin_block_reference (mvlt_tpu_torch/ops/swin_band.py) are what kernels F and
E are held to on the card; here they are held to Pallas entries #19
(_fused_swin_attention, in both its window-pair and its single-window form)
and #18 (fused_swin_band_block with gelu="erf"), run in interpret mode on the
CPU at fp32 with rtol = atol = 1e-4 (the Pallas kernels take one-pass
LayerNorm statistics and the A&S erf). The band kernel's TPU layout -- the
vertical roll of the stream, lane padding, head stripes, y-pooling of its
x-pooled rows -- is applied on the JAX side as the JAX model applies it
(mvlt_tpu/models/pvlt.py:_swin_fused_block). Inputs are numpy draws from a
seed; the relative-position tables at std 0.5, so a wrong bias index shows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu_torch.models import swin as port_swin
from mvlt_tpu_torch.ops.swin_attention import fused_swin_attention, plan
from mvlt_tpu_torch.ops.swin_band import fused_swin_block
from tests.kernel_utils import run_interpret

TOL = dict(rtol=1e-4, atol=1e-4)


def test_swin_helpers_match_jax():
    from mvlt_tpu.models import swin as jax_swin

    assert port_swin.TEXT_POOL == jax_swin.TEXT_POOL
    assert port_swin.NEG_INF == jax_swin.NEG_INF
    for ws in range(1, 9):
        np.testing.assert_array_equal(port_swin.relative_position_index(ws),
                                      jax_swin.relative_position_index(ws))
    for h, w, ws, shift in [(8, 8, 4, 0), (8, 8, 4, 2), (7, 7, 7, 3), (12, 12, 8, 4),
                            (6, 10, 4, 2), (28, 28, 8, 4), (3, 3, 3, 0)]:
        np.testing.assert_array_equal(port_swin.window_masks(h, w, ws, shift),
                                      jax_swin.window_masks(h, w, ws, shift))


def _attn_inputs(gen, b, nw, nh, ws2, t, hd, table):
    f = lambda *s: gen.standard_normal(s).astype(np.float32)
    return (f(b, nw, nh, ws2, hd), f(b, nw, nh, ws2, hd), f(b, nw, nh, ws2, hd),
            f(b, nh, t, hd), f(b, nh, t, hd), table.astype(np.float32))


def _grid_table(gen, hw, ws, shift, nh, t):
    """The additive table of a real (padded, shifted) grid, as
    SwinJointAttention makes it."""
    rel = torch.from_numpy((0.5 * gen.standard_normal(((2 * ws - 1) ** 2, nh))).astype(np.float32))
    index = torch.from_numpy(port_swin.relative_position_index(ws))
    mask = torch.from_numpy(port_swin.window_masks(*hw, ws, shift))
    return port_swin.add_table(rel, index, mask, t).numpy()


def _port_table(rel, hw, ws, shift, t):
    """``rel``'s additive table on a grid, as a SwinBlock hands it to kernel E
    (the plain version, which a CPU tensor takes, builds its own)."""
    return port_swin.add_table(torch.from_numpy(rel),
                               torch.from_numpy(port_swin.relative_position_index(ws)),
                               torch.from_numpy(port_swin.window_masks(*hw, ws, shift)), t)


ATTN_CASES = ["nw4_paired", "nw4_single", "nw3", "padded_shifted", "window7_hd32"]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_swin_attention_reference_matches_pallas(case):
    """Pallas #19 in its paired form (nW even, the JAX default) and its
    single-window form (nW even with pairing off, and nW odd), on a real
    6x6 grid padded to 8x8 and shifted, and on one 7x7 window (stage 4 at
    224: ws^2 = 49, 61 keys, head dim 32), against the plain version."""
    from mvlt_tpu.ops.swin_attention import _fused_swin_attention

    gen = np.random.default_rng(ATTN_CASES.index(case))
    b, nh, t, hd = 2, 2, 12, 16
    if case == "window7_hd32":
        ws, pair, hd = 7, False, 32
        table = _grid_table(gen, (7, 7), ws, 0, nh, t)
        nw = table.shape[0]
    elif case == "padded_shifted":
        ws, pair = 4, True
        table = _grid_table(gen, (6, 6), ws, ws // 2, nh, t)
        nw = table.shape[0]
    else:
        ws, nw, pair = 4, 3 if case == "nw3" else 4, case == "nw4_paired"
        table = 0.5 * gen.standard_normal((nw, nh, ws * ws, ws * ws + t))
        table[..., : ws * ws] += np.where(gen.random((nw, nh, ws * ws, ws * ws)) < 0.3,
                                          port_swin.NEG_INF, 0.0)
    args = _attn_inputs(gen, b, nw, nh, ws * ws, t, hd, table)
    scale = hd ** -0.5
    want = run_interpret(lambda: _fused_swin_attention(*map(jnp.asarray, args), scale=scale,
                                                       pair=pair))
    got = fused_swin_attention(*map(torch.from_numpy, args), scale=scale)
    assert got.shape == (b, nw, nh, ws * ws, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("batch,nw,heads,want", [
    (101, 16, 2, (2, 2)),     # stage 2 at 224: 1,616 blocks of two windows
    (101, 4, 5, (2, 2)),      # stage 3
    (101, 1, 8, (1, 1)),      # stage 4: one window, one warpgroup
    (4, 16, 2, (2, 2)),
    (1200, 7, 2, (2, 7)),     # enough windows to share the text K/V seven ways
    (3000, 16, 2, (2, 16)),
])
def test_kernel_f_plan(batch, nw, heads, want):
    """Kernel F's (warpgroups, windows) a block on 132 SMs: at least four
    waves of blocks, two an SM, and no more windows a block than a sample
    has."""
    assert plan(batch, nw, heads, 132) == want
    wgs, per = want
    assert -(-nw // per) * batch * heads >= min(8 * 132, batch * heads * -(-nw // wgs))


def _block_weights(gen, c, hidden, nh, ws):
    """Seeded weights in flax layout ([in, out] kernels) and the bias table."""
    def mat(i, o):
        return (gen.standard_normal((i, o)) * 1.5 / np.sqrt(i)).astype(np.float32)

    def vec(n, mean=0.0):
        return (mean + 0.1 * gen.standard_normal(n)).astype(np.float32)
    return dict(ln1_scale=vec(c, 1.0), ln1_bias=vec(c), wq=mat(c, c), bq=vec(c),
                wk=mat(c, c), bk=vec(c), wv=mat(c, c), bv=vec(c), wp=mat(c, c), bp=vec(c),
                ln2_scale=vec(c, 1.0), ln2_bias=vec(c), w1=mat(c, hidden), b1=vec(hidden),
                w2=mat(hidden, c), b2=vec(c),
                rel=(0.5 * gen.standard_normal(((2 * ws - 1) ** 2, nh))).astype(np.float32))


def _jax_band_block(x, kt, vt, p, *, hw, ws, shift, win, c, nh, t):
    """fused_swin_band_block in interpret mode with the JAX model's glue:
    returns (out [B, h*w, C], pooled [B, (h/win)(w/win), C])."""
    from mvlt_tpu.ops.kernel_math import round_up
    from mvlt_tpu.ops.swin_band import fused_swin_band_block, swin_band_add_tables

    h, w = hw
    b, hd = x.shape[0], c // nh
    s = ws // 2 if shift else 0
    d_pad, t_pad = round_up(c, 128), round_up(t, 16)

    def stripe_seq(a):             # [B, T, c] -> [B, T_pad, nh*128]
        z = jnp.zeros((b, t_pad, nh, 128), jnp.float32)
        z = z.at[:, :t, :, :hd].set(a.reshape(b, t, nh, hd))
        return z.reshape(b, t_pad, nh * 128)

    add = swin_band_add_tables(jnp.asarray(p["rel"]), h=h, w=w, ws=ws, shift=bool(s),
                               t_num=t, t_pad=t_pad)
    xv = jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (0, d_pad - c)))
    xin = jnp.roll(xv, -s * w, axis=1) if s else xv
    keys = ("ln1_scale", "ln1_bias", "wq", "bq", "wk", "bk", "wv", "bv", "wp", "bp",
            "ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2")
    out, pooled = run_interpret(lambda: fused_swin_band_block(
        xin, stripe_seq(jnp.asarray(kt)), stripe_seq(jnp.asarray(vt)), add,
        *(jnp.asarray(p[k]) for k in keys), hw=hw, ws=ws, win=win, dim=c, num_heads=nh,
        scale=hd ** -0.5, eps1=1e-6, eps2=1e-6, gelu="erf"))
    if s:
        out = jnp.roll(out, s * w, axis=1)
    pooled = pooled[..., :c].reshape(b, h, w // win, c)
    if s:
        pooled = jnp.roll(pooled, s, axis=1)
    pooled = pooled.reshape(b, h // win, win, w // win, c).mean(axis=2).reshape(b, -1, c)
    return np.asarray(out[..., :c]), np.asarray(pooled)


@pytest.mark.parametrize("hw,ws,shift,c,nh,hidden,t", [
    ((8, 8), 4, False, 32, 2, 64, 12),     # unshifted, two bands
    ((4, 8), 4, True, 32, 2, 64, 12),      # shifted, one band: it is the wrap band
    ((8, 12), 4, True, 32, 2, 64, 12),     # shifted, two bands of different kinds
    ((24, 24), 8, True, 16, 1, 32, 8),     # pool window 3 does not divide ws = 8
], ids=["unshifted", "shifted_one_band", "shifted_bands", "pool_off_window"])
def test_swin_block_reference_matches_band_pallas(hw, ws, shift, c, nh, hidden, t):
    h, w = hw
    win = max(1, h // port_swin.TEXT_POOL)
    gen = np.random.default_rng(h * w + c + shift)
    p = _block_weights(gen, c, hidden, nh, ws)
    x = gen.standard_normal((2, h * w, c)).astype(np.float32)
    kt, vt = (gen.standard_normal((2, t, c)).astype(np.float32) for _ in range(2))
    want_out, want_pooled = _jax_band_block(x, kt, vt, p, hw=hw, ws=ws, shift=shift, win=win,
                                            c=c, nh=nh, t=t)
    tt = lambda a: torch.from_numpy(a)
    tl = lambda a: torch.from_numpy(np.ascontiguousarray(a.T))
    got_out, got_pooled = fused_swin_block(
        tt(x), tt(kt), tt(vt), tt(p["rel"]), tt(p["ln1_scale"]), tt(p["ln1_bias"]),
        tl(p["wq"]), tt(p["bq"]), tl(np.concatenate([p["wk"], p["wv"]], axis=1)),
        tt(np.concatenate([p["bk"], p["bv"]])), tl(p["wp"]), tt(p["bp"]),
        tt(p["ln2_scale"]), tt(p["ln2_bias"]), tl(p["w1"]), tt(p["b1"]), tl(p["w2"]),
        tt(p["b2"]), hw=hw, heads=nh, window=ws, shift=ws // 2 if shift else 0, pool=win,
        eps1=1e-6, eps2=1e-6, table=_port_table(p["rel"], hw, ws, ws // 2 if shift else 0, t))
    assert got_pooled.shape == (2, (h // win) * (w // win), c)
    np.testing.assert_allclose(got_out.numpy(), want_out, **TOL)
    np.testing.assert_allclose(got_pooled.numpy(), want_pooled, **TOL)
