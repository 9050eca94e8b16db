"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; every test skips where no CUDA device is present (the
kernels have no CPU mode). On a machine with an NVIDIA H100, nvcc and
PyTorch for CUDA:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

(``--noconftest``: tests/conftest.py configures JAX, which this file does
not need.) chip_smoke.py checks the kernels at the pvlt_tiny stage shapes;
these tests take other widths, head dims, grids and lengths, kernel A's
chain on grids with h != w at sr = 2 and 4, D = 96 and 320 (five heads), a
ragged T = 7, sr = 1, and one and many ranges of its split SR conv, its
output bit-equal twice, kernel B's
chain at D = 96 with head dim 32 and at D = 320 with odd N (its launch
counts: #10's and #12's wrappers count none of its launches), the fused
attention forward's chain at D = 96, head dim 32, an odd N and a tile
across samples of different scales, the training attention kernels at head dims 32 and
64 with M = 5, 22, 177, 192, 272, 600 and 900, N off the tile, one range of N
and four, and the backward's bit-equal repeat at stage 1, B = 150, the
LN-MLP kernels at the four stage widths, rows off the tile, D = 96, D =
128 and 144 (the forward's one-launch and three-launch forms side by side),
and the largest stage with one and two row ranges of the weight gradients, the v2 kernels on grids of odd
sizes, one wider than 128, no text rows and a hidden width off the chunk
(kernel C's chain at head dims 32 and 64, head dim 16 refused),
kernel D's chain on grids with h != w, w = 7, no or ragged text rows, hidden
1,280 and the stage-1 shape, kernel E's chain at the Swin stage shapes of
windows of 8 (two, five and eight heads, one window a sample, shifted and
not) and h != w, each with the wrappers' launch counts (D and E run #12's
and F's kernels through C, so those counts stay), the Swin kernels at
windows of 4 and 6 (36 rows, off the 16-row tile), grids
with h != w, pool windows of 2, T = 7 and a head dim of 32, a Swin block
on both of its routes, kernel F at ws^2 16, 36, 49 and 64, T 7, 20, 128
and 300, head dims 32 and 64, one and two warpgroups, looping warpgroups,
and on padded, shifted grids, the MLM CE kernels at widths 64, 256 and
768 with ragged rows and vocabularies (one with every logit below 0), the
backward bit-equal twice and exactly zero with every row ignored, the fused
attention half's training kernels at head dim 64 with 1, 2, 5 and 8 heads
(M = 192) and a ragged M, at head dim 32 with M = 600 and five heads, both
backward forms, bit-equal repeats, head dim 16 refused, and a training block
on that route against the plain route, and the ways a wrapper refuses its
input. Bound:
max|kernel - plain| / max|plain| <= 2e-2 in bf16, as in chip_smoke.py.
"""

import pytest
import torch

from mvlt_tpu_torch.models.pvlt import Block, SwinBlock
from mvlt_tpu_torch.ops.block_attention import (block_attention_bwd_reference,
                                                block_attention_reference,
                                                block_attention_train_bwd,
                                                block_attention_train_fwd,
                                                block_attention_train_reference,
                                                fused_block_attention,
                                                fused_block_attention_train)
from mvlt_tpu_torch.ops.block_fused import block_reference, fused_block
from mvlt_tpu_torch.ops.dwconv_mlp import dwconv_mlp_reference, fused_dwconv_mlp
from mvlt_tpu_torch.ops.fused_mlp import (fused_ln_mlp, ln_mlp_bwd, ln_mlp_bwd_reference,
                                          ln_mlp_fwd, ln_mlp_reference)
from mvlt_tpu_torch.ops.pallas_attention import (attention_bwd, attention_bwd_reference,
                                                 attention_fwd, attention_reference,
                                                 attention_stats_bwd_reference,
                                                 attention_stats_reference, fused_attention)
from mvlt_tpu_torch.ops.mlm_ce import (mlm_ce_bwd, mlm_ce_fwd, mlm_ce_loss,
                                       mlm_nll_bwd_reference, mlm_nll_reference)
from mvlt_tpu_torch.ops.sr_kv import conv_splits, fused_ln_sr_kv, sr_kv_reference
from mvlt_tpu_torch.ops.swin_attention import fused_swin_attention, swin_attention_reference
from mvlt_tpu_torch.ops.swin_band import fused_swin_block, swin_block_reference

pytestmark = pytest.mark.cuda

TOL = 2e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _block(dim, heads, sr, mlp_ratio, dev, seed, v2=False):
    """A port Block in eval mode with every parameter perturbed."""
    gen = torch.Generator().manual_seed(seed)
    blk = Block(dim, heads, mlp_ratio, sr, True, v2=v2).eval()
    with torch.no_grad():
        for p in blk.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return blk.to(dev)


def _kv_args(blk):
    return blk.kernel_params()[0]


def _block_args(blk):
    return blk.kernel_params()[1]


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.parametrize("hw,dim,heads,sr,mlp_ratio,t,batch", [
    ((8, 8), 64, 2, 2, 4.0, 5, 3),       # head dim 32, M = 21, N = 69
    ((6, 10), 96, 3, 2, 4.0, 7, 2),      # non-square grid, head dim 32
    ((4, 4), 64, 2, 1, 4.0, 9, 2),       # sr == 1: M = N = 25
    ((16, 16), 512, 8, 4, 2.0, 3, 1),    # widest kernel A: an 8,192-deep SR conv, M = 19
    ((24, 24), 128, 2, 1, 4.0, 24, 1),   # M = 600: ten 64-row K/V chunks of #10
])
def test_kernels_match_plain(dev, hw, dim, heads, sr, mlp_ratio, t, batch):
    blk = _block(dim, heads, sr, mlp_ratio, dev, seed=dim + t)
    gen = torch.Generator().manual_seed(t)
    x = torch.randn(batch, hw[0] * hw[1] + t, dim, generator=gen).to(dev, torch.bfloat16)
    kw_kv = dict(sr=sr, heads=heads, eps1=1e-6, eps_sr=1e-5)
    kw_b = dict(heads=heads, eps1=1e-6, eps2=1e-6)
    with torch.no_grad():
        k_ref, v_ref = sr_kv_reference(x, hw, *_kv_args(blk), **kw_kv)
        launches = (fused_ln_sr_kv.launches, fused_block.launches)
        k, v = fused_ln_sr_kv(x, hw, *_kv_args(blk), **kw_kv)
        out = fused_block(x, k_ref, v_ref, *_block_args(blk), **kw_b)
        out_ref = block_reference(x, k_ref, v_ref, *_block_args(blk), **kw_b)
        torch.cuda.synchronize()
        assert (fused_ln_sr_kv.launches, fused_block.launches) == (launches[0] + 1,
                                                                   launches[1] + 1)
        # the module path on the card is the two kernels, on the Block's
        # cached operands (bf16, SR weight channels-last)
        via_module = blk(x, hw)
        k_ops, v_ops = fused_ln_sr_kv(x, hw, *blk.kernel_operands(torch.bfloat16)[0], **kw_kv)
    m = (hw[0] // sr) * (hw[1] // sr) + t if sr > 1 else x.shape[1]
    assert k.shape == v.shape == (batch, heads, m, dim // heads)
    assert _rel(k, k_ref) <= TOL and _rel(v, v_ref) <= TOL
    assert _rel(k_ops, k_ref) <= TOL and _rel(v_ops, v_ref) <= TOL
    assert torch.isfinite(out.float()).all() and _rel(out, out_ref) <= TOL
    assert _rel(via_module, out_ref) <= TOL


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    hw, dim, heads, sr = (8, 8), 64, 2, 2
    blk = _block(dim, heads, sr, 4.0, dev, seed=0)
    x = torch.randn(2, 64 + 4, dim, device=dev).to(torch.bfloat16)
    kw_kv = dict(sr=sr, heads=heads, eps1=1e-6, eps_sr=1e-5)
    kw_b = dict(heads=heads, eps1=1e-6, eps2=1e-6)
    with torch.no_grad():
        k, v = fused_ln_sr_kv(x, hw, *_kv_args(blk), **kw_kv)
        with pytest.raises(ValueError, match="bfloat16"):
            fused_ln_sr_kv(x.float(), hw, *_kv_args(blk), **kw_kv)
        with pytest.raises(ValueError, match="contiguous"):
            fused_ln_sr_kv(x.transpose(0, 1).contiguous().transpose(0, 1), hw,
                           *_kv_args(blk), **kw_kv)
        with pytest.raises(ValueError, match="multiple of sr"):
            fused_ln_sr_kv(x, (4, 16), *_kv_args(blk), **dict(kw_kv, sr=3))
        with pytest.raises(ValueError, match="differ"):
            fused_block(x, k, v[:, :, :-1].contiguous(), *_block_args(blk), **kw_b)
        with pytest.raises(ValueError, match="contiguous"):
            fused_block(x, k.transpose(2, 3), v, *_block_args(blk), **kw_b)
        # head dim 16: #10's forward, which the chain runs, takes 32 and 64
        launches = fused_block.launches
        with pytest.raises(ValueError, match="head dims"):
            fused_block(x, k, v, *_block_args(blk), **dict(kw_b, heads=4))
        assert fused_block.launches == launches
    # training mode is the training path: its kernels, not the serving ones
    launches = (fused_ln_sr_kv.launches, fused_block.launches, attention_fwd.launches,
                ln_mlp_fwd.launches)
    out = blk.train()(x, hw)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert (fused_ln_sr_kv.launches, fused_block.launches, attention_fwd.launches,
            ln_mlp_fwd.launches) == (launches[0], launches[1], launches[2] + 1, launches[3] + 1)


@pytest.mark.parametrize("hw,dim,heads,sr,t,batch", [
    ((6, 10), 96, 3, 2, 7, 3),       # h != w, D = 96: a 64-column stage spans two pixels
    ((8, 12), 96, 3, 4, 7, 2),       # sr = 4, ragged T = 7
    ((8, 4), 320, 5, 2, 7, 2),       # D = 320, five heads, h != w
    ((8, 16), 320, 5, 4, 0, 1),      # sr = 4 at D = 320 (80 chunks), no text rows
    ((5, 7), 96, 3, 1, 7, 2),        # sr = 1: LN1 and the K/V product only
    ((16, 16), 64, 1, 2, 7, 4),      # the split plan: many ranges
    ((16, 16), 64, 1, 2, 7, 240),    # the split plan: one range (120 tiles)
])
def test_sr_kv_chain_matches_plain(dev, hw, dim, heads, sr, t, batch):
    """Kernel A's chain against its plain version, element by element, and
    bit-equal over two calls; the wrapper counts one launch a call and #12's
    wrapper none (the chain runs #12's norm kernel through C)."""
    blk = _block(dim, heads, sr, 4.0, dev, seed=dim + t + sr)
    gen = torch.Generator().manual_seed(batch + sr)
    x = torch.randn(batch, hw[0] * hw[1] + t, dim, generator=gen).to(dev, torch.bfloat16)
    kw_kv = dict(sr=sr, heads=heads, eps1=1e-6, eps_sr=1e-5)
    with torch.no_grad():
        k_ref, v_ref = sr_kv_reference(x, hw, *_kv_args(blk), **kw_kv)
        launches, norm = fused_ln_sr_kv.launches, ln_mlp_fwd.launches
        k, v = fused_ln_sr_kv(x, hw, *_kv_args(blk), **kw_kv)
        k2, v2 = fused_ln_sr_kv(x, hw, *_kv_args(blk), **kw_kv)
        torch.cuda.synchronize()
    assert fused_ln_sr_kv.launches == launches + 2 and ln_mlp_fwd.launches == norm
    m = (hw[0] // sr) * (hw[1] // sr) + t if sr > 1 else x.shape[1]
    assert k.shape == v.shape == (batch, heads, m, dim // heads)
    assert _rel(k, k_ref) <= TOL and _rel(v, v_ref) <= TOL
    assert torch.equal(k, k2) and torch.equal(v, v2)
    if sr > 1 and hw == (16, 16):
        p = (hw[0] // sr) * (hw[1] // sr)
        splits = conv_splits(batch, p, dim, sr, torch.cuda.get_device_properties(dev)
                             .multi_processor_count)
        assert (splits > 1) == (batch == 4)


def _chain_counts():
    """The wrappers' counts of #10's and #12's own launches, which the
    chains of kernel B and the fused attention forward (run through C) leave
    as they are."""
    return {"attention_fwd": attention_fwd.launches, "ln_mlp_fwd": ln_mlp_fwd.launches}


@pytest.mark.parametrize("hw,dim,heads,sr,mlp_ratio,t,batch", [
    ((7, 9), 96, 3, 1, 4.0, 8, 2),       # head dim 32, N = M = 71 (odd), one-launch MLP
    ((10, 6), 96, 3, 2, 4.0, 3, 3),      # head dim 32, N = 63, M = 18
    ((5, 5), 320, 5, 1, 4.0, 8, 2),      # N = M = 33, the three-launch MLP (hidden 1,280)
])
def test_block_chain_matches_plain(dev, hw, dim, heads, sr, mlp_ratio, t, batch):
    """Kernel B's chain against its plain version, through the wrapper and
    through the Block; the wrapper counts one launch a call and #10's and
    #12's wrappers none."""
    blk = _block(dim, heads, sr, mlp_ratio, dev, seed=dim + t + 1)
    gen = torch.Generator().manual_seed(t + 1)
    x = torch.randn(batch, hw[0] * hw[1] + t, dim, generator=gen).to(dev, torch.bfloat16)
    kw_kv = dict(sr=sr, heads=heads, eps1=1e-6, eps_sr=1e-5)
    kw_b = dict(heads=heads, eps1=1e-6, eps2=1e-6)
    with torch.no_grad():
        k, v = sr_kv_reference(x, hw, *_kv_args(blk), **kw_kv)
        before, launches = _chain_counts(), fused_block.launches
        out = fused_block(x, k, v, *_block_args(blk), **kw_b)
        torch.cuda.synchronize()
        assert fused_block.launches == launches + 1 and _chain_counts() == before
        want = block_reference(x, k, v, *_block_args(blk), **kw_b)
        via_module = blk(x, hw)
    assert torch.isfinite(out.float()).all() and _rel(out, want) <= TOL
    assert _rel(via_module, want) <= TOL


def _mlp_params(d, hidden, dev, gen):
    r = lambda *s, std: (std * torch.randn(*s, generator=gen)).to(dev)
    return (1 + r(d, std=0.1), r(d, std=0.1), r(hidden, d, std=d ** -0.5),
            r(hidden, std=0.05), r(d, hidden, std=hidden ** -0.5), r(d, std=0.05))


# q, do (and o, dq) are [B, H, N, hd] views of [B, N, H, hd] (row stride D);
# `splits` is what plan_splits gives the backward on a 132-SM card (an H100)
@pytest.mark.parametrize("b,h,n,m,hd,splits", [
    (2, 3, 300, 600, 32, 1),    # head dim 32, M = 600 (4 K/V groups), N off the q tile
    (3, 5, 77, 192, 64, 1),     # stage-3 heads, N off the tile
    (1, 1, 17, 5, 32, 1),       # tiny M and N
    (2, 1, 130, 22, 64, 1),     # M = 22 (the ragged check's), N off the tile
    (1, 2, 1000, 177, 64, 4),   # M = 177 (stage 1 at 224 input), N split in 4 ranges
    (2, 2, 1030, 272, 32, 4),   # M = 272 (two K/V groups), head dim 32, 4 ranges
    (1, 2, 200, 900, 64, 1),    # M = 900: the forward stages K/V in two windows
])
def test_attention_kernels_match_plain(dev, b, h, n, m, hd, splits):
    from mvlt_tpu_torch.ops.pallas_attention import plan_splits

    assert plan_splits(b * h, n, 132) == splits
    gen = torch.Generator().manual_seed(n + m)
    bf = lambda *s, std=1.0: (std * torch.randn(*s, generator=gen)).to(dev, torch.bfloat16)
    q, do = bf(b, n, h, hd, std=1.5).transpose(1, 2), bf(b, n, h, hd).transpose(1, 2)
    kv = bf(b, m, 2, h, hd).permute(2, 0, 3, 1, 4)
    k, v = kv[0], kv[1]
    launches = (attention_fwd.launches, attention_bwd.launches)
    o, lse = attention_fwd(q, k, v, hd ** -0.5)
    o_ref, lse_ref = attention_stats_reference(q, k, v, hd ** -0.5)
    grads = attention_bwd(q, k, v, o_ref, lse_ref, do, hd ** -0.5)
    torch.cuda.synchronize()
    assert (attention_fwd.launches, attention_bwd.launches) == (launches[0] + 1, launches[1] + 1)
    assert o.stride() == q.stride() and lse.dtype == torch.float32
    assert _rel(o, o_ref) <= TOL and _rel(lse, lse_ref) <= TOL
    want = attention_stats_bwd_reference(q, k, v, o_ref, lse_ref, do, hd ** -0.5)
    for got, w in zip(grads, want):
        assert got.shape == w.shape and _rel(got, w) <= TOL
    # the recomputing plain backward agrees too
    for got, w in zip(grads, attention_bwd_reference(q, k, v, do, hd ** -0.5)):
        assert _rel(got, w) <= TOL
    # the autograd Function: the same kernels under backward(), o and lse saved
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    fused_attention(*leaves, hd ** -0.5).backward(do)
    for leaf, w in zip(leaves, grads):
        assert _rel(leaf.grad, w) <= TOL


def test_attention_backward_is_deterministic(dev):
    """Stage 1 at B = 150 (4 ranges of N, their dK/dV slots summed in order):
    two calls are bit-equal."""
    gen = torch.Generator().manual_seed(1)
    bf = lambda *s: torch.randn(*s, generator=gen).to(dev, torch.bfloat16)
    q, do = bf(150, 1, 4224, 64), bf(150, 1, 4224, 64)
    k, v = bf(150, 1, 192, 64), bf(150, 1, 192, 64)
    o, lse = attention_fwd(q, k, v, 0.125)
    one = attention_bwd(q, k, v, o, lse, do, 0.125)
    two = attention_bwd(q, k, v, o, lse, do, 0.125)
    assert all(torch.equal(x, y) for x, y in zip(one, two))


@pytest.mark.parametrize("b,n,d,hidden", [
    (2, 333, 320, 1280),      # D = 320 at ratio 4, rows off the tile, two row ranges
    (3, 70, 64, 512),         # ratio 8, the row scale spans samples in a tile
    (2, 20, 512, 2048),       # stage-4 widths, one tile per sample
    (4, 77, 96, 384),         # D = 96, off the 64-deep chunk and the 128 tile
    (8, 192, 512, 2048),      # the largest stage, 12 row tiles, one row range
    (3, 150, 128, 1024),      # stage-2 widths: the widest one-launch forward
    (3, 70, 144, 576),        # the narrowest three-launch forward
])
def test_ln_mlp_kernels_match_plain(dev, b, n, d, hidden):
    gen = torch.Generator().manual_seed(d + n)
    x = torch.randn(b, n, d, generator=gen).to(dev, torch.bfloat16)
    dy = torch.randn(b, n, d, generator=gen).to(dev, torch.bfloat16)
    g, be, w1, b1, w2, b2 = _mlp_params(d, hidden, dev, gen)
    s = torch.full((b,), 1 / 0.9, device=dev)
    s[0] = 0.0
    y = ln_mlp_fwd(x, g, be, w1, b1, w2, b2, s, 1e-6)
    grads = ln_mlp_bwd(x, g, be, w1, b1, w2, s, 1e-6, dy)
    torch.cuda.synchronize()
    assert _rel(y, ln_mlp_reference(x, g, be, w1, b1, w2, b2, s, 1e-6)) <= TOL
    want = ln_mlp_bwd_reference(x, g, be, w1, b1, w2, s, 1e-6, dy)
    for got, w in zip(grads, want):
        assert got.shape == w.shape and _rel(got, w) <= TOL
    torch.testing.assert_close(grads[0][0], dy[0])          # a dropped sample: dx = dy
    # deterministic: the slot sums run in a fixed order
    again = ln_mlp_bwd(x, g, be, w1, b1, w2, s, 1e-6, dy)
    assert all(torch.equal(a, c) for a, c in zip(grads, again))
    # the autograd Function on fp32 masters returns fp32 gradients
    params = [t.detach().requires_grad_() for t in (g, be, w1, b1, w2, b2)]
    xl = x.detach().requires_grad_()
    fused_ln_mlp(xl, *params, s, 1e-6).backward(dy)
    assert xl.grad.dtype == torch.bfloat16
    assert all(p.grad.dtype == torch.float32 for p in params)
    assert _rel(params[2].grad, grads[3]) <= TOL


def test_training_wrappers_refuse_what_the_kernels_do_not_take(dev):
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 2, 40, 32, generator=gen).to(dev, torch.bfloat16)
    k = torch.randn(2, 2, 24, 32, generator=gen).to(dev, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor for k"):
        attention_fwd(q, k.cpu(), k, 0.2)                    # CPU/CUDA mix
    with pytest.raises(ValueError, match="does not match"):
        attention_fwd(q, k[:1], k, 0.2)
    with pytest.raises(ValueError, match="bfloat16"):
        attention_fwd(q.float(), k, k, 0.2)
    with pytest.raises(ValueError, match="contiguous"):
        attention_fwd(torch.cat([q, q], -1)[..., ::2], k, k, 0.2)   # last dim strided
    q48, k48 = (torch.randn(*t.shape[:3], 48, generator=gen).to(dev, torch.bfloat16)
                for t in (q, k))
    with pytest.raises(ValueError, match="head dim 48"):
        attention_fwd(q48, k48, k48, 0.2)
    lse = torch.zeros(2, 2, 40, device=dev)
    with pytest.raises(ValueError, match="head dim 48"):
        attention_bwd(q48, k48, k48, q48, lse, q48, 0.2)
    with pytest.raises(ValueError, match="positive scale"):
        attention_fwd(q, k, k, -0.2)
    with pytest.raises(ValueError, match="lse must be"):
        attention_bwd(q, k, k, q, lse.double(), q, 0.2)
    x = torch.randn(2, 10, 64, generator=gen).to(dev, torch.bfloat16)
    g, be, w1, b1, w2, b2 = _mlp_params(64, 256, dev, gen)
    s = torch.ones(2, device=dev)
    with pytest.raises(ValueError, match="weight on cpu"):
        ln_mlp_fwd(x, g, be, w1.cpu(), b1, w2, b2, s, 1e-6)
    with pytest.raises(ValueError, match="bfloat16"):
        ln_mlp_fwd(x.float(), g, be, w1, b1, w2, b2, s, 1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        ln_mlp_fwd(x.transpose(0, 1), g, be, w1, b1, w2, b2, s, 1e-6)
    with pytest.raises(ValueError, match="differ"):
        ln_mlp_bwd(x, g, be, w1, b1, w2, s, 1e-6, x[:, :5].contiguous())



def _fba_inputs(b, n, d, heads, m, dev, gen):
    """Inputs of the fused attention half: Q at gain 1.5 (a peaked softmax),
    Wq and Wp in bf16, a row scale with a dropped sample."""
    bf = lambda *s: torch.randn(*s, generator=gen).to(dev, torch.bfloat16)
    r = lambda *s, std: (std * torch.randn(*s, generator=gen)).to(dev)
    params = (1 + r(d, std=0.1), r(d, std=0.1),
              r(d, d, std=1.5 * d ** -0.5).to(torch.bfloat16), r(d, std=0.05),
              r(d, d, std=d ** -0.5).to(torch.bfloat16), r(d, std=0.05))
    s = torch.full((b,), 1 / 0.9, device=dev)
    s[0] = 0.0
    hd = d // heads
    return bf(b, n, d), bf(b, heads, m, hd), bf(b, heads, m, hd), params, s, bf(b, n, d)


@pytest.mark.parametrize("b,n,d,heads,m", [
    (2, 300, 96, 3, 600),     # head dim 32, M = 600 (two K/V groups), N off the row tile
    (3, 77, 160, 5, 40),      # head dim 32, five heads, one row tile per sample
    (2, 300, 64, 1, 192),     # stage 1's head: one head of 64, M = 192
    (2, 150, 128, 2, 192),    # stage 2's heads
    (2, 100, 320, 5, 192),    # stage 3's heads: five head columns of Q, dO, A and dQ
    (2, 70, 512, 8, 192),     # stage 4's heads
    (3, 77, 128, 2, 37),      # head dim 64, a ragged M under one K/V chunk
])
def test_fba_train_kernels_match_plain(dev, b, n, d, heads, m):
    """The fused attention half's forward (with and without statistics) and
    its backward in both forms against their plain versions; a dropped
    sample passes dy through; the backward is deterministic."""
    gen = torch.Generator().manual_seed(n + d)
    x, k, v, params, s, dy = _fba_inputs(b, n, d, heads, m, dev, gen)
    g, be, wq, bq, wp, bp = params
    kw = dict(heads=heads, eps=1e-6)
    launches = (block_attention_train_fwd.launches, block_attention_train_bwd.launches)
    out = block_attention_train_fwd(x, k, v, *params, s, **kw)
    out_s, st = block_attention_train_fwd(x, k, v, *params, s, save_stats=True, **kw)
    grads = block_attention_train_bwd(x, k, v, g, be, wq, bq, wp, s, dy, **kw)
    grads_s = block_attention_train_bwd(x, k, v, g, be, wq, bq, wp, s, dy, stats=st, **kw)
    torch.cuda.synchronize()
    assert (block_attention_train_fwd.launches - launches[0],
            block_attention_train_bwd.launches - launches[1]) == (2, 2)
    want = block_attention_train_reference(x, k, v, *params, s, **kw)
    _, st_ref = block_attention_train_reference(x, k, v, *params, s, save_stats=True, **kw)
    assert _rel(out, want) <= TOL and _rel(out_s, want) <= TOL
    for c in (slice(0, 1), slice(1, 2), slice(2, None, 2), slice(3, None, 2)):
        assert _rel(st[..., c], st_ref[..., c]) <= TOL
    for got, stats in ((grads, None), (grads_s, st_ref)):
        ref = block_attention_bwd_reference(x, k, v, g, be, wq, bq, wp, s, dy, stats=stats, **kw)
        for a, w in zip(got, ref):
            assert a.shape == w.shape and a.dtype == w.dtype and _rel(a, w) <= TOL
        assert torch.equal(got[0][0], dy[0]) and not got[1][0].any() and not got[2][0].any()
    for got, stats in ((grads, None), (grads_s, st)):   # in-order sums: repeats bit-equal
        again = block_attention_train_bwd(x, k, v, g, be, wq, bq, wp, s, dy, stats=stats, **kw)
        assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.parametrize("b,n,d,heads,m,scales", [
    (3, 131, 96, 3, 177, (0.0, 1.25, 0.5)),   # head dim 32, odd N: tile 1 spans samples 0, 1
    (2, 77, 320, 5, 40, (2.0, 0.0)),          # odd N, five heads of 64
])
def test_fba_forward_chain_matches_plain(dev, b, n, d, heads, m, scales):
    """The fused attention forward's chain (both forms) against its plain
    version, every statistics column included, each row at its own sample's
    scale; #10's and #12's wrappers count none of its launches."""
    gen = torch.Generator().manual_seed(n + d + 1)
    x, k, v, params, _, _ = _fba_inputs(b, n, d, heads, m, dev, gen)
    s = torch.tensor(scales, device=dev)
    kw = dict(heads=heads, eps=1e-6)
    before, launches = _chain_counts(), block_attention_train_fwd.launches
    out = block_attention_train_fwd(x, k, v, *params, s, **kw)
    out_s, st = block_attention_train_fwd(x, k, v, *params, s, save_stats=True, **kw)
    torch.cuda.synchronize()
    assert block_attention_train_fwd.launches == launches + 2 and _chain_counts() == before
    want, st_ref = block_attention_train_reference(x, k, v, *params, s, save_stats=True, **kw)
    assert _rel(out, want) <= TOL and _rel(out_s, want) <= TOL
    for c in (slice(0, 1), slice(1, 2), slice(2, None, 2), slice(3, None, 2)):
        assert _rel(st[..., c], st_ref[..., c]) <= TOL


def test_fused_attention_route_block_matches_plain(dev):
    """A training Block on the fused_attn_train route (both forms) against
    the same block on the plain route: output and every gradient."""
    gen = torch.Generator().manual_seed(5)
    blk = Block(96, 3, 2.0, 2, True, drop_path=0.3).train()
    with torch.no_grad():
        for p in blk.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    blk = blk.to(dev)
    x = torch.randn(3, 8 * 6 + 9, 96, generator=gen).to(dev, torch.bfloat16)
    dy = torch.randn(x.shape, generator=gen).to(dev, torch.bfloat16)
    def plain_ln_mlp(x, gamma, beta, w1, b1, w2, b2, row_scale, eps):
        if row_scale is None:
            row_scale = torch.ones(x.shape[0], device=x.device)
        return ln_mlp_reference(x, gamma, beta, w1, b1, w2, b2, row_scale, eps)

    plain = dict(attention=attention_reference, ln_mlp=plain_ln_mlp,
                 block_attention=lambda *a, save_stats, **kw: block_attention_train_reference(
                     *a, **kw))
    for with_stats in (False, True):
        blk.fused_attn_train, blk.fused_attn_stats = True, with_stats
        results = []
        for kwargs in ({}, plain):
            xl = x.clone().requires_grad_()
            out = blk.train_forward(xl, (8, 6), torch.Generator(dev).manual_seed(1), **kwargs)
            results.append((out, torch.autograd.grad(out, [xl] + list(blk.parameters()), dy)))
        (out_k, g_k), (out_p, g_p) = results
        assert _rel(out_k, out_p) <= TOL
        for a, w in zip(g_k, g_p):
            assert _rel(a, w) <= TOL


def test_fba_wrappers_refuse_what_the_kernels_do_not_take(dev):
    gen = torch.Generator().manual_seed(0)
    x, k, v, params, s, dy = _fba_inputs(2, 40, 64, 2, 24, dev, gen)
    g, be, wq, bq, wp, bp = params
    kw = dict(heads=2, eps=1e-6)
    with pytest.raises(ValueError, match="bfloat16"):
        block_attention_train_fwd(x.float(), k, v, *params, s, **kw)
    with pytest.raises(ValueError, match="16-multiple head dim"):
        block_attention_train_fwd(x, k, v, *params, s, heads=8, eps=1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        block_attention_train_fwd(x, k.transpose(2, 3), v, *params, s, **kw)
    with pytest.raises(ValueError, match="stats"):
        block_attention_train_bwd(x, k, v, g, be, wq, bq, wp, s, dy,
                                  stats=torch.zeros(2, 40, 4, device=dev), **kw)
    with pytest.raises(ValueError, match="differ"):
        block_attention_train_bwd(x, k, v, g, be, wq, bq, wp, s, dy[:, :5].contiguous(), **kw)
    # head dim 16 (the attention core takes 32 and 64): the backward refuses
    # it, and the training form refuses it before its forward launches
    x, k, v, params, s, dy = _fba_inputs(2, 129, 256, 16, 7, dev, gen)
    g, be, wq, bq, wp, bp = params
    with pytest.raises(ValueError, match="head dims"):
        block_attention_train_bwd(x, k, v, g, be, wq, bq, wp, s, dy, heads=16, eps=1e-6)
    launches = block_attention_train_fwd.launches
    with pytest.raises(ValueError, match="head dims"):
        fused_block_attention_train(x, k, v, *params, s, heads=16, eps=1e-6)
    assert block_attention_train_fwd.launches == launches


@pytest.mark.parametrize("r,v,h,frac,bias_mean", [
    (70, 1000, 64, 0.5, 0.0), (513, 4099, 256, 0.2, 0.0), (64, 64, 768, 1.0, 0.0),
    (200, 30522, 768, 0.15, 0.0), (1000, 30522, 768, 0.3, 0.0), (129, 130, 64, 1.0, 0.0),
    (300, 4099, 768, 0.5, -10.0)])
def test_mlm_ce_kernels_match_plain(dev, r, v, h, frac, bias_mean):
    """nll, lse and the three gradients at other widths, ragged row and
    vocabulary counts (the kernels' 128 tiles: 1,000 rows, 130, 4,099 and
    30,522 columns), a single tile, every row labeled, labels in the last
    (ragged) vocabulary tile, and every logit far below 0 on a vocabulary
    ragged against 128 (a padded column counted at 0 would dominate)."""
    gen = torch.Generator().manual_seed(r)
    x = torch.randn(r, h, generator=gen).to(dev, torch.bfloat16)
    table = (torch.randn(v, h, generator=gen) * (2.0 / h ** 0.5)).to(dev, torch.bfloat16)
    bias = (bias_mean + 0.1 * torch.randn(v, generator=gen)).to(dev)
    labels = torch.where(torch.rand(r, generator=gen) < frac,
                         torch.randint(v - 70 if v > 70 else 0, v, (r,), generator=gen), -1).to(dev)
    nll, lse = mlm_ce_fwd(x, table, bias, labels)
    want_nll, want_lse = mlm_nll_reference(x, table, bias, labels)
    g = torch.rand(r, generator=gen).to(dev)
    got = mlm_ce_bwd(x, table, bias, labels, want_lse, g)
    want = mlm_nll_bwd_reference(x, table, bias, labels, want_lse, g)
    torch.cuda.synchronize()
    assert _rel(nll, want_nll) <= TOL and _rel(lse, want_lse) <= TOL
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert _rel(a, b) <= TOL
    assert torch.equal(nll[labels < 0], torch.zeros_like(nll[labels < 0]))


def test_mlm_ce_backward_is_deterministic_and_zero_where_ignored(dev):
    """Two backward calls at the pre-training shape (R = 3,072, H = 768, V =
    30,522, five vocabulary ranges of dx) are bit-equal; with every row
    ignored every gradient is exactly zero."""
    gen = torch.Generator().manual_seed(3)
    r, v, h = 3072, 30522, 768
    x = torch.randn(r, h, generator=gen).to(dev, torch.bfloat16)
    table = (torch.randn(v, h, generator=gen) * (3.0 / h ** 0.5)).to(dev, torch.bfloat16)
    bias = (0.1 * torch.randn(v, generator=gen)).to(dev)
    labels = torch.where(torch.rand(r, generator=gen) < 0.15,
                         torch.randint(0, v, (r,), generator=gen), -1).to(dev)
    g = torch.rand(r, generator=gen).to(dev)
    _, lse = mlm_ce_fwd(x, table, bias, labels)
    one = mlm_ce_bwd(x, table, bias, labels, lse, g)
    two = mlm_ce_bwd(x, table, bias, labels, lse, g)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    ignored = torch.full_like(labels, -1)
    for t in mlm_ce_bwd(x[:700], table, bias, ignored[:700], lse[:700], g[:700]):
        assert not torch.count_nonzero(t)


def test_mlm_ce_loss_gradients_through_autograd(dev):
    """The Function on fp32 masters: fp32 gradients for the table and bias,
    bf16 for the rows, against autograd through the plain logits."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(300, 128, generator=gen).to(dev, torch.bfloat16).requires_grad_()
    table = (0.1 * torch.randn(3000, 128, generator=gen)).to(dev).requires_grad_()
    bias = (0.1 * torch.randn(3000, generator=gen)).to(dev).requires_grad_()
    labels = torch.where(torch.rand(300, generator=gen) < 0.3,
                         torch.randint(0, 3000, (300,), generator=gen), -1).to(dev)
    mlm_ce_loss(x, table, bias, labels).backward()
    got = (x.grad, table.grad, bias.grad)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32, torch.float32]
    x.grad = table.grad = bias.grad = None
    logits = (x.float() @ table.to(torch.bfloat16).float().T) + bias
    torch.nn.functional.cross_entropy(logits, labels, ignore_index=-1).backward()
    for a, b in zip(got, (x.grad, table.grad, bias.grad)):
        assert _rel(a, b) <= TOL


def test_mlm_ce_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros(10, 64, device=dev, dtype=torch.bfloat16)
    table = torch.zeros(100, 64, device=dev)
    bias = torch.zeros(100, device=dev)
    labels = torch.zeros(10, dtype=torch.long, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        mlm_ce_fwd(x.float(), table, bias, labels)
    with pytest.raises(ValueError, match="width"):
        mlm_ce_fwd(torch.zeros(10, 1024, device=dev, dtype=torch.bfloat16),
                   torch.zeros(100, 1024, device=dev), bias, labels)
    with pytest.raises(ValueError, match="width"):   # the backward streams 64-deep chunks
        mlm_ce_bwd(torch.zeros(10, 96, device=dev, dtype=torch.bfloat16),
                   torch.zeros(100, 96, device=dev), bias, labels, torch.zeros(10, device=dev),
                   torch.zeros(10, device=dev))
    with pytest.raises(ValueError, match="labels"):
        mlm_ce_fwd(x, table, bias, labels[:5])
    with pytest.raises(ValueError, match="weight on cpu"):
        mlm_ce_fwd(x, table.cpu(), bias, labels)
    with pytest.raises(ValueError, match="lse and g"):
        mlm_ce_bwd(x, table, bias, labels, torch.zeros(10, device=dev), torch.zeros(9, device=dev))


@pytest.mark.parametrize("hw,dim,heads,sr,mlp_ratio,t,batch", [
    ((8, 8), 32, 1, 2, 4.0, 5, 3),       # D = 32, head dim 32, M = 21
    ((7, 9), 64, 2, 1, 3.0, 5, 2),       # odd grid sides, sr == 1, hidden 192 in one chunk
    ((2, 130), 32, 1, 2, 4.0, 3, 2),     # a grid row wider than kernel D's 128-row tile
    ((3, 40), 64, 2, 1, 4.0, 0, 2),      # no text rows
    ((4, 4), 512, 8, 2, 2.03125, 9, 2),  # hidden 1040: the last chunk 16 wide; head dim 64
])
def test_v2_kernels_match_plain(dev, hw, dim, heads, sr, mlp_ratio, t, batch):
    """Kernels C and D against their plain versions, and the v2 Block on the
    card: kernels A, C and D once each, on its cached operands."""
    blk = _block(dim, heads, sr, mlp_ratio, dev, seed=dim + t, v2=True)
    with torch.no_grad():
        p = blk.mlp.dwconv.dwconv.weight
        p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(1)) / 3)
    gen = torch.Generator().manual_seed(t)
    x = torch.randn(batch, hw[0] * hw[1] + t, dim, generator=gen).to(dev, torch.bfloat16)
    (kv_args, attn_args, mlp_args), (kw_kv, kw_c, kw_d) = blk.kernel_params(), blk.kernel_kwargs()
    with torch.no_grad():
        k, v = sr_kv_reference(x, hw, *kv_args, **kw_kv)
        launches = (fused_block_attention.launches, fused_dwconv_mlp.launches)
        attn = fused_block_attention(x, k, v, *attn_args, **kw_c)
        mlp = fused_dwconv_mlp(x, hw, *mlp_args, **kw_d)
        torch.cuda.synchronize()
        assert (fused_block_attention.launches, fused_dwconv_mlp.launches) == (launches[0] + 1,
                                                                               launches[1] + 1)
        assert _rel(attn, block_attention_reference(x, k, v, *attn_args, **kw_c)) <= TOL
        assert _rel(mlp, dwconv_mlp_reference(x, hw, *mlp_args, **kw_d)) <= TOL
        launches = (fused_ln_sr_kv.launches, fused_block.launches, fused_block_attention.launches,
                    fused_dwconv_mlp.launches)
        out = blk(x, hw)
        want = dwconv_mlp_reference(block_attention_reference(x, k, v, *attn_args, **kw_c), hw,
                                    *mlp_args, **kw_d)
        torch.cuda.synchronize()
    assert (fused_ln_sr_kv.launches, fused_block.launches, fused_block_attention.launches,
            fused_dwconv_mlp.launches) == (launches[0] + 1, launches[1], launches[2] + 1,
                                           launches[3] + 1)
    assert torch.isfinite(out.float()).all() and _rel(out, want) <= TOL


def test_v2_wrappers_refuse_what_the_kernels_do_not_take(dev):
    hw, dim, heads = (4, 4), 64, 2
    blk = _block(dim, heads, 2, 4.0, dev, seed=0, v2=True)
    (kv_args, attn_args, mlp_args), (kw_kv, kw_c, kw_d) = blk.kernel_params(), blk.kernel_kwargs()
    x = torch.randn(2, 16 + 4, dim, device=dev).to(torch.bfloat16)
    with torch.no_grad():
        k, v = fused_ln_sr_kv(x, hw, *kv_args, **kw_kv)
        with pytest.raises(ValueError, match="bfloat16"):
            fused_block_attention(x.float(), k, v, *attn_args, **kw_c)
        with pytest.raises(ValueError, match="contiguous"):
            fused_block_attention(x.transpose(0, 1).contiguous().transpose(0, 1), k, v,
                                  *attn_args, **kw_c)
        with pytest.raises(ValueError, match="k must be"):
            fused_block_attention(x, k[:, :1].contiguous(), v, *attn_args, **kw_c)
        with pytest.raises(ValueError, match="differ"):
            fused_block_attention(x, k, v[:, :, :-1].contiguous(), *attn_args, **kw_c)
        with pytest.raises(ValueError, match="head dim"):
            fused_block_attention(x, k, v, *attn_args, heads=8, eps=1e-6)
        # head dim 16: #10's forward, which the chain runs, takes 32 and 64
        k16, v16 = fused_ln_sr_kv(x, hw, *kv_args, **dict(kw_kv, heads=4))
        launches = fused_block_attention.launches
        with pytest.raises(ValueError, match="head dims"):
            fused_block_attention(x, k16, v16, *attn_args, heads=4, eps=1e-6)
        assert fused_block_attention.launches == launches
        with pytest.raises(ValueError, match="bfloat16"):
            fused_dwconv_mlp(x.float(), hw, *mlp_args, **kw_d)
        with pytest.raises(ValueError, match="contiguous"):
            fused_dwconv_mlp(x.transpose(0, 1).contiguous().transpose(0, 1), hw, *mlp_args,
                             **kw_d)
        with pytest.raises(ValueError, match="unsupported shape"):
            fused_dwconv_mlp(x, (5, 5), *mlp_args, **kw_d)        # N < h*w
        wide = torch.zeros(1, 20, 528, device=dev, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="D <= 512"):
            fused_dwconv_mlp(wide, hw, *[torch.zeros(528, device=dev)] * 2,
                             torch.zeros(16, 528, device=dev), None,
                             torch.zeros(16, 1, 3, 3, device=dev), None,
                             torch.zeros(528, 16, device=dev), None, eps=1e-6)
        g, b = mlp_args[:2]
        with pytest.raises(ValueError, match="hidden a multiple of 16"):
            fused_dwconv_mlp(x, hw, g, b, torch.zeros(40, dim, device=dev), None,
                             torch.zeros(40, 1, 3, 3, device=dev), None,
                             torch.zeros(dim, 40, device=dev), None, eps=1e-6)
        with pytest.raises(ValueError, match="weight shape"):
            fused_dwconv_mlp(x, hw, *mlp_args[:4], mlp_args[4][:, :, :2], *mlp_args[5:], **kw_d)
    # a gradient wanted, or training mode: the training path (#10/#11, the
    # DWConv MLP in PyTorch), no serving kernel
    served = (fused_ln_sr_kv.launches, fused_block_attention.launches,
              fused_dwconv_mlp.launches)
    fwd, bwd = attention_fwd.launches, attention_bwd.launches
    for train in (False, True):
        out = blk.train(train)(x, hw)
        out.float().sum().backward()
        assert torch.isfinite(out.float()).all()
    assert (attention_fwd.launches, attention_bwd.launches) == (fwd + 2, bwd + 2)
    assert (fused_ln_sr_kv.launches, fused_block_attention.launches,
            fused_dwconv_mlp.launches) == served


def _launch_counts():
    return {"D": fused_dwconv_mlp.launches, "E": fused_swin_block.launches,
            "F": fused_swin_attention.launches, "ln_mlp_fwd": ln_mlp_fwd.launches}


@pytest.mark.parametrize("hw,dim,hidden,t,batch", [
    ((6, 10), 64, 256, 0, 2),        # h != w, no text rows
    ((7, 7), 128, 512, 5, 2),        # w = 7: a grid row off a 16-row step; ragged T
    ((9, 13), 96, 384, 3, 3),        # odd sides, ragged T
    ((16, 16), 320, 1280, 128, 2),   # stage 3: hidden 1,280, not a power of two
    ((64, 64), 64, 512, 128, 2),     # stage 1, the shape of Pallas #17
])
def test_dwconv_mlp_chain_matches_plain(dev, hw, dim, hidden, t, batch):
    """Kernel D's chain against its plain version; the wrapper's count moves
    by one and E's, F's and #12's wrappers' counts not at all (D runs #12's
    kernels through C)."""
    gen = torch.Generator().manual_seed(dim + t)
    rnd = lambda *s, std=1.0: (std * torch.randn(*s, generator=gen)).to(dev)
    params = (1.0 + rnd(dim, std=0.1), rnd(dim, std=0.1), rnd(hidden, dim, std=dim ** -0.5),
              rnd(hidden, std=0.05), rnd(hidden, 1, 3, 3, std=1 / 3), rnd(hidden, std=0.1),
              rnd(dim, hidden, std=hidden ** -0.5), rnd(dim, std=0.05))
    x = torch.randn(batch, hw[0] * hw[1] + t, dim, generator=gen).to(dev, torch.bfloat16)
    before = _launch_counts()
    got = fused_dwconv_mlp(x, hw, *params, eps=1e-6)
    want = dwconv_mlp_reference(x, hw, *params, eps=1e-6)
    torch.cuda.synchronize()
    assert _launch_counts() == {**before, "D": before["D"] + 1}
    assert torch.isfinite(got.float()).all() and _rel(got, want) <= TOL


def _swin_block(dim, heads, mlp_ratio, ws, shift, dev, seed):
    """A port SwinBlock in eval mode with every parameter perturbed, its
    bias table at std 0.5, no gradient wanted."""
    gen = torch.Generator().manual_seed(seed)
    blk = SwinBlock(dim, heads, mlp_ratio, True, ws, shift, ws).eval().requires_grad_(False)
    with torch.no_grad():
        for p in blk.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
        blk.attn.relative_position_bias_table.normal_(0.0, 0.5, generator=gen)
    return blk.to(dev)


@pytest.mark.parametrize("hw,dim,heads,mlp_ratio,ws,shift,t,batch", [
    ((8, 16), 64, 2, 4.0, 4, True, 7, 3),        # h != w, 8 windows, T = 7
    ((12, 12), 96, 3, 4.0, 6, True, 16, 2),      # 36 rows, head dim 32
    ((16, 16), 128, 2, 2.0, 8, False, 33, 2),    # pool window 2, unshifted
    ((16, 16), 128, 2, 2.0, 8, True, 128, 2),    # shifted, T = 128
])
def test_swin_kernels_match_plain(dev, hw, dim, heads, mlp_ratio, ws, shift, t, batch):
    """Kernel E on the split stream and the Swin block on it, then kernel F
    on the same block's windows."""
    blk = _swin_block(dim, heads, mlp_ratio, ws, shift, dev, seed=dim + t)
    gen = torch.Generator().manual_seed(t)
    h, w = hw
    xv = torch.randn(batch, h * w, dim, generator=gen).to(dev, torch.bfloat16)
    xt = torch.randn(batch, t, dim, generator=gen).to(dev, torch.bfloat16)
    kt, vt = (torch.randn(batch, t, dim, generator=gen).to(dev, torch.bfloat16)
              for _ in range(2))
    args = (xv, kt, vt, blk.attn.relative_position_bias_table, *blk.kernel_params()[0])
    kw = blk.kernel_kwargs(hw)
    with torch.no_grad():
        launches = fused_swin_block.launches
        out, pooled = fused_swin_block(*args, **kw, table=blk.attn.add_table(hw, t))
        want_out, want_pooled = swin_block_reference(*args, **kw)
        torch.cuda.synchronize()
        assert fused_swin_block.launches == launches + 1
        assert _rel(out, want_out) <= TOL and _rel(pooled, want_pooled) <= TOL
        # the block on its split stream (kernel E) and on the joint stream (kernel F)
        vis, txt = blk((xv, xt), hw)
        joint = blk(torch.cat([xv, xt], dim=1), hw)
        torch.cuda.synchronize()
    assert torch.isfinite(vis.float()).all() and torch.isfinite(txt.float()).all()
    assert _rel(joint[:, : h * w], vis) <= 3 * TOL and _rel(joint[:, h * w:], txt) <= 3 * TOL


@pytest.mark.parametrize("hw,dim,heads,mlp_ratio,shift,t,batch", [
    ((32, 32), 128, 2, 4.0, True, 128, 2),    # stage 2 at 256: two heads, shifted
    ((16, 16), 320, 5, 4.0, True, 128, 2),    # stage 3: five heads, #12 in three launches
    ((8, 8), 512, 8, 4.0, False, 128, 2),     # stage 4: one window a sample, pool 1
    ((8, 8), 512, 8, 4.0, True, 20, 3),       # one window, shifted (regions in one window)
    ((16, 24), 96, 3, 4.0, True, 7, 2),       # h != w, head dim 32, ragged T
])
def test_swin_block_chain_matches_plain(dev, hw, dim, heads, mlp_ratio, shift, t, batch):
    """Kernel E (windows of 8) against its plain version, both outputs; E's
    count moves by one and F's, #12's and D's wrappers' counts not at all (E
    runs their kernels through C). Then the Block on the split stream (its
    cached table) against the plain version."""
    blk = _swin_block(dim, heads, mlp_ratio, 8, shift, dev, seed=dim + t)
    gen = torch.Generator().manual_seed(t + heads)
    h, w = hw
    xv = torch.randn(batch, h * w, dim, generator=gen).to(dev, torch.bfloat16)
    xt = torch.randn(batch, t, dim, generator=gen).to(dev, torch.bfloat16)
    kt, vt = (torch.randn(batch, t, dim, generator=gen).to(dev, torch.bfloat16)
              for _ in range(2))
    args = (xv, kt, vt, blk.attn.relative_position_bias_table, *blk.kernel_params()[0])
    kw = blk.kernel_kwargs(hw)
    with torch.no_grad():
        before = _launch_counts()
        out, pooled = fused_swin_block(*args, **kw, table=blk.attn.add_table(hw, t))
        want_out, want_pooled = swin_block_reference(*args, **kw)
        torch.cuda.synchronize()
        assert _launch_counts() == {**before, "E": before["E"] + 1}
        assert _rel(out, want_out) <= TOL and _rel(pooled, want_pooled) <= TOL
        vis, txt = blk((xv, xt), hw)
        want = blk.band_forward(xv, xt, hw, block=lambda *a, table, **k:
                                swin_block_reference(*a, **k))
        torch.cuda.synchronize()
    assert _rel(vis, want[0]) <= TOL and _rel(txt, want[1]) <= TOL


@pytest.mark.parametrize("nw,heads,ws2,t,hd,batch", [
    (4, 2, 16, 7, 32, 3), (3, 3, 36, 20, 64, 2), (1, 4, 49, 128, 64, 2), (16, 2, 64, 128, 64, 2),
    (1, 8, 49, 128, 32, 3),      # stage 4 at 224 with head dim 32, one warpgroup a block
    (5, 2, 64, 20, 32, 2),       # an odd window count over two warpgroups
    (2, 2, 36, 300, 64, 2),      # five 64-key text chunks, the last ragged
    (7, 2, 16, 7, 32, 1200),     # seven windows a block: each warpgroup loops
])
def test_swin_attention_kernel_matches_plain(dev, nw, heads, ws2, t, hd, batch):
    gen = torch.Generator().manual_seed(nw + ws2)
    bf = lambda *s: torch.randn(*s, generator=gen).to(dev, torch.bfloat16)
    q, k, v = (bf(batch, nw, heads, ws2, hd) for _ in range(3))
    kt, vt = bf(batch, heads, t, hd), bf(batch, heads, t, hd)
    table = 0.5 * torch.randn(nw, heads, ws2, ws2 + t, generator=gen)
    table[..., :ws2] += torch.where(torch.rand(nw, heads, ws2, ws2, generator=gen) < 0.3,
                                    -1e9, 0.0)
    table = table.to(dev)
    launches = fused_swin_attention.launches
    got = fused_swin_attention(q, k, v, kt, vt, table, scale=hd ** -0.5)
    want = swin_attention_reference(q, k, v, kt, vt, table, scale=hd ** -0.5)
    torch.cuda.synchronize()
    assert fused_swin_attention.launches == launches + 1
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("hw,ws,shift,dim,heads,t", [((10, 6), 4, True, 96, 3, 7),
                                                     ((28, 28), 8, True, 128, 2, 128),
                                                     ((7, 7), 7, False, 256, 8, 20)])
def test_swin_attention_kernel_on_a_grid(dev, hw, ws, shift, dim, heads, t):
    """Kernel F on the windows of a padded, shifted grid as the window path
    cuts them, with the grid's table (relative bias at std 0.5, region and
    pad masks): a 10x6 grid padded to 12x8, stage 2 at 224 (28 -> 32) and
    stage 4 (one 7x7 window, head dim 32)."""
    from mvlt_tpu_torch.models.swin import (add_table, heads_of, relative_position_index,
                                            window_masks, window_partition)
    gen = torch.Generator().manual_seed(sum(hw) + t)
    s = ws // 2 if shift else 0
    win = lambda: heads_of(window_partition(
        torch.randn(2, hw[0] * hw[1], dim, generator=gen).to(dev, torch.bfloat16), hw, ws, s),
        heads).contiguous()
    txt = lambda: torch.randn(2, heads, t, dim // heads, generator=gen).to(dev, torch.bfloat16)
    rel = (0.5 * torch.randn((2 * ws - 1) ** 2, heads, generator=gen)).to(dev)
    table = add_table(rel, torch.from_numpy(relative_position_index(ws)).to(dev),
                      torch.from_numpy(window_masks(*hw, ws, s)).to(dev), t)
    args = (win(), win(), win(), txt(), txt(), table)
    got = fused_swin_attention(*args, scale=(dim // heads) ** -0.5)
    want = swin_attention_reference(*args, scale=(dim // heads) ** -0.5)
    torch.cuda.synchronize()
    assert _rel(got, want) <= TOL


def test_swin_wrappers_refuse_what_the_kernels_do_not_take(dev):
    blk = _swin_block(64, 2, 2.0, 4, True, dev, seed=0)
    hw, t = (8, 8), 5
    xv = torch.randn(2, 64, 64, device=dev).to(torch.bfloat16)
    kt = torch.randn(2, t, 64, device=dev).to(torch.bfloat16)
    params = (blk.attn.relative_position_bias_table, *blk.kernel_params()[0])
    kw = {**blk.kernel_kwargs(hw), "table": blk.attn.add_table(hw, t)}
    with torch.no_grad():
        with pytest.raises(ValueError, match="bfloat16"):
            fused_swin_block(xv.float(), kt, kt, *params, **kw)
        with pytest.raises(ValueError, match="k_txt must be"):
            fused_swin_block(xv, kt.float(), kt, *params, **kw)
        with pytest.raises(ValueError, match="unsupported shape"):
            fused_swin_block(xv, kt, kt, *params, **{**kw, "window": 3})
        with pytest.raises(ValueError, match="unsupported shape"):
            fused_swin_block(xv, kt, kt, *params, **{**kw, "pool": 3})
        with pytest.raises(ValueError, match="rel_table"):
            fused_swin_block(xv, kt, kt, params[0][:-1], *params[1:], **kw)
        with pytest.raises(ValueError, match="unsupported shape"):   # head dim 16
            fused_swin_block(xv, kt, kt, params[0].repeat(1, 2), *params[1:],
                             **{**kw, "heads": 4})
        with pytest.raises(ValueError, match="table must be"):
            fused_swin_block(xv, kt, kt, *params,
                             **{**kw, "table": torch.zeros(4, 2, 16, 16, device=dev)})
        q = torch.zeros(2, 4, 2, 16, 32, device=dev, dtype=torch.bfloat16)
        kt4 = torch.zeros(2, 2, t, 32, device=dev, dtype=torch.bfloat16)
        table = torch.zeros(4, 2, 16, 16 + t, device=dev)
        with pytest.raises(ValueError, match="q_win must be"):
            fused_swin_attention(q.float(), q, q, kt4, kt4, table, scale=1.0)
        with pytest.raises(ValueError, match="k_txt must be"):
            fused_swin_attention(q, q, q, kt4[:, :1].contiguous(), kt4, table, scale=1.0)
        with pytest.raises(ValueError, match="add_table"):
            fused_swin_attention(q, q, q, kt4, kt4, table.double(), scale=1.0)
        with pytest.raises(ValueError, match="out of range"):
            fused_swin_attention(q[..., :24].contiguous(), q[..., :24].contiguous(),
                                 q[..., :24].contiguous(), kt4[..., :24].contiguous(),
                                 kt4[..., :24].contiguous(), table, scale=1.0)
        for hd in (16, 48):   # kernel F takes head dims 32 and 64 only
            qh = torch.zeros(2, 4, 2, 16, hd, device=dev, dtype=torch.bfloat16)
            kh = torch.zeros(2, 2, t, hd, device=dev, dtype=torch.bfloat16)
            with pytest.raises(ValueError, match="out of range"):
                fused_swin_attention(qh, qh, qh, kh, kh, table, scale=1.0)
        q81 = torch.zeros(2, 1, 2, 81, 32, device=dev, dtype=torch.bfloat16)   # ws = 9
        with pytest.raises(ValueError, match="out of range"):
            fused_swin_attention(q81, q81, q81, kt4, kt4,
                                 torch.zeros(1, 2, 81, 81 + t, device=dev), scale=1.0)
    # a gradient wanted, or training mode: the split stream serves only; the
    # joint stream trains on the window glue and #12/#13, no serving kernel
    with pytest.raises(ValueError, match="serves only"):
        blk.requires_grad_(True)((xv, kt), hw)
    with pytest.raises(ValueError, match="serves only"):
        blk.train()((xv, kt), hw)
    served = (fused_swin_block.launches, fused_swin_attention.launches)
    mlp = (ln_mlp_fwd.launches, ln_mlp_bwd.launches)
    for train in (False, True):
        out = blk.train(train)(torch.cat([xv, kt], dim=1), hw)
        out.float().sum().backward()
        assert torch.isfinite(out.float()).all()
    assert (ln_mlp_fwd.launches, ln_mlp_bwd.launches) == (mlp[0] + 2, mlp[1] + 2)
    assert (fused_swin_block.launches, fused_swin_attention.launches) == served


def _scale_block_weights(model, gen):
    """Give every matrix of the blocks' attention and MLP (Q, K/V, the SR
    conv, the out-projection, fc1, fc2) std gain / sqrt(fan_in), gain 1.5
    for Q and K/V and 1 elsewhere, as chip_smoke.py's stage_params does, and
    a 0.03 normal perturbation to every 1-d parameter. With the 0.02 init
    the attention is near-uniform and a block's update tiny beside its
    residual, so a misplaced K/V row moves the logits by well under 1%."""
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, (torch.nn.Linear, torch.nn.Conv2d)) and (
                    ".attn." in name or ".mlp." in name):
                gain = 1.5 if name.endswith(("attn.q", "attn.kv")) else 1.0
                std = gain / mod.weight[0].numel() ** 0.5
                mod.weight.copy_(std * torch.randn(mod.weight.shape, generator=gen))
        for p in model.parameters():
            if p.dim() == 1:
                p.add_((0.03 * torch.randn(p.shape, generator=gen)).to(p.device))


@pytest.mark.parametrize("batch", [500, 28])
def test_cls_scorer_matches_plain_at_recognition_batches(dev, batch):
    """make_cls_scorer on pvlt_tiny with the fine-tune heads (bf16, 256x256,
    128 tokens) and scaled block weights at the recognition protocol's batch
    of 500 and the valid split's ragged last batch of 28: kernels A and B 8
    launches a forward, the logits within 3e-2 of the same model with both
    wrappers replaced by their plain versions, the argmax equal where the
    plain margin exceeds twice that bound. A planted fault (A's V rows moved
    by one) must land outside the bound."""
    from unittest import mock

    from mvlt_tpu_torch.config import LossType, ModelConfig
    from mvlt_tpu_torch.eval import recognition
    from mvlt_tpu_torch.models import pvlt
    from mvlt_tpu_torch.models.pvlt import create_model

    torch.manual_seed(3)
    cfg = ModelConfig(compute_dtype="bfloat16",
                      loss_type=LossType(itm=False, mlm=False, t2i=False, cls=True))
    model = create_model(cfg, device=dev).eval()
    gen = torch.Generator().manual_seed(4)
    _scale_block_weights(model, gen)
    images = torch.randint(0, 256, (batch, 256, 256, 3), dtype=torch.uint8, generator=gen).to(dev)
    ids = torch.randint(1000, 8000, (batch, 128), generator=gen).to(dev)
    launches = (fused_ln_sr_kv.launches, fused_block.launches)
    sup, sub = recognition.make_cls_scorer(model)(images, ids)
    kernel = recognition.cls_logits(model, dev, images, ids)
    torch.cuda.synchronize()
    assert (fused_ln_sr_kv.launches - launches[0], fused_block.launches - launches[1]) == (16, 16)
    assert sup.shape == sub.shape == (batch,)
    with mock.patch.object(pvlt, "fused_ln_sr_kv", sr_kv_reference), \
            mock.patch.object(pvlt, "fused_block", block_reference):
        plain = recognition.cls_logits(model, dev, images, ids)

    def v_rows_moved(*args, **kwargs):
        k, v = fused_ln_sr_kv(*args, **kwargs)
        return k, v.roll(1, dims=2)

    with mock.patch.object(pvlt, "fused_ln_sr_kv", v_rows_moved):
        faulty = recognition.cls_logits(model, dev, images, ids)
    for got, want, bad, pred in zip(kernel, plain, faulty, (sup, sub)):
        assert got.shape == (batch, want.shape[1]) and torch.isfinite(got).all()
        scale = want.abs().max()
        assert (got - want).abs().max() <= 3e-2 * scale
        assert (bad - want).abs().max() > 3e-2 * scale
        assert torch.equal(pred, got.argmax(-1))
        top2 = want.topk(2, dim=-1).values
        decided = top2[:, 0] - top2[:, 1] > 6e-2 * scale
        assert torch.equal(got.argmax(-1)[decided], want.argmax(-1)[decided])
