"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; every test skips where no CUDA device is present (the
kernels have no CPU mode). On a machine with an NVIDIA H100, nvcc and
PyTorch for CUDA:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

(``--noconftest``: tests/conftest.py configures JAX, which this file does
not need.) chip_smoke.py checks the kernels at the pvlt_tiny stage shapes;
these tests take other widths, head dims, grids and lengths, the row tiles
kernel B falls back to, the training kernels at head dim 32 with M = 600,
rows off the tile and D = 320 at ratio 4, and the ways a wrapper refuses
its input. Bound:
max|kernel - plain| / max|plain| <= 2e-2 in bf16, as in chip_smoke.py.
"""

import pytest
import torch

from mvlt_tpu_torch.models.pvlt import Block
from mvlt_tpu_torch.ops.block_fused import block_reference, fused_block
from mvlt_tpu_torch.ops.fused_mlp import (fused_ln_mlp, ln_mlp_bwd, ln_mlp_bwd_reference,
                                          ln_mlp_fwd, ln_mlp_reference)
from mvlt_tpu_torch.ops.pallas_attention import (attention_bwd, attention_bwd_reference,
                                                 attention_fwd, attention_reference,
                                                 fused_attention)
from mvlt_tpu_torch.ops.mlm_ce import (mlm_ce_bwd, mlm_ce_fwd, mlm_ce_loss,
                                       mlm_nll_bwd_reference, mlm_nll_reference)
from mvlt_tpu_torch.ops.sr_kv import fused_ln_sr_kv, sr_kv_reference

pytestmark = pytest.mark.cuda

TOL = 2e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _block(dim, heads, sr, mlp_ratio, dev, seed):
    """A port Block in eval mode with every parameter perturbed."""
    gen = torch.Generator().manual_seed(seed)
    blk = Block(dim, heads, mlp_ratio, sr, True).eval()
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
    ((8, 8), 32, 2, 2, 4.0, 5, 3),       # head dim 16, M = 21, N = 69
    ((6, 10), 96, 3, 2, 4.0, 7, 2),      # non-square grid, head dim 32
    ((4, 4), 64, 4, 1, 4.0, 9, 2),       # sr == 1: M = N = 25
    ((16, 16), 512, 8, 4, 2.0, 3, 1),    # widest kernel-A variant, M = 19
    ((24, 24), 128, 2, 1, 4.0, 24, 1),   # M = 600: kernel B takes 16-row tiles
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
        # K/V too long for any row tile's shared memory: the launch is refused
        long_kv = torch.zeros(2, heads, 2048, dim // heads, device=dev, dtype=torch.bfloat16)
        with pytest.raises(RuntimeError, match="cudaError_t"):
            fused_block(x, long_kv, long_kv, *_block_args(blk), **kw_b)
    # training mode is the training path: its kernels, not the serving ones
    launches = (fused_ln_sr_kv.launches, fused_block.launches, attention_fwd.launches,
                ln_mlp_fwd.launches)
    out = blk.train()(x, hw)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert (fused_ln_sr_kv.launches, fused_block.launches, attention_fwd.launches,
            ln_mlp_fwd.launches) == (launches[0], launches[1], launches[2] + 1, launches[3] + 1)


def _mlp_params(d, hidden, dev, gen):
    r = lambda *s, std: (std * torch.randn(*s, generator=gen)).to(dev)
    return (1 + r(d, std=0.1), r(d, std=0.1), r(hidden, d, std=d ** -0.5),
            r(hidden, std=0.05), r(d, hidden, std=hidden ** -0.5), r(d, std=0.05))


@pytest.mark.parametrize("b,h,n,m,hd", [
    (2, 3, 300, 600, 32),     # head dim 32, M = 600 (padded to 608), N off the q tile
    (3, 5, 77, 192, 64),      # stage-3 heads, N off the tile
    (1, 1, 17, 5, 16),        # tiny M and N
])
def test_attention_kernels_match_plain(dev, b, h, n, m, hd):
    gen = torch.Generator().manual_seed(n + m)
    bf = lambda *s, std=1.0: (std * torch.randn(*s, generator=gen)).to(dev, torch.bfloat16)
    q, do = bf(b, n, h, hd, std=1.5).transpose(1, 2), bf(b, n, h, hd).transpose(1, 2)
    kv = bf(b, m, 2, h, hd).permute(2, 0, 3, 1, 4)
    k, v = kv[0], kv[1]
    launches = (attention_fwd.launches, attention_bwd.launches)
    o = attention_fwd(q, k, v, hd ** -0.5)
    grads = attention_bwd(q, k, v, do, hd ** -0.5)
    torch.cuda.synchronize()
    assert (attention_fwd.launches, attention_bwd.launches) == (launches[0] + 1, launches[1] + 1)
    assert _rel(o, attention_reference(q, k, v, hd ** -0.5)) <= TOL
    for got, want in zip(grads, attention_bwd_reference(q, k, v, do, hd ** -0.5)):
        assert got.shape == want.shape and _rel(got, want) <= TOL
    # the autograd Function: the same kernels under backward()
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    fused_attention(*leaves, hd ** -0.5).backward(do)
    for leaf, want in zip(leaves, grads):
        assert _rel(leaf.grad, want) <= TOL


@pytest.mark.parametrize("b,n,d,hidden", [
    (2, 333, 320, 1280),      # D = 320 at ratio 4, rows off the tile
    (3, 70, 64, 512),         # ratio 8, the row scale spans samples in a tile
    (2, 20, 512, 2048),       # stage-4 widths, one tile per sample
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
    with pytest.raises(ValueError, match="multiple of 16"):
        attention_fwd(q[..., :24], k[..., :24], k[..., :24], 0.2)
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



@pytest.mark.parametrize("r,v,h,frac", [(70, 1000, 64, 0.5), (513, 4099, 256, 0.2),
                                        (64, 64, 768, 1.0), (200, 30522, 768, 0.15)])
def test_mlm_ce_kernels_match_plain(dev, r, v, h, frac):
    """nll, lse and the three gradients at other widths, ragged row and
    vocabulary counts, a single tile, every row labeled, and labels in the
    last (ragged) vocabulary tile."""
    gen = torch.Generator().manual_seed(r)
    x = torch.randn(r, h, generator=gen).to(dev, torch.bfloat16)
    table = (torch.randn(v, h, generator=gen) * (2.0 / h ** 0.5)).to(dev, torch.bfloat16)
    bias = (0.1 * torch.randn(v, generator=gen)).to(dev)
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
    with pytest.raises(ValueError, match="labels"):
        mlm_ce_fwd(x, table, bias, labels[:5])
    with pytest.raises(ValueError, match="weight on cpu"):
        mlm_ce_fwd(x, table.cpu(), bias, labels)
    with pytest.raises(ValueError, match="lse and g"):
        mlm_ce_bwd(x, table, bias, labels, torch.zeros(10, device=dev), torch.zeros(9, device=dev))
