"""The attention half of a block: LN1 -> Q -> attention against the SR K/V
-> out-proj -> +res, for serving and for training.

Serving: counterpart of
mvlt_tpu/ops/block_attention.py:fused_block_attention_padded (the
lane-padded PVT-v2 serving form) and, at stage 1, of
mvlt_tpu/ops/block_packed.py:fused_attention_p2. ``block_attention_reference``
is the plain version; ``fused_block_attention`` takes it for a CPU tensor
and launches the Hopper kernel (csrc/block_attention.cu, kernel C) for a
CUDA tensor, or raises.

Training: counterpart of mvlt_tpu/ops/block_attention.py:fused_block_attention
with a row scale, whose forward is ``_fba_impl`` (or ``_fba_impl_stats``
with saved statistics) and whose backward is ``_fba_bwd``:
    out = x + s[b] * (proj(concat_h softmax(LN1(x) Wq_h K_h^T * hd^-1/2) V_h) + bp)
with s [B] the per-sample DropPath scale. ``block_attention_train_reference``
and ``block_attention_bwd_reference`` are the plain versions (the latter
written out, in a recompute form and a saved-statistics form);
``block_attention_train_fwd`` and ``block_attention_train_bwd`` take them
for CPU tensors and launch the Hopper kernels (csrc/block_attention_train.cu)
for CUDA tensors, or raise; ``fused_block_attention_train`` is the
differentiable ``autograd.Function`` on the fp32 master parameters.

K and V are [B, heads, M, hd]. The statistics side output is [B, N, 2 + 2H]
fp32 in natural units: per row the LN1 mean and 1/std, then per head h the
row max of the scaled logits (column 2 + 2h) and the reciprocal of the
softmax denominator (column 3 + 2h), so that
P = exp(logits * hd^-1/2 - max) * inv. (The JAX package keeps the max in
exp2 units, times log2(e), and pads the columns to a multiple of 8.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mvlt_tpu_torch.ops import _build
from mvlt_tpu_torch.ops.kernel_math import (acc_dtype, layer_norm_fp32, linear, matmul_acc,
                                            softmax_av)


def attention_residual(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, bp, *,
                       heads: int, eps: float, row_scale=None) -> torch.Tensor:
    """x + s * (proj(attention(LN1(x) Wq + bq, K, V)) + bp), unrounded: the
    sum is fp32 (fp64 for fp64), the products in x.dtype with fp32 LN
    statistics and softmax. Linear weights in torch layout [out, in];
    row_scale [B] (None: ones) scales the projection only."""
    b, n, d = x.shape
    hd = d // heads
    normed = layer_norm_fp32(x, ln1_weight, ln1_bias, eps)
    q = linear(normed, wq, bq).reshape(b, n, heads, hd).transpose(1, 2)
    attn = softmax_av(q, k.to(x.dtype), v.to(x.dtype), scale=hd ** -0.5)
    attn = attn.transpose(1, 2).reshape(b, n, d)
    acc = acc_dtype(x.dtype)
    y = linear(attn, wp, bp).to(acc)
    if row_scale is not None:
        y = y * row_scale.to(acc)[:, None, None]
    return x.to(acc) + y


def block_attention_reference(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, bp, *,
                              heads: int, eps: float) -> torch.Tensor:
    """Plain PyTorch attention half in x.dtype: ``attention_residual``
    rounded once. x [B, N, D]; k, v [B, heads, M, hd]."""
    return attention_residual(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, bp,
                              heads=heads, eps=eps).to(x.dtype)


def fused_block_attention(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, bp, *,
                          heads: int, eps: float) -> torch.Tensor:
    """The attention half of one block. A CPU tensor takes
    ``block_attention_reference``; a CUDA tensor (bf16, contiguous, D and hd
    multiples of 16) launches kernel C, and anything else raises.
    ``fused_block_attention.launches`` counts the kernel launches."""
    if x.device.type == "cpu":
        return block_attention_reference(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, bp,
                                         heads=heads, eps=eps)
    name = "fused_block_attention"
    hd = _check_stream_heads(name, x, heads)
    b, n, d = x.shape
    _build.check_kv(name, k, v, b, heads, hd, x.device)
    dev = x.device
    wq_ = _build.kernel_weight(name, wq, (d, d), dev)
    wp_ = _build.kernel_weight(name, wp, (d, d), dev)
    vec = _build.kernel_vector
    g1, be1 = vec(name, ln1_weight, d, dev), vec(name, ln1_bias, d, dev)
    bq_, bp_ = vec(name, bq, d, dev), vec(name, bp, d, dev)
    out = torch.empty_like(x)
    lib = _build.load_library()
    err = lib.mvlt_block_attention(
        x.data_ptr(), k.data_ptr(), v.data_ptr(), g1.data_ptr(), be1.data_ptr(),
        wq_.data_ptr(), bq_.data_ptr(), wp_.data_ptr(), bp_.data_ptr(), out.data_ptr(),
        b, n, d, heads, k.shape[2], hd ** -0.5, eps, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(name, err)
    fused_block_attention.launches += 1
    return out


fused_block_attention.launches = 0


# ---- the training form ---------------------------------------------------


def _heads(t, heads):
    """[B, N, D] -> [B, heads, N, D / heads]."""
    b, n, d = t.shape
    return t.reshape(b, n, heads, d // heads).transpose(1, 2)


def _merge(t):
    """[B, heads, N, hd] -> [B, N, heads * hd]."""
    b, h, n, hd = t.shape
    return t.transpose(1, 2).reshape(b, n, h * hd)


def _ln_stats(x, eps: float, stats=None):
    """LN1 mean and 1/std [B, N, 1] in the sum type: computed (two-pass),
    or read from a statistics side output."""
    if stats is not None:
        acc = acc_dtype(x.dtype)
        return stats[..., 0:1].to(acc), stats[..., 1:2].to(acc)
    xf = x.to(acc_dtype(x.dtype))
    mean = xf.mean(-1, keepdim=True)
    return mean, torch.rsqrt((xf - mean).square().mean(-1, keepdim=True) + eps)


def _logits(q, k, scale: float):
    """q K^T * scale [B, H, N, M] in the sum type, over operands in q.dtype."""
    return matmul_acc(q, k.transpose(-1, -2), q.dtype) * scale


def block_attention_train_reference(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, bp,
                                    row_scale=None, *, heads: int, eps: float,
                                    save_stats: bool = False):
    """Plain forward of the training form in x.dtype: ``attention_residual``
    with the row scale, rounded once; with ``save_stats`` also the
    statistics [B, N, 2 + 2H] in the sum type (module docstring).
    Differentiable by autograd."""
    out = attention_residual(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, bp, heads=heads,
                             eps=eps, row_scale=row_scale).to(x.dtype)
    if not save_stats:
        return out
    with torch.no_grad():
        mean, rstd = _ln_stats(x, eps)
        q = _heads(linear(layer_norm_fp32(x, ln1_weight, ln1_bias, eps), wq, bq), heads)
        logits = _logits(q, k, (x.shape[-1] // heads) ** -0.5)
        mx = logits.amax(-1)
        inv = 1.0 / torch.exp(logits - mx[..., None]).sum(-1)
        per_head = torch.stack([mx, inv], -1).transpose(1, 2).flatten(2)   # [B, N, 2H]
        stats = torch.cat([mean, rstd, per_head], -1)
    return out, stats


def block_attention_bwd_reference(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, row_scale, dy,
                                  *, heads: int, eps: float, stats=None):
    """Plain backward of the training form for the output gradient dy:
    (dx, dk, dv, dgamma, dbeta, dWq, dbq, dWp, dbp), written out as the
    Pallas backward computes it. Without ``stats`` LN1 and P are recomputed
    (the statistics by reductions); with them nhat = (x - mean) * rstd and
    P = exp(min(logits - max, 0)) * inv are rebuilt by multiplies. Every
    product over operands in x.dtype with the sum in fp32 (fp64 for fp64);
    dx, dk and dv in their inputs' types, the parameter gradients in the sum
    type. Then dys = s * dy, dA = dys Wp, per head dV = P^T dO,
    dP = dO V^T, dS = P (dP - rowsum(dP P)) scale, dQ = dS K, dK = dS^T Q;
    dWp = dys^T A, dWq = dQ^T LN1(x), dLN1 = dQ Wq, dx = dy + the LN1
    backward. Rows with s = 0 pass dy through to dx and add nothing to any
    other gradient. row_scale gets none (a constant)."""
    acc, dt = acc_dtype(x.dtype), x.dtype
    b, n, d = x.shape
    hd = d // heads
    scale = hd ** -0.5
    mean, rstd = _ln_stats(x, eps, stats)
    nhat = (x.to(acc) - mean) * rstd
    normed = (nhat * ln1_weight.to(acc) + ln1_bias.to(acc)).to(dt)
    q = matmul_acc(normed, wq.transpose(0, 1), dt)
    q = _heads((q if bq is None else q + bq.to(acc)).to(dt), heads)
    logits = _logits(q, k, scale)
    if stats is None:
        p = torch.softmax(logits, -1)
    else:
        st = stats[..., 2:].to(acc).reshape(b, n, heads, 2).transpose(1, 2)    # [B, H, N, 2]
        p = torch.exp(torch.clamp(logits - st[..., 0:1], max=0.0)) * st[..., 1:2]
    pb = p.to(dt)
    attn = _merge(matmul_acc(pb, v, dt).to(dt))
    dys = dy.to(acc) * row_scale.to(acc)[:, None, None]
    do = _heads(matmul_acc(dys, wp, dt).to(dt), heads)
    dv = matmul_acc(pb.transpose(-1, -2), do, dt)
    dp = matmul_acc(do, v.transpose(-1, -2), dt)
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True)) * scale).to(dt)
    dq = _merge(matmul_acc(ds, k, dt))
    dk = matmul_acc(ds.transpose(-1, -2), q, dt)
    rows = lambda t: t.reshape(-1, d)
    dwp = matmul_acc(rows(dys).transpose(0, 1), rows(attn), dt)
    dwq = matmul_acc(rows(dq).transpose(0, 1), rows(normed), dt)
    dnormed = matmul_acc(dq, wq, dt)
    dnhat = dnormed * ln1_weight.to(acc)
    dx_ln = (dnhat - dnhat.mean(-1, keepdim=True)
             - nhat * (dnhat * nhat).mean(-1, keepdim=True)) * rstd
    dx = (dy.to(acc) + dx_ln).to(dt)
    return (dx, dk.to(k.dtype), dv.to(v.dtype), rows(dnormed * nhat).sum(0),
            rows(dnormed).sum(0), dwq, rows(dq).sum(0), dwp, rows(dys).sum(0))


def _check_stream_heads(name: str, x, heads: int) -> int:
    """The stream checks of the attention kernels; returns the head dim."""
    _build.check_stream(name, x)
    d = x.shape[-1]
    if d % heads or (d // heads) % 16:
        raise ValueError(f"{name}: D={d} with {heads} heads gives no 16-multiple head dim")
    return d // heads


def _train_operands(name: str, x, k, v, ln1_weight, ln1_bias, wq, bq, wp, row_scale,
                    heads: int):
    """What the training kernels read: (hd, gamma, beta, Wq, bq, Wp, s) as
    bf16 matrices and fp32 vectors, after the stream and K/V checks."""
    hd = _check_stream_heads(name, x, heads)
    b, _, d = x.shape
    _build.check_kv(name, k, v, b, heads, hd, x.device)
    dev, vec = x.device, _build.kernel_vector
    return (hd, vec(name, ln1_weight, d, dev), vec(name, ln1_bias, d, dev),
            _build.kernel_weight(name, wq, (d, d), dev), vec(name, bq, d, dev),
            _build.kernel_weight(name, wp, (d, d), dev), vec(name, row_scale, b, dev))


def block_attention_train_fwd(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, bp, row_scale, *,
                              heads: int, eps: float, save_stats: bool = False):
    """Forward of the training form: out, or (out, stats) with
    ``save_stats``. A CPU tensor takes ``block_attention_train_reference``;
    a CUDA tensor (bf16, contiguous, D and hd multiples of 16) launches the
    kernel (Pallas #6, or #7 with the statistics), anything else raises.
    Counts launches in ``block_attention_train_fwd.launches``."""
    if x.device.type == "cpu":
        return block_attention_train_reference(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, bp,
                                               row_scale, heads=heads, eps=eps,
                                               save_stats=save_stats)
    name = "block_attention_train_fwd"
    hd, g1, be1, wq_, bq_, wp_, s = _train_operands(name, x, k, v, ln1_weight, ln1_bias, wq,
                                                    bq, wp, row_scale, heads)
    b, n, d = x.shape
    bp_ = _build.kernel_vector(name, bp, d, x.device)
    out = torch.empty_like(x)
    stats = (torch.empty((b, n, 2 + 2 * heads), dtype=torch.float32, device=x.device)
             if save_stats else None)
    err = _build.load_library().mvlt_fba_fwd(
        x.data_ptr(), k.data_ptr(), v.data_ptr(), g1.data_ptr(), be1.data_ptr(),
        wq_.data_ptr(), bq_.data_ptr(), wp_.data_ptr(), bp_.data_ptr(), s.data_ptr(),
        out.data_ptr(), None if stats is None else stats.data_ptr(), b, n, d, heads,
        k.shape[2], hd ** -0.5, eps, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(name, err)
    block_attention_train_fwd.launches += 1
    return (out, stats) if save_stats else out


def block_attention_train_bwd(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, row_scale, dy, *,
                              heads: int, eps: float, stats=None):
    """Backward of the training form: (dx, dk, dv, dgamma, dbeta, dWq, dbq,
    dWp, dbp), the recompute form without ``stats``, the saved-statistics
    form with them. A CPU tensor takes ``block_attention_bwd_reference``; a
    CUDA tensor launches the kernels (Pallas #8: a row-tile launch, a
    (sample, head) launch for dK/dV and the in-order sum of the weight
    gradients), anything else raises. Counts launches in
    ``block_attention_train_bwd.launches``."""
    if x.device.type == "cpu":
        return block_attention_bwd_reference(x, k, v, ln1_weight, ln1_bias, wq, bq, wp,
                                             row_scale, dy, heads=heads, eps=eps, stats=stats)
    name = "block_attention_train_bwd"
    hd, g1, be1, wq_, bq_, wp_, s = _train_operands(name, x, k, v, ln1_weight, ln1_bias, wq,
                                                    bq, wp, row_scale, heads)
    _build.check_stream(name, dy)
    b, n, d = x.shape
    if dy.shape != x.shape:
        raise ValueError(f"{name}: dy {tuple(dy.shape)} and x {tuple(x.shape)} differ")
    if stats is not None and (stats.device != x.device or stats.dtype != torch.float32
                              or tuple(stats.shape) != (b, n, 2 + 2 * heads)
                              or not stats.is_contiguous()):
        raise ValueError(f"{name}: stats must be contiguous fp32 [{b}, {n}, {2 + 2 * heads}] "
                         f"on {x.device}, got {tuple(stats.shape)} {stats.dtype}")
    m = k.shape[2]
    # the backward reads K and V as tensor-core fragments: rows padded to 16
    pad = (-m) % 16
    kp, vp = (F.pad(t, (0, 0, 0, pad)) if pad else t for t in (k, v))
    dev = x.device
    lib = _build.load_library()
    # one fp32 slot of partial weight gradients per block, a block per SM
    slots = torch.cuda.get_device_properties(dev).multi_processor_count
    ws = torch.empty(slots * lib.mvlt_fba_slot_floats(d), dtype=torch.float32, device=dev)
    qs, dos = torch.empty_like(x), torch.empty_like(x)
    rs = torch.empty((b, heads, n, 3), dtype=torch.float32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dx, dk, dv = torch.empty_like(x), torch.empty_like(k), torch.empty_like(v)
    dwq, dwp = torch.empty((d, d), **f32), torch.empty((d, d), **f32)
    dbq, dbp, dg, dbe = (torch.empty(d, **f32) for _ in range(4))
    err = lib.mvlt_fba_bwd(
        x.data_ptr(), dy.data_ptr(), kp.data_ptr(), vp.data_ptr(), g1.data_ptr(),
        be1.data_ptr(), wq_.data_ptr(), bq_.data_ptr(), wp_.data_ptr(), s.data_ptr(),
        None if stats is None else stats.data_ptr(), dx.data_ptr(), ws.data_ptr(), slots,
        qs.data_ptr(), dos.data_ptr(), rs.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dwq.data_ptr(), dbq.data_ptr(), dwp.data_ptr(), dbp.data_ptr(), dg.data_ptr(),
        dbe.data_ptr(), b, n, d, heads, m, hd ** -0.5, eps,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(name, err)
    block_attention_train_bwd.launches += 1
    return dx, dk, dv, dg, dbe, dwq, dbq, dwp, dbp


block_attention_train_fwd.launches = 0
block_attention_train_bwd.launches = 0


class FusedBlockAttentionTrain(torch.autograd.Function):
    """The training form on the fp32 master parameters: Wq and Wp rounded to
    x.dtype once per call (not the serving cache), fp32 gradients for every
    parameter, none for the row scale."""

    @staticmethod
    def forward(ctx, x, k, v, ln1_weight, ln1_bias, wq, bq, wp, bp, row_scale, heads, eps,
                save_stats):
        if x.device.type == "cuda":
            k, v = k.contiguous(), v.contiguous()
        wq_c, wp_c = wq.detach().to(x.dtype), wp.detach().to(x.dtype)
        res = block_attention_train_fwd(x, k, v, ln1_weight, ln1_bias, wq_c, bq, wp_c, bp,
                                        row_scale, heads=heads, eps=eps, save_stats=save_stats)
        out, stats = res if save_stats else (res, None)
        ctx.heads, ctx.eps = heads, eps
        ctx.param_dtypes = [None if t is None else t.dtype
                            for t in (ln1_weight, ln1_bias, wq, bq, wp, bp)]
        ctx.save_for_backward(x, k, v, ln1_weight, ln1_bias, wq_c, bq, wp_c, row_scale, stats)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, k, v, g1, be1, wq_c, bq, wp_c, row_scale, stats = ctx.saved_tensors
        if dy.device.type == "cuda":
            dy = dy.contiguous()   # an incoming gradient's layout is autograd's choice
        dx, dk, dv, *grads = block_attention_train_bwd(
            x, k, v, g1, be1, wq_c, bq, wp_c, row_scale, dy, heads=ctx.heads, eps=ctx.eps,
            stats=stats)
        grads = (None if t is None else g.to(t) for g, t in zip(grads, ctx.param_dtypes))
        return (dx, dk, dv, *grads, None, None, None, None)


def fused_block_attention_train(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, bp, row_scale=None,
                                *, heads: int, eps: float, save_stats: bool = False):
    """x + s * (proj(attention(LN1 x)) + bp), differentiable in x, K, V and
    every parameter: the forward and the backward are the kernels on CUDA
    tensors and their plain versions on CPU tensors; ``save_stats`` picks the
    saved-statistics backward. row_scale None means ones."""
    if row_scale is None:
        row_scale = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    return FusedBlockAttentionTrain.apply(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, bp,
                                          row_scale, heads, eps, save_stats)
