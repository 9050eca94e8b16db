"""The attention half of a block: LN1 -> Q -> attention against the SR K/V
-> out-proj -> +res, for serving and for training.

Serving: counterpart of
mvlt_tpu/ops/block_attention.py:fused_block_attention_padded (the
lane-padded PVT-v2 serving form) and, at stage 1, of
mvlt_tpu/ops/block_packed.py:fused_attention_p2. ``block_attention_reference``
is the plain version; ``fused_block_attention`` takes it for a CPU tensor
and launches the Hopper kernels (csrc/block_attention.cu, kernel C: the
attention-half chain of csrc/attn_chain.cuh over the scratch that
``fwd_scratch`` sizes) for a CUDA tensor, or raises.

Training: counterpart of mvlt_tpu/ops/block_attention.py:fused_block_attention
with a row scale, whose forward is ``_fba_impl`` (or ``_fba_impl_stats``
with saved statistics) and whose backward is ``_fba_bwd``:
    out = x + s[b] * (proj(concat_h softmax(LN1(x) Wq_h K_h^T * hd^-1/2) V_h) + bp)
with s [B] the per-sample DropPath scale. ``block_attention_train_reference``
and ``block_attention_bwd_reference`` are the plain versions (the latter
written out, in a recompute form and a saved-statistics form);
``block_attention_train_fwd`` and ``block_attention_train_bwd`` take them
for CPU tensors and launch the Hopper kernels (csrc/block_attention_train.cu:
chains of launches that run the attention core on csrc/attention.cu's
kernels) for CUDA tensors, or raise; ``fused_block_attention_train`` is the
differentiable ``autograd.Function`` on the fp32 master parameters.
``fwd_scratch`` sizes the forward's scratch (kernels B and C share it),
``bwd_plan``, ``bwd_col_blocks`` and ``bwd_scratch`` the backward's
launches and scratch.

Tensor-parallel mode of the training form (``block_attention_train_fwd_tp``,
``block_attention_train_bwd_tp``; plain versions
``block_attention_train_reference(partial=True)`` and
``block_attention_bwd_reference(partial=True)``): on a rank's H heads (Wq,
bq its [H hd, D] rows, Wp its [D, H hd] columns, K and V its heads, hd =
Wq's rows / H) the forward gives the fp32 partial s (A Wp^T) without bp and
x (the statistics: LN1's of the whole row, the max and 1/denominator of the
rank's heads), and the backward the fp32 LN1 backward of the rank's dLN1
without dy, dgamma and dbeta of the rank's heads, dWq, dbq, dWp of its
shard and dK, dV of its heads; dbp is whole. The model group sums the
partials (parallel/tensor.py:fused_attn_tp).

K and V are [B, heads, M, hd]. The statistics side output is [B, N, 2 + 2H]
fp32 in natural units: per row the LN1 mean and 1/std, then per head h the
row max of the scaled logits (column 2 + 2h) and the reciprocal of the
softmax denominator (column 3 + 2h), so that
P = exp(logits * hd^-1/2 - max) * inv. (The JAX package keeps the max in
exp2 units, times log2(e), and pads the columns to a multiple of 8.)
"""

from __future__ import annotations

import torch

from mvlt_tpu_torch.ops import _build
# the wgmma tiles (csrc/hopper.cuh: kGemmTile, kGemmChunk) and the most row
# ranges of a weight gradient, as the LN-MLP backward's plan takes them
from mvlt_tpu_torch.ops.fused_mlp import BWD_CHUNK, BWD_TILE, MAX_SPLITS
from mvlt_tpu_torch.ops.kernel_math import (acc_dtype, layer_norm_fp32, linear, matmul_acc,
                                            softmax_av)
from mvlt_tpu_torch.ops.pallas_attention import HEAD_DIMS, TILE, plan_splits
from mvlt_tpu_torch.utils.profiling import op_span

# the rows a block of the backward's finishing row kernel takes at least,
# in at most BWD_MAX_COL_BLOCKS blocks
BWD_COL_ROWS = 256
BWD_MAX_COL_BLOCKS = 512


def attention_residual(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, bp, *,
                       heads: int, eps: float, row_scale=None,
                       partial: bool = False) -> torch.Tensor:
    """x + s * (proj(attention(LN1(x) Wq + bq, K, V)) + bp), unrounded: the
    sum is fp32 (fp64 for fp64), the products in x.dtype with fp32 LN
    statistics and softmax. Linear weights in torch layout [out, in], the
    head dim Wq's rows / heads; row_scale [B] (None: ones) scales the
    projection only. With ``partial`` (the tensor-parallel mode; bp unused)
    s (A Wp^T) alone, its product unrounded."""
    b, n, _ = x.shape
    dh = wq.shape[0]
    hd = dh // heads
    normed = layer_norm_fp32(x, ln1_weight, ln1_bias, eps)
    q = linear(normed, wq, bq).reshape(b, n, heads, hd).transpose(1, 2)
    attn = softmax_av(q, k.to(x.dtype), v.to(x.dtype), scale=hd ** -0.5)
    attn = attn.transpose(1, 2).reshape(b, n, dh)
    acc = acc_dtype(x.dtype)
    y = (matmul_acc(attn, wp.transpose(0, 1), x.dtype) if partial
         else linear(attn, wp, bp).to(acc))
    if row_scale is not None:
        y = y * row_scale.to(acc)[:, None, None]
    return y if partial else x.to(acc) + y


def block_attention_reference(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, bp, *,
                              heads: int, eps: float) -> torch.Tensor:
    """Plain PyTorch attention half in x.dtype: ``attention_residual``
    rounded once. x [B, N, D]; k, v [B, heads, M, hd]."""
    return attention_residual(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, bp,
                              heads=heads, eps=eps).to(x.dtype)


@op_span
def fused_block_attention(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, bp, *,
                          heads: int, eps: float) -> torch.Tensor:
    """The attention half of one block. A CPU tensor takes
    ``block_attention_reference``; a CUDA tensor (bf16, contiguous, D a
    multiple of 16 and at most 512, head dim 32 or 64) launches kernel C's
    chain, and anything else raises. ``fused_block_attention.launches``
    counts the chain's launches (one a call)."""
    if x.device.type == "cpu":
        return block_attention_reference(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, bp,
                                         heads=heads, eps=eps)
    name = "fused_block_attention"
    hd = _check_stream_heads(name, x, heads)
    b, n, d = x.shape
    if hd not in HEAD_DIMS or d > 512:
        raise ValueError(f"{name}: D={d} with {heads} heads: the chain takes D <= 512 and "
                         f"head dims {HEAD_DIMS}")
    _build.check_kv(name, k, v, b, heads, hd, x.device)
    dev = x.device
    wq_ = _build.kernel_weight(name, wq, (d, d), dev)
    wp_ = _build.kernel_weight(name, wp, (d, d), dev)
    vec = _build.kernel_vector
    g1, be1 = vec(name, ln1_weight, d, dev), vec(name, ln1_bias, d, dev)
    bq_, bp_ = vec(name, bq, d, dev), vec(name, bp, d, dev)
    out = torch.empty_like(x)
    work = [torch.empty(max(count, 1), dtype=dt, device=dev)
            for count, dt in fwd_scratch(b, n, d, heads).values()]
    lib = _build.load_library()
    err = lib.mvlt_block_attention(
        x.data_ptr(), k.data_ptr(), v.data_ptr(), g1.data_ptr(), be1.data_ptr(),
        wq_.data_ptr(), bq_.data_ptr(), wp_.data_ptr(), bp_.data_ptr(), out.data_ptr(),
        *(t.data_ptr() for t in work), b, n, d, heads, k.shape[2], hd ** -0.5, eps,
        torch.cuda.current_stream(dev).cuda_stream)
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
                                    save_stats: bool = False, partial: bool = False):
    """Plain forward of the training form in x.dtype: ``attention_residual``
    with the row scale, rounded once; with ``save_stats`` also the
    statistics [B, N, 2 + 2H] in the sum type (module docstring). With
    ``partial`` (the tensor-parallel mode on the rank's heads; bp unused)
    the unrounded partial s (A Wp^T) in the sum type. Differentiable by
    autograd."""
    out = attention_residual(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, bp, heads=heads,
                             eps=eps, row_scale=row_scale, partial=partial)
    if not partial:
        out = out.to(x.dtype)
    if not save_stats:
        return out
    with torch.no_grad():
        mean, rstd = _ln_stats(x, eps)
        q = _heads(linear(layer_norm_fp32(x, ln1_weight, ln1_bias, eps), wq, bq), heads)
        logits = _logits(q, k, (wq.shape[0] // heads) ** -0.5)
        mx = logits.amax(-1)
        inv = 1.0 / torch.exp(logits - mx[..., None]).sum(-1)
        per_head = torch.stack([mx, inv], -1).transpose(1, 2).flatten(2)   # [B, N, 2H]
        stats = torch.cat([mean, rstd, per_head], -1)
    return out, stats


def block_attention_bwd_reference(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, row_scale, dy,
                                  *, heads: int, eps: float, stats=None, partial: bool = False):
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
    other gradient. row_scale gets none (a constant). With ``partial`` (the
    tensor-parallel mode on the rank's heads, hd = Wq's rows / heads) dx is
    the LN1 backward alone, unrounded in the sum type."""
    acc, dt = acc_dtype(x.dtype), x.dtype
    b, n, d = x.shape
    hd = wq.shape[0] // heads
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
    rows = lambda t: t.reshape(-1, t.shape[-1])
    dwp = matmul_acc(rows(dys).transpose(0, 1), rows(attn), dt)
    dwq = matmul_acc(rows(dq).transpose(0, 1), rows(normed), dt)
    dnormed = matmul_acc(dq, wq, dt)
    dnhat = dnormed * ln1_weight.to(acc)
    dx_ln = (dnhat - dnhat.mean(-1, keepdim=True)
             - nhat * (dnhat * nhat).mean(-1, keepdim=True)) * rstd
    dx = dx_ln if partial else (dy.to(acc) + dx_ln).to(dt)
    return (dx, dk.to(k.dtype), dv.to(v.dtype), rows(dnormed * nhat).sum(0),
            rows(dnormed).sum(0), dwq, rows(dq).sum(0), dwp, rows(dys).sum(0))


def _check_stream_heads(name: str, x, heads: int, hd: int = 0) -> int:
    """The stream checks of the attention kernels; returns the head dim
    (``hd``, or D / heads where it is 0)."""
    _build.check_stream(name, x)
    d = x.shape[-1]
    if not hd and d % heads:
        raise ValueError(f"{name}: D={d} with {heads} heads gives no 16-multiple head dim")
    hd = hd or d // heads
    if hd % 16 or heads * hd > d:
        raise ValueError(f"{name}: D={d} with {heads} heads of {hd}: no 16-multiple head dim "
                         f"within D")
    return hd


def check_train_heads(name: str, d: int, heads: int) -> None:
    """The backward's attention core (csrc/attention.cu) takes head dims 32
    and 64 only; the training form refuses any other before its forward
    launches, so that a step never fails halfway into its backward. ``d``:
    the heads' width (D, or a rank's heads' under tensor parallelism)."""
    if d % heads or d // heads not in HEAD_DIMS:
        raise ValueError(f"{name}: D={d} with {heads} heads gives head dim {d / heads:g}; "
                         f"the training kernels take head dims {HEAD_DIMS}")


def bwd_plan(rows: int, d: int, sms: int, dh: int = 0) -> int:
    """Row ranges of the backward's weight-gradient GEMMs (dWq and dWp in one
    launch, each of ceil(D/128) ceil(dh/128) output tiles, dh the heads'
    width, D where 0; contracting over the rows in 64-row chunks): the
    fewest whose blocks fill at least 90% of their last wave on ``sms``
    SMs (else the fullest), no range empty. Each range sums into an fp32
    slot, added in order after."""
    tiles = 2 * (-(-d // BWD_TILE)) * (-(-(dh or d) // BWD_TILE))
    return _build.split_plan(tiles, -(-rows // BWD_CHUNK), sms, MAX_SPLITS)


def bwd_col_blocks(rows: int) -> int:
    """Blocks of the backward's finishing row kernel, each writing one slot
    of column sums: one per BWD_COL_ROWS rows, at most BWD_MAX_COL_BLOCKS. A
    function of the rows alone, so the sums' order is fixed."""
    return min(-(-rows // BWD_COL_ROWS), BWD_MAX_COL_BLOCKS)


def fwd_scratch(batch: int, n: int, d: int, heads: int, hd: int = 0) -> dict:
    """The forward's scratch, name -> (elements, dtype), in the order the C
    entry takes it: LN1(x) bf16 [rows, D], Q and the attention output A
    bf16 [rows, heads hd] (hd = D / heads where 0), the attention core's
    lse [B, H, N] fp32 (written, not read)."""
    bf16, rows = torch.bfloat16, batch * n
    dh = heads * hd if hd else d
    return {"nrm": (rows * d, bf16), "q": (rows * dh, bf16), "attn": (rows * dh, bf16),
            "lse": (batch * heads * n, torch.float32)}


def bwd_scratch(batch: int, n: int, d: int, heads: int, m: int, splits: int,
                attn_splits: int, hd: int = 0) -> dict:
    """The backward's scratch, name -> (elements, dtype), in the order the C
    entry takes it, for heads of hd (D / heads where 0), dh = heads hd
    wide: LN1(x) and s.dy bf16 [rows, D]; Q then dO bf16 [2, rows, dh] in a
    [2, rows, D] space (dLN1 in fp32 over it once they are read); A = P V
    and dQ bf16 [rows, dh]; (mean, rstd) [rows]; lse [B, H, N]; column-sum
    slots [col blocks, 4, D]; the weight gradients' slots [2, splits, dh, D]
    (0 for one range, written straight to dWq/dWp); the attention
    backward's dK/dV slots [attn_splits, 2, B.H.M.hd] (0 for one split) and
    its fp32 dq sum where M > 192 (else 0)."""
    bf16, f32 = torch.bfloat16, torch.float32
    hd = hd or d // heads
    rows, dh = batch * n, heads * hd
    bhm = batch * heads * m * hd
    return {"nrm": (rows * d, bf16), "dys": (rows * d, bf16), "qdo": (2 * rows * d, bf16),
            "attn": (rows * dh, bf16), "dq": (rows * dh, bf16), "st": (2 * rows, f32),
            "lse": (batch * heads * n, f32), "colp": (bwd_col_blocks(rows) * 4 * d, f32),
            "wslots": (2 * splits * d * dh if splits > 1 else 0, f32),
            "aslots": (2 * attn_splits * bhm if attn_splits > 1 else 0, f32),
            "dq_acc": (batch * heads * n * hd if m > 3 * TILE else 0, f32)}


def _train_operands(name: str, x, k, v, ln1_weight, ln1_bias, wq, bq, wp, row_scale,
                    heads: int, partial: bool):
    """What the training kernels read: (hd, dh, gamma, beta, Wq, bq, Wp, s)
    as bf16 matrices and fp32 vectors, after the stream, head and K/V
    checks; ``partial``: a rank's heads, hd from Wq's rows (else D / heads,
    Wq whole)."""
    b, _, d = x.shape
    if partial and (wq.dim() != 2 or wq.shape[0] % heads):
        raise ValueError(f"{name}: Wq {tuple(wq.shape)} holds no whole {heads} heads")
    hd = _check_stream_heads(name, x, heads, wq.shape[0] // heads if partial else 0)
    dh = heads * hd
    check_train_heads(name, dh, heads)
    _build.check_kv(name, k, v, b, heads, hd, x.device)
    dev, vec = x.device, _build.kernel_vector
    return (hd, dh, vec(name, ln1_weight, d, dev), vec(name, ln1_bias, d, dev),
            _build.kernel_weight(name, wq, (dh, d), dev), vec(name, bq, dh, dev),
            _build.kernel_weight(name, wp, (d, dh), dev), vec(name, row_scale, b, dev))


def _fwd_launch(name: str, x, k, v, ln1_weight, ln1_bias, wq, bq, wp, bp, row_scale, *,
                heads: int, eps: float, save_stats: bool, partial: bool):
    """The forward's chain on a CUDA tensor: (out or the fp32 partial,
    stats or None)."""
    hd, dh, g1, be1, wq_, bq_, wp_, s = _train_operands(name, x, k, v, ln1_weight, ln1_bias,
                                                        wq, bq, wp, row_scale, heads, partial)
    b, n, d = x.shape
    bp_ = None if partial else _build.kernel_vector(name, bp, d, x.device)
    out = (torch.empty(x.shape, dtype=torch.float32, device=x.device) if partial
           else torch.empty_like(x))
    stats = (torch.empty((b, n, 2 + 2 * heads), dtype=torch.float32, device=x.device)
             if save_stats else None)
    work = [torch.empty(count, dtype=dt, device=x.device)
            for count, dt in fwd_scratch(b, n, d, heads, hd).values()]
    err = _build.load_library().mvlt_fba_fwd(
        x.data_ptr(), k.data_ptr(), v.data_ptr(), g1.data_ptr(), be1.data_ptr(),
        wq_.data_ptr(), bq_.data_ptr(), wp_.data_ptr(), None if partial else bp_.data_ptr(),
        s.data_ptr(), None if partial else out.data_ptr(),
        None if stats is None else stats.data_ptr(), *(t.data_ptr() for t in work),
        out.data_ptr() if partial else None, b, n, d, heads, k.shape[2], hd, hd ** -0.5, eps,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(name, err)
    return out, stats


@op_span
def block_attention_train_fwd(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, bp, row_scale, *,
                              heads: int, eps: float, save_stats: bool = False):
    """Forward of the training form: out, or (out, stats) with
    ``save_stats``. A CPU tensor takes ``block_attention_train_reference``;
    a CUDA tensor (bf16, contiguous, D a multiple of 16, head dim 32 or 64)
    launches the chain (Pallas #6, or #7 with the statistics: LN1, Q, the
    attention core, the scaled projection) with the scratch of
    ``fwd_scratch``, anything else raises. Counts calls in
    ``block_attention_train_fwd.launches``."""
    if x.device.type == "cpu":
        return block_attention_train_reference(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, bp,
                                               row_scale, heads=heads, eps=eps,
                                               save_stats=save_stats)
    out, stats = _fwd_launch("block_attention_train_fwd", x, k, v, ln1_weight, ln1_bias, wq,
                             bq, wp, bp, row_scale, heads=heads, eps=eps,
                             save_stats=save_stats, partial=False)
    block_attention_train_fwd.launches += 1
    return (out, stats) if save_stats else out


@op_span
def block_attention_train_fwd_tp(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, row_scale, *,
                                 heads: int, eps: float, save_stats: bool = False):
    """Forward of the tensor-parallel mode on a rank's ``heads`` heads (Wq,
    bq its rows, Wp its columns): the fp32 partial s (A Wp^T) [B, N, D], or
    (partial, stats) with ``save_stats``. A CPU tensor takes
    ``block_attention_train_reference(partial=True)``; a CUDA tensor
    launches the chain with its out-projection writing the partial,
    anything else raises. Counts calls in
    ``block_attention_train_fwd_tp.launches``."""
    if x.device.type == "cpu":
        return block_attention_train_reference(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, None,
                                               row_scale, heads=heads, eps=eps,
                                               save_stats=save_stats, partial=True)
    out, stats = _fwd_launch("block_attention_train_fwd_tp", x, k, v, ln1_weight, ln1_bias,
                             wq, bq, wp, None, row_scale, heads=heads, eps=eps,
                             save_stats=save_stats, partial=True)
    block_attention_train_fwd_tp.launches += 1
    return (out, stats) if save_stats else out


def _bwd_launch(name: str, x, k, v, ln1_weight, ln1_bias, wq, bq, wp, row_scale, dy, *,
                heads: int, eps: float, stats, partial: bool):
    """The backward's kernels on a CUDA tensor; with ``partial`` dx is the
    fp32 partial of the tensor-parallel mode."""
    hd, dh, g1, be1, wq_, bq_, wp_, s = _train_operands(name, x, k, v, ln1_weight, ln1_bias,
                                                        wq, bq, wp, row_scale, heads, partial)
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
    dev = x.device
    sms = _build.sm_count(dev.index)
    splits, attn_splits = bwd_plan(b * n, d, sms, dh), plan_splits(b * heads, n, sms)
    scratch = [torch.empty(max(count, 1), dtype=dt, device=dev)
               for count, dt in bwd_scratch(b, n, d, heads, m, splits, attn_splits,
                                            hd).values()]
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty(x.shape, **f32) if partial else torch.empty_like(x)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dwq, dwp = torch.empty((dh, d), **f32), torch.empty((d, dh), **f32)
    dbq, dbp, dg, dbe = (torch.empty(c, **f32) for c in (dh, d, d, d))
    err = _build.load_library().mvlt_fba_bwd(
        x.data_ptr(), dy.data_ptr(), k.data_ptr(), v.data_ptr(), g1.data_ptr(),
        be1.data_ptr(), wq_.data_ptr(), bq_.data_ptr(), wp_.data_ptr(), s.data_ptr(),
        None if stats is None else stats.data_ptr(), None if partial else dx.data_ptr(),
        *(t.data_ptr() for t in scratch), dk.data_ptr(), dv.data_ptr(), dwq.data_ptr(),
        dbq.data_ptr(), dwp.data_ptr(), dbp.data_ptr(), dg.data_ptr(), dbe.data_ptr(),
        dx.data_ptr() if partial else None, b, n, d, heads, m, hd, splits, attn_splits,
        bwd_col_blocks(b * n), hd ** -0.5, eps, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(name, err)
    return dx, dk, dv, dg, dbe, dwq, dbq, dwp, dbp


@op_span
def block_attention_train_bwd(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, row_scale, dy, *,
                              heads: int, eps: float, stats=None):
    """Backward of the training form: (dx, dk, dv, dgamma, dbeta, dWq, dbq,
    dWp, dbp), the recompute form without ``stats``, the saved-statistics
    form with them. A CPU tensor takes ``block_attention_bwd_reference``; a
    CUDA tensor (head dim 32 or 64) launches the kernels (Pallas #8: the
    rows' LN1 and s.dy, Q and dO, the attention core's forward and backward,
    the weight gradients, dLN1, dx with the column sums, the in-order slot
    sums) with the scratch of ``bwd_scratch``, anything else raises. Counts
    launches in ``block_attention_train_bwd.launches``."""
    if x.device.type == "cpu":
        return block_attention_bwd_reference(x, k, v, ln1_weight, ln1_bias, wq, bq, wp,
                                             row_scale, dy, heads=heads, eps=eps, stats=stats)
    out = _bwd_launch("block_attention_train_bwd", x, k, v, ln1_weight, ln1_bias, wq, bq, wp,
                      row_scale, dy, heads=heads, eps=eps, stats=stats, partial=False)
    block_attention_train_bwd.launches += 1
    return out


@op_span
def block_attention_train_bwd_tp(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, row_scale, dy, *,
                                 heads: int, eps: float, stats=None):
    """Backward of the tensor-parallel mode on a rank's ``heads`` heads:
    (dx, dk, dv, dgamma, dbeta, dWq, dbq, dWp, dbp) with dx the fp32 LN1
    backward of the rank's dLN1 without dy and dgamma, dbeta partial (the
    model group sums them), the shard's dWq, dbq, dWp and dbp whole. A CPU
    tensor takes ``block_attention_bwd_reference(partial=True)``; a CUDA
    tensor launches the kernels, anything else raises. Counts launches in
    ``block_attention_train_bwd_tp.launches``."""
    if x.device.type == "cpu":
        return block_attention_bwd_reference(x, k, v, ln1_weight, ln1_bias, wq, bq, wp,
                                             row_scale, dy, heads=heads, eps=eps, stats=stats,
                                             partial=True)
    out = _bwd_launch("block_attention_train_bwd_tp", x, k, v, ln1_weight, ln1_bias, wq, bq,
                      wp, row_scale, dy, heads=heads, eps=eps, stats=stats, partial=True)
    block_attention_train_bwd_tp.launches += 1
    return out


block_attention_train_fwd.launches = 0
block_attention_train_bwd.launches = 0
block_attention_train_fwd_tp.launches = 0
block_attention_train_bwd_tp.launches = 0


class FusedBlockAttentionTrain(torch.autograd.Function):
    """The training form on the fp32 master parameters: Wq and Wp rounded to
    x.dtype once per call (not the serving cache), fp32 gradients for every
    parameter, none for the row scale."""

    @staticmethod
    def forward(ctx, x, k, v, ln1_weight, ln1_bias, wq, bq, wp, bp, row_scale, heads, eps,
                save_stats):
        if x.device.type == "cuda":
            check_train_heads("fused_block_attention_train", x.shape[-1], heads)
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
