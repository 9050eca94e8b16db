"""LN -> fc1 -> GELU(erf) -> fc2 -> scaled residual of the training path,
forward and backward:
    y = x + s * (GELU(LN(x) W1^T + b1) W2^T + b2)
with x [B, N, D], W1 [H, D] and W2 [D, H] in torch Linear layout, and s [B]
the per-sample DropPath scale (mask / keep; ones when DropPath is off).

Counterpart of mvlt_tpu/ops/fused_mlp.py:fused_ln_mlp (forward
``_fused_ln_mlp_impl``, backward ``_fused_ln_mlp_bwd``), with gelu="erf".
The plain versions are ``ln_mlp_reference`` and ``ln_mlp_bwd_reference``;
the latter recomputes the hidden as the Pallas backward does.
``ln_mlp_fwd`` and ``ln_mlp_bwd`` take them for CPU tensors and launch the
Hopper kernels (csrc/ln_mlp.cu, csrc/ln_mlp_bwd.cu) for CUDA tensors, or
raise (``fwd_fused`` and ``fwd_scratch`` say which form of the forward runs
and what scratch it takes); ``fused_ln_mlp`` is the differentiable ``autograd.Function``. It
takes the fp32 master parameters, rounds the matrices to x.dtype inside,
and returns fp32 gradients for them; s gets no gradient (the DropPath mask
is a constant).

Tensor-parallel mode (``ln_mlp_fwd_tp``, ``ln_mlp_bwd_tp``; plain versions
``ln_mlp_reference(partial=True)`` and ``ln_mlp_bwd_reference(
passthrough=False)``): on a rank's [H / tp] slice of the hidden (W1, b1 its
rows, W2 its columns) the forward gives the fp32 partial s (G W2^T), without
b2 and x, and the backward the fp32 LN-backward of the rank's dn without the
dy passthrough, with the rank's partial dgamma and dbeta; the model group
sums them (parallel/tensor.py:fused_ln_mlp_tp).
"""

from __future__ import annotations

import torch

from mvlt_tpu_torch.ops import _build
from mvlt_tpu_torch.ops.kernel_math import (acc_dtype, gelu, gelu_grad, layer_norm_bwd,
                                            layer_norm_fp32, matmul_acc)


# the widest stream of the one-launch forward (csrc/ln_mlp.cu: kFusedMaxD)
FWD_FUSED_MAX_D = 128
# the backward's tiles (csrc/hopper.cuh: kGemmTile, kGemmChunk) and the rows
# a block of its row kernel sums over (csrc/ln_mlp_bwd.cu: kColRows)
BWD_TILE = 128
BWD_CHUNK = 64
BWD_COL_ROWS = 128
MAX_SPLITS = 64


def _rows_scale(row_scale, x):
    """[B] per-sample scale -> [B, 1, 1] in the sum type."""
    return row_scale.to(acc_dtype(x.dtype))[:, None, None]


def ln_mlp_reference(x, gamma, beta, w1, b1, w2, b2, row_scale, eps: float,
                     partial: bool = False):
    """Plain forward in x.dtype: LN statistics, the products' sums, GELU and
    the residual in fp32, the LN output and the GELU output rounded to
    x.dtype before the products. With ``partial`` (the tensor-parallel
    mode; b2 unused) the unrounded s (G W2^T) in fp32 (fp64 for fp64)."""
    acc = acc_dtype(x.dtype)
    normed = layer_norm_fp32(x, gamma, beta, eps)
    h = matmul_acc(normed, w1.transpose(0, 1), x.dtype) + b1.to(acc)
    y = matmul_acc(gelu(h).to(x.dtype), w2.transpose(0, 1), x.dtype)
    if partial:
        return _rows_scale(row_scale, x) * y
    return (x.to(acc) + _rows_scale(row_scale, x) * (y + b2.to(acc))).to(x.dtype)


def ln_mlp_bwd_reference(x, gamma, beta, w1, b1, w2, row_scale, eps: float, dy,
                         passthrough: bool = True):
    """Plain backward for the output gradient dy: (dx, dgamma, dbeta, dW1,
    db1, dW2, db2), the hidden recomputed; parameter gradients in fp32 (fp64
    for fp64), dx in x.dtype. Rows with s = 0 pass dy through to dx.
    Without ``passthrough`` (the tensor-parallel mode) dx is the LN
    backward of dn alone, unrounded in fp32 (fp64 for fp64)."""
    acc = acc_dtype(x.dtype)
    dt = x.dtype
    d, hidden = x.shape[-1], w1.shape[0]
    normed = layer_norm_fp32(x, gamma, beta, eps)
    h1 = matmul_acc(normed, w1.transpose(0, 1), dt) + b1.to(acc)
    g = gelu(h1).to(dt)
    dys = dy.to(acc) * _rows_scale(row_scale, x)
    rows_dys = dys.reshape(-1, d)
    db2 = rows_dys.sum(0)
    dw2 = matmul_acc(rows_dys.transpose(0, 1), g.reshape(-1, hidden), dt)
    dh1 = matmul_acc(dys, w2, dt) * gelu_grad(h1)
    rows_dh1 = dh1.reshape(-1, hidden)
    db1 = rows_dh1.sum(0)
    dw1 = matmul_acc(rows_dh1.transpose(0, 1), normed.reshape(-1, d), dt)
    dnormed = matmul_acc(dh1, w1, dt)
    dx_ln, dgamma, dbeta = layer_norm_bwd(x, gamma, eps, dnormed)
    dx = (dy.to(acc) + dx_ln).to(dt) if passthrough else dx_ln
    return dx, dgamma, dbeta, dw1, db1, dw2, db2


def _check(name: str, x, gamma, beta, w1, b1, w2, b2, row_scale):
    """Shapes, devices and types the kernels take; returns the operands as
    they read them (bf16 matrices, fp32 vectors and row scale)."""
    _build.check_stream(name, x)
    b, n, d = x.shape
    hidden = w1.shape[0]
    if d > 512 or hidden % 16:
        raise ValueError(f"{name}: D = {d} (<= 512) and hidden {hidden} (a multiple "
                         f"of 16) out of range")
    dev = x.device
    vec = _build.kernel_vector
    s = vec(name, row_scale, b, dev)
    return (vec(name, gamma, d, dev), vec(name, beta, d, dev),
            _build.kernel_weight(name, w1, (hidden, d), dev), vec(name, b1, hidden, dev),
            _build.kernel_weight(name, w2, (d, hidden), dev),
            None if b2 is None else vec(name, b2, d, dev), s)


def fwd_fused(d: int) -> bool:
    """Whether the forward is the one-launch kernel (the hidden kept on chip,
    the fc2 sum [64, D] in a warpgroup's registers: D <= 128) or the
    three-launch form through LN(x) and G in device memory."""
    return d <= FWD_FUSED_MAX_D


def fwd_scratch(rows: int, d: int, hidden: int, fused: bool) -> dict:
    """The forward's scratch, name -> (elements, dtype): none for the
    one-launch kernel; LN(x) bf16 [rows, D] and G = GELU(h1) bf16 [rows, H]
    for the three-launch form."""
    bf16 = torch.bfloat16
    return {"nrm": (0 if fused else rows * d, bf16), "g": (0 if fused else rows * hidden, bf16)}


def bwd_plan(rows: int, d: int, hidden: int, sms: int) -> int:
    """Row ranges of the backward's weight-gradient GEMMs (dW1 and dW2 in
    one launch, each of ceil(D/128) x ceil(H/128) output tiles, contracting
    over the rows in 64-row chunks): the fewest whose blocks fill at least
    90% of their last wave on ``sms`` SMs (else the fullest), no range
    empty. Each range sums into an fp32 slot, added in order after."""
    tiles = 2 * (-(-d // BWD_TILE)) * (-(-hidden // BWD_TILE))
    return _build.split_plan(tiles, -(-rows // BWD_CHUNK), sms, MAX_SPLITS)


def bwd_scratch(rows: int, d: int, hidden: int, splits: int) -> dict:
    """The backward's scratch, name -> (elements, dtype), in the order the
    kernels take it: LN(x) and s.dy in bf16 [rows, D], (mean, rstd) [rows];
    G and dh1 in bf16 [rows, H]; dn in fp32 [rows, D] -- 0 elements where it
    fits in G's space (H >= 2D), which the weight gradients have read before
    dn is written; db1 partials [row tiles, H]; column-sum partials of s.dy,
    dn.nhat and dn [row blocks, 3, D]; the weight gradients' slots [2,
    splits, H, D] (0 elements for one range, written straight to dW1/dW2)."""
    bf16, f32 = torch.bfloat16, torch.float32
    return {"nhat": (rows * d, bf16), "dys": (rows * d, bf16), "stats": (2 * rows, f32),
            "g": (rows * hidden, bf16), "dh": (rows * hidden, bf16),
            "dn": (0 if hidden >= 2 * d else rows * d, f32),
            "db1p": (-(-rows // BWD_TILE) * hidden, f32),
            "colp": (-(-rows // BWD_COL_ROWS) * 3 * d, f32),
            "wslots": (2 * splits * hidden * d if splits > 1 else 0, f32)}


def _fwd_launch(name: str, x, gamma, beta, w1, b1, w2, b2, row_scale, eps: float,
                partial: bool):
    """The forward's kernels on a CUDA tensor: y in x.dtype, or with
    ``partial`` the fp32 partial of the tensor-parallel mode."""
    g, be, w1_, b1_, w2_, b2_, s = _check(name, x, gamma, beta, w1, b1, w2, b2, row_scale)
    b, n, d = x.shape
    hidden = w1.shape[0]
    fused = fwd_fused(d)
    scratch = [torch.empty(max(count, 1), dtype=dt, device=x.device)
               for count, dt in fwd_scratch(b * n, d, hidden, fused).values()]
    out = (torch.empty(x.shape, dtype=torch.float32, device=x.device) if partial
           else torch.empty_like(x))
    err = _build.load_library().mvlt_ln_mlp_fwd(
        x.data_ptr(), g.data_ptr(), be.data_ptr(), w1_.data_ptr(), b1_.data_ptr(),
        w2_.data_ptr(), None if partial else b2_.data_ptr(), s.data_ptr(),
        None if partial else out.data_ptr(), *(t.data_ptr() for t in scratch), b * n, n, d,
        hidden, int(fused), 0, eps, out.data_ptr() if partial else None,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(name, err)
    return out


def ln_mlp_fwd(x, gamma, beta, w1, b1, w2, b2, row_scale, eps: float):
    """Forward. A CPU tensor takes ``ln_mlp_reference``; a CUDA tensor
    launches the kernel (one launch for D <= 128, else three with the
    scratch of ``fwd_scratch``), anything else raises. Counts launches in
    ``ln_mlp_fwd.launches``."""
    if x.device.type == "cpu":
        return ln_mlp_reference(x, gamma, beta, w1, b1, w2, b2, row_scale, eps)
    out = _fwd_launch("ln_mlp_fwd", x, gamma, beta, w1, b1, w2, b2, row_scale, eps, False)
    ln_mlp_fwd.launches += 1
    return out


def ln_mlp_fwd_tp(x, gamma, beta, w1, b1, w2, row_scale, eps: float):
    """The forward's tensor-parallel mode on a rank's slice of the hidden:
    the fp32 partial s (G W2^T) [B, N, D]. A CPU tensor takes
    ``ln_mlp_reference(partial=True)``; a CUDA tensor launches the kernel
    (its epilogue writing the partial), anything else raises. Counts
    launches in ``ln_mlp_fwd_tp.launches``."""
    if x.device.type == "cpu":
        return ln_mlp_reference(x, gamma, beta, w1, b1, w2, None, row_scale, eps, partial=True)
    out = _fwd_launch("ln_mlp_fwd_tp", x, gamma, beta, w1, b1, w2, None, row_scale, eps, True)
    ln_mlp_fwd_tp.launches += 1
    return out


def _bwd_launch(name: str, x, gamma, beta, w1, b1, w2, row_scale, eps: float, dy,
                partial: bool):
    """The backward's kernels on a CUDA tensor; with ``partial`` dx is the
    fp32 partial of the tensor-parallel mode."""
    g, be, w1_, b1_, w2_, _, s = _check(name, x, gamma, beta, w1, b1, w2, None, row_scale)
    _build.check_stream(name, dy)
    if dy.shape != x.shape:
        raise ValueError(f"{name}: dy {tuple(dy.shape)} and x {tuple(x.shape)} differ")
    b, n, d = x.shape
    hidden = w1.shape[0]
    dev = x.device
    rows = b * n
    splits = bwd_plan(rows, d, hidden, _build.sm_count(dev.index))
    layout = bwd_scratch(rows, d, hidden, splits)
    scratch = {k: torch.empty(max(count, 1), dtype=dt, device=dev)
               for k, (count, dt) in layout.items()}
    if not layout["dn"][0]:
        scratch["dn"] = scratch["g"]   # dn is written after G's last read
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty(x.shape, **f32) if partial else torch.empty_like(x)
    dw1, dw2 = torch.empty((hidden, d), **f32), torch.empty((d, hidden), **f32)
    db1, db2 = torch.empty(hidden, **f32), torch.empty(d, **f32)
    dgamma, dbeta = torch.empty(d, **f32), torch.empty(d, **f32)
    err = _build.load_library().mvlt_ln_mlp_bwd(
        x.data_ptr(), dy.data_ptr(), g.data_ptr(), be.data_ptr(), w1_.data_ptr(),
        b1_.data_ptr(), w2_.data_ptr(), s.data_ptr(), dx.data_ptr(),
        *(t.data_ptr() for t in scratch.values()), dw1.data_ptr(), dw2.data_ptr(),
        db1.data_ptr(), db2.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), rows, n, d,
        hidden, splits, eps, dx.data_ptr() if partial else None,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(name, err)
    return dx, dgamma, dbeta, dw1, db1, dw2, db2



def ln_mlp_bwd(x, gamma, beta, w1, b1, w2, row_scale, eps: float, dy):
    """Backward (dx, dgamma, dbeta, dW1, db1, dW2, db2). A CPU tensor takes
    ``ln_mlp_bwd_reference``; a CUDA tensor launches the kernels (the rows'
    LN and s.dy, the hidden and its gradient, the weight gradients, dn, dx
    with the column sums, the in-order slot sums) with the scratch of
    ``bwd_scratch``, anything else raises. Counts launches in
    ``ln_mlp_bwd.launches``."""
    if x.device.type == "cpu":
        return ln_mlp_bwd_reference(x, gamma, beta, w1, b1, w2, row_scale, eps, dy)
    out = _bwd_launch("ln_mlp_bwd", x, gamma, beta, w1, b1, w2, row_scale, eps, dy, False)
    ln_mlp_bwd.launches += 1
    return out


def ln_mlp_bwd_tp(x, gamma, beta, w1, b1, w2, row_scale, eps: float, dy):
    """The backward's tensor-parallel mode on a rank's slice of the hidden:
    (dx_part, dgamma, dbeta, dW1, db1, dW2, db2), dx_part the fp32
    LN-backward of the rank's dn without dy, dgamma and dbeta partial, db2
    whole. A CPU tensor takes ``ln_mlp_bwd_reference(passthrough=False)``;
    a CUDA tensor launches the kernels, anything else raises. Counts
    launches in ``ln_mlp_bwd_tp.launches``."""
    if x.device.type == "cpu":
        return ln_mlp_bwd_reference(x, gamma, beta, w1, b1, w2, row_scale, eps, dy,
                                    passthrough=False)
    out = _bwd_launch("ln_mlp_bwd_tp", x, gamma, beta, w1, b1, w2, row_scale, eps, dy, True)
    ln_mlp_bwd_tp.launches += 1
    return out


ln_mlp_fwd.launches = 0
ln_mlp_bwd.launches = 0
ln_mlp_fwd_tp.launches = 0
ln_mlp_bwd_tp.launches = 0


class _FusedLnMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2, row_scale, eps):
        ctx.eps = eps
        ctx.param_dtypes = [t.dtype for t in (gamma, beta, w1, b1, w2, b2)]
        ctx.save_for_backward(x, gamma, beta, w1, b1, w2, row_scale)
        return ln_mlp_fwd(x, gamma, beta, w1, b1, w2, b2, row_scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, w1, b1, w2, row_scale = ctx.saved_tensors
        if dy.device.type == "cuda":
            dy = dy.contiguous()   # an incoming gradient's layout is autograd's choice
        dx, *grads = ln_mlp_bwd(x, gamma, beta, w1, b1, w2, row_scale, ctx.eps, dy)
        return (dx, *(g.to(t) for g, t in zip(grads, ctx.param_dtypes)), None, None)


def fused_ln_mlp(x, gamma, beta, w1, b1, w2, b2, row_scale=None, eps: float = 1e-6):
    """x + s * MLP(LN(x)), differentiable: the forward and the backward are
    the kernels on CUDA tensors and their plain versions on CPU tensors.
    row_scale None means ones."""
    if row_scale is None:
        row_scale = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    return _FusedLnMlp.apply(x, gamma, beta, w1, b1, w2, b2, row_scale, eps)
