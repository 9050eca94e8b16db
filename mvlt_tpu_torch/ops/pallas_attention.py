"""Attention core of the training path, forward and backward:
softmax(q k^T * scale) v for q [B, H, N, hd] against a whole K/V
[B, H, M, hd].

Counterpart of mvlt_tpu/ops/pallas_attention.py:fused_attention (forward
``_fused_attention_impl``, backward ``_fused_attention_bwd``). The plain
versions are ``attention_reference`` and ``attention_bwd_reference``; the
latter recomputes P from q and K as the Pallas backward does, it is not
autograd of the forward. ``attention_fwd`` and ``attention_bwd`` take them
for CPU tensors and launch the Hopper kernels (csrc/attention.cu) for CUDA
tensors, or raise; ``fused_attention`` is the differentiable
``autograd.Function`` over the two.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mvlt_tpu_torch.ops import _build
from mvlt_tpu_torch.ops.kernel_math import acc_dtype, softmax_av


def attention_reference(q, k, v, scale: float) -> torch.Tensor:
    """Plain forward: fp32 logits and softmax, P rounded to v.dtype, fp32
    P.V sum; q.dtype out."""
    return softmax_av(q, k, v, scale=scale)


def attention_bwd_reference(q, k, v, do, scale: float):
    """Plain backward (dq, dk, dv) of ``attention_reference`` for the
    output gradient ``do``: P recomputed in fp32, then
    dV = P^T dO, dP = dO V^T, dS = P (dP - rowsum(dP P)) scale,
    dQ = dS K, dK = dS^T Q, every product over operands in q.dtype with an
    fp32 sum."""
    acc = acc_dtype(q.dtype)
    up = lambda t: t.to(q.dtype).to(acc)
    p = torch.softmax(torch.matmul(up(q), up(k).transpose(-1, -2)) * scale, dim=-1)
    dob = up(do)
    dv = torch.matmul(up(p).transpose(-1, -2), dob)
    dp = torch.matmul(dob, up(v).transpose(-1, -2))
    ds = up(p * (dp - (dp * p).sum(-1, keepdim=True)) * scale)
    dq = torch.matmul(ds, up(k))
    dk = torch.matmul(ds.transpose(-1, -2), up(q))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _layout_ok(t) -> bool:
    """A contiguous last dimension, the batch, head and row strides (of the
    dimensions longer than 1) multiples of 16 elements, and a 32-byte
    aligned start: tensor-core fragments load straight from it."""
    return (t.stride(3) == 1 and t.data_ptr() % 32 == 0
            and all(s % 16 == 0 for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1))


def _check(name: str, t, what: str, like=None) -> None:
    """What the kernels take: bf16 [B, H, rows, hd] on the card, hd a
    multiple of 16, in a layout ``_layout_ok`` accepts."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor for {what}, got {t.device}")
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the kernel takes bfloat16 only, got {t.dtype} for {what}")
    if t.dim() != 4:
        raise ValueError(f"{name}: {what} must be [B, H, rows, hd], got {tuple(t.shape)}")
    if like is not None and (t.device != like.device or t.shape[:2] != like.shape[:2]
                             or t.shape[3] != like.shape[3]):
        raise ValueError(f"{name}: {what} {tuple(t.shape)} on {t.device} does not match "
                         f"q {tuple(like.shape)} on {like.device}")
    if t.shape[3] % 16:
        raise ValueError(f"{name}: head dim {t.shape[3]} is not a multiple of 16")
    if not _layout_ok(t):
        raise ValueError(f"{name}: {what} must be contiguous in its last dimension with "
                         f"strides of 16 elements and a 32-byte aligned start, got "
                         f"strides {t.stride()}")


def _kv_rows16(t: torch.Tensor) -> torch.Tensor:
    """K or V with its rows padded by zeros to a multiple of 16 (the
    tensor-core tile); no copy where M already is one."""
    m = t.shape[2]
    return t if m % 16 == 0 else F.pad(t, (0, 0, 0, 16 - m % 16))


def attention_fwd(q, k, v, scale: float) -> torch.Tensor:
    """Forward. A CPU tensor takes ``attention_reference``; CUDA tensors
    launch the kernel, anything else raises. Counts launches in
    ``attention_fwd.launches``."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale)
    name = "attention_fwd"
    _check(name, q, "q")
    _check(name, k, "k", like=q)
    _check(name, v, "v", like=q)
    if k.shape != v.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    b, h, n, hd = q.shape
    m = k.shape[2]
    kp, vp = _kv_rows16(k), _kv_rows16(v)
    o = torch.empty_like(q)
    err = _build.load_library().mvlt_attention_fwd(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), o.data_ptr(),
        _build.strides_arg(q, kp, vp, o), b, h, n, m, hd, scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch(name, err)
    attention_fwd.launches += 1
    return o


def attention_bwd(q, k, v, do, scale: float):
    """Backward (dq, dk, dv). A CPU tensor takes ``attention_bwd_reference``;
    CUDA tensors launch the kernel, anything else raises. Counts launches in
    ``attention_bwd.launches``."""
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, do, scale)
    name = "attention_bwd"
    _check(name, q, "q")
    _check(name, do, "do", like=q)
    _check(name, k, "k", like=q)
    _check(name, v, "v", like=q)
    if k.shape != v.shape or do.shape != q.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, do {tuple(do.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    b, h, n, hd = q.shape
    m = k.shape[2]
    kp, vp = _kv_rows16(k), _kv_rows16(v)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    err = _build.load_library().mvlt_attention_bwd(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), do.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), _build.strides_arg(q, kp, vp, do, dq, dk, dv),
        b, h, n, m, hd, scale, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch(name, err)
    attention_bwd.launches += 1
    return dq, dk, dv


attention_fwd.launches = 0
attention_bwd.launches = 0


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v)
        return attention_fwd(q, k, v, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        if do.device.type == "cuda" and not _layout_ok(do):
            do = do.contiguous()   # an incoming gradient's layout is autograd's choice
        dq, dk, dv = attention_bwd(q, k, v, do, ctx.scale)
        return dq, dk, dv, None


def fused_attention(q, k, v, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v, differentiable: the forward and the
    backward are the kernels on CUDA tensors and their plain versions on CPU
    tensors. q [B, H, N, hd]; k, v [B, H, M, hd]; q.dtype out."""
    return _FusedAttention.apply(q, k, v, scale)
