"""Attention core of the training path, forward and backward:
softmax(q k^T * scale) v for q [B, H, N, hd] against a whole K/V
[B, H, M, hd].

Counterpart of mvlt_tpu/ops/pallas_attention.py:fused_attention (forward
``_fused_attention_impl``, backward ``_fused_attention_bwd``). The forward
also returns the rows' logsumexp ``lse``, and the backward takes the
forward's ``o`` and ``lse`` instead of recomputing the softmax statistics.
The plain versions of that interface are ``attention_stats_reference`` and
``attention_stats_bwd_reference``; ``attention_reference`` (o alone) and
``attention_bwd_reference`` (P recomputed from q and K, as the Pallas
backward does) are the plain route's functions. ``attention_fwd`` and
``attention_bwd`` take the plain versions for CPU tensors and launch the
Hopper kernels (csrc/attention.cu) for CUDA tensors, or raise;
``fused_attention`` is the differentiable ``autograd.Function`` over the
two, saving o and lse. ``plan_splits`` picks how many ranges of q tiles the
backward cuts each (sample, head) into.
"""

from __future__ import annotations

import torch

from mvlt_tpu_torch.ops import _build
from mvlt_tpu_torch.ops.kernel_math import acc_dtype, softmax_av
from mvlt_tpu_torch.utils.profiling import op_span


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


def attention_stats_reference(q, k, v, scale: float):
    """Plain forward with its softmax statistics: (o, lse), o as
    ``attention_reference`` computes it and lse the logsumexp of the scaled
    logits [B, H, N] in fp32 (fp64 for fp64 inputs)."""
    acc = acc_dtype(q.dtype)
    logits = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    return attention_reference(q, k, v, scale), torch.logsumexp(logits, dim=-1)


def attention_stats_bwd_reference(q, k, v, o, lse, do, scale: float):
    """Plain backward (dq, dk, dv) from the forward's saved o and lse:
    P = exp(q k^T scale - lse), Dq = rowsum(dO o), then
    dV = P^T dO, dP = dO V^T, dS = P (dP - Dq) scale, dQ = dS K,
    dK = dS^T Q, every product over operands in q.dtype with an fp32 sum."""
    acc = acc_dtype(q.dtype)
    up = lambda t: t.to(q.dtype).to(acc)
    p = torch.exp(torch.matmul(up(q), up(k).transpose(-1, -2)) * scale - lse.to(acc)[..., None])
    dob = up(do)
    dv = torch.matmul(up(p).transpose(-1, -2), dob)
    dp = torch.matmul(dob, up(v).transpose(-1, -2))
    ds = up(p * (dp - (dob * up(o)).sum(-1, keepdim=True)) * scale)
    dq = torch.matmul(ds, up(k))
    dk = torch.matmul(ds.transpose(-1, -2), up(q))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


TILE = 64            # q rows of a kernel tile
HEAD_DIMS = (32, 64)  # the head dims the kernels are built for


def split_ranges(tiles: int, splits: int) -> list[tuple[int, int]]:
    """The q-tile ranges [start, end) of the backward's splits, as the kernel
    cuts them (csrc/attention.cu: tile0 = s * tiles / splits)."""
    return [(s * tiles // splits, (s + 1) * tiles // splits) for s in range(splits)]


def plan_splits(bh: int, n: int, sms: int) -> int:
    """How many ranges of q tiles the backward cuts each (sample, head)
    into: enough blocks (one an SM) for about four waves over ``sms`` SMs,
    and at least four tiles a range (each range writes its own fp32 dK/dV
    slot, summed in order by a second launch). ``bh`` = B * H."""
    tiles = -(-n // TILE)
    return max(1, min(-(-4 * sms // bh), tiles // 4))


def _layout_ok(t) -> bool:
    """A contiguous last dimension, the batch, head and row strides (of the
    dimensions longer than 1) multiples of 8 elements, and a 16-byte aligned
    start: every row is read and written as 16-byte copies."""
    st, sh = t.stride(), t.shape
    return (st[3] == 1 and t.data_ptr() % 16 == 0 and (st[0] % 8 == 0 or sh[0] == 1)
            and (st[1] % 8 == 0 or sh[1] == 1) and (st[2] % 8 == 0 or sh[2] == 1))


def _check(name: str, t, what: str, like=None) -> None:
    """What the kernels take: bf16 [B, H, rows, hd] on the card, hd 32 or
    64, in a layout ``_layout_ok`` accepts."""
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
    if t.shape[3] not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {t.shape[3]} is not one of {HEAD_DIMS}")
    if not _layout_ok(t):
        raise ValueError(f"{name}: {what} must be contiguous in its last dimension with "
                         f"strides of 8 elements and a 16-byte aligned start, got "
                         f"strides {t.stride()}")


@op_span
def attention_fwd(q, k, v, scale: float):
    """Forward, (o, lse). A CPU tensor takes ``attention_stats_reference``;
    CUDA tensors launch the kernel, anything else raises. Counts launches in
    ``attention_fwd.launches``."""
    if q.device.type == "cpu":
        return attention_stats_reference(q, k, v, scale)
    name = "attention_fwd"
    _check(name, q, "q")
    _check(name, k, "k", like=q)
    _check(name, v, "v", like=q)
    if k.shape != v.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if not scale > 0:
        raise ValueError(f"{name}: the kernel takes a positive scale, got {scale}")
    b, h, n, hd = q.shape
    m = k.shape[2]
    o = torch.empty_like(q)
    lse = q.new_empty((b, h, n), dtype=torch.float32)
    err = _build.load_library().mvlt_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        _build.strides_arg(q, k, v, o), b, h, n, m, hd, scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch(name, err)
    attention_fwd.launches += 1
    return o, lse


@op_span
def attention_bwd(q, k, v, o, lse, do, scale: float):
    """Backward (dq, dk, dv) from the forward's o and lse. A CPU tensor takes
    ``attention_stats_bwd_reference``; CUDA tensors launch the kernel (and,
    with more than one split of N, its slot sum), anything else raises.
    Counts launches in ``attention_bwd.launches``."""
    if q.device.type == "cpu":
        return attention_stats_bwd_reference(q, k, v, o, lse, do, scale)
    name = "attention_bwd"
    _check(name, q, "q")
    for t, what in ((o, "o"), (do, "do"), (k, "k"), (v, "v")):
        _check(name, t, what, like=q)
    b, h, n, hd = q.shape
    m = k.shape[2]
    if k.shape != v.shape or do.shape != q.shape or o.shape != q.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, o {tuple(o.shape)}, "
                         f"do {tuple(do.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         f"do not fit")
    if (lse.device != q.device or lse.dtype != torch.float32 or lse.shape != (b, h, n)
            or not lse.is_contiguous()):
        raise ValueError(f"{name}: lse must be contiguous fp32 {(b, h, n)} on {q.device}, "
                         f"got {tuple(lse.shape)} {lse.dtype} on {lse.device}")
    splits = plan_splits(b * h, n, torch.cuda.get_device_properties(q.device).multi_processor_count)
    dq = torch.empty_like(q)
    dk = torch.empty((b, h, m, hd), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, h, m, hd), dtype=v.dtype, device=v.device)
    empty = torch.empty(0, dtype=torch.float32, device=q.device)
    slots = (torch.empty((splits, 2, b * h * m * hd), dtype=torch.float32, device=q.device)
             if splits > 1 else empty)
    dq_acc = (torch.empty((b, h, n, hd), dtype=torch.float32, device=q.device)
              if m > 3 * TILE else empty)
    err = _build.load_library().mvlt_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), slots.data_ptr(), dq_acc.data_ptr(),
        _build.strides_arg(q, k, v, o, do, dq), b, h, n, m, hd, splits, scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch(name, err)
    attention_bwd.launches += 1
    return dq, dk, dv


attention_fwd.launches = 0
attention_bwd.launches = 0


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = scale
        o, lse = attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)   # o is alive anyway: the projection saves it
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.device.type == "cuda" and not _layout_ok(do):
            do = do.contiguous()   # an incoming gradient's layout is autograd's choice
        dq, dk, dv = attention_bwd(q, k, v, o, lse, do, ctx.scale)
        return dq, dk, dv, None


def fused_attention(q, k, v, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v, differentiable: the forward and the
    backward are the kernels on CUDA tensors and their plain versions on CPU
    tensors. q [B, H, N, hd]; k, v [B, H, M, hd]; q.dtype out."""
    return _FusedAttention.apply(q, k, v, scale)
