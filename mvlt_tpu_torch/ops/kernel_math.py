"""Plain PyTorch helpers shared by the port's modules and kernel references.

Counterparts of mvlt_tpu/ops/kernel_math.py. The TPU-layout helpers there
(``packed_ln``, ``half_average_matrix``, ``softmax_av_pair`` and the A&S
``erf``) serve the TPU's 128-lane registers only and have none here; the
CUDA kernels carry these functions as device code (csrc/common.cuh).
Statistics, softmax and GELU run in fp32, or in fp64 for fp64 inputs (the
gradient checks).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type sums and statistics are taken in: fp32, or fp64 for fp64."""
    return torch.promote_types(dtype, torch.float32)


def layer_norm_fp32(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """LayerNorm over the last dimension with statistics and affine in fp32,
    returned in x.dtype (the unmasked analogue of ``one_pass_ln``)."""
    acc = acc_dtype(x.dtype)
    y = F.layer_norm(x.to(acc), (x.shape[-1],), weight.to(acc), bias.to(acc), eps)
    return y.to(x.dtype)


def layer_norm_bwd(x: torch.Tensor, weight: torch.Tensor, eps: float,
                   dout: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of ``layer_norm_fp32`` in fp32: (dx, dweight, dbias) for the
    gradient ``dout`` of its output; the affine gradients are summed over
    every leading dimension."""
    acc = acc_dtype(x.dtype)
    xf, dout = x.to(acc), dout.to(acc)
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xf - mean).square().mean(-1, keepdim=True) + eps)
    nhat = (xf - mean) * rstd
    rows = tuple(range(x.dim() - 1))
    dnhat = dout * weight.to(acc)
    dx = (dnhat - dnhat.mean(-1, keepdim=True)
          - nhat * (dnhat * nhat).mean(-1, keepdim=True)) * rstd
    return dx, (dout * nhat).sum(rows), dout.sum(rows)


def softmax_av(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v with fp32 logits and softmax and an fp32 P.V
    sum over probabilities rounded to v.dtype; returns q.dtype.
    q [..., N, hd], k and v [..., M, hd]."""
    acc = acc_dtype(q.dtype)
    logits = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs.to(acc), v.to(acc)).to(q.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU computed in fp32, returned in x.dtype."""
    return F.gelu(x.to(acc_dtype(x.dtype)), approximate="none").to(x.dtype)


def gelu_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx of the exact GELU, Phi(x) + x phi(x), in fp32 (fp64 for fp64)."""
    x = x.to(acc_dtype(x.dtype))
    return (0.5 * (1.0 + torch.erf(x * 2 ** -0.5))
            + x * torch.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi))


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None) -> torch.Tensor:
    """x W^T + b in x.dtype: fp32 parameters are rounded to the compute
    dtype, as a flax Dense with ``dtype`` does."""
    return F.linear(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype))


def matmul_acc(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """a @ b with both operands rounded to ``dtype`` and the sum taken in
    fp32 (fp64 for fp64), unrounded: a tensor-core product's arithmetic."""
    acc = acc_dtype(dtype)
    return torch.matmul(a.to(dtype).to(acc), b.to(dtype).to(acc))
