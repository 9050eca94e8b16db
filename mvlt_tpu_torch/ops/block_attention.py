"""The attention half of a block: LN1 -> Q -> attention against the SR K/V
-> out-proj -> +res.

Counterpart of mvlt_tpu/ops/block_attention.py:fused_block_attention_padded
(the lane-padded PVT-v2 serving form) and, at stage 1, of
mvlt_tpu/ops/block_packed.py:fused_attention_p2. ``block_attention_reference``
is the plain version; ``fused_block_attention`` takes it for a CPU tensor
and launches the Hopper kernel (csrc/block_attention.cu) for a CUDA tensor,
or raises. K and V are [B, heads, M, hd] as ``fused_ln_sr_kv`` emits them.
"""

from __future__ import annotations

import torch

from mvlt_tpu_torch.ops import _build
from mvlt_tpu_torch.ops.kernel_math import layer_norm_fp32, linear, softmax_av


def attention_residual(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, bp, *,
                       heads: int, eps: float) -> torch.Tensor:
    """x + proj(attention(LN1(x) Wq + bq, K, V)) + bp, unrounded: the sum is
    fp32 (fp64 for fp64), the products in x.dtype with fp32 LN statistics
    and softmax. Linear weights in torch layout [out, in]."""
    b, n, d = x.shape
    hd = d // heads
    normed = layer_norm_fp32(x, ln1_weight, ln1_bias, eps)
    q = linear(normed, wq, bq).reshape(b, n, heads, hd).transpose(1, 2)
    attn = softmax_av(q, k.to(x.dtype), v.to(x.dtype), scale=hd ** -0.5)
    attn = attn.transpose(1, 2).reshape(b, n, d)
    acc = torch.promote_types(x.dtype, torch.float32)
    return x.to(acc) + linear(attn, wp, bp).to(acc)


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
    _build.check_stream(name, x)
    b, n, d = x.shape
    if d % heads or (d // heads) % 16:
        raise ValueError(f"{name}: D={d} with {heads} heads gives no 16-multiple head dim")
    hd = d // heads
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
