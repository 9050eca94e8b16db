"""The whole transformer block: LN1 -> Q -> attention against the SR K/V ->
out-proj -> +res -> LN2 -> fc1 -> GELU(erf) -> fc2 -> +res.

Counterpart of mvlt_tpu/ops/block_fused.py:fused_block and, at stage 1, of
mvlt_tpu/ops/block_packed.py:fused_block_p2. ``block_reference`` is the plain
version; ``fused_block`` takes it for a CPU tensor and launches the Hopper
kernels (csrc/block_fused.cu: a chain over the scratch that ``scratch``
sizes) for a CUDA tensor, or raises.
"""

from __future__ import annotations

import torch

from mvlt_tpu_torch.ops import _build
from mvlt_tpu_torch.ops.block_attention import attention_residual, fwd_scratch
from mvlt_tpu_torch.ops.fused_mlp import fwd_fused
from mvlt_tpu_torch.ops.kernel_math import gelu, layer_norm_fp32, linear
from mvlt_tpu_torch.ops.pallas_attention import HEAD_DIMS
from mvlt_tpu_torch.utils.profiling import op_span


def block_reference(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, bp,
                    ln2_weight, ln2_bias, w1, b1, w2, b2, *, heads: int,
                    eps1: float, eps2: float) -> torch.Tensor:
    """Plain PyTorch block in x.dtype with an fp32 residual, LN statistics
    and softmax. x [B, N, D]; k, v [B, heads, M, hd]; Linear weights in
    torch layout [out, in]."""
    res = attention_residual(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, bp,
                             heads=heads, eps=eps1)
    normed2 = layer_norm_fp32(res, ln2_weight, ln2_bias, eps2).to(x.dtype)
    y = linear(gelu(linear(normed2, w1, b1)), w2, b2)
    return (res + y.float()).to(x.dtype)


def scratch(batch: int, n: int, d: int, heads: int, hidden: int) -> dict:
    """Kernel B's scratch, name -> (elements, dtype), in the order its C
    entry takes it: the attention half's (``fwd_scratch``: LN1(x), then
    #12's LN2(h), Q and the attention output bf16 [rows, D], lse [B, H, N]),
    h bf16 [rows, D], and #12's hidden G bf16 [rows, hidden] where its
    forward takes three launches (D > 128; else 0 elements)."""
    rows = batch * n
    half = fwd_scratch(batch, n, d, heads)
    return {"nrm": half["nrm"], "q": half["q"], "attn": half["attn"],
            "h": (rows * d, torch.bfloat16),
            "g": (0 if fwd_fused(d) else rows * hidden, torch.bfloat16), "lse": half["lse"]}


@op_span
def fused_block(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, bp,
                ln2_weight, ln2_bias, w1, b1, w2, b2, *, heads: int,
                eps1: float, eps2: float) -> torch.Tensor:
    """One block. A CPU tensor takes ``block_reference``; a CUDA tensor (bf16,
    contiguous, D and the hidden width multiples of 16, D <= 512, head dim
    32 or 64) launches kernel B's chain, and anything else raises.
    ``fused_block.launches`` counts the chain's launches (one a call)."""
    if x.device.type == "cpu":
        return block_reference(x, k, v, ln1_weight, ln1_bias, wq, bq, wp, bp,
                               ln2_weight, ln2_bias, w1, b1, w2, b2, heads=heads,
                               eps1=eps1, eps2=eps2)
    name = "fused_block"
    _build.check_stream(name, x)
    b, n, d = x.shape
    if d % heads or d // heads not in HEAD_DIMS or d > 512:
        raise ValueError(f"{name}: D={d} with {heads} heads: the chain takes D <= 512 and "
                         f"head dims {HEAD_DIMS}")
    hd = d // heads
    _build.check_kv(name, k, v, b, heads, hd, x.device)
    m = k.shape[2]
    hidden = w1.shape[0]
    if hidden % 16:
        raise ValueError(f"{name}: hidden width {hidden} is not a multiple of 16")
    dev = x.device
    wq_ = _build.kernel_weight(name, wq, (d, d), dev)
    wp_ = _build.kernel_weight(name, wp, (d, d), dev)
    w1_ = _build.kernel_weight(name, w1, (hidden, d), dev)
    w2_ = _build.kernel_weight(name, w2, (d, hidden), dev)
    vec = _build.kernel_vector
    g1, be1 = vec(name, ln1_weight, d, dev), vec(name, ln1_bias, d, dev)
    g2, be2 = vec(name, ln2_weight, d, dev), vec(name, ln2_bias, d, dev)
    bq_, bp_ = vec(name, bq, d, dev), vec(name, bp, d, dev)
    b1_, b2_ = vec(name, b1, hidden, dev), vec(name, b2, d, dev)
    out = torch.empty_like(x)
    work = [torch.empty(max(count, 1), dtype=dt, device=dev)
            for count, dt in scratch(b, n, d, heads, hidden).values()]
    lib = _build.load_library()
    err = lib.mvlt_block_fused(
        x.data_ptr(), k.data_ptr(), v.data_ptr(), g1.data_ptr(), be1.data_ptr(),
        wq_.data_ptr(), bq_.data_ptr(), wp_.data_ptr(), bp_.data_ptr(),
        g2.data_ptr(), be2.data_ptr(), w1_.data_ptr(), b1_.data_ptr(),
        w2_.data_ptr(), b2_.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in work),
        b, n, d, heads, m, hidden, hd ** -0.5, eps1, eps2,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(name, err)
    fused_block.launches += 1
    return out


fused_block.launches = 0
