"""The MLP half of a PVT-v2 block: LN2 -> fc1 -> 3x3 depthwise conv over the
visual rows -> GELU(erf) -> fc2 -> +res.

Counterpart of mvlt_tpu/ops/dwconv_mlp.py:fused_dwconv_mlp and, at stage 1,
of its packed form fused_dwconv_mlp_p2 (module semantics
mvlt_tpu/models/pvlt.py:DWConvMlp). The first h*w rows of the stream are the
visual grid in row-major (y, x) order: they go through the conv (zero
padding at the grid's borders) and its bias; the T text rows after them
skip both. ``dwconv_mlp_reference`` is the plain version; ``fused_dwconv_mlp``
takes it for a CPU tensor and launches kernel D (csrc/dwconv_mlp.cu: LN2 and
fc1 on #12's kernels, the conv and GELU, fc2 and the residual) for a CUDA
tensor, or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mvlt_tpu_torch.ops import _build
from mvlt_tpu_torch.ops.kernel_math import gelu, layer_norm_fp32, linear
from mvlt_tpu_torch.utils.profiling import op_span


def dwconv_mlp_reference(x, hw, ln2_weight, ln2_bias, w1, b1, dw_weight, dw_bias,
                         w2, b2, *, eps: float) -> torch.Tensor:
    """Plain PyTorch MLP half in x.dtype, as the JAX package's XLA module
    computes it in the compute dtype, with an fp32 residual sum. x [B, N, D];
    Linear weights [out, in]; the depthwise conv weight [hidden, 1, 3, 3]."""
    b, _, _ = x.shape
    h, w = hw
    normed = layer_norm_fp32(x, ln2_weight, ln2_bias, eps)
    hid = linear(normed, w1, b1)
    grid = hid[:, : h * w].reshape(b, h, w, -1).permute(0, 3, 1, 2)
    vis = F.conv2d(grid, dw_weight.to(x.dtype), None if dw_bias is None else dw_bias.to(x.dtype),
                   padding=1, groups=hid.shape[-1])
    hid = torch.cat([vis.flatten(2).transpose(1, 2), hid[:, h * w:]], dim=1)
    y = linear(gelu(hid), w2, b2)
    acc = torch.promote_types(x.dtype, torch.float32)
    return (x.to(acc) + y.to(acc)).to(x.dtype)


def scratch_elems(rows: int, d: int, hidden: int) -> int:
    """bf16 elements of kernel D's scratch: fc1's output H1 [rows, hidden],
    then LN2(x) [rows, D], whose space the GELU output G [rows, hidden]
    takes over (csrc/dwconv_mlp.cu's C entry)."""
    return rows * (hidden + max(d, hidden))


@op_span
def fused_dwconv_mlp(x, hw, ln2_weight, ln2_bias, w1, b1, dw_weight, dw_bias, w2, b2, *,
                     eps: float) -> torch.Tensor:
    """The MLP half of one v2 block. A CPU tensor takes
    ``dwconv_mlp_reference``; a CUDA tensor (bf16, contiguous, D <= 512 and
    the hidden width multiples of 16) launches kernel D's chain, and
    anything else raises.
    ``fused_dwconv_mlp.launches`` counts the calls that launch it."""
    if x.device.type == "cpu":
        return dwconv_mlp_reference(x, hw, ln2_weight, ln2_bias, w1, b1, dw_weight, dw_bias,
                                    w2, b2, eps=eps)
    name = "fused_dwconv_mlp"
    _build.check_stream(name, x)
    b, n, d = x.shape
    h, w = hw
    t = n - h * w
    hidden = w1.shape[0]
    if t < 0 or d > 512 or hidden % 16:
        raise ValueError(f"{name}: unsupported shape N={n} hw={hw} D={d} hidden={hidden} "
                         f"(N >= h*w, D <= 512, hidden a multiple of 16)")
    dev = x.device
    w1_ = _build.kernel_weight(name, w1, (hidden, d), dev)
    w2_ = _build.kernel_weight(name, w2, (d, hidden), dev)
    # [hidden, 1, 3, 3]: the nine taps of a channel are contiguous
    wdw = _build.kernel_weight(name, dw_weight, (hidden, 1, 3, 3), dev)
    vec = _build.kernel_vector
    g2, be2 = vec(name, ln2_weight, d, dev), vec(name, ln2_bias, d, dev)
    b1_, bdw = vec(name, b1, hidden, dev), vec(name, dw_bias, hidden, dev)
    b2_ = vec(name, b2, d, dev)
    scratch = torch.empty(scratch_elems(b * n, d, hidden), dtype=torch.bfloat16, device=dev)
    out = torch.empty_like(x)
    err = _build.load_library().mvlt_dwconv_mlp(
        x.data_ptr(), g2.data_ptr(), be2.data_ptr(), w1_.data_ptr(), b1_.data_ptr(),
        wdw.data_ptr(), bdw.data_ptr(), w2_.data_ptr(), b2_.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), b, h, w, t, d, hidden, eps,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(name, err)
    fused_dwconv_mlp.launches += 1
    return out


fused_dwconv_mlp.launches = 0
