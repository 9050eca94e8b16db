"""K/V front end of a block: LN1 -> SR conv -> SR-LN -> text re-concat ->
K and V projections.

Counterpart of mvlt_tpu/ops/sr_kv.py:fused_ln_sr_kv and, at stage 1, of
mvlt_tpu/ops/block_packed.py:fused_ln_sr_kv_p2 (reference semantics
libs/pvlt.py:100-108). ``sr_kv_reference`` is the plain version;
``fused_ln_sr_kv`` takes it for a CPU tensor and launches the Hopper kernels
(csrc/sr_kv.cu: a chain over the scratch that ``scratch`` sizes, the SR
conv's contraction split by ``conv_splits``) for a CUDA tensor, or raises.
K and V are [B, heads, M, hd] with M = (h/sr)(w/sr) + T, or M = N at
sr == 1; the text rows of the K/V input are LN1 of the stream, not
SR-normalised. ``s2d_operand`` writes out the space-to-depth operand the SR
conv's kernel gathers, for the tests. ``linear_reduce_kv_input`` is the
K/V input of PVT-v2's linear SR, which no kernel computes: the model runs
it in PyTorch on both paths, as the JAX package runs it in XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mvlt_tpu_torch.ops import _build
# the wgmma tiles (csrc/hopper.cuh: kGemmTile, kGemmChunk) and the most
# ranges of a split contraction, as the LN-MLP backward's plan takes them
from mvlt_tpu_torch.ops.fused_mlp import BWD_CHUNK, BWD_TILE, MAX_SPLITS
from mvlt_tpu_torch.ops.kernel_math import gelu, layer_norm_fp32, linear
from mvlt_tpu_torch.utils.profiling import op_span


def reduce_kv_input(normed: torch.Tensor, hw: tuple, sr: int,
                    sr_weight: torch.Tensor | None, sr_bias: torch.Tensor | None,
                    srn_weight: torch.Tensor | None, srn_bias: torch.Tensor | None,
                    eps_sr: float) -> torch.Tensor:
    """The K/V input from the LN1'd joint stream [B, h*w + T, D]: the visual
    rows through the k = stride = sr conv and SR-LN, the text rows as they
    are (sr == 1 returns the stream unchanged)."""
    if sr == 1:
        return normed
    b, _, d = normed.shape
    h, w = hw
    grid = normed[:, : h * w].reshape(b, h, w, d).permute(0, 3, 1, 2)
    red = F.conv2d(grid, sr_weight.to(normed.dtype),
                   None if sr_bias is None else sr_bias.to(normed.dtype), stride=sr)
    red = layer_norm_fp32(red.flatten(2).transpose(1, 2), srn_weight, srn_bias, eps_sr)
    return torch.cat([red, normed[:, h * w:]], dim=1)


# the pooled grid's side of PVT-v2's linear SR (mvlt_tpu/models/pvlt.py:181)
LINEAR_SR_POOL = 7


def linear_pool_shape(hw: tuple) -> tuple:
    """((wh, ww), (oh, ow)): linear SR's pooling windows on an h x w grid,
    (h // p, w // p) with p = min(7, h, w), and how many fit, the last
    partial window dropped (at 64/32/16 that gives 7x7, 8x8 and 8x8, not
    an adaptive 7x7)."""
    h, w = hw
    p = min(LINEAR_SR_POOL, h, w)
    win = (max(1, h // p), max(1, w // p))
    return win, (h // win[0], w // win[1])


def linear_sr_rows(pooled: torch.Tensor, sr_weight: torch.Tensor, sr_bias: torch.Tensor | None,
                   srn_weight: torch.Tensor, srn_bias: torch.Tensor,
                   eps_sr: float) -> torch.Tensor:
    """The reduced K/V input rows [B, oh*ow, D] of linear SR from the pooled
    grid [B, D, oh, ow]: the 1x1 conv ``sr_weight`` [D, D, 1, 1], SR-LN and
    exact GELU."""
    red = F.conv2d(pooled, sr_weight.to(pooled.dtype),
                   None if sr_bias is None else sr_bias.to(pooled.dtype))
    return gelu(layer_norm_fp32(red.flatten(2).transpose(1, 2), srn_weight, srn_bias, eps_sr))


def linear_reduce_kv_input(normed: torch.Tensor, hw: tuple, sr_weight: torch.Tensor,
                           sr_bias: torch.Tensor | None, srn_weight: torch.Tensor,
                           srn_bias: torch.Tensor, eps_sr: float) -> torch.Tensor:
    """The K/V input of PVT-v2's linear SR from the LN1'd joint stream
    [B, h*w + T, D]: the visual grid average-pooled in ``linear_pool_shape``'s
    windows, windows as strides, then ``linear_sr_rows``; the text rows as
    they are. Counterpart of mvlt_tpu/models/pvlt.py:197-209, in PyTorch (no
    kernel computes it)."""
    b, _, d = normed.shape
    h, w = hw
    win, _ = linear_pool_shape(hw)
    grid = normed[:, : h * w].reshape(b, h, w, d).permute(0, 3, 1, 2)
    pooled = F.avg_pool2d(grid, win, win)
    red = linear_sr_rows(pooled, sr_weight, sr_bias, srn_weight, srn_bias, eps_sr)
    return torch.cat([red, normed[:, h * w:]], dim=1)


def split_kv(kv: torch.Tensor, heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, M, 2D] joint projection -> K, V [B, heads, M, D/heads]."""
    b, m, d2 = kv.shape
    kv = kv.reshape(b, m, 2, heads, d2 // (2 * heads)).permute(2, 0, 3, 1, 4)
    return kv[0], kv[1]


def sr_kv_reference(x, hw, ln1_weight, ln1_bias, sr_weight, sr_bias,
                    srn_weight, srn_bias, kv_weight, kv_bias, *, sr: int,
                    heads: int, eps1: float, eps_sr: float):
    """Plain PyTorch K/V front end in x.dtype (LN statistics in fp32).
    Weights in torch layout: conv OIHW [D, D, sr, sr], Linear [2D, D]."""
    normed = layer_norm_fp32(x, ln1_weight, ln1_bias, eps1)
    kv_in = reduce_kv_input(normed, hw, sr, sr_weight, sr_bias, srn_weight,
                            srn_bias, eps_sr)
    k, v = split_kv(linear(kv_in, kv_weight, kv_bias), heads)
    return k.contiguous(), v.contiguous()


def s2d_operand(normed: torch.Tensor, hw: tuple, sr: int) -> torch.Tensor:
    """The SR conv's operand [B*p, sr*sr*D] from the LN1'd stream
    [B, h*w + T, D], built element by element as the kernel's gather
    (csrc/sr_kv.cu:sr_conv_gemm_kernel) addresses it: column k of reduced
    pixel (b, py, px) is normed[b, (py*sr + r)*w + px*sr + s, c] with
    (r, s, c) = unravel(k, (sr, sr, D)). Times the conv weight laid out as
    [D_out, (r, s, c_in)] it is the k = stride = sr conv. For tests only."""
    b, _, d = normed.shape
    h, w = hw
    pw, p = w // sr, (h // sr) * (w // sr)
    rows = torch.arange(b * p)
    bi, pix = rows // p, rows % p
    py, px = pix // pw, pix % pw
    k = torch.arange(sr * sr * d)
    rs, ch = k // d, k % d
    r, s = rs // sr, rs % sr
    token = (py[:, None] * sr + r[None]) * w + px[:, None] * sr + s[None]
    return normed[bi[:, None], token, ch[None]]


def conv_splits(batch: int, p: int, d: int, sr: int, sms: int) -> int:
    """Ranges of the SR conv's contraction (sr*sr*D deep, in 64-deep chunks)
    for its ceil(B*p/128) x ceil(D/128) output tiles: the fewest whose
    blocks fill at least 90% of their last wave on ``sms`` SMs (else the
    fullest), no range empty. Each range sums into its own fp32 slot; the
    SR-LN row kernel adds them in order."""
    tiles = -(-batch * p // BWD_TILE) * -(-d // BWD_TILE)
    return _build.split_plan(tiles, -(-sr * sr * d // BWD_CHUNK), sms, MAX_SPLITS)


def scratch(batch: int, n: int, d: int, m: int, p: int, splits: int) -> dict:
    """Kernel A's scratch, name -> (elements, dtype), in the order its C
    entry takes it: LN1(x) bf16 [B*N, D], the SR conv's slots fp32 [splits,
    B*p, D] and the K/V input bf16 [B*M, D] (both 0 at sr == 1, p = 0)."""
    return {"nrm": (batch * n * d, torch.bfloat16),
            "slots": (splits * batch * p * d, torch.float32),
            "kvin": (batch * m * d if p else 0, torch.bfloat16)}


@op_span
def fused_ln_sr_kv(x, hw, ln1_weight, ln1_bias, sr_weight, sr_bias,
                   srn_weight, srn_bias, kv_weight, kv_bias, *, sr: int,
                   heads: int, eps1: float, eps_sr: float):
    """K, V [B, heads, M, hd] of one block. A CPU tensor takes
    ``sr_kv_reference``; a CUDA tensor (bf16, contiguous, D and hd multiples
    of 16, D <= 512, h and w multiples of sr) launches kernel A's chain, and
    anything else raises. ``fused_ln_sr_kv.launches`` counts the chain's
    launches (one a call)."""
    if x.device.type == "cpu":
        return sr_kv_reference(x, hw, ln1_weight, ln1_bias, sr_weight, sr_bias,
                               srn_weight, srn_bias, kv_weight, kv_bias, sr=sr,
                               heads=heads, eps1=eps1, eps_sr=eps_sr)
    name = "fused_ln_sr_kv"
    _build.check_stream(name, x)
    b, n, d = x.shape
    h, w = hw
    t = n - h * w
    if t < 0 or d > 512 or d % heads or (d // heads) % 16:
        raise ValueError(f"{name}: unsupported shape N={n} hw={hw} D={d} heads={heads} "
                         f"(D <= 512, head dim a multiple of 16)")
    if sr > 1 and (h % sr or w % sr):
        raise ValueError(f"{name}: grid {hw} is not a multiple of sr={sr}")
    dev = x.device
    if sr > 1:
        # OIHW [out, in, r, s] -> [out, (r, s, in)]: one contraction row is
        # the space-to-depth row of a reduced pixel (no copy for a bf16
        # channels-last weight)
        wsr = _build.kernel_weight(name, sr_weight.permute(0, 2, 3, 1), (d, sr, sr, d), dev)
        wsr = wsr.reshape(d, sr * sr * d)
        bsr = _build.kernel_vector(name, sr_bias, d, dev)
        gsr = _build.kernel_vector(name, srn_weight, d, dev)
        bsrn = _build.kernel_vector(name, srn_bias, d, dev)
        p = (h // sr) * (w // sr)
        m = p + t
        splits = conv_splits(b, p, d, sr, _build.sm_count(dev.index))
    else:
        wsr = bsr = gsr = bsrn = x   # never read at sr == 1
        p, m, splits = 0, n, 1
    wkv = _build.kernel_weight(name, kv_weight, (2 * d, d), dev)
    bkv = _build.kernel_vector(name, kv_bias, 2 * d, dev)
    g1 = _build.kernel_vector(name, ln1_weight, d, dev)
    b1 = _build.kernel_vector(name, ln1_bias, d, dev)
    hd = d // heads
    k = torch.empty((b, heads, m, hd), dtype=torch.bfloat16, device=dev)
    v = torch.empty_like(k)
    work = [torch.empty(max(count, 1), dtype=dt, device=dev)
            for count, dt in scratch(b, n, d, m, p, splits).values()]
    lib = _build.load_library()
    err = lib.mvlt_sr_kv(
        x.data_ptr(), g1.data_ptr(), b1.data_ptr(), wsr.data_ptr(), bsr.data_ptr(),
        gsr.data_ptr(), bsrn.data_ptr(), wkv.data_ptr(), bkv.data_ptr(),
        k.data_ptr(), v.data_ptr(), *(t_.data_ptr() for t_ in work), b, h, w, t, d, heads,
        sr, splits, eps1, eps_sr, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(name, err)
    fused_ln_sr_kv.launches += 1
    return k, v


fused_ln_sr_kv.launches = 0
