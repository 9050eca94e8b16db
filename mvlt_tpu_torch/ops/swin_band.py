"""The whole Swin block on the visual stream, with the pooled LN1 rows the
text queries consume:
    h   = x + proj(window attention over [window K/V | text K/V]) + bp
    out = h + fc2(GELU(fc1(LN2(h))))
    pooled = LN1(x) averaged over pool x pool cells of the grid
with queries, window K/V from LN1(x), the relative-position bias and the
shifted-window region mask on the window columns, text K/V [B, T, C] given
(the caller projects the text rows' LN1, as the JAX package does in XLA).

Counterpart of mvlt_tpu/ops/swin_band.py:fused_swin_band_block (Pallas body
``_kernel``) at gelu="erf". The TPU form's band of windows, dense masked
logits, lane padding, head stripes and caller-side vertical roll serve
VMEM block specs and have no counterpart: kernel E (csrc/swin_block.cu) is
a chain (LN1 and the pooled rows, the q/k/v product storing each row into
its window slot by ``window_index``, kernel F's attention on the additive
table of models/swin.py:add_table, the out-projection gathering the rows
back, #12's LN-MLP), and returns the pooled rows un-rolled and pooled along
both axes. ``swin_block_reference`` is the plain version;
``fused_swin_block`` takes it for a CPU tensor and launches the chain for a
CUDA tensor, or raises.
"""

from __future__ import annotations

import functools

import torch

from mvlt_tpu_torch.models.swin import (add_table, heads_of, relative_position_index,
                                        window_masks, window_partition, window_reverse)
from mvlt_tpu_torch.ops import _build
from mvlt_tpu_torch.ops.kernel_math import acc_dtype, gelu, layer_norm_fp32, linear, matmul_acc
from mvlt_tpu_torch.ops.swin_attention import (HEAD_DIMS, MAX_KEYS, MAX_WINDOW_ROWS, plan,
                                                swin_attention_reference)
from mvlt_tpu_torch.utils.profiling import op_span


def swin_block_reference(x, k_txt, v_txt, rel_table, ln1_weight, ln1_bias, wq, bq, wkv, bkv,
                         wp, bp, ln2_weight, ln2_bias, w1, b1, w2, b2, *, hw: tuple,
                         heads: int, window: int, shift: int, pool: int, eps1: float,
                         eps2: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch Swin block in x.dtype: (out [B, h*w, C], pooled
    [B, (h/pool)(w/pool), C]). x is the visual stream in row-major (y, x)
    order; k_txt, v_txt [B, T, C]; rel_table [(2 window - 1)^2, heads];
    Linear weights [out, in] (wkv [2C, C]: K rows, then V rows). LayerNorm
    statistics, logits, softmax and the residual fp32; the pooled rows are
    the unrounded LN1 rows' means, rounded once."""
    b, n, c = x.shape
    h, w = hw
    dt, acc = x.dtype, acc_dtype(x.dtype)
    normed_f = layer_norm_fp32(x.to(acc), ln1_weight, ln1_bias, eps1)
    normed = normed_f.to(dt)
    q = linear(normed, wq, bq)
    kv = linear(normed, wkv, bkv)

    def windows(t):
        return heads_of(window_partition(t, hw, window, shift), heads)

    index = torch.from_numpy(relative_position_index(window)).to(x.device)
    mask = torch.from_numpy(window_masks(h, w, window, shift)).to(x.device)
    out_win = swin_attention_reference(
        windows(q), windows(kv[..., :c]), windows(kv[..., c:]), heads_of(k_txt.to(dt), heads),
        heads_of(v_txt.to(dt), heads), add_table(rel_table, index, mask, k_txt.shape[1]),
        scale=(c // heads) ** -0.5)
    attn = window_reverse(out_win.movedim(2, -2).flatten(-2), hw, window, shift)
    res = x.to(acc) + matmul_acc(attn, wp.t(), dt) + bp.to(acc)
    normed2 = layer_norm_fp32(res, ln2_weight, ln2_bias, eps2).to(dt)
    hid = gelu(matmul_acc(normed2, w1.t(), dt) + b1.to(acc)).to(dt)
    out = (res + matmul_acc(hid, w2.t(), dt) + b2.to(acc)).to(dt)
    pooled = normed_f.reshape(b, h // pool, pool, w // pool, pool, c).mean((2, 4))
    return out, pooled.reshape(b, -1, c).to(dt)


@functools.cache
def window_index(hw: tuple, window: int, shift: int, device) -> torch.Tensor:
    """int32 [h*w] on ``device``: the window slot (window * ws^2 + position
    in the window) of each token of a grid in row-major (y, x) order, as
    ``window_partition`` lays the (shifted) windows out: kernel E's q/k/v
    product stores token p's row at slot index[p], its out-projection reads
    it back from there. Made once per grid, window, shift and device."""
    h, w = hw
    tokens = torch.arange(h * w, dtype=torch.float64)[None, :, None]
    order = window_partition(tokens, hw, window, shift).reshape(-1).long()  # slot -> token
    index = torch.empty_like(order)
    index[order] = torch.arange(order.numel())
    return index.to(device=device, dtype=torch.int32)


def scratch_elems(rows: int, d: int, hidden: int) -> int:
    """bf16 elements of kernel E's scratch: LN1(x) and h [rows, C] each, then
    q, k, v and the attention output [rows, C] each, whose space #12's
    hidden [rows, hidden] takes over (csrc/swin_block.cu's C entry)."""
    return rows * (2 * d + max(4 * d, hidden))


@op_span
def fused_swin_block(x, k_txt, v_txt, rel_table, ln1_weight, ln1_bias, wq, bq, wkv, bkv,
                     wp, bp, ln2_weight, ln2_bias, w1, b1, w2, b2, *, hw: tuple, heads: int,
                     window: int, shift: int, pool: int, eps1: float, eps2: float,
                     table: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One Swin block on the visual stream, and the pooled LN1 rows. A CPU
    tensor takes ``swin_block_reference``; a CUDA tensor launches kernel E
    (bf16, contiguous; the window dividing the grid, ws^2 <= 64 and ws^2 +
    T <= 512; the pool dividing the grid; C <= 512 and the head dim 32 or
    64; the hidden width a multiple of 16), and anything else raises.
    ``table`` is kernel F's additive table of ``rel_table`` on this grid
    (models/swin.py:add_table, [nW, heads, ws^2, ws^2 + T] fp32), which a
    Block caches beside its operands; the plain version builds its own
    from ``rel_table``.
    ``fused_swin_block.launches`` counts the calls that launch it."""
    args = (x, k_txt, v_txt, rel_table, ln1_weight, ln1_bias, wq, bq, wkv, bkv, wp, bp,
            ln2_weight, ln2_bias, w1, b1, w2, b2)
    kw = dict(hw=hw, heads=heads, window=window, shift=shift, pool=pool, eps1=eps1, eps2=eps2)
    if x.device.type == "cpu":
        return swin_block_reference(*args, **kw)
    name = "fused_swin_block"
    _build.check_stream(name, x)
    b, n, d = x.shape
    h, w = hw
    hidden = w1.shape[0]
    t = k_txt.shape[1]
    if (n != h * w or h % window or w % window or h % pool or w % pool or d > 512
            or d % heads or d // heads not in HEAD_DIMS or hidden % 16
            or window * window > MAX_WINDOW_ROWS or window * window + t > MAX_KEYS
            or not 0 <= shift < window):
        raise ValueError(f"{name}: unsupported shape N={n} hw={hw} window={window} "
                         f"shift={shift} pool={pool} D={d} heads={heads} hidden={hidden} T={t} "
                         f"(N = h*w, window and pool dividing h and w, ws^2 <= "
                         f"{MAX_WINDOW_ROWS}, ws^2 + T <= {MAX_KEYS}, D <= 512, head dim one "
                         f"of {HEAD_DIMS}, hidden a multiple of 16)")
    for label, kv in (("k_txt", k_txt), ("v_txt", v_txt)):
        if (kv.device != x.device or kv.dtype != torch.bfloat16 or not kv.is_contiguous()
                or tuple(kv.shape) != (b, t, d) or kv.data_ptr() % 16):
            raise ValueError(f"{name}: {label} must be contiguous, 16-byte aligned bf16 "
                             f"[{b}, {t}, {d}] on {x.device}, got {tuple(kv.shape)} "
                             f"{kv.dtype} on {kv.device}")
    dev = x.device
    weight, vec = _build.kernel_weight, _build.kernel_vector
    wqkv = torch.cat([weight(name, wq, (d, d), dev), weight(name, wkv, (2 * d, d), dev)])
    wp_ = weight(name, wp, (d, d), dev)
    w1_, w2_ = weight(name, w1, (hidden, d), dev), weight(name, w2, (d, hidden), dev)
    if rel_table.device != dev or tuple(rel_table.shape) != ((2 * window - 1) ** 2, heads):
        raise ValueError(f"{name}: rel_table {tuple(rel_table.shape)} on {rel_table.device}, "
                         f"expected [{(2 * window - 1) ** 2}, {heads}] on {dev}")
    nw, ws2 = (h // window) * (w // window), window * window
    if (table.device != dev or table.dtype != torch.float32
            or tuple(table.shape) != (nw, heads, ws2, ws2 + t)):
        raise ValueError(f"{name}: table must be fp32 [{nw}, {heads}, {ws2}, {ws2 + t}] on "
                         f"{dev}, got {tuple(table.shape)} {table.dtype} on {table.device}")
    table = table.contiguous()
    g1, be1, g2, be2 = (vec(name, t_, d, dev) for t_ in (ln1_weight, ln1_bias, ln2_weight,
                                                          ln2_bias))
    bqkv = torch.cat([vec(name, bq, d, dev), vec(name, bkv, 2 * d, dev)])
    bp_ = vec(name, bp, d, dev)
    b1_, b2_ = vec(name, b1, hidden, dev), vec(name, b2, d, dev)
    index = window_index((h, w), window, shift, dev)
    wgs, per_block = plan(b, nw, heads, _build.sm_count(dev.index))
    scratch = torch.empty(scratch_elems(b * n, d, hidden), dtype=torch.bfloat16, device=dev)
    out = torch.empty_like(x)
    pooled = torch.empty((b, (h // pool) * (w // pool), d), dtype=x.dtype, device=dev)
    err = _build.load_library().mvlt_swin_block(
        x.data_ptr(), k_txt.data_ptr(), v_txt.data_ptr(), table.data_ptr(), index.data_ptr(),
        g1.data_ptr(), be1.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wp_.data_ptr(),
        bp_.data_ptr(), g2.data_ptr(), be2.data_ptr(), w1_.data_ptr(), b1_.data_ptr(),
        w2_.data_ptr(), b2_.data_ptr(), out.data_ptr(), pooled.data_ptr(), scratch.data_ptr(),
        b, h, w, d, heads, t, hidden, window, pool, per_block, wgs, (d // heads) ** -0.5, eps1,
        eps2, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(name, err)
    fused_swin_block.launches += 1
    return out, pooled


fused_swin_block.launches = 0
