"""Windowed joint attention of the Swin variant: each window's queries attend
over [the window's K/V | all text K/V] with one additive logit table.

Counterpart of mvlt_tpu/ops/swin_attention.py:fused_swin_attention (Pallas
bodies ``_kernel`` and ``_kernel_paired``). The TPU's window-pair grouping is
MXU tiling and has no counterpart: kernel F (wgmma) gives each warpgroup one
window of a (sample, head) at a time, and each block a run of windows that
share its copy of the sample's text K/V (``plan``).
``swin_attention_reference`` is the plain version; ``fused_swin_attention``
takes it for a CPU tensor and launches the Hopper kernel
(csrc/swin_attention.cu) for a CUDA tensor, or raises.
"""

from __future__ import annotations

import torch

from mvlt_tpu_torch.ops import _build
from mvlt_tpu_torch.ops.kernel_math import acc_dtype
from mvlt_tpu_torch.utils.profiling import op_span


def swin_attention_reference(q_win, k_win, v_win, k_txt, v_txt, add_table, *,
                             scale: float) -> torch.Tensor:
    """softmax(q [k_win | k_txt]^T * scale + add_table) [v_win | v_txt] with
    fp32 logits and softmax and an fp32 P.V sum over probabilities rounded
    to the value dtype; returns q's dtype. q/k/v_win [B, nW, heads, ws^2, hd],
    k/v_txt [B, heads, T, hd] (shared by every window), add_table [nW, heads,
    ws^2, ws^2 + T]."""
    acc = acc_dtype(q_win.dtype)
    q = q_win.to(acc)
    logits = torch.cat([torch.matmul(q, k_win.to(acc).transpose(-1, -2)),
                        torch.matmul(q, k_txt[:, None].to(acc).transpose(-1, -2))], dim=-1)
    probs = torch.softmax(logits * scale + add_table.to(acc), dim=-1).to(v_win.dtype).to(acc)
    ws2 = q_win.shape[-2]
    out = (torch.matmul(probs[..., :ws2], v_win.to(acc))
           + torch.matmul(probs[..., ws2:], v_txt[:, None].to(acc)))
    return out.to(q_win.dtype)


HEAD_DIMS = (32, 64)
MAX_WINDOW_ROWS = 64   # ws^2: one wgmma row tile
MAX_KEYS = 512         # ws^2 + T: the text K/V stays in shared memory


def plan(batch: int, nw: int, heads: int, sms: int) -> tuple[int, int]:
    """(warpgroups a block, windows a block) of kernel F: two warpgroups
    taking alternate windows where a sample has more than one, and as many
    windows a block (sharing its text K/V) as keep at least 4 waves of
    blocks, two an SM, on ``sms`` SMs."""
    wgs = 2 if nw > 1 else 1
    per = wgs * max(1, batch * heads * nw // (wgs * 8 * sms))
    return wgs, min(nw, per)


@op_span
def fused_swin_attention(q_win, k_win, v_win, k_txt, v_txt, add_table, *,
                         scale: float) -> torch.Tensor:
    """Windowed joint attention. A CPU tensor takes
    ``swin_attention_reference``; a CUDA tensor launches kernel F (bf16,
    contiguous q/k/v, head dim 32 or 64, ws^2 <= 64, ws^2 + T <= 512, an
    fp32 table), and anything else raises. ``fused_swin_attention.launches``
    counts the kernel launches."""
    if q_win.device.type == "cpu":
        return swin_attention_reference(q_win, k_win, v_win, k_txt, v_txt, add_table,
                                        scale=scale)
    name = "fused_swin_attention"
    dev = q_win.device
    b, nw, nh, ws2, hd = q_win.shape
    t = k_txt.shape[2]
    for label, x, shape in (("q_win", q_win, (b, nw, nh, ws2, hd)),
                            ("k_win", k_win, (b, nw, nh, ws2, hd)),
                            ("v_win", v_win, (b, nw, nh, ws2, hd)),
                            ("k_txt", k_txt, (b, nh, t, hd)), ("v_txt", v_txt, (b, nh, t, hd))):
        if (x.device != dev or x.dtype != torch.bfloat16 or not x.is_contiguous()
                or tuple(x.shape) != shape or x.data_ptr() % 16):
            raise ValueError(f"{name}: {label} must be contiguous, 16-byte aligned bf16 "
                             f"{list(shape)} on {dev}, got {tuple(x.shape)} {x.dtype} "
                             f"on {x.device}")
    if hd not in HEAD_DIMS or ws2 > MAX_WINDOW_ROWS or ws2 + t > MAX_KEYS:
        raise ValueError(f"{name}: head dim {hd} (one of {HEAD_DIMS}), ws^2 = {ws2} "
                         f"(<= {MAX_WINDOW_ROWS}) or ws^2 + T = {ws2 + t} (<= {MAX_KEYS}) "
                         f"out of range")
    if (add_table.device != dev or add_table.dtype != torch.float32
            or tuple(add_table.shape) != (nw, nh, ws2, ws2 + t)):
        raise ValueError(f"{name}: add_table must be fp32 [{nw}, {nh}, {ws2}, {ws2 + t}] "
                         f"on {dev}, got {tuple(add_table.shape)} {add_table.dtype}")
    table = add_table.contiguous()
    out = torch.empty_like(q_win)
    wgs, per_block = plan(b, nw, nh, _build.sm_count(dev.index))
    err = _build.load_library().mvlt_swin_attention(
        q_win.data_ptr(), k_win.data_ptr(), v_win.data_ptr(), k_txt.data_ptr(),
        v_txt.data_ptr(), table.data_ptr(), out.data_ptr(), _build.strides_arg(k_txt), b, nw,
        nh, ws2, t, hd, per_block, wgs, 0, scale, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(name, err)
    fused_swin_attention.launches += 1
    return out


fused_swin_attention.launches = 0
