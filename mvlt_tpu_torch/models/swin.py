"""Swin-style joint image+text attention, in PyTorch.

Counterpart of mvlt_tpu/models/swin.py. Visual queries attend within
(optionally cyclically shifted) windows, with Swin's learned relative-position
bias on the visual-visual logits, plus all text tokens as extra K/V columns;
text queries attend over an average-pooled visual grid plus the text tokens.
Grids that the window does not divide are zero-padded after the projections
(padded K/V rows are zero, not bias) and the padded cells masked by the same
static region-id table that implements the shifted-window masking; the text
columns are never masked, so no row of a padded window is empty.

``window_masks``, ``relative_position_index``, ``NEG_INF`` and ``TEXT_POOL``
are the port's own copies of the JAX module's, pinned to them by
tests/test_torch_port_swin.py. ``SwinJointAttention`` is the plain path of the
module; its windowed softmax.V goes through ops/swin_attention.py, which
launches kernel F on a CUDA tensor.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mvlt_tpu_torch.ops.kernel_math import linear, softmax_av
from mvlt_tpu_torch.ops.swin_attention import fused_swin_attention

NEG_INF = -1e9

# text-query pooling divisor: the pooled-K/V window is max(1, h // TEXT_POOL)
TEXT_POOL = 8


def _pad_to(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def window_masks(h: int, w: int, wsize: int, shift: int) -> np.ndarray:
    """[nW, wsize^2, wsize^2] additive mask implementing Swin's shifted-window
    region masking and padding masking in one static table."""
    hp, wp = _pad_to(h, wsize), _pad_to(w, wsize)
    rows = np.arange(hp)
    cols = np.arange(wp)

    # padding flags move with the cyclic shift exactly like the tokens do
    pad = ((rows >= h)[:, None] | (cols >= w)[None, :]).astype(np.int64)
    pad = np.roll(pad, (-shift, -shift), axis=(0, 1))

    def region(n: int) -> np.ndarray:
        r = np.zeros(n, np.int64)
        if shift:
            r[n - wsize:] = 1
            r[n - shift:] = 2
        return r

    ids = region(hp)[:, None] * 3 + region(wp)[None, :] + 9 * pad

    nh, nw = hp // wsize, wp // wsize
    win_ids = ids.reshape(nh, wsize, nw, wsize).transpose(0, 2, 1, 3)
    win_ids = win_ids.reshape(nh * nw, wsize * wsize)
    same = win_ids[:, :, None] == win_ids[:, None, :]
    return np.where(same, 0.0, NEG_INF).astype(np.float32)


def relative_position_index(wsize: int) -> np.ndarray:
    """[wsize^2, wsize^2] index into the (2w-1)^2 relative-bias table."""
    coords = np.stack(np.meshgrid(np.arange(wsize), np.arange(wsize),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :] + (wsize - 1)
    return (rel[0] * (2 * wsize - 1) + rel[1]).astype(np.int32)


def window_size_for(window_size: int, hw: tuple) -> int:
    """The window a grid of ``hw`` takes: ``window_size``, or the grid's
    shorter side when that is smaller."""
    return min(window_size, *hw)


def swin_band_stage(window_size: int, hw: tuple) -> bool:
    """Whether a stage's grid runs on kernel E (ops/swin_band.py): an even
    window (the shift is half of it) that divides both sides, and a
    text-pool window that divides both. The gate of
    mvlt_tpu/models/pvlt.py:1121-1140 without its TPU-only terms (16-row
    alignment, the VMEM estimate); other grids take the window path."""
    h, w = hw
    ws = window_size_for(window_size, hw)
    win = max(1, h // TEXT_POOL)
    return ws % 2 == 0 and h % ws == 0 and w % ws == 0 and h % win == 0 and w % win == 0


def window_partition(t: torch.Tensor, hw: tuple, ws: int, shift: int) -> torch.Tensor:
    """Visual tokens [B, h*w, C] in row-major (y, x) order -> windows
    [B, nW, ws^2, C]: the grid zero-padded to multiples of ws, rolled by
    -shift along both axes, cut into ws x ws windows (row-major, each
    row-major inside)."""
    b, _, c = t.shape
    h, w = hw
    hp, wp = _pad_to(h, ws), _pad_to(w, ws)
    g = F.pad(t.reshape(b, h, w, c), (0, 0, 0, wp - w, 0, hp - h))
    if shift:
        g = torch.roll(g, (-shift, -shift), dims=(1, 2))
    g = g.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return g.reshape(b, (hp // ws) * (wp // ws), ws * ws, c)


def window_reverse(t: torch.Tensor, hw: tuple, ws: int, shift: int) -> torch.Tensor:
    """Inverse of ``window_partition``: windows [B, nW, ws^2, C] -> tokens
    [B, h*w, C], the padding cropped."""
    b, _, _, c = t.shape
    h, w = hw
    hp, wp = _pad_to(h, ws), _pad_to(w, ws)
    g = t.reshape(b, hp // ws, wp // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    g = g.reshape(b, hp, wp, c)
    if shift:
        g = torch.roll(g, (shift, shift), dims=(1, 2))
    return g[:, :h, :w].reshape(b, h * w, c)


def add_table(rel_table: torch.Tensor, index: torch.Tensor, mask: torch.Tensor,
              t_num: int) -> torch.Tensor:
    """The additive logit table kernel F takes, [nW, heads, ws^2, ws^2 + T]
    fp32: the relative-position bias ``rel_table`` [(2 ws - 1)^2, heads] at
    ``index`` (``relative_position_index``) plus the region/pad ``mask``
    (``window_masks``) on the window columns, zeros on the T text columns."""
    bias = rel_table.float()[index.long()].permute(2, 0, 1)
    return F.pad(bias[None] + mask[:, None], (0, t_num))


def heads_of(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[..., L, C] -> [..., heads, L, C / heads]."""
    return t.reshape(*t.shape[:-1], heads, t.shape[-1] // heads).movedim(-2, -3)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """[B, heads, L, hd] -> [B, L, heads * hd]."""
    b, nh, n, hd = t.shape
    return t.transpose(1, 2).reshape(b, n, nh * hd)


class SwinJointAttention(nn.Module):
    """Windowed visual attention with global text K/V, and pooled-K/V text
    queries (the module's docstring). Parameters: ``q``, ``kv``, ``proj``
    and ``relative_position_bias_table`` [(2 ws - 1)^2, heads], where ws is
    the window of the grid the model is built to run on (``table_ws``): the
    table's shape depends on it, as the flax parameter's does on the images
    the JAX model is initialised with."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift: bool,
                 qkv_bias: bool, table_ws: int):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift = shift
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.kv = nn.Linear(dim, 2 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * table_ws - 1) ** 2, num_heads))
        self._tables: dict = {}

    def window(self, hw: tuple) -> tuple[int, int]:
        """(ws, shift) on a grid of ``hw``; raises if the bias table was
        built for another window."""
        ws = window_size_for(self.window_size, hw)
        if (2 * ws - 1) ** 2 != self.relative_position_bias_table.shape[0]:
            raise ValueError(
                f"a {hw[0]}x{hw[1]} grid takes a window of {ws}, but the relative-position "
                f"table has {self.relative_position_bias_table.shape[0]} rows: build the "
                f"model for the input size it runs at (create_model(..., input_size=))")
        return ws, (ws // 2 if self.shift else 0)

    def _static(self, hw: tuple, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(relative-position index [ws^2, ws^2] int64, region/pad mask
        [nW, ws^2, ws^2] fp32) of a grid on ``device``, made once."""
        key = (tuple(hw), str(device))
        if key not in self._tables:
            ws, s = self.window(hw)
            self._tables[key] = (
                torch.from_numpy(relative_position_index(ws)).to(device),
                torch.from_numpy(window_masks(*hw, ws, s)).to(device))
        return self._tables[key]

    def add_table(self, hw: tuple, t_num: int) -> torch.Tensor:
        """``add_table`` of this module's bias on a grid of ``hw``."""
        table = self.relative_position_bias_table
        return add_table(table, *self._static(hw, table.device), t_num)

    def forward(self, x: torch.Tensor, hw: tuple, t_num: int, *,
                attention=fused_swin_attention) -> torch.Tensor:
        """x: the LayerNorm'd joint stream [B, h*w + T, C] -> the attention
        output before the residual. ``attention`` is kernel F's wrapper; a
        check passes its plain version."""
        b, n, c = x.shape
        h, w = hw
        nh = self.num_heads
        hd = c // nh
        ws, s = self.window(hw)
        q = linear(x, self.q.weight, self.q.bias)
        kv = linear(x, self.kv.weight, self.kv.bias)
        k_all, v_all = kv[..., :c], kv[..., c:]

        def windows(t):    # visual rows -> [B, nW, heads, ws^2, hd]
            return heads_of(window_partition(t[:, : h * w], hw, ws, s), nh).contiguous()

        k_txt, v_txt = (heads_of(t[:, h * w:], nh).contiguous() for t in (k_all, v_all))
        out_win = attention(windows(q), windows(k_all), windows(v_all), k_txt, v_txt,
                            self.add_table(hw, t_num), scale=hd ** -0.5)
        out_vis = window_reverse(out_win.movedim(2, -2).flatten(-2), hw, ws, s)

        # text queries: pooled visual K/V (floor pooling) + text K/V
        win = max(1, h // TEXT_POOL)

        def pooled(t):
            grid = t[:, : h * w].reshape(b, h, w, c).permute(0, 3, 1, 2)
            return F.avg_pool2d(grid, win, win).flatten(2).transpose(1, 2)

        k_t = torch.cat([heads_of(pooled(k_all), nh), k_txt], dim=-2)
        v_t = torch.cat([heads_of(pooled(v_all), nh), v_txt], dim=-2)
        out_txt = merge_heads(softmax_av(heads_of(q[:, h * w:], nh), k_t, v_t, scale=hd ** -0.5))
        out = torch.cat([out_vis, out_txt], dim=1)
        return linear(out, self.proj.weight, self.proj.bias)
