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
tests/test_torch_port_swin.py. ``SwinJointAttention`` is the module's
PyTorch glue; where the JAX module's ``use_kernel`` holds (eval mode, no
gradient wanted) its windowed softmax.V goes through ops/swin_attention.py,
which launches kernel F on a CUDA tensor, and elsewhere (training mode, or
a gradient wanted) through ``window_attention``, the differentiable
counterpart of the JAX module's einsum branch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mvlt_tpu_torch.models.bert_embeddings import dropout
from mvlt_tpu_torch.ops.kernel_math import acc_dtype, linear, softmax_av
from mvlt_tpu_torch.ops.swin_attention import fused_swin_attention
from mvlt_tpu_torch.parallel import sequence
from mvlt_tpu_torch.parallel.tensor import model_input, row_parallel_linear

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


def window_partition(t: torch.Tensor, hw: tuple, ws: int, shift: int,
                     rows: bool = True) -> torch.Tensor:
    """Visual tokens [B, h*w, C] in row-major (y, x) order -> windows
    [B, nW, ws^2, C]: the grid zero-padded to multiples of ws, rolled by
    -shift along both axes (along x alone where ``rows`` is False: a
    sequence-parallel band whose rows parallel/sequence.py:roll_rows
    rolled), cut into ws x ws windows (row-major, each row-major inside)."""
    b, _, c = t.shape
    h, w = hw
    hp, wp = _pad_to(h, ws), _pad_to(w, ws)
    g = F.pad(t.reshape(b, h, w, c), (0, 0, 0, wp - w, 0, hp - h))
    if shift:
        g = torch.roll(g, (-shift, -shift), dims=(1, 2)) if rows else torch.roll(g, -shift, 2)
    g = g.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return g.reshape(b, (hp // ws) * (wp // ws), ws * ws, c)


def window_reverse(t: torch.Tensor, hw: tuple, ws: int, shift: int,
                   rows: bool = True) -> torch.Tensor:
    """Inverse of ``window_partition``: windows [B, nW, ws^2, C] -> tokens
    [B, h*w, C], the padding cropped."""
    b, _, _, c = t.shape
    h, w = hw
    hp, wp = _pad_to(h, ws), _pad_to(w, ws)
    g = t.reshape(b, hp // ws, wp // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    g = g.reshape(b, hp, wp, c)
    if shift:
        g = torch.roll(g, (shift, shift), dims=(1, 2)) if rows else torch.roll(g, shift, 2)
    return g[:, :h, :w].reshape(b, h * w, c)


def position_bias(rel_table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The relative-position bias [heads, ws^2, ws^2] fp32: ``rel_table``
    [(2 ws - 1)^2, heads] at ``index`` (``relative_position_index``)."""
    return rel_table.float()[index.long()].permute(2, 0, 1)


def add_table(rel_table: torch.Tensor, index: torch.Tensor, mask: torch.Tensor,
              t_num: int) -> torch.Tensor:
    """The additive logit table kernel F takes, [nW, heads, ws^2, ws^2 + T]
    fp32: ``position_bias`` plus the region/pad ``mask`` (``window_masks``)
    on the window columns, zeros on the T text columns."""
    return F.pad(position_bias(rel_table, index)[None] + mask[:, None], (0, t_num))


def window_attention(q_win: torch.Tensor, k_win: torch.Tensor, v_win: torch.Tensor,
                     k_txt: torch.Tensor, v_txt: torch.Tensor, bias: torch.Tensor,
                     mask: torch.Tensor, *, scale: float) -> torch.Tensor:
    """The windows' joint attention, differentiable: q/k/v_win [B, nW, heads,
    ws^2, hd], k/v_txt [B, heads, T, hd], ``bias`` [heads, ws^2, ws^2] and
    ``mask`` [nW, ws^2, ws^2] fp32. The visual-visual logits in fp32 plus
    the bias, then the region/pad mask; the text columns unmasked; softmax
    in fp32, the probabilities rounded to q's dtype, the two products summed
    in fp32. Counterpart of mvlt_tpu/models/swin.py:157-171."""
    acc = acc_dtype(q_win.dtype)
    q = q_win.to(acc)
    logits_vv = torch.matmul(q, k_win.to(acc).transpose(-1, -2)) * scale
    logits_vv = logits_vv + bias[None, None] + mask[None, :, None]
    logits_vt = torch.matmul(q, k_txt.to(acc)[:, None].transpose(-1, -2)) * scale
    probs = torch.softmax(torch.cat([logits_vv, logits_vt], dim=-1), dim=-1).to(q_win.dtype)
    ws2 = q_win.shape[-2]
    out = (torch.matmul(probs[..., :ws2].to(acc), v_win.to(acc))
           + torch.matmul(probs[..., ws2:].to(acc), v_txt.to(acc)[:, None]))
    return out.to(q_win.dtype)


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
    the JAX model is initialised with. ``proj_drop``: dropout after the
    projection in training mode."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift: bool,
                 qkv_bias: bool, table_ws: int, proj_drop: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.proj_drop = proj_drop
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

    def _static(self, hw: tuple, device, sp=None) -> tuple[torch.Tensor, torch.Tensor]:
        """(relative-position index [ws^2, ws^2] int64, region/pad mask
        [nW, ws^2, ws^2] fp32) of a grid on ``device``, made once; ``sp``:
        the whole grid's mask's windows of that row plan's band
        (sequence.band_windows)."""
        key = (tuple(hw), str(device), None if sp is None else (sp.rank, sp.n))
        if key not in self._tables:
            ws, s = self.window(hw)
            mask = window_masks(*hw, ws, s)
            if sp is not None:
                mask = mask[sequence.band_windows(sp, ws)]
            self._tables[key] = (torch.from_numpy(relative_position_index(ws)).to(device),
                                 torch.from_numpy(np.ascontiguousarray(mask)).to(device))
        return self._tables[key]

    def add_table(self, hw: tuple, t_num: int, sp=None) -> torch.Tensor:
        """``add_table`` of this module's bias on a grid of ``hw`` (the
        band's windows of the row plan ``sp``)."""
        table = self.relative_position_bias_table
        return add_table(table, *self._static(hw, table.device, sp), t_num)

    def forward(self, x: torch.Tensor, hw: tuple, t_num: int, *,
                attention=fused_swin_attention,
                generator: torch.Generator | None = None, group=None, sp=None) -> torch.Tensor:
        """x: the LayerNorm'd joint stream [B, h*w + T, C] -> the attention
        output before the residual. In eval mode with no gradient wanted the
        windows go through ``attention``, kernel F's wrapper (a check passes
        its plain version); in training mode, or with a gradient wanted,
        through ``window_attention`` (mvlt_tpu/models/swin.py:141-144's
        ``use_kernel``). ``generator`` draws the projection's dropout. With
        a model ``group`` (tensor parallelism) the parameters hold this
        rank's heads (q's and kv's rows, the bias table's columns, proj's
        columns): x enters q and kv through ``copy_to_model``, the windows,
        masks, pooled text K/V and text queries run on the rank's heads, the
        out-projection's partials are summed before its bias, and the
        windows take ``window_attention`` in every mode.

        ``sp`` (sequence parallelism, the stage's row plan): x holds the
        rank's band of whole window rows and its text rows, ``hw`` the
        band's grid; the window, the pool window and the masks are the
        whole grid's (sp.h, sp.w). Alone, the band's windows run here: on a
        shifted block q, k and v of the band's rows are rolled by -s grid
        rows across the bands (sequence.roll_rows) and along x locally, the
        window outputs rolled back; the masks and the bias table are the
        whole grid's sliced to the band's window rows; each rank pools its
        band (whole pool windows) and the pooled and text K/V rows are
        gathered whole (sequence.gather_kv). With a ``group`` too, x is
        gathered whole, runs as above on the rank's heads, and the
        out-projection's partials are reduce-scattered to the band."""
        b, _, c = x.shape
        whole = hw if sp is None else (sp.h, sp.w)
        hd = c // self.num_heads
        nh = self.q.weight.shape[0] // hd      # the rank's heads under tensor parallelism
        ws, s = self.window(whole)
        win = max(1, whole[0] // TEXT_POOL)
        band = sp if group is None else None    # x holds a band here
        if group is not None:
            x = model_input(x, group, sp)
            hw = whole
        h, w = hw
        m = h * w
        q = linear(x, self.q.weight, self.q.bias)
        kv = linear(x, self.kv.weight, self.kv.bias)
        cl = q.shape[-1]
        qkv = torch.cat([q[:, :m], kv[:, :m]], -1)
        if band is not None:
            qkv = sequence.roll_rows(qkv, band, -s)
        win_q, win_k, win_v = (
            heads_of(window_partition(t, hw, ws, s, rows=band is None), nh).contiguous()
            for t in qkv.split(cl, -1))

        # the text queries' K/V: the visual K/V pooled in floored windows
        # (pool(LN1) then project is project then pool), then the text K/V
        def pooled(t):
            grid = t.reshape(b, h, w, t.shape[-1]).permute(0, 3, 1, 2)
            return F.avg_pool2d(grid, win, win).flatten(2).transpose(1, 2)

        kv_t = torch.cat([pooled(kv[:, :m]), kv[:, m:]], 1)
        if band is not None:
            kv_t = sequence.gather_kv(kv_t, band, kv_t.shape[1] - band.tb, dim=1)
        k_t, v_t = heads_of(kv_t[..., :cl], nh), heads_of(kv_t[..., cl:], nh)
        k_txt, v_txt = k_t[:, :, -t_num:].contiguous(), v_t[:, :, -t_num:].contiguous()
        use_kernel = group is None and not self.training and not (torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters())))
        if use_kernel:
            out_win = attention(win_q, win_k, win_v, k_txt, v_txt,
                                self.add_table(whole, t_num, band), scale=hd ** -0.5)
        else:
            index, mask = self._static(whole, x.device, band)
            bias = position_bias(self.relative_position_bias_table, index)
            out_win = window_attention(win_q, win_k, win_v, k_txt, v_txt, bias, mask,
                                       scale=hd ** -0.5)
        out_vis = window_reverse(out_win.movedim(2, -2).flatten(-2), hw, ws, s,
                                 rows=band is None)
        if band is not None:
            out_vis = sequence.roll_rows(out_vis, band, s)
        out_txt = merge_heads(softmax_av(heads_of(q[:, m:], nh), k_t, v_t, scale=hd ** -0.5))
        out = row_parallel_linear(torch.cat([out_vis, out_txt], dim=1), self.proj.weight,
                                  self.proj.bias, group, sp)
        if self.training and self.proj_drop:
            out = dropout(out, self.proj_drop, generator, rows=None if sp is None else (1, sp))
        return out
