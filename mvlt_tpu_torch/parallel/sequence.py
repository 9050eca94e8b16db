"""Sequence parallelism of the v1, v2 and linear-SR v2 backbones: the joint
token stream of a stage split over a model group, every rank holding the
whole model.

Counterpart of mvlt_tpu/parallel/sharding.py:sequence_sharding_constraint
(:161-172), which ``PVLT.sp_mesh`` applies to the joint [B, h*w + T, C]
stream after each stage's concat (mvlt_tpu/models/pvlt.py:1153-1156). There
GSPMD places the tokens over the mesh's model axis and inserts the gathers
of the K/V path; here each rank runs its own rows and the collectives are
written out. The port splits by whole grid rows, so that every serving
kernel stays on the path:

  * ``row_plan``: a stage splits when its h grid rows divide into n bands
    whose height is a multiple of the SR ratio (kernel A's conv windows
    then never cross a band) and n divides its T text rows; rank r holds
    grid rows [r h/n, (r+1) h/n) and text rows [r T/n, (r+1) T/n), and its
    blocks run on that band with hw = (h/n, w). Otherwise the stage runs
    whole on every rank (JAX's constraint is a no-op where N does not
    divide).
  * ``split_rows`` / ``gather_rows``: the stage's entry keeps the rank's
    rows, and its backward all-gathers the rows' gradients, so that the
    replicated code before the split gets whole, identical gradients; the
    stage's end all-gathers the stream back to [B, h*w + T, D], and its
    backward keeps the rank's rows.
  * ``gather_kv``: the K/V rows a band gives (kernel A's reduced rows and
    text rows; the K/V input on the training route) gathered into the
    one-process order, all the visual rows then all the text rows; the
    backward sums the ranks' partial dK/dV (each rank's queries give a
    part) and keeps the rank's rows: a reduce-scatter.
  * ``exchange_halo``: one grid row above and below the band from the
    neighbouring ranks, for the 3x3 depthwise conv of v2's MLP (kernel D,
    or its training glue); none at the grid's true top and bottom, where
    the conv's zero padding stays. Its backward sends the halo rows'
    gradients back to their owners.
  * ``linear_pool_partial``: linear SR's floored pooling windows straddle
    the bands; each rank sums its rows' share of every window, the sums
    are all-reduced (its backward all-reduces the partial gradients) and
    divided by the window's whole count.

Every block parameter of a split stage then holds a partial gradient on
each rank, summed over the model group by ``reduce_row_grads`` before the
clip (the patch embeds, text denses, position tables and heads run
replicated, and their gradients are whole). The collectives are
``all_reduce`` sums only, in fp32 (fp64 for fp64): gloo offers nothing
else on CUDA tensors; a gather places each rank's rows in a zero-filled
buffer, which is exact.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from mvlt_tpu_torch.ops.kernel_math import acc_dtype
from mvlt_tpu_torch.parallel.sharding import all_reduce_sum, group_size


@dataclasses.dataclass(frozen=True)
class RowPlan:
    """Rank ``rank`` of ``n``'s rows of a stage with an h x w grid and t text
    rows; ``split`` False: the whole stage on every rank."""
    h: int
    w: int
    t: int
    n: int
    rank: int
    split: bool
    group: object = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def hb(self) -> int:
        """The band's grid rows."""
        return self.h // self.n if self.split else self.h

    @property
    def tb(self) -> int:
        """The rank's text rows."""
        return self.t // self.n if self.split else self.t

    @property
    def hw(self) -> tuple:
        """The band's grid, as its blocks take it."""
        return self.hb, self.w

    @property
    def above(self) -> int:
        """Halo rows above the band: 1, or 0 at the grid's top."""
        return int(self.rank > 0)

    @property
    def below(self) -> int:
        """Halo rows below the band: 1, or 0 at the grid's bottom."""
        return int(self.rank < self.n - 1)

    @property
    def halo_hw(self) -> tuple:
        """The grid of the band with its halo rows."""
        return self.hb + self.above + self.below, self.w


def row_plan(h: int, w: int, t: int, sr: int, n: int, rank: int, group=None) -> RowPlan:
    """The row plan of a stage over ``n`` ranks (see the module docstring);
    ``sr`` the SR conv's ratio (1 where no conv reduces the K/V rows: sr 1,
    or linear SR)."""
    split = n > 1 and h % n == 0 and (h // n) % sr == 0 and t % n == 0
    return RowPlan(h, w, t, n, rank, split, group)


def take(whole: torch.Tensor, plan: RowPlan, m_vis: int, dim: int = 1) -> torch.Tensor:
    """The rank's rows of ``whole`` along ``dim``: visual rows first (``m_vis``
    a rank), then text rows (the rest, an equal share a rank)."""
    dim %= whole.dim()
    m_txt = (whole.shape[dim] - plan.n * m_vis) // plan.n
    vis = whole.narrow(dim, plan.rank * m_vis, m_vis)
    txt = whole.narrow(dim, plan.n * m_vis + plan.rank * m_txt, m_txt)
    return torch.cat([vis, txt], dim)


def assemble(parts: torch.Tensor, m_vis: int, dim: int = 1) -> torch.Tensor:
    """The whole tensor from every rank's rows ``parts`` [n, ...] (each a
    ``take`` along ``dim`` of the part's shape): every rank's visual rows in
    rank order, then every rank's text rows."""
    dim = dim % (parts.dim() - 1) + 1

    def flat(t):
        return t.movedim(0, dim - 1).flatten(dim - 1, dim)

    vis = parts.narrow(dim, 0, m_vis)
    txt = parts.narrow(dim, m_vis, parts.shape[dim] - m_vis)
    return torch.cat([flat(vis), flat(txt)], dim - 1)


def _all_slots(local: torch.Tensor, plan: RowPlan) -> torch.Tensor:
    """[n, *local.shape]: every rank's ``local`` in its slot (one all_reduce
    of a zero-filled buffer in fp32 or fp64: exact), in local's type."""
    buf = local.new_zeros((plan.n, *local.shape), dtype=acc_dtype(local.dtype))
    buf[plan.rank] = local
    dist.all_reduce(buf, group=plan.group)
    return buf.to(local.dtype)


def _summed(t: torch.Tensor, plan: RowPlan) -> torch.Tensor:
    """The sum of ``t`` over the group in fp32 (fp64 for fp64), in t's type."""
    buf = t.to(acc_dtype(t.dtype), memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(buf, group=plan.group)
    return buf.to(t.dtype)


class _SplitRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, plan, m_vis):
        ctx.plan, ctx.m_vis = plan, m_vis
        return take(z, plan, m_vis).contiguous()

    @staticmethod
    def backward(ctx, dy):
        return assemble(_all_slots(dy.contiguous(), ctx.plan), ctx.m_vis), None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, plan, m_vis, dim):
        ctx.plan, ctx.m_vis, ctx.dim = plan, m_vis, dim
        return assemble(_all_slots(z.contiguous(), plan), m_vis, dim).contiguous()

    @staticmethod
    def backward(ctx, dy):
        return take(dy, ctx.plan, ctx.m_vis, ctx.dim).contiguous(), None, None, None


class _GatherKv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, plan, m_vis, dim):
        ctx.plan, ctx.m_vis, ctx.dim = plan, m_vis, dim
        return assemble(_all_slots(z.contiguous(), plan), m_vis, dim).contiguous()

    @staticmethod
    def backward(ctx, dy):
        return (take(_summed(dy, ctx.plan), ctx.plan, ctx.m_vis, ctx.dim).contiguous(),
                None, None, None)


def split_rows(z: torch.Tensor, plan: RowPlan) -> torch.Tensor:
    """The rank's rows [B, hb*w + tb, D] of the whole stream z [B, h*w + T, D];
    the backward all-gathers the rows' gradients into z's."""
    return _SplitRows.apply(z, plan, plan.hb * plan.w)


def gather_rows(z: torch.Tensor, plan: RowPlan) -> torch.Tensor:
    """The whole stream [B, h*w + T, D] from every rank's rows; the backward
    keeps the rank's rows of the (replicated, whole) gradient."""
    return _GatherRows.apply(z, plan, plan.hb * plan.w, 1)


def gather_kv(local: torch.Tensor, plan: RowPlan, m_vis: int, dim: int = -2) -> torch.Tensor:
    """K/V rows (along ``dim``: ``m_vis`` visual rows a rank, then its text
    rows) gathered from every rank into the one-process order; the backward
    sums the ranks' gradients and keeps this rank's rows."""
    return _GatherKv.apply(local, plan, m_vis, dim)


def kv_visual_rows(plan: RowPlan, sr: int) -> int:
    """The visual K/V rows a band gives: the SR conv's reduced pixels, or
    the band's own rows at sr 1."""
    return (plan.hb // sr) * (plan.w // sr)


def halo_band(whole: torch.Tensor, plan: RowPlan) -> torch.Tensor:
    """The rank's rows with their halo, taken from the whole stream
    [B, h*w + T, D]: grid rows [r0 - above, r1 + below), then its text rows.
    What ``exchange_halo`` builds from the neighbours."""
    w, r0 = plan.w, plan.rank * plan.hb
    vis = whole[:, (r0 - plan.above) * w:(r0 + plan.hb + plan.below) * w]
    txt = whole[:, plan.h * w + plan.rank * plan.tb:plan.h * w + (plan.rank + 1) * plan.tb]
    return torch.cat([vis, txt], 1)


def trim_halo(ext: torch.Tensor, plan: RowPlan) -> torch.Tensor:
    """The band's rows of a tensor on the band with its halo (its visual
    rows then its text rows): the halo rows dropped."""
    w = plan.w
    he = plan.halo_hw[0]
    band = ext[:, plan.above * w:(plan.above + plan.hb) * w]
    return torch.cat([band, ext[:, he * w:]], 1)


class _ExchangeHalo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        w, hbw = plan.w, plan.hb * plan.w
        edges = torch.stack([x[:, :w], x[:, hbw - w:hbw]])        # [2, B, w, D]
        slots = _all_slots(edges, plan)                            # [n, 2, B, w, D]
        parts = [x[:, :hbw]]
        if plan.above:
            parts.insert(0, slots[plan.rank - 1, 1])
        if plan.below:
            parts.append(slots[plan.rank + 1, 0])
        return torch.cat(parts + [x[:, hbw:]], 1)

    @staticmethod
    def backward(ctx, dy):
        plan = ctx.plan
        w, hbw = plan.w, plan.hb * plan.w
        top = plan.above * w
        sent = dy.new_zeros((plan.n, 2, dy.shape[0], w, dy.shape[2]))
        if plan.above:       # the row above is the previous rank's last
            sent[plan.rank - 1, 1] = dy[:, :w]
        if plan.below:       # the row below is the next rank's first
            sent[plan.rank + 1, 0] = dy[:, top + hbw:top + hbw + w]
        got = _summed(sent, plan)[plan.rank]
        dx = torch.cat([dy[:, top:top + hbw], dy[:, top + hbw + plan.below * w:]], 1)
        acc = acc_dtype(dx.dtype)
        dx[:, :w] = (dx[:, :w].to(acc) + got[0].to(acc)).to(dx.dtype)
        dx[:, hbw - w:hbw] = (dx[:, hbw - w:hbw].to(acc) + got[1].to(acc)).to(dx.dtype)
        return dx, None


def exchange_halo(x: torch.Tensor, plan: RowPlan) -> torch.Tensor:
    """The band's stream [B, hb*w + tb, D] with one grid row from each
    neighbouring band around its visual rows ([B, he*w + tb, D], he =
    ``plan.halo_hw[0]``): ``halo_band`` of the whole stream."""
    return _ExchangeHalo.apply(x, plan)


def linear_pool_partial(band: torch.Tensor, plan: RowPlan, win: tuple, out: tuple) -> torch.Tensor:
    """This band's share [B, oh, ow, D] (fp32, or fp64 for fp64) of the sums
    over linear SR's pooling windows: windows of win = (wh, ww) rows and
    columns, as strides, out = (oh, ow) of them (the last partial window
    dropped); ``band`` [B, hb, w, D] is grid rows [r0, r0 + hb). Summed over
    the ranks and divided by wh * ww it is the average pool."""
    (wh, ww), (oh, ow) = win, out
    b, hb, _, d = band.shape
    acc = acc_dtype(band.dtype)
    cols = band[:, :, :ow * ww].to(acc).reshape(b, hb, ow, ww, d).sum(3)
    rows = plan.rank * plan.hb + torch.arange(hb, device=band.device)
    onehot = (rows[None] // wh == torch.arange(oh, device=band.device)[:, None]).to(acc)
    return torch.einsum("ih,bhjd->bijd", onehot, cols)


def linear_pool(band: torch.Tensor, plan: RowPlan, win: tuple, out: tuple) -> torch.Tensor:
    """linear SR's average pool [B, oh, ow, D] of the whole grid from the
    band's rows: ``linear_pool_partial`` all-reduced over the group, the
    backward an all-reduce of the partial gradients, then divided by the
    window's count, in band's type."""
    total = all_reduce_sum(linear_pool_partial(band, plan, win, out), plan.group,
                           differentiable=True)
    return (total / (win[0] * win[1])).to(band.dtype)


def reduce_row_grads(model: torch.nn.Module) -> None:
    """Sum over the model group, in place, the gradients of the blocks of
    every stage the last forward split (each rank's holds its rows' part):
    one all_reduce in fp32 (fp64 for fp64). The other parameters' gradients
    are whole on every rank and stay."""
    group = getattr(model, "sp_group", None)
    if group is None or not any(model.sp_split):
        return
    grads = [p.grad for i, split in enumerate(model.sp_split) if split
             for p in getattr(model, f"block{i + 1}").parameters() if p.grad is not None]
    acc = acc_dtype(grads[0].dtype)
    flat = torch.cat([g.reshape(-1).to(acc) for g in grads])
    dist.all_reduce(flat, group=group)
    for g, s in zip(grads, torch.split(flat, [g.numel() for g in grads])):
        g.copy_(s.view_as(g))


def refusals(cfg, sp_group, tp_group) -> None:
    """Raise NotImplementedError, naming it, for a combination sequence
    parallelism does not cover: the Swin backbone (its windows and the
    shifted windows' roll cross the bands), or sequence parallelism
    together with tensor-parallel weights."""
    if sp_group is None:
        return
    refused = []
    if cfg.variant == "swin":
        refused.append("the Swin backbone")
    if tp_group is not None:
        refused.append("tensor-parallel weights (--tp-size)")
    if refused:
        raise NotImplementedError("sequence parallelism does not cover: " + "; ".join(refused))


def stage_grids(cfg, input_size: int) -> list:
    """(h, w) of each stage's grid at ``input_size`` x ``input_size``: v1's
    strided patch convs, v2's overlapping ones (k7 s4 p3, then k3 s2 p1)."""
    grids, g = [], input_size
    for i in range(cfg.num_stages):
        if cfg.variant == "v2":
            g = (g - 1) // 4 + 1 if i == 0 else (g - 1) // 2 + 1
        else:
            g = g // cfg.patch_size if i == 0 else g // 2
        grids.append((g, g))
    return grids


def stage_sr(cfg, i: int) -> int:
    """The ratio of the conv that reduces stage i's K/V rows: the SR ratio,
    or 1 where linear SR pools instead."""
    sr = cfg.sr_ratios[i]
    return 1 if cfg.linear_sr and sr > 1 else sr


def describe(model: torch.nn.Module) -> str:
    """Which stages of a sequence-parallel model split at its input size,
    one line a stage."""
    cfg, group = model.cfg, model.sp_group
    n = group_size(group)
    lines = [f"sequence parallelism over {n} ranks (the model replicated):"]
    for i, (h, w) in enumerate(stage_grids(cfg, model.input_size)):
        t = cfg.num_text_tokens
        plan = row_plan(h, w, t, stage_sr(cfg, i), n, 0)
        what = (f"split, {plan.hb} of {h} grid rows and {plan.tb} of {t} text rows a rank"
                if plan.split else
                f"whole on every rank ({h} grid rows, {t} text rows, sr {stage_sr(cfg, i)})")
        lines.append(f"  stage {i + 1} ({h}x{w}): {what}")
    return "\n".join(lines)


def stage_plan(model, i: int, h: int, w: int, t: int) -> Optional[RowPlan]:
    """The rank's plan of stage i of a sequence-parallel model on an h x w
    grid and t text rows, or None: no group, or the stage runs whole."""
    group = getattr(model, "sp_group", None)
    if group is None:
        return None
    plan = row_plan(h, w, t, stage_sr(model.cfg, i), group_size(group), dist.get_rank(group),
                    group)
    return plan if plan.split else None
