"""What a data-parallel rank does beyond its own step.

Counterpart of mvlt_tpu/parallel/sharding.py's data axis (the reference's
DDP wrap, main_vl.py:298-302): there GSPMD inserts the gradient psum, here
DistributedDataParallel all-reduces the gradients; ZeRO-1 (``Zero1AdamW``,
built by train/schedule.py:make_optimizer) shards each AdamW moment by
element over the data ranks as ``state_shardings(zero1=True)`` does
(``_zero1_spec``, :78-91): the first dim the data size divides and tensor
parallelism has not split. An eval set
is cut into contiguous, equal shards, the last one padded; a rank's results
go into its slots of zero-filled buffers that ``all_reduce`` sums, and the
padded slots are masked out. The collectives used are ``all_reduce`` and
``broadcast`` only: gloo offers nothing else on CUDA tensors; each takes a
contiguous tensor (NCCL refuses others). Under tensor or sequence
parallelism (parallel/tensor.py, parallel/sequence.py) all of this acts over
the data group: the ranks of a model group hold the same rows, and a
sequence-parallel model's T2I head runs replicated on them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from mvlt_tpu_torch.parallel import mesh


def group_size(group) -> int:
    """The ranks of ``group``; 1 for None (no process group)."""
    return 1 if group is None else dist.get_world_size(group)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose gradient is the sum of the ranks' gradients
    (each rank's loss depends on every rank's input through the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(dx, group=ctx.group)
        return dx, None


def all_reduce_sum(x: torch.Tensor, group=None, differentiable: bool = False) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (``x`` itself without a
    group), as a new tensor; with ``differentiable`` autograd goes through."""
    if group_size(group) == 1:
        return x
    if differentiable:
        return _AllReduceSum.apply(x, group)
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y


def exclusive_prefix(count: torch.Tensor, group) -> tuple[torch.Tensor, torch.Tensor]:
    """(the sum of ``count`` over the ranks before this one, the sum over
    all ranks) of a scalar: one all_reduce of a zero-filled [world] vector."""
    n = group_size(group)
    if n == 1:
        return torch.zeros_like(count), count
    slots = torch.zeros(n, dtype=count.dtype, device=count.device)
    slots[dist.get_rank(group)] = count
    dist.all_reduce(slots, group=group)
    return slots[:dist.get_rank(group)].sum(), slots.sum()


def wrap_model(model: torch.nn.Module, device: torch.device,
               group=None) -> DistributedDataParallel:
    """``model`` under DDP over ``group`` (the data group; the world by
    default) on ``device``, its BatchNorms' training statistics taken over
    the group's ranks (heads.py:BatchNorm.group). DDP's construction
    broadcasts the group's first rank's parameters and buffers, a write
    that moves no ``_version``: every block's cast cache is dropped after
    it."""
    group = group if group is not None else dist.group.WORLD
    from mvlt_tpu_torch.models.heads import BatchNorm

    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group
    device_ids = [device.index] if device.type == "cuda" else None
    ddp = DistributedDataParallel(model, device_ids=device_ids, process_group=group)
    for m in model.modules():
        if hasattr(m, "_operands"):
            m._operands = None
    return ddp


@dataclasses.dataclass(frozen=True)
class EvalShard:
    """A rank's contiguous shard of an eval set of ``total`` items: ``slots``
    = ceil(total / world) slots, the first ``count`` holding items ``start``
    on, the rest padded with the shard's last item (the set's last item
    where the shard is empty)."""
    total: int
    rank: int = 0
    world: int = 1

    @property
    def slots(self) -> int:
        return -(-self.total // self.world)

    @property
    def start(self) -> int:
        return min(self.rank * self.slots, self.total)

    @property
    def count(self) -> int:
        return max(0, min(self.total - self.start, self.slots))

    def indices(self) -> List[int]:
        real = list(range(self.start, self.start + self.count))
        pad = (real[-1] if real else self.total - 1)
        return real + [pad] * (self.slots - self.count)

    @classmethod
    def of_this_rank(cls, total: int) -> "EvalShard":
        """This rank's shard among the data ranks (the world without tensor
        parallelism; the ranks of a model group share one)."""
        return cls(total, mesh.data_rank(), mesh.data_size())


def gather_slots(local: torch.Tensor, shard: EvalShard, group=None) -> torch.Tensor:
    """The results of every rank's real slots in the set's order: ``local``
    [slots, ...] is this rank's, one row a slot. Each rank writes its rows
    into a zero-filled [world, slots, ...] buffer in float64 (exact for the
    counts and fp32 values it carries), all_reduce sums the buffers over
    ``group`` (the data group by default), and the padded slots are
    dropped. Returns float64 [total, ...] on the CPU."""
    group = group if group is not None else mesh.data_group()
    if local.shape[0] != shard.slots:
        raise ValueError(f"{local.shape[0]} rows for {shard.slots} slots")
    device = mesh.comm_device() if shard.world > 1 else local.device
    buf = torch.zeros((shard.world,) + tuple(local.shape), dtype=torch.float64, device=device)
    buf[shard.rank] = local.to(device, torch.float64)
    mask = torch.zeros(shard.world, shard.slots, dtype=torch.bool)
    for r in range(shard.world):
        mask[r, :EvalShard(shard.total, r, shard.world).count] = True
    if shard.world > 1:
        dist.all_reduce(buf, group=group)
    return buf.cpu().reshape((-1,) + tuple(local.shape[1:]))[mask.reshape(-1)]


# the dim a tensor-parallel split takes (parallel/tensor.py: ROW, COL, KV)
_TP_DIM = {"row": 0, "col": 1, "kv": 0}


def zero1_dim(p: torch.Tensor, world: int) -> Optional[int]:
    """The dim of ``p`` whose ZeRO-1 moments split over ``world`` data
    ranks: the first that ``world`` divides and that tensor parallelism has
    not split (``tp_split``; the dims are those of the rank's shard); None:
    whole moments on every rank (``world`` 1, or no such dim)."""
    if world <= 1:
        return None
    split = _TP_DIM.get(getattr(p, "tp_split", None))
    return next((i for i, n in enumerate(p.shape) if i != split and n % world == 0), None)


class Zero1AdamW(torch.optim.AdamW):
    """AdamW under ZeRO-1 by element over the data ``group``: each
    parameter's moments are this rank's slice along ``zero1_dim`` (whole
    where it has none), the step runs AdamW's arithmetic
    (torch.optim.AdamW's single-tensor form, decoupled weight decay) on the
    rank's slice of the parameter and its gradient, after DDP's gradient
    average and the clip, and one all_reduce of a zero-filled buffer
    holding every rank's updated slices gathers the parameters whole
    (exact: the other slots are zeros). Its param_groups are AdamW's, so
    ``set_lr`` holds. ``consolidate_state_dict`` (every rank of the group)
    gathers the moments whole; ``state_dict`` then gives plain AdamW's form,
    and ``load_state_dict`` takes that form and keeps the rank's slices, so
    a checkpoint resumes with or without ZeRO-1 at any data size."""

    def __init__(self, params, group, **kwargs):
        super().__init__(params, **kwargs)
        self.world = group_size(group)
        self.rank = dist.get_rank(group) if self.world > 1 else 0
        self.data_group = group
        self._whole = None   # param -> (exp_avg, exp_avg_sq) whole, after consolidation

    def _part(self, p: torch.Tensor) -> Optional[tuple]:
        """(dim, start, length) of the rank's slice of p's moments, or None."""
        dim = zero1_dim(p, self.world)
        if dim is None:
            return None
        n = p.shape[dim] // self.world
        return dim, self.rank * n, n

    def _params(self) -> list:
        return [p for g in self.param_groups for p in g["params"]]

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self._whole = None
        placed = []
        for group in self.param_groups:
            lr, (beta1, beta2) = group["lr"], group["betas"]
            eps, wd = group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                part = self._part(p)
                pv, g = (p, p.grad) if part is None else (p.narrow(*part), p.grad.narrow(*part))
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0)
                    st["exp_avg"] = torch.zeros_like(pv, memory_format=torch.contiguous_format)
                    st["exp_avg_sq"] = torch.zeros_like(pv, memory_format=torch.contiguous_format)
                st["step"] += 1
                step = st["step"].item()
                pv.mul_(1 - lr * wd)
                st["exp_avg"].lerp_(g, 1 - beta1)
                st["exp_avg_sq"].mul_(beta2).addcmul_(g, g, value=1 - beta2)
                denom = (st["exp_avg_sq"].sqrt() / (1 - beta2 ** step) ** 0.5).add_(eps)
                pv.addcdiv_(st["exp_avg"], denom, value=-(lr / (1 - beta1 ** step)))
                if part is not None:
                    placed.append((p, part))
        self._gather(placed)
        return loss

    def _gather(self, placed: list) -> None:
        """Every rank's updated slices into the parameters, whole: one
        all_reduce a dtype of a zero-filled flat buffer."""
        by_dtype: dict = {}
        for p, part in placed:
            by_dtype.setdefault(p.dtype, []).append((p, part))
        for dtype, items in by_dtype.items():
            buf = torch.zeros(sum(p.numel() for p, _ in items), dtype=dtype,
                              device=items[0][0].device)
            views, off = [], 0
            for p, part in items:
                view = buf[off:off + p.numel()].view(p.shape)
                view.narrow(*part).copy_(p.narrow(*part))
                views.append(view)
                off += p.numel()
            dist.all_reduce(buf, group=self.data_group)
            for (p, _), view in zip(items, views):
                p.copy_(view)

    @torch.no_grad()
    def consolidate_state_dict(self) -> None:
        """Gather every sharded moment whole (a collective: every rank of the
        data group calls it, in one order), for ``state_dict``."""
        whole = {}
        for p in self._params():
            part, st = self._part(p), self.state.get(p)
            if part is None or not st:
                continue
            moments = []
            for key in ("exp_avg", "exp_avg_sq"):
                full = torch.zeros(p.shape, dtype=st[key].dtype, device=st[key].device)
                full.narrow(*part).copy_(st[key])
                dist.all_reduce(full, group=self.data_group)
                moments.append(full)
            whole[p] = tuple(moments)
        self._whole = whole

    def state_dict(self) -> dict:
        """Plain AdamW's state dict, the moments whole (after
        ``consolidate_state_dict`` where any is sharded)."""
        sd = super().state_dict()
        params = self._params()
        sharded = [i for i in sd["state"] if self._part(params[i]) is not None]
        if sharded and self._whole is None:
            raise RuntimeError("Zero1AdamW.state_dict: call consolidate_state_dict() on every "
                               "rank of the data group first")
        for i in sharded:
            exp_avg, exp_avg_sq = self._whole[params[i]]
            sd["state"][i] = {**sd["state"][i], "exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq}
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        """Plain AdamW's form, the moments whole; each rank keeps copies of
        its slices (of every loaded tensor: they may be the caller's)."""
        super().load_state_dict(state_dict)
        self._whole = None
        for p in self._params():
            part, st = self._part(p), self.state.get(p)
            for key, t in (st or {}).items():
                mine = t.narrow(*part) if part is not None and key != "step" else t
                st[key] = mine.clone(memory_format=torch.contiguous_format)


def barrier() -> None:
    if mesh.world_size() > 1:
        dist.barrier()
