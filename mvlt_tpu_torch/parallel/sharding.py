"""What a data-parallel rank does beyond its own step.

Counterpart of mvlt_tpu/parallel/sharding.py's data axis (the reference's
DDP wrap, main_vl.py:298-302): there GSPMD inserts the gradient psum, here
DistributedDataParallel all-reduces the gradients (ZeRO-1, which
partitions the AdamW moments as ``state_shardings(zero1=True)`` does, is
train/schedule.py:make_optimizer's). An eval set
is cut into contiguous, equal shards, the last one padded; a rank's results
go into its slots of zero-filled buffers that ``all_reduce`` sums, and the
padded slots are masked out. The collectives used are ``all_reduce`` and
``broadcast`` only: gloo offers nothing else on CUDA tensors; each takes a
contiguous tensor (NCCL refuses others). Under tensor
parallelism (parallel/tensor.py) all of this acts over the data group: the
ranks of a model group hold the same rows.
"""

from __future__ import annotations

import dataclasses
from typing import List

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


def barrier() -> None:
    if mesh.world_size() > 1:
        dist.barrier()
