"""Process-group bring-up from the torchrun environment.

Counterpart of mvlt_tpu/parallel/mesh.py:maybe_init_distributed, and of the
reference's init_distributed_mode (libs/utils.py:218-254): ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` name the
rank; NCCL carries a CUDA device's collectives and gloo the CPU's unless the
caller names a backend. With none of those variables set there is no process
group and everything runs in one process, as before; with some but not all
of them, or with a CUDA device that is missing, it raises. Nothing falls
back to another backend, to the CPU or to one process.

Tensor parallelism (``init_model_parallel``) splits the world into
``world / tp`` data groups' worth of model groups, as
mvlt_tpu/parallel/mesh.py:make_mesh reshapes the devices to (data, model):
rank = data_index x tp + model_index, the model axis innermost. A model
group holds the ``tp`` ranks of one data index (one replica of the model,
sharded); a data group the ``dp`` ranks of one model index (the ranks
holding the same shard, over which DDP averages). With tp = 1 the data
group is the world and there is no model group. A model group stays inside
one node, as make_hybrid_mesh (mvlt_tpu/parallel/mesh.py:67-99) keeps the
model axis inside a slice: torchrun numbers a node's ranks consecutively
and sets ``LOCAL_WORLD_SIZE`` to their count, so tp must divide it
(``ranks_per_node``; without the variable every rank is taken to run on
one machine); data groups span the nodes. Sequence parallelism
(parallel/sequence.py) takes the same groups: a model group's ranks split
each stage's rows, holding the whole model or, under tensor parallelism
over the same group, their shards of it; the data groups average.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

ENV_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

_device: Optional[torch.device] = None   # the device this rank's collectives use
_layout: Optional[dict] = None           # tp > 1: {"tp", "data_group", "model_group"}
_layouts: dict = {}                      # tp -> its layout, made once a process group


def maybe_init_distributed(device: Optional[str] = None, backend: Optional[str] = None,
                           timeout_s: float = 600.0) -> Optional[torch.device]:
    """Join the process group the environment names and return this rank's
    device: ``device`` when given (``cpu``, ``cuda`` or ``cuda:i``; a bare
    ``cuda`` means ``cuda:LOCAL_RANK``), else ``cuda:LOCAL_RANK``. Returns
    None, and starts nothing, when the environment names no rank. Called
    again in a process that joined already, it returns the same device."""
    global _device
    present = [k for k in ENV_KEYS if os.environ.get(k)]
    if not present:
        return None
    if len(present) != len(ENV_KEYS):
        missing = [k for k in ENV_KEYS if k not in present]
        raise RuntimeError(f"partial torchrun environment: {', '.join(present)} set but "
                           f"{', '.join(missing)} missing")
    if dist.is_initialized():
        return _device
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ["LOCAL_RANK"])
    dev = torch.device(device if device and device != "cuda" else f"cuda:{local_rank}")
    if dev.type == "cuda":
        if not torch.cuda.is_available() or dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank}: {dev} does not exist "
                               f"({torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                               f"CUDA devices)")
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    _device = dev
    return dev


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def is_main() -> bool:
    return rank() == 0


def comm_device() -> torch.device:
    """The device whose tensors this rank's collectives take (NCCL's are
    CUDA tensors); the CPU without a process group."""
    if _device is not None:
        return _device
    return torch.device("cpu")


def ranks_per_node() -> int:
    """The ranks of this rank's node: torchrun's ``LOCAL_WORLD_SIZE``, or
    the whole world where it is unset (every rank on one machine)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE") or world_size())


def init_model_parallel(tp: int) -> None:
    """Split the world into model groups of ``tp`` consecutive ranks and data
    groups of the ranks ``tp`` apart. Every rank calls it, in the same order
    as its other group creations; tp = 1 undoes it (the world is one data
    group). A tp set up before in this process group takes its groups
    again (every rank calls with the same sequence of tp, so none creates
    a group the others skip). Raises ValueError when tp does not divide the
    world, or does not divide the ranks of a node (``ranks_per_node``): a
    model group would then straddle two nodes."""
    global _layout
    world, local = world_size(), ranks_per_node()
    if tp < 1 or world % tp:
        raise ValueError(f"--tp-size {tp} does not divide the {world} ranks")
    if local % tp:
        raise ValueError(f"--tp-size {tp} does not divide the {local} ranks of a node "
                         f"(LOCAL_WORLD_SIZE): a model group would straddle two nodes")
    _layout = None
    if tp == 1:
        return
    if tp in _layouts:
        _layout = _layouts[tp]
        return
    dp, me = world // tp, rank()
    layout = {"tp": tp}
    for d in range(dp):              # every rank creates every group, in one order
        g = dist.new_group([d * tp + m for m in range(tp)])
        if d == me // tp:
            layout["model_group"] = g
    for m in range(tp):
        g = dist.new_group([d * tp + m for d in range(dp)])
        if m == me % tp:
            layout["data_group"] = g
    _layout = _layouts[tp] = layout


def model_size() -> int:
    return _layout["tp"] if _layout else 1


def model_rank() -> int:
    return rank() % model_size()


def data_size() -> int:
    return world_size() // model_size()


def data_rank() -> int:
    return rank() // model_size()


def model_group():
    """This rank's model group; None at tp = 1."""
    return _layout["model_group"] if _layout else None


def data_group():
    """This rank's data group: the world at tp = 1 (None without a process
    group)."""
    if _layout:
        return _layout["data_group"]
    return dist.group.WORLD if initialized() else None


def rank_seed(seed: int) -> int:
    """The seed of this rank's mask generator: ``seed`` + its data rank, so
    that the ranks of a model group, which hold the same rows, draw the same
    DropPath and dropout masks (mvlt_tpu/cli.py seeds each host)."""
    return seed + data_rank()


def destroy() -> None:
    """Leave the process group, if any."""
    global _device, _layout
    if initialized():
        dist.destroy_process_group()
    _device = None
    _layout = None
    _layouts.clear()
