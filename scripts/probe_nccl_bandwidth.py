#!/usr/bin/env python3
"""NCCL all-reduce time and bandwidth between the cards of one machine.

    python -m torch.distributed.run --nproc_per_node=4 scripts/probe_nccl_bandwidth.py

One rank a card (the torchrun environment names it; the port's
``parallel/mesh.py`` joins the group). For each size, fp32 tensors are
summed over the world and over the pair of ranks 0 and 1 (a model group of
``--tp-size 2``): 3 warm-up calls, then the median of 10 by CUDA events
around each call. Rank 0 prints one JSON line per size and group with the
time, the algorithm bandwidth (bytes / time) and the bus bandwidth (times
2 (n - 1) / n, what a ring moves a link), and first whether each pair of
cards can reach each other's memory directly (``can_device_access_peer``).
Run it with ``NCCL_DEBUG=INFO`` to see the transport NCCL picked for each
channel (P2P, SHM or NET).
"""

from __future__ import annotations

import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from mvlt_tpu_torch.parallel import mesh  # noqa: E402

SIZES_MB = (1, 16, 64, 320)


def timed_all_reduce(t: torch.Tensor, group) -> float:
    """Median ms of one all_reduce of ``t`` over ``group``."""
    for _ in range(3):
        dist.all_reduce(t, group=group)
    times = []
    for _ in range(10):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        dist.all_reduce(t, group=group)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> None:
    device = mesh.maybe_init_distributed(timeout_s=300)
    if device is None or device.type != "cuda":
        raise RuntimeError("run under torch.distributed.run on a machine with CUDA cards")
    rank, world = mesh.rank(), mesh.world_size()
    pair = dist.new_group([0, 1])
    if rank == 0:
        n = torch.cuda.device_count()
        print(json.dumps({"peer_access": [[torch.cuda.can_device_access_peer(i, j) if i != j
                                           else None for j in range(n)] for i in range(n)],
                          "backend": dist.get_backend(), "world": world}), flush=True)
    for mb in SIZES_MB:
        t = torch.ones(mb * 2 ** 20 // 4, device=device)
        for name, group, n in (("world", dist.group.WORLD, world), ("ranks 0-1", pair, 2)):
            ms = timed_all_reduce(t, group) if rank < n else None
            if rank == 0:
                algbw = mb * 2 ** 20 / (ms * 1e-3) / 1e9
                print(json.dumps({"group": name, "ranks": n, "mb": mb, "ms": ms,
                                  "algbw_gb_s": algbw, "busbw_gb_s": algbw * 2 * (n - 1) / n}),
                      flush=True)
            dist.barrier()
    mesh.destroy()


if __name__ == "__main__":
    main()
