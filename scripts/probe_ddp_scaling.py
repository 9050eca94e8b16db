#!/usr/bin/env python3
"""Where a data-parallel step's time goes over several cards.

    python -m torch.distributed.run --nproc_per_node=4 scripts/probe_ddp_scaling.py

One rank a card, NCCL. Each rank takes pre-training steps of pvlt_tiny
(configs/pretrain_exp21.py's heads, bf16, B = 150 a rank, DropPath and
dropout off) in three forms, all ranks at once: ``alone``, its own model
without DDP (four processes on one host, no collective); ``ddp``, under
DDP over the world as the command line trains; ``ddp_local_bn``, the same
with the T2I head's BatchNorms on each rank's own statistics (their
cross-rank sums off: the timing shows what those sums cost). Each form's
ms a step by CUDA events (2 warm-up, median of 5), then one step of
``alone`` and of ``ddp`` under torch.profiler on rank 0: the host wall
time, the device time of the kernels, that of NCCL's kernels, and the
idle share. Rank 0 prints one JSON line per form. The weights come from
torch's generator: the times do not depend on them.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from mvlt_tpu_torch.config import DataConfig, ModelConfig, OptimConfig  # noqa: E402
from mvlt_tpu_torch.data.fashion_gen import (SyntheticFashionGen, batch_to_device,  # noqa: E402
                                             collate)
from mvlt_tpu_torch.models.heads import BatchNorm  # noqa: E402
from mvlt_tpu_torch.models.pvlt import create_model  # noqa: E402
from mvlt_tpu_torch.ops import _build  # noqa: E402
from mvlt_tpu_torch.parallel import mesh  # noqa: E402
from mvlt_tpu_torch.parallel.sharding import wrap_model  # noqa: E402
from mvlt_tpu_torch.train.state import create_train_state  # noqa: E402
from mvlt_tpu_torch.train.step import make_train_step  # noqa: E402

BATCH = 150


def step_ms(step, state, batch) -> float:
    for _ in range(2):
        step(state, batch)
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiled(step, state, batch) -> dict:
    """One step under torch.profiler: host wall ms, kernel device ms (all,
    and NCCL's), idle share."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - start) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and e.self_device_time_total > 0]
    device = sum(e.self_device_time_total for e in kernels) / 1e3
    nccl = sum(e.self_device_time_total for e in kernels if "nccl" in e.key.lower()) / 1e3
    return {"wall_ms": wall, "device_ms": device, "nccl_ms": nccl,
            "idle_share": 1 - device / wall if device else "not measured"}


def main() -> None:
    device = mesh.maybe_init_distributed(timeout_s=300)
    if device is None or device.type != "cuda":
        raise RuntimeError("run under torch.distributed.run on a machine with CUDA cards")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = mesh.rank(), mesh.world_size()
    if rank == 0:
        _build.load_library()   # one build, then every rank loads it
    dist.barrier()
    _build.load_library()
    data = SyntheticFashionGen(DataConfig(), size=BATCH, seed=rank)
    batch = batch_to_device({k: v for k, v in collate([data[i] for i in range(BATCH)]).items()
                             if isinstance(v, np.ndarray)}, device)
    cfg = ModelConfig(name="pvlt_tiny", compute_dtype="bfloat16", drop_path_rate=0.0,
                      bert_dropout=0.0)
    step = make_train_step(cfg)
    for form in ("alone", "ddp", "ddp_local_bn"):
        torch.manual_seed(0)
        model = create_model(cfg, device=device)
        ddp = wrap_model(model, device) if form != "alone" else None
        if form == "ddp_local_bn":
            for m in model.modules():
                if isinstance(m, BatchNorm):
                    m.group = None
        state = create_train_state(model, OptimConfig(warmup_epochs=0), BATCH * world, 1,
                                   ddp=ddp)
        ms = step_ms(step, state, batch)
        prof = profiled(step, state, batch) if form != "ddp_local_bn" else {}
        if rank == 0:
            print(json.dumps({"form": form, "world": world, "batch_per_rank": BATCH,
                              "ms_per_step": ms, **prof,
                              "card": torch.cuda.get_device_name(device)}), flush=True)
        del model, ddp, state
        torch.cuda.empty_cache()
        dist.barrier()
    mesh.destroy()


if __name__ == "__main__":
    main()
