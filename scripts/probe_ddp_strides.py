#!/usr/bin/env python3
"""Which gradients make DDP warn that their strides differ from its bucket
views, on a CUDA card.

    python3 scripts/probe_ddp_strides.py [--device cuda|cpu]

joins a one-rank gloo group (the torchrun environment set here), wraps
pvlt_tiny with configs/pretrain_exp21.py's heads (bf16, DropPath and
dropout off, seeded weights) in DDP through parallel/sharding.py:wrap_model
and takes one step at B = 8 on a synthetic batch, recording Python
warnings. Prints one JSON line: the warnings' texts; every parameter whose
gradient's strides differ from the parameter's (name, shape, both strides,
whether each is contiguous), before DDP's reducer reads them; and the card's
name and power limit.
"""

import argparse
import json
import os
import pathlib
import socket
import subprocess
import sys
import warnings

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from mvlt_tpu_torch.config import DataConfig, ModelConfig, OptimConfig  # noqa: E402
from mvlt_tpu_torch.data.fashion_gen import SyntheticFashionGen, batch_to_device, collate  # noqa: E402
from mvlt_tpu_torch.models.pvlt import create_model  # noqa: E402
from mvlt_tpu_torch.parallel import mesh  # noqa: E402
from mvlt_tpu_torch.parallel.sharding import wrap_model  # noqa: E402
from mvlt_tpu_torch.train.state import create_train_state  # noqa: E402
from mvlt_tpu_torch.train.step import make_train_step  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    device = mesh.maybe_init_distributed(device=args.device if args.device == "cpu" else "cuda:0",
                                         backend="gloo")
    cfg = ModelConfig(name="pvlt_tiny", compute_dtype="bfloat16", drop_path_rate=0.0,
                      bert_dropout=0.0)
    torch.manual_seed(0)
    model = create_model(cfg, device=device)
    ddp = wrap_model(model, device)
    state = create_train_state(model, OptimConfig(warmup_epochs=0), 8, 1, ddp=ddp)
    data = SyntheticFashionGen(DataConfig(), size=8, seed=0)
    batch = batch_to_device({k: v for k, v in collate([data[i] for i in range(8)]).items()
                             if not isinstance(v, list)}, device)
    mismatched = []

    def look(name, p):
        def hook(grad):
            if grad.stride() != p.stride():
                mismatched.append({"name": name, "shape": list(p.shape),
                                   "param_stride": list(p.stride()),
                                   "grad_stride": list(grad.stride()),
                                   "grad_contiguous": grad.is_contiguous(),
                                   "param_contiguous": p.is_contiguous()})
        return hook

    for name, p in model.named_parameters():
        p.register_hook(look(name, p))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        make_train_step(cfg)(state, batch)
        if device.type == "cuda":
            torch.cuda.synchronize()
    after = [{"name": n, "grad_stride": list(p.grad.stride()), "param_stride": list(p.stride())}
             for n, p in model.named_parameters()
             if p.grad is not None and p.grad.stride() != p.stride()]
    smi = ""
    if device.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=False).stdout.strip()
    print(json.dumps({"probe": "ddp_strides", "device": str(device),
                      "warnings": sorted({str(w.message)[:300] for w in caught}),
                      "hook_grads_off_param_strides": mismatched,
                      "accumulated_grads_off_param_strides": after, "nvidia_smi": smi}),
          flush=True)
    mesh.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
