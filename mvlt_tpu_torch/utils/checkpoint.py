"""Checkpoint save and resume with ``torch.save``.

Counterpart of mvlt_tpu/utils/checkpoint.py (reference main_vl.py:441-498
and :327-346). The reference policy: a checkpoint every epoch for the first
``save_every_frac`` (2/3) of training, then one only when the summed eval
quality score (mlm + itm + sup + sub accuracy) improves; resume restores
everything and goes on at epoch + 1.

Layout: ``<output_dir>/checkpoint/{last,best}/state.pt`` holds the step,
the model's state dict (parameters and BatchNorm buffers, the reference's
names), the AdamW state and the mask generator's state; ``{last,best}.json``
beside it holds the epoch, the score and the config. The data goes to a
temporary file that is renamed into place, and the meta is written after
it, so a meta never points at a torn checkpoint. Saves are synchronous: the
JAX package's asynchronous Orbax writer has no counterpart here. The LR
schedule is a function of the step and needs no state.

Under data parallelism every rank calls ``save_epoch`` and ``restore``:
rank 0 writes the unwrapped model's state dict (the reference's names,
without DDP's ``module.``), under ZeRO-1 the optimizer state consolidated on
rank 0 first (a collective); ``generators`` holds every data rank's
generator state and ``generator`` rank 0's. Every rank restores the same
file, each taking its data rank's generator state; the optimizer state has
one layout with and without ZeRO-1, so either resumes the other.

Under tensor parallelism (``state.model_group``) the file holds the whole
model: saving consolidates the parameters and the AdamW moments over the
model group (parallel/tensor.py:consolidate) and rank 0 writes them with
the reference's names; restoring shards them (shard_state_dict). Under
ZeRO-1 as well, each data group first consolidates its shard's moments on
its data rank 0 (the ranks of model group 0), which then consolidate them
over their model group. A run saved at one tp, with or without ZeRO-1,
resumes at any other, tp = 1 included. Under sequence parallelism every
rank holds the whole model (``state.model_group`` None): rank 0 writes it
as one process would, and it restores in one process with strict names.

The fine-tune init (``load_finetune_state``) intersects state-dict keys with
shape filtering, as ``merge_params_by_path`` intersects parameter paths: a
reference ``.pth`` loads as it is; a split model merges into its whole
state dict, then takes its shard.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from mvlt_tpu_torch.config import RunConfig, config_to_dict
from mvlt_tpu_torch.parallel import mesh
from mvlt_tpu_torch.parallel.sharding import EvalShard, barrier, gather_slots, group_size
from mvlt_tpu_torch.parallel.tensor import consolidate, shard_state_dict

STATE_FILE = "state.pt"


def resolve_checkpoint_path(path: str, root: Optional[str] = None) -> str:
    """A checkpoint directory from a checkpoint directory itself, an output
    directory holding ``checkpoint/{best,last}``, or a bare tag (``last``,
    ``best``) relative to ``root``."""
    cand = path
    if root and not os.path.exists(cand) and not os.path.isabs(cand):
        cand = os.path.join(root, path)
    p = os.path.abspath(cand)
    if os.path.isdir(p) and not os.path.exists(os.path.join(p, STATE_FILE)):
        for sub in ("checkpoint/best", "checkpoint/last", "best", "last"):
            if os.path.exists(os.path.join(p, sub, STATE_FILE)):
                return os.path.join(p, sub)
    return p


def merge_state_dicts(template: Mapping[str, torch.Tensor],
                      restored: Mapping) -> Tuple[Dict[str, torch.Tensor], Dict[str, list]]:
    """Intersect by key with shape filtering (the reference's fine-tune load,
    main_vl.py:284-290): keys only in the checkpoint are dropped, keys only
    in the template and shape mismatches keep the template's tensor, the
    rest take the checkpoint's, cast to the template's type."""
    report: Dict[str, list] = {"loaded": [], "skipped_shape": [], "missing": [],
                               "dropped": [k for k in restored if k not in template]}
    merged = {}
    for k, t in template.items():
        r = restored.get(k)
        if not isinstance(r, torch.Tensor):
            report["missing"].append(k)
            merged[k] = t
        elif r.shape != t.shape:
            report["skipped_shape"].append(f"{k}: ckpt {tuple(r.shape)} vs model {tuple(t.shape)}")
            merged[k] = t
        else:
            report["loaded"].append(k)
            merged[k] = r.to(t.dtype)
    print(f"param merge: {len(report['loaded'])} loaded, "
          f"{len(report['skipped_shape'])} shape-filtered, "
          f"{len(report['missing'])} kept at init, "
          f"{len(report['dropped'])} checkpoint-only dropped", flush=True)
    return merged, report


def load_finetune_state(path: str, model: torch.nn.Module) -> Dict[str, list]:
    """Fine-tune init (main_vl.py:272-291) and the eval modes' weights
    (cli.py:load_eval_model): model weights only, from a
    reference ``.pth`` (its ``model`` entry, or the file itself) or a
    checkpoint of this package (a checkpoint or output directory), merged
    into ``model`` by ``merge_state_dicts``; returns the merge report and
    raises when no tensor matched."""
    if path.endswith(".pth"):
        # the reference's checkpoints pickle their argparse namespace too
        restored = torch.load(path, map_location="cpu", weights_only=False)
        restored = restored.get("model", restored)
    else:
        file = os.path.join(resolve_checkpoint_path(path), STATE_FILE)
        if not os.path.exists(file):
            raise FileNotFoundError(f"finetune checkpoint not found: {path!r} ({file})")
        restored = torch.load(file, map_location="cpu", weights_only=True)["model"]
    group = getattr(model, "tp_group", None)
    merged, report = merge_state_dicts(consolidate(model.state_dict(), group, model.cfg)
                                       if group is not None else model.state_dict(), restored)
    if not report["loaded"]:
        raise ValueError(f"{path}: no checkpoint tensor matched the model")
    if group is not None:
        merged = shard_state_dict(merged, dist.get_rank(group), group_size(group), model.cfg)
    model.load_state_dict(merged)
    return report


def _moment_names(state) -> list:
    """The parameter names in the optimizer state dict's index order."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [names[id(p)] for g in state.optimizer.param_groups for p in g["params"]]


def _map_moments(optim: dict, names: list, fn) -> dict:
    """``optim`` with each parameter's moments passed through
    ``fn(name, tensor)``."""
    moments = {i: {k: fn(names[i], t) if k in ("exp_avg", "exp_avg_sq") else t
                   for k, t in st.items()} for i, st in optim["state"].items()}
    return {**optim, "state": moments}


def whole_state(state) -> tuple[dict, dict]:
    """(model state dict, optimizer state dict) of the whole model: under
    tensor parallelism consolidated over the model group (a collective on
    every rank of it), else as they are."""
    model_sd, optim_sd = state.model.state_dict(), state.optimizer.state_dict()
    group = state.model_group
    if group_size(group) == 1:
        return model_sd, optim_sd
    cfg = state.model.cfg
    return (consolidate(model_sd, group, cfg),
            _map_moments(optim_sd, _moment_names(state),
                           lambda n, t: consolidate({n: t}, group, cfg)[n]))


def load_whole_state(state, model_sd: dict, optim_sd: dict) -> None:
    """Load a whole model's state dicts into ``state``, each rank taking
    its shard under tensor parallelism (strict names)."""
    group = state.model_group
    if group_size(group) > 1:
        cfg, tp, rank = state.model.cfg, group_size(group), dist.get_rank(group)
        model_sd = shard_state_dict(model_sd, rank, tp, cfg)
        optim_sd = _map_moments(optim_sd, _moment_names(state),
                                  lambda n, t: shard_state_dict({n: t}, rank, tp, cfg)[n])
    state.model.load_state_dict(model_sd, strict=True)
    state.optimizer.load_state_dict(optim_sd)


class CheckpointManager:
    """Two-phase checkpointing under ``<output_dir>/checkpoint``."""

    def __init__(self, output_dir: str, cfg: Optional[RunConfig] = None):
        self.root = os.path.abspath(os.path.join(output_dir, "checkpoint"))
        self.is_main = mesh.is_main()
        if self.is_main:
            os.makedirs(self.root, exist_ok=True)
        barrier()
        self.cfg = cfg
        self.best_score = float("-inf")
        meta = self._read_meta("best")
        if meta:
            self.best_score = meta.get("score", float("-inf"))

    def _path(self, tag: str) -> str:
        return os.path.join(self.root, tag)

    def _read_meta(self, tag: str) -> Optional[dict]:
        p = self._path(tag) + ".json"
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return None

    def _save(self, tag: str, state, epoch: int, score: Optional[float]) -> None:
        """Called by every rank; rank 0 writes, the others wait for it."""
        from torch.distributed.optim import ZeroRedundancyOptimizer

        if isinstance(state.optimizer, ZeroRedundancyOptimizer):
            # onto the data group's first rank: data rank 0, one per model rank
            state.optimizer.consolidate_state_dict(to=0)
        generators = _every_rank_generator_state(state.generator)
        # a split model's consolidation is a collective of its model group,
        # model group 0's (data rank 0, where ZeRO-1's state dicts are)
        whole = whole_state(state) if mesh.data_rank() == 0 else None
        if self.is_main:
            self._write(tag, state, epoch, score, generators, *whole)
        barrier()

    def _write(self, tag: str, state, epoch: int, score: Optional[float], generators,
               model_sd: dict, optim_sd: dict) -> None:
        d = self._path(tag)
        os.makedirs(d, exist_ok=True)
        data = {"step": state.step, "model": model_sd, "optimizer": optim_sd,
                "generator": generators[0], "generators": generators}
        tmp = os.path.join(d, STATE_FILE + ".tmp")
        torch.save(data, tmp)
        os.replace(tmp, os.path.join(d, STATE_FILE))
        meta = {"epoch": epoch, "score": score}
        if self.cfg is not None:
            meta["config"] = config_to_dict(self.cfg)
        with open(d + ".json.tmp", "w") as f:
            json.dump(meta, f, indent=1)
        os.replace(d + ".json.tmp", d + ".json")

    def save_epoch(self, state, epoch: int, total_epochs: int,
                   quality_score: Optional[float] = None,
                   save_every_frac: float = 2.0 / 3.0) -> bool:
        """The reference's two-phase policy; True when a new best was saved
        or the epoch is in the first phase. ``last`` is written every epoch."""
        if epoch < int(total_epochs * save_every_frac):
            self._save("last", state, epoch, quality_score)
            return True
        if quality_score is not None and quality_score > self.best_score:
            self.best_score = quality_score
            self._save("best", state, epoch, quality_score)
            self._save("last", state, epoch, quality_score)
            return True
        self._save("last", state, epoch, quality_score)
        return False

    def restore(self, state, tag_or_path: str = "last"):
        """Restore ``state`` in place from a tag of this run or a path to
        another run or checkpoint; returns (state, the epoch to start at).
        Raises when the target is missing instead of starting afresh."""
        path = resolve_checkpoint_path(tag_or_path, self.root)
        file = os.path.join(path, STATE_FILE)
        if not os.path.exists(file):
            raise FileNotFoundError(
                f"resume target not found: {tag_or_path!r} (resolved to {path})")
        data = torch.load(file, map_location="cpu", weights_only=True)
        load_whole_state(state, data["model"], data["optimizer"])
        # each data rank its own stream; a data rank the writer did not
        # have keeps the one it was seeded with
        generators = data.get("generators") or [data["generator"]]
        if mesh.data_rank() < len(generators):
            state.generator.set_state(generators[mesh.data_rank()])
        state.step = int(data["step"])
        meta = {}
        if os.path.exists(path + ".json"):
            with open(path + ".json") as f:
                meta = json.load(f)
        return state, int(meta.get("epoch", -1)) + 1


def _every_rank_generator_state(generator: torch.Generator) -> list:
    """Every data rank's generator state (uint8 CPU tensors), in data-rank
    order (the ranks of a model group draw from equal generators)."""
    mine = generator.get_state()
    if mesh.world_size() == 1:
        return [mine]
    shard = EvalShard(mesh.world_size(), mesh.rank(), mesh.world_size())
    every = gather_slots(mine.to(torch.float64)[None], shard, dist.group.WORLD)
    return [row.to(torch.uint8) for row in every[::mesh.model_size()]]
