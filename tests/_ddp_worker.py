"""Worker of the port's data-, tensor- and sequence-parallel tests
(tests/test_torch_port_ddp.py, tests/test_torch_port_ddp_eval.py,
tests/test_torch_port_imports.py, tests/test_torch_port_tp.py,
tests/test_torch_port_tp_families.py, tests/test_torch_port_sp.py).

Run as ``python tests/_ddp_worker.py <spec.json> [--guard]`` with the
torchrun environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT) set: each rank joins the gloo group through
mvlt_tpu_torch.parallel.mesh.maybe_init_distributed, runs the spec's
cases on its share of the data, and writes what the test compares to
``<out>/<case>_<rank>.pt``. It imports nothing of JAX (with ``--guard``
jax, flax and mvlt_tpu are blocked, and it checks that none was loaded).
The spec names the port's micro config, a state dict bridged from the JAX
weights, the global batch and the eval data, all written by the test.
"""

import json
import os
import sys

if "--guard" in sys.argv:
    for _name in ("jax", "jaxlib", "flax", "mvlt_tpu"):
        sys.modules[_name] = None      # any import of them now fails

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mvlt_tpu_torch import config  # noqa: E402
from mvlt_tpu_torch.models.pvlt import Block, create_model, kernel_operand  # noqa: E402
from mvlt_tpu_torch.parallel import mesh  # noqa: E402
from mvlt_tpu_torch.parallel.sharding import EvalShard, wrap_model  # noqa: E402
from mvlt_tpu_torch.train.losses import mlm_gather_plan  # noqa: E402
from mvlt_tpu_torch.train.state import create_train_state  # noqa: E402
from mvlt_tpu_torch.train.step import make_train_step  # noqa: E402
from mvlt_tpu_torch.utils.checkpoint import CheckpointManager  # noqa: E402
from mvlt_tpu_torch.utils.logging import MetricLogger  # noqa: E402


def port_config(spec, dtype: str = "", **overrides) -> config.ModelConfig:
    micro = {k: tuple(v) if isinstance(v, list) else v
             for k, v in {**spec["micro"], **overrides}.items()}
    if dtype:
        micro["compute_dtype"] = dtype
    return config.ModelConfig(**micro, loss_type=config.LossType(**spec["heads"]))


def rank_rows(n: int, rank: int, world: int, grad_accum: int = 1) -> np.ndarray:
    """The global batch's rows of ``rank``: for each of ``grad_accum``
    consecutive microbatches, its ``rank``-th contiguous share, as a data
    mesh shards each microbatch of the JAX step."""
    mb = n // grad_accum
    share = mb // world
    return np.concatenate([np.arange(i * mb + rank * share, i * mb + (rank + 1) * share)
                           for i in range(grad_accum)])


def ddp_state(spec, zero1: bool = False, step: int = 0, dtype: str = ""):
    cfg = port_config(spec, dtype)
    model = create_model(cfg, device="cpu", input_size=spec["img"])
    model.load_state_dict(torch.load(spec["weights"], weights_only=True), strict=True)
    model.to(getattr(torch, cfg.compute_dtype))    # fp64 runs keep fp64 masters
    ddp = wrap_model(model, torch.device("cpu"))
    state = create_train_state(model, config.OptimConfig(warmup_epochs=0), spec["global_batch"],
                               10, seed=mesh.rank(), ddp=ddp, zero1=zero1)
    state.step = step
    return cfg, state


def snapshot(state, losses) -> dict:
    return {"losses": {k: float(v) for k, v in losses.items()},
            "grads": {n: p.grad.detach().clone() for n, p in state.model.named_parameters()
                      if p.grad is not None},
            "params": {n: p.detach().clone() for n, p in state.model.named_parameters()},
            "buffers": {n: b.detach().clone() for n, b in state.model.named_buffers()}}


def local_batch(spec, rows) -> dict:
    batch = dict(np.load(spec["batch"]))
    return {k: v[rows] for k, v in batch.items()}


def case_step(spec, rank, world) -> dict:
    """One DDP step on this rank's rows at step 0, with grad_accum 1 and 2,
    computing in each of the spec's dtypes."""
    out = {}
    n = spec["global_batch"]
    for dtype in spec["step_dtypes"]:
        for ga in (1, 2):
            cfg, state = ddp_state(spec, dtype=dtype)
            state, losses = make_train_step(cfg, grad_accum=ga)(state, local_batch(
                spec, rank_rows(n, rank, world, ga)))
            out[f"{dtype}_accum{ga}"] = snapshot(state, losses)
    return out


def case_plan(spec, rank, world) -> dict:
    """Each rank's plan over its share of every label set of the spec, with
    the counts exchanged: the global rows it keeps, in slot order, and the
    global count kept."""
    out = {}
    for name, labels in np.load(spec["plan_labels"]).items():
        rows = labels.shape[0] // world
        mine = torch.from_numpy(labels[rank * rows:(rank + 1) * rows])
        idx, sel, chunk, total = mlm_gather_plan(mine, capacity_frac=spec["plan_frac"],
                                                 group=torch.distributed.group.WORLD)
        kept = idx[sel != -1] + rank * mine.numel()
        out[name] = {"kept": kept, "slots": int(idx.numel()), "chunk": chunk,
                     "total": int(total)}
    return out


def case_meters(spec, rank, world) -> dict:
    logger = MetricLogger(is_main=False)
    for v in range(3 + 2 * rank):              # unequal counts per rank
        logger.update(loss=10.0 * rank + v, lr=0.5)
    logger.synchronize_between_processes()
    return {"global": logger.global_averages(),
            "counts": {k: m.count for k, m in logger.meters.items()}}


def case_zero(spec, rank, world) -> dict:
    """A DDP step without and with ZeRO-1 from the same weights; the ZeRO
    run saves a checkpoint (rank 0 writes) and takes a second step."""
    out = {}
    rows = rank_rows(spec["global_batch"], rank, world)
    for zero1 in (False, True):
        cfg, state = ddp_state(spec, zero1=zero1, dtype=spec["zero_dtype"])
        step = make_train_step(cfg)
        blocks = [m for m in state.model.modules() if isinstance(m, Block)]
        before = blocks[0].kernel_operands(torch.bfloat16)   # a cache filled before the step
        state, losses = step(state, local_batch(spec, rows))
        tag = "zero1" if zero1 else "plain"
        out[tag] = snapshot(state, losses)
        out[tag]["moment_bytes"] = sum(
            t.numel() * t.element_size()
            for s in (state.optimizer.optim.state if zero1 else state.optimizer.state).values()
            for k, t in s.items() if k in ("exp_avg", "exp_avg_sq"))
        fresh = [kernel_operand(t, torch.bfloat16) for t in blocks[0].kernel_params()[0]]
        cached = blocks[0].kernel_operands(torch.bfloat16)[0]
        out[tag]["cache_fresh"] = all(torch.equal(a, b) for a, b in zip(cached, fresh)
                                      if a is not None)
        mat = next(i for i, t in enumerate(cached) if t is not None and t.dim() > 1)
        out[tag]["cache_moved"] = cached[mat] is not before[0][mat]
        if zero1:
            CheckpointManager(spec["ckpt_dir"]).save_epoch(state, 0, 3)
            state, losses = step(state, local_batch(spec, rows))
            out["zero1_next"] = snapshot(state, losses)
    return out


def case_eval(spec, rank, world) -> dict:
    """The VL eval, retrieval and recognition of the spec's data with every
    eval sharded over the (data) ranks; with spec["sp_group"] the model is
    sequence-parallel over the model group."""
    from mvlt_tpu_torch import cli
    from mvlt_tpu_torch.eval.recognition import evaluate_recognition, make_cls_scorer
    from mvlt_tpu_torch.eval.retrieval import evaluate_retrieval, make_itm_scorer
    from mvlt_tpu_torch.eval.vl_eval import evaluate_vl, make_vl_eval_fn

    cfg = port_config(spec)
    model = create_model(cfg, device="cpu", input_size=spec["img"],
                         sp_group=mesh.model_group() if spec.get("sp_group") else None)
    model.load_state_dict(torch.load(spec["weights"], weights_only=True), strict=True)
    model.eval()
    data = torch.load(spec["eval_data"], weights_only=False)
    vl = evaluate_vl(make_vl_eval_fn(model, cfg), data["vl_batches"], is_main=False)
    bundles = data["bundles"]
    shard = EvalShard.of_this_rank(len(bundles))
    retrieval = evaluate_retrieval(make_itm_scorer(model), cli._simple_loader(bundles, 1, shard),
                                   is_main=False, shard=shard)
    items = data["items"]
    shard = EvalShard.of_this_rank(len(items))
    recognition = evaluate_recognition(
        make_cls_scorer(model), cli._simple_loader(items, data["rec_batch"], shard),
        num_super=cfg.num_super_classes, num_sub=cfg.num_sub_classes,
        artifact_dir=spec["out"] if rank == 0 else None, is_main=rank == 0, shard=shard,
        names=[it["info_list"] for it in items])
    return {"vl": vl, "retrieval": retrieval, "recognition": recognition}


def tp_state(spec, step: int = 0, clip: float = 0.0, zero1: bool = False, dtype: str = "",
             **overrides):
    """A state of the spec's micro model (``overrides`` on its config, the
    masters in ``dtype``) split over this rank's model group
    (parallel/mesh.py:init_model_parallel done), under DDP over its data
    group when there are several, ZeRO-1 over it with ``zero1``, from the
    spec's whole weights."""
    from mvlt_tpu_torch.parallel.tensor import shard_model
    from mvlt_tpu_torch.parallel.sharding import wrap_model

    cfg = port_config(spec, dtype, **overrides)
    model = create_model(cfg, device="cpu", input_size=spec["img"])
    model.load_state_dict(torch.load(spec["weights"], weights_only=True), strict=True)
    model.to(getattr(torch, cfg.compute_dtype))    # fp64 runs keep fp64 masters
    shard_model(model, mesh.model_group())
    ddp = wrap_model(model, torch.device("cpu"), mesh.data_group()) if mesh.data_size() > 1 \
        else None
    state = create_train_state(model, config.OptimConfig(warmup_epochs=0, clip_grad=clip),
                               spec["global_batch"], 10, seed=mesh.rank_seed(0), ddp=ddp,
                               zero1=zero1, model_group=mesh.model_group())
    state.step = step
    return cfg, state


def tp_snapshot(cfg, state, losses) -> dict:
    """The step's losses and the whole model's gradients, parameters and
    buffers, consolidated over the model group."""
    from mvlt_tpu_torch.parallel.tensor import consolidate

    group, model = state.model_group, state.model
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    return {"losses": {k: float(v) for k, v in losses.items()},
            "grads": consolidate(grads, group, cfg),
            "params": consolidate({n: p.detach().clone() for n, p in model.named_parameters()},
                                  group, cfg),
            "buffers": {n: b.detach().clone() for n, b in model.named_buffers()}}


def case_tp(spec, rank, world) -> dict:
    """Steps of the split model on this data rank's rows of the global batch:
    at step 0 (clean images), step 1 (masked images) and step 0 with
    clip_grad; then a checkpoint of the step-1 state (whole, rank 0 writes)."""
    out = {}
    mesh.init_model_parallel(spec["tp"])
    rows = rank_rows(spec["global_batch"], mesh.data_rank(), mesh.data_size())
    for name, step, clip in (("step0", 0, 0.0), ("step1", 1, 0.0), ("clip", 0, spec["clip"])):
        cfg, state = tp_state(spec, step, clip)
        state, losses = make_train_step(cfg)(state, local_batch(spec, rows))
        out[name] = tp_snapshot(cfg, state, losses)
        if name == "step1":
            CheckpointManager(spec["ckpt_dir"]).save_epoch(state, 0, 3)
    out["layout"] = {"model_rank": mesh.model_rank(), "data_rank": mesh.data_rank(),
                     "generator": state.generator.get_state()}
    return out


def case_tp_decode(spec, rank, world) -> dict:
    """The eval decode of a vocabulary split over the model group against
    the whole logits' nll and argmax, on logits whose maxima repeat within
    and across the ranks' ranges (the lowest index must win)."""
    from mvlt_tpu_torch.parallel.tensor import VocabShardLogits

    mesh.init_model_parallel(spec["tp"])
    gen = torch.Generator().manual_seed(5)
    logits = torch.randn(6, 7, 30, generator=gen).round(decimals=1)
    logits[0, :, [3, 20]] = 9.0                  # across the two ranges
    logits[1, :, [16, 29]] = 9.0                 # within the second range
    logits[2, :, [0, 1, 15]] = 9.0               # within the first, and across
    labels = torch.randint(-1, 30, (6, 7), generator=gen)
    width = 30 // mesh.model_size()
    start = mesh.model_rank() * width
    shard = VocabShardLogits(logits[..., start:start + width], start, mesh.model_group())
    nll, argmax = shard.nll_and_argmax(labels)
    return {"nll": nll, "argmax": argmax, "logits": logits, "labels": labels}


def case_tp_families(spec, rank, world) -> dict:
    """For each family of the spec (its own micro config, weights, image
    size and global batch): a step of the split model at step 0 on this
    data rank's rows (fp32, the JAX comparison). Then each fp64 case of the
    spec on its family (dropout, --remat, ZeRO-1 over the data group): a
    step from the same weights and seed, the ZeRO-1 case saving its
    checkpoint; the resume case restores that checkpoint at this tp
    without ZeRO-1. Every snapshot consolidated over the model group."""
    from mvlt_tpu_torch.utils.checkpoint import whole_state

    mesh.init_model_parallel(spec["tp"])
    rows = rank_rows(spec["global_batch"], mesh.data_rank(), mesh.data_size())
    out = {}
    for label, fam in spec["families"].items():
        fspec = {**spec, **fam}
        cfg, state = tp_state(fspec)
        state, losses = make_train_step(cfg)(state, local_batch(fspec, rows))
        out[label] = tp_snapshot(cfg, state, losses)
    for label, case in spec["fp64_cases"].items():
        fspec = {**spec, **spec["families"][case["family"]]}
        cfg, state = tp_state(fspec, zero1=case.get("zero1", False), dtype="float64",
                              **case["overrides"])
        if case.get("resume"):
            state, epoch = CheckpointManager(case["resume"]).restore(state, "last")
            model_sd, optim_sd = whole_state(state)
            out[label] = {"params": model_sd, "moments": optim_sd["state"],
                          "step": state.step, "epoch": epoch}
            continue
        state, losses = make_train_step(cfg)(state, local_batch(fspec, rows))
        out[label] = tp_snapshot(cfg, state, losses)
        out[label]["generator"] = state.generator.get_state()
        if case.get("save"):
            CheckpointManager(case["save"]).save_epoch(state, 0, 3)
    return out


def sp_model(spec, fam: dict, dtype: str = "", **overrides):
    """The family's micro model (``overrides`` on its config, the masters in
    ``dtype``) from its whole weights, sequence-parallel over this rank's
    model group (parallel/mesh.py:init_model_parallel done)."""
    cfg = port_config({**spec, **fam}, dtype, **overrides)
    model = create_model(cfg, device="cpu", input_size=spec["img"],
                         sp_group=mesh.model_group())
    model.load_state_dict(torch.load(fam["weights"], weights_only=True), strict=True)
    model.to(getattr(torch, cfg.compute_dtype))    # fp64 runs keep fp64 masters
    return cfg, model


def case_sp(spec, rank, world) -> dict:
    """Sequence parallelism over model groups of spec["sp"] ranks: per
    family, the eval forward of this data rank's rows of the global batch
    (every head), the stages it split and ``describe``; per step case, one
    step at step 0 on those rows (DDP over the data group where there are
    several), the v1 one saving a checkpoint; with spec["eval"] the VL,
    retrieval and recognition evals of the v1 model, sharded over the data
    ranks."""
    from mvlt_tpu_torch.parallel.sequence import describe

    mesh.init_model_parallel(spec["sp"])
    rows = rank_rows(spec["global_batch"], mesh.data_rank(), mesh.data_size())
    batch = local_batch(spec, rows)
    out = {"layout": {"model_rank": mesh.model_rank(), "data_rank": mesh.data_rank()},
           "forward": {}, "split": {}, "describe": {}}
    for label, fam in spec["families"].items():
        _, model = sp_model(spec, fam)
        model.eval()
        with torch.no_grad():
            logits = model(torch.from_numpy(batch["images"]),
                           torch.from_numpy(batch["input_ids"]).long())
        out["forward"][label] = {k: v for k, v in logits.items() if v is not None}
        out["split"][label] = model.sp_split
        out["describe"][label] = describe(model)
    for label, (family, overrides, dtype) in spec["steps"].items():
        cfg, model = sp_model(spec, spec["families"][family], dtype, **overrides)
        ddp = wrap_model(model, torch.device("cpu"), mesh.data_group()) \
            if mesh.data_size() > 1 else None
        state = create_train_state(model, config.OptimConfig(warmup_epochs=0),
                                   spec["global_batch"], 10, seed=mesh.rank_seed(0), ddp=ddp)
        state, losses = make_train_step(cfg)(state, batch)
        out[label] = {**snapshot(state, losses), "generator": state.generator.get_state()}
        if label == "v1":
            CheckpointManager(spec["ckpt_dir"]).save_epoch(state, 0, 3)
    if spec.get("eval_data"):
        out["eval"] = case_eval({**spec, **spec["families"]["v1"], "sp_group": True}, rank, world)
    return out


CASES = {"step": case_step, "plan": case_plan, "meters": case_meters, "zero": case_zero,
         "eval": case_eval, "tp": case_tp, "tp_decode": case_tp_decode,
         "tp_families": case_tp_families, "sp": case_sp}


def main() -> None:
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    assert mesh.maybe_init_distributed(device="cpu") == torch.device("cpu")
    rank, world = mesh.rank(), mesh.world_size()
    assert torch.distributed.get_backend() == "gloo" and world == spec["world"]
    try:
        for case in spec["cases"]:
            torch.save(CASES[case](spec, rank, world),
                       os.path.join(spec["out"], f"{case}_{rank}.pt"))
    finally:
        mesh.destroy()
    if "--guard" in sys.argv:
        loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "mvlt_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
    print("OK", rank, flush=True)


if __name__ == "__main__":
    main()
