"""Tensor parallelism of the v2, linear-SR v2 and Swin backbones, with
dropout, ``--remat`` and ``--zero1``, on gloo ranks on the CPU.

The JAX package's contract (tests/test_train_step.py:120,
test_tp_matches_single_device) is that the step on a (data, model) mesh
equals the single-device step on the global batch; its ``--tp-size`` shards
the same parameter paths in every family (mvlt_tpu/parallel/sharding.py:
_RULES). Here worker processes (tests/_ddp_worker.py, case ``tp_families``)
split the micro model of tests/test_train_step.py (heads 1/2/2/4, MLP
hidden 2x, vocabulary 64, ITM + MLM + T2I) as ``pvlt_v2_tiny``,
``pvlt_v2_linear_tiny`` and ``pvlt_swin_tiny`` at 64x64 over tp = 2 ranks
(world 2) and over dp = 2 x tp = 2 (world 4): stage 1's attention stays
replicated, stages 2-4 split by whole heads (Swin's relative-position
tables by their head columns), every MLP hidden (v2's depthwise conv by its
channels) and the vocabulary split. One fp32 step at step 0 (DropPath and
dropout off) is held to JAX's single-device XLA step on the global batch of
8: the losses (the data ranks' mean), every consolidated gradient and the
BatchNorm statistics at rtol 2e-4 / atol 2e-5, the tolerance of that test.
Dropout cannot match JAX's random stream, so the fp64 cases are held to the
port's one-process step from the same weights and seed within 1e-6 of each
tensor's largest magnitude: dropout on v2 (projection, MLP hidden and
attention probabilities) and on Swin (projection and MLP hidden), whose
split tensors' masks are each rank's slice of the one-process mask;
``--remat`` with dropout on linear-SR v2 and on Swin (the recompute repeats
the block's collectives and draws the same masks); and ``--zero1`` at dp 2 x
tp 2 on v2 (the moments partitioned over each data group), whose
checkpoint resumes at tp = 1 without ZeRO-1 and at tp = 2, each to the same
parameters and moments. Every rank holds the same consolidated tensors. A
torchrun CLI epoch trains ``pvlt_v2_tiny`` at --tp-size 2 over four ranks
with ``--zero1 --remat`` and dropout. Two gloo spawns and one torchrun
launch.
"""

import concurrent.futures
import json
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu import config as jax_config
from mvlt_tpu_torch import config
from mvlt_tpu_torch.convert import state_dict_from_jax
from mvlt_tpu_torch.models.pvlt import create_model
from mvlt_tpu_torch.train.state import create_train_state
from mvlt_tpu_torch.train.step import make_train_step
from mvlt_tpu_torch.utils.checkpoint import STATE_FILE, CheckpointManager
from tests.test_torch_port_ddp import (GLOBAL_B, HEADS, PORT_TOL, REPO, assert_close_to_max,
                                       spawn, torchrun)
from tests.test_torch_port_train import LOSS_KEYS, MICRO, T, _numpy_weights, one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

TOL = dict(rtol=2e-4, atol=2e-5)
IMG = 64
FAMILIES = {"v2": "pvlt_v2_tiny", "linear": "pvlt_v2_linear_tiny", "swin": "pvlt_swin_tiny"}
DROP = dict(drop_rate=0.1, drop_path_rate=0.1, bert_dropout=0.1)
# fp64 cases at tp = 2 (world 2): (family, config overrides)
FP64_CASES = {
    "dropout_v2": ("v2", {**DROP, "attn_drop_rate": 0.1}),
    "dropout_swin": ("swin", DROP),
    "remat_linear": ("linear", {**DROP, "attn_drop_rate": 0.1, "remat": True}),
    "remat_swin": ("swin", {**DROP, "remat": True}),
}


def family_micro(name: str) -> dict:
    return {**MICRO, "img_size": IMG, "name": name}


def global_batch(seed: int) -> dict:
    """The global batch of 8 at IMG, rows 0-3 labeled at 40%, rows 4-7 at
    5% (tests/test_torch_port_ddp.py:make_global_batch's imbalance)."""
    rng = np.random.default_rng(seed)
    b = GLOBAL_B
    imgs = rng.random((b, IMG, IMG, 3)).astype(np.float32)
    rate = np.where(np.arange(b) < b // 2, 0.4, 0.05)[:, None]
    labels = np.where(rng.random((b, T)) < rate, rng.integers(0, 64, (b, T)), -1)
    labels[b // 2, 0] = 7
    return {
        "images": imgs,
        "masked_images": np.where(rng.random((b, IMG, IMG, 1)) < 0.5, 1e-6,
                                  imgs).astype(np.float32),
        "input_ids": rng.integers(0, 64, (b, T)).astype(np.int32),
        "mlm_labels": labels.astype(np.int32),
        "itm_labels": rng.integers(0, 2, (b,)).astype(np.int32),
        "sup_cls_labels": rng.integers(0, 48, (b,)).astype(np.int32),
        "sub_cls_labels": rng.integers(0, 122, (b,)).astype(np.int32),
    }


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    """(root, {label: (JAX config and model, params, stats, batch, the
    workers' family spec)}) with each family's weights and batch on disk."""
    from mvlt_tpu.models import create_model as jax_create_model

    root = tmp_path_factory.mktemp("tp_families")
    out = {}
    for i, (label, name) in enumerate(FAMILIES.items()):
        jcfg = jax_config.ModelConfig(**family_micro(name), use_pallas_attention=False,
                                      loss_type=jax_config.LossType(**HEADS))
        jmodel = jax_create_model(jcfg)
        params, stats = _numpy_weights(jmodel, seed=11 + i, img=IMG)
        torch.save(state_dict_from_jax(params, stats), root / f"{label}.pt")
        batch = global_batch(21 + i)
        np.savez(root / f"{label}.npz", **batch)
        out[label] = ((jcfg, jmodel), params, stats, batch,
                      {"micro": family_micro(name), "img": IMG,
                       "weights": str(root / f"{label}.pt"), "batch": str(root / f"{label}.npz")})
    return root, out


def base_spec(families) -> dict:
    return {"micro": MICRO, "heads": HEADS, "img": IMG, "global_batch": GLOBAL_B, "tp": 2,
            "cases": ["tp_families"],
            "families": {label: f[4] for label, f in families[1].items()}}


@pytest.fixture(scope="module")
def runs(families):
    """({world: every rank's results}, {label: JAX's step}): world 4 (dp 2 x
    tp 2) with the ZeRO-1 case saving its checkpoint, then world 2 (tp 2)
    with the dropout and remat cases and the resume of that checkpoint;
    JAX's steps are taken in a thread meanwhile."""
    root = families[0]
    zero_dir = str(root / "zero1_run")
    one_dir = str(root / "one_run")
    _, state, _ = one_process(families[1]["v2"])
    CheckpointManager(one_dir).save_epoch(state, 0, 3)     # world 1, plain AdamW
    spec4 = {**base_spec(families), "fp64_cases": {
        "zero1_v2": {"family": "v2", "overrides": {}, "zero1": True, "save": zero_dir},
        "resume_zero1": {"family": "v2", "overrides": {}, "zero1": True, "resume": one_dir}}}
    spec2 = {**base_spec(families), "fp64_cases": {
        **{k: {"family": f, "overrides": o} for k, (f, o) in FP64_CASES.items()},
        "resume_tp2": {"family": "v2", "overrides": {}, "resume": zero_dir}}}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        steps = pool.submit(lambda: {label: jax_step(f) for label, f in families[1].items()})
        world4 = spawn(spec4, root / "w4", world=4)["tp_families"]
        world2 = spawn(spec2, root / "w2", world=2)["tp_families"]
        return {4: world4, 2: world2}, steps.result()


def jax_step(family):
    """(gradients, losses, BatchNorm statistics) of JAX's single-device step
    on the family's global batch at step 0."""
    from mvlt_tpu.train.losses import compute_losses

    (jcfg, jmodel), params, stats, batch, _ = family

    def loss_fn(p):
        out, new = jmodel.apply({"params": p, "batch_stats": stats}, jnp.asarray(batch["images"]),
                                jnp.asarray(batch["input_ids"]), train=True,
                                mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        losses = compute_losses(out, batch, mlm_chunk=max(jcfg.mlm_loss_chunk, 1),
                                mlm_capacity_frac=jcfg.mlm_capacity_frac, mlm_ce_kernel=False)
        return losses["total_loss"], (losses, new["batch_stats"])

    g, (losses, st) = jax.jit(jax.grad(loss_fn, has_aux=True))(params)
    return (state_dict_from_jax(jax.tree_util.tree_map(np.asarray, g)),
            {k: float(v) for k, v in losses.items()}, state_dict_from_jax({}, jax.device_get(st)))


def one_process(family, dtype="float64", **overrides):
    """The port's one-process step (seed 0) of a family on its global
    batch: (model, state, losses)."""
    cfg = config.ModelConfig(**{**family[4]["micro"], "compute_dtype": dtype, **overrides},
                             loss_type=config.LossType(**HEADS))
    model = create_model(cfg, device="cpu", input_size=IMG)
    model.load_state_dict(torch.load(family[4]["weights"], weights_only=True), strict=True)
    model.to(getattr(torch, dtype))
    state = create_train_state(model, config.OptimConfig(warmup_epochs=0), GLOBAL_B, 10, seed=0)
    state, losses = make_train_step(cfg)(state, family[3])
    return model, state, {k: float(v) for k, v in losses.items()}


def assert_ranks_equal(ranks, case):
    for r in ranks[1:]:
        for key in ("grads", "params", "buffers"):
            for n, t in ranks[0][case][key].items():
                assert torch.equal(t, r[case][key][n]), (case, key, n)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("label", sorted(FAMILIES))
def test_family_step_matches_jax_single_device(runs, world, label):
    ranks = runs[0][world]
    assert_ranks_equal(ranks, label)
    want_g, want_l, want_bn = runs[1][label]
    data_ranks = [r[label] for r in ranks[::2]]      # one rank of each model group
    for k in LOSS_KEYS:
        got = float(np.mean([r["losses"][k] for r in data_ranks]))
        np.testing.assert_allclose(got, want_l[k], err_msg=k, **TOL)
    got_g = ranks[0][label]["grads"]
    assert sorted(got_g) == sorted(want_g)
    for n, w in want_g.items():
        np.testing.assert_allclose(got_g[n].numpy(), w.numpy(), err_msg=n, **TOL)
    for n, w in want_bn.items():
        np.testing.assert_allclose(ranks[0][label]["buffers"][n].numpy(), w.numpy(),
                                   err_msg=n, **TOL)


@pytest.mark.parametrize("case", sorted(FP64_CASES))
def test_dropout_and_remat_match_one_process(families, runs, case):
    """tp = 2 in fp64 against the port's one-process step from the same
    weights and seed: losses, gradients and parameters after AdamW within
    PORT_TOL of each tensor's largest magnitude, the generator at the same
    state after the step (the split masks drew what one process draws)."""
    label, overrides = FP64_CASES[case]
    ranks = runs[0][2]
    assert_ranks_equal(ranks, case)
    model, state, losses = one_process(families[1][label], **overrides)
    got = ranks[0][case]
    assert_close_to_max(got["grads"], {n: p.grad for n, p in model.named_parameters()},
                        PORT_TOL, f"{case} grads")
    assert_close_to_max(got["params"], {n: p.detach() for n, p in model.named_parameters()},
                        PORT_TOL, f"{case} params")
    for k in LOSS_KEYS:
        assert abs(got["losses"][k] - losses[k]) <= PORT_TOL * max(abs(losses[k]), 1e-12), k
    assert torch.equal(got["generator"], state.generator.get_state())
    assert losses["loss_mlm"] > 0 and all(np.isfinite(v) for v in losses.values())


def _moments(optimizer, names: dict) -> dict:
    return {f"{names[id(p)]}.{k}": v for p, st in optimizer.state.items()
            for k, v in st.items() if k in ("exp_avg", "exp_avg_sq")}


def test_zero1_under_tp_then_resume(families, runs):
    """dp 2 x tp 2 with ZeRO-1 in fp64 against the one-process step (no
    ZeRO-1): gradients and parameters within PORT_TOL; its checkpoint (the
    whole model and moments) restores in one process without ZeRO-1 to the
    same parameters and moments, and at tp = 2 to them exactly."""
    family = families[1]["v2"]
    ranks = runs[0][4]
    assert_ranks_equal(ranks, "zero1_v2")
    model, state, _ = one_process(family)
    got = ranks[0]["zero1_v2"]
    assert_close_to_max(got["grads"], {n: p.grad for n, p in model.named_parameters()},
                        PORT_TOL, "grads")
    assert_close_to_max(got["params"], {n: p.detach() for n, p in model.named_parameters()},
                        PORT_TOL, "params")
    names = {id(p): n for n, p in model.named_parameters()}
    want_moments = _moments(state.optimizer, names)

    root = families[0] / "zero1_run"
    saved = torch.load(root / "checkpoint" / "last" / STATE_FILE, weights_only=True)
    assert sorted(saved["model"]) == sorted(model.state_dict())
    assert len(saved["generators"]) == 2 and saved["step"] == 1
    fresh = create_model(model.cfg, device="cpu", input_size=IMG).to(torch.float64)
    restored = create_train_state(fresh, config.OptimConfig(warmup_epochs=0), GLOBAL_B, 10)
    restored, epoch = CheckpointManager(str(root)).restore(restored, "last")
    assert (restored.step, epoch) == (1, 1)
    for n, p in fresh.named_parameters():
        assert torch.equal(p.detach(), saved["model"][n]), n
        assert torch.equal(p.detach(), got["params"][n]), n
    names = {id(p): n for n, p in fresh.named_parameters()}
    got_moments = _moments(restored.optimizer, names)
    assert_close_to_max(got_moments, want_moments, PORT_TOL, "moments")

    for r in runs[0][2]:              # resumed at tp = 2, consolidated again
        res = r["resume_tp2"]
        assert (res["step"], res["epoch"]) == (1, 1)
        for n, t in saved["model"].items():
            assert torch.equal(res["params"][n], t), n
        assert sorted(res["moments"]) == sorted(saved["optimizer"]["state"])
        for i, st in saved["optimizer"]["state"].items():
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(res["moments"][i][k], st[k]), (i, k)


def test_world1_checkpoint_resumes_under_zero1(families, runs):
    """A checkpoint of one process's plain AdamW step restores at dp 2 x tp 2
    under ZeRO-1 by element: each rank keeps its slice of every moment of
    its shard that splits (sharded / 2 + whole bytes, exactly), and the
    moments gathered whole again (over the data group, then the model
    group) and the parameters equal the checkpoint's."""
    from mvlt_tpu_torch.parallel.sharding import zero1_dim
    from mvlt_tpu_torch.parallel.tensor import shard_tensor, split_of

    saved = torch.load(families[0] / "one_run" / "checkpoint" / "last" / STATE_FILE,
                       weights_only=True)
    model, _, _ = one_process(families[1]["v2"])
    for rank, r in enumerate(runs[0][4]):
        res = r["resume_zero1"]
        assert (res["step"], res["epoch"]) == (1, 1)
        for n, t in saved["model"].items():
            assert torch.equal(res["params"][n], t), n
        assert sorted(res["moments"]) == sorted(saved["optimizer"]["state"])
        for i, st in saved["optimizer"]["state"].items():
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(res["moments"][i][k], st[k]), (i, k)
        want = 0
        for n, p in model.named_parameters():
            kind = split_of(n, model.cfg, 2)
            shard = torch.nn.Parameter(shard_tensor(p.detach(), kind, rank % 2, 2))
            shard.tp_split = kind
            nbytes = 2 * shard.numel() * shard.element_size()
            want += nbytes // 2 if zero1_dim(shard, 2) is not None else nbytes
        assert res["moment_bytes"] == want


def test_cli_tp2_v2_zero1_remat_dropout(tmp_path):
    """An epoch of pvlt_v2_tiny (configs/test_micro.py's widths) at
    --tp-size 2 on four gloo ranks (dp 2) with --zero1, --remat and
    dropout: the layout printed, finite losses, the VL eval, a checkpoint
    of the whole model."""
    micro = runpy.run_path(str(REPO / "configs" / "test_micro.py"))["cfg"]
    micro["model"] = "pvlt_v2_tiny"
    micro["model_overrides"] = {**micro["model_overrides"], "drop_rate": 0.1,
                                "attn_drop_rate": 0.1}
    path = tmp_path / "v2.json"
    path.write_text(json.dumps(micro))
    out = tmp_path / "run"
    stdout = torchrun(4, ["-m", "mvlt_tpu_torch.cli", "--config", str(path), "--synthetic-data",
                          "--device", "cpu", "--batch-size", "8", "--epochs", "1", "--tp-size",
                          "2", "--zero1", "--remat", "--output-dir", str(out)],
                      tmp_path / "torchrun.log")
    assert stdout.count("device: cpu; 4 ranks (gloo)") == 1
    assert "stage 2 (2 blocks): attention sharded, 1 of 2 heads a rank" in stdout
    with open(out / "train_log.jsonl") as f:
        (line,) = [json.loads(ln) for ln in f]
    assert all(np.isfinite(v) for v in line.values()) and "eval_mlm_acc" in line
    saved = torch.load(out / "checkpoint" / "last" / STATE_FILE, weights_only=True)
    assert saved["model"]["block1.0.mlp.dwconv.dwconv.weight"].shape == (16, 1, 3, 3)
    assert len(saved["generators"]) == 2
