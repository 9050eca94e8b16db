"""The port's tensor-parallel step, decode, checkpoint and CLI on gloo ranks
on the CPU.

The JAX package's contract (tests/test_train_step.py:120,
test_tp_matches_single_device) is that the step on a (data, model) mesh
equals the single-device step on the global batch. Here worker processes
(tests/_ddp_worker.py, case ``tp``) split the micro model of
tests/test_train_step.py (heads 1/2/2/4, vocabulary 64, DropPath and
dropout off, fp32; ITM + MLM + T2I) over tp = 2 ranks: stage 1's attention
stays replicated, the others split by whole heads, every MLP's hidden and
the vocabulary split. At tp = 2 (world 2) and at dp = 2 x tp = 2 (world 4)
the step at step 0 (clean images), at step 1 (masked images) and at step 0
with clip_grad is held to JAX's single-device step on the global batch of
8: the losses (the data ranks' mean), every consolidated gradient
(clipped) and the BatchNorm statistics at rtol 2e-4 / atol 2e-5, the
tolerance of that test; the consolidated parameters after AdamW to the
port's one-process step at the same tolerance. Every rank holds the same
consolidated tensors. A checkpoint written at tp = 2 restores in one
process with strict names. The split vocabulary's eval decode gives the
whole logits' nll and argmax, the lowest index winning ties within and
across the ranks' ranges. The CLI trains an epoch of configs/test_micro.py
under torchrun at --tp-size 2 (the vocabulary of 30,522 split into two odd
halves of 15,261), its VL eval equal to one process's on the checkpoint it
wrote, which resumes at tp = 1, and a CLS fine-tune epoch at --tp-size 2
starts from it. The same spawns take step 0 on the fused_attn_train route
in both forms (#6-#8's tensor-parallel modes) and with the MLM loss
through the logits (mlm_loss_chunk = 0), each held to JAX's single-device
step; the world-4 spawn runs under a two-node torchrun environment
(LOCAL_WORLD_SIZE 2), each model group inside a node. Every model option
passes the --tp-size gate, and the gradient through the split
vocabulary's decode equals one process's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu_torch import cli, config
from mvlt_tpu_torch.convert import state_dict_from_jax
from mvlt_tpu_torch.models.heads import MLMHead
from mvlt_tpu_torch.models.pvlt import create_model
from mvlt_tpu_torch.parallel import mesh
from mvlt_tpu_torch.parallel import tensor
from mvlt_tpu_torch.train.state import create_train_state
from mvlt_tpu_torch.train.step import make_train_step
from mvlt_tpu_torch.utils.checkpoint import STATE_FILE, CheckpointManager
from tests._thread_ranks import ThreadGroup, patched, run_ranks
from tests.test_torch_port_ddp import GLOBAL_B, setup, spawn, torchrun  # noqa: F401
from tests.test_torch_port_train import IMG, LOSS_KEYS, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

TOL = dict(rtol=2e-4, atol=2e-5)
CLIP = 0.05
STEPS = (("step0", 0, 0.0), ("step1", 1, 0.0), ("clip", 0, CLIP))
# step 0 on the other routes: config overrides
ROUTES = {"fused": {"fused_attn_train": True},
          "fused_stats": {"fused_attn_train": True, "fused_attn_stats": True},
          "mlm_logits": {"mlm_loss_chunk": 0}}


@pytest.fixture(scope="module")
def tp_runs(setup):
    """{world: {case: every rank's results}} of the ``tp`` case at world 2
    (tp 2) and world 4 (dp 2 x tp 2, two simulated nodes of two ranks), and
    of the decode case at tp 2."""
    root, runs = setup[7], {}
    for world in (2, 4):
        spec = {**setup[6], "tp": 2, "clip": CLIP, "ckpt_dir": str(root / f"tp{world}_run"),
                "routes": ROUTES, "cases": ["tp", "tp_decode"] if world == 2 else ["tp"]}
        runs[world] = spawn(spec, root / f"tp{world}", world=world, nodes=world // 2)
    return runs


@pytest.fixture(scope="module")
def jax_steps(setup):
    """{name: (gradients, losses, BatchNorm statistics)} of JAX's
    single-device step on the global batch for each of ``STEPS``."""
    from mvlt_tpu.train.losses import compute_losses

    jcfg, jmodel, params, stats, _, batch, _, _ = setup

    def loss_fn(p, images):
        out, new = jmodel.apply({"params": p, "batch_stats": stats}, images,
                                jnp.asarray(batch["input_ids"]), train=True,
                                mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        losses = compute_losses(out, batch, mlm_chunk=max(jcfg.mlm_loss_chunk, 1),
                                mlm_capacity_frac=jcfg.mlm_capacity_frac, mlm_ce_kernel=False)
        return losses["total_loss"], (losses, new["batch_stats"])

    grad_fn = jax.jit(jax.grad(loss_fn, has_aux=True))
    out = {}
    for name, step, clip in STEPS:
        images = batch["masked_images"] if step % 2 else batch["images"]
        g, (losses, st) = grad_fn(params, jnp.asarray(images))
        g = jax.tree_util.tree_map(np.asarray, g)
        if clip:   # optax.clip_by_global_norm, as the port's clip_by_global_norm
            norm = np.sqrt(sum(float(np.square(x.astype(np.float64)).sum())
                               for x in jax.tree_util.tree_leaves(g)))
            if norm >= clip:
                g = jax.tree_util.tree_map(lambda x: x / np.float32(norm) * np.float32(clip), g)
        out[name] = (state_dict_from_jax(g), {k: float(v) for k, v in losses.items()},
                     state_dict_from_jax({}, jax.device_get(st)))
    return out


def port_step(setup, step: int, clip: float, **overrides) -> dict:
    """The port's one-process step from the same weights on the global batch
    (``overrides`` on its config)."""
    import dataclasses

    cfg = dataclasses.replace(setup[4], **overrides)
    model = create_model(cfg, device="cpu", input_size=IMG)
    model.load_state_dict(torch.load(setup[7] / "weights.pt", weights_only=True), strict=True)
    state = create_train_state(model, config.OptimConfig(warmup_epochs=0, clip_grad=clip),
                               GLOBAL_B, 10)
    state.step = step
    state, losses = make_train_step(cfg)(state, setup[5])
    return {n: p.detach().clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name,step,clip", STEPS)
def test_tp_step_matches_jax_single_device(setup, tp_runs, jax_steps, world, name, step, clip,
                                           one_torch_thread):
    runs = [r[name] for r in tp_runs[world]["tp"]]
    for r in runs[1:]:                 # every rank holds the same whole tensors
        for key in ("grads", "params", "buffers"):
            for n, t in runs[0][key].items():
                assert torch.equal(t, r[key][n]), (key, n)
    layouts = [r["layout"] for r in tp_runs[world]["tp"]]
    assert [(x["data_rank"], x["model_rank"]) for x in layouts] == [
        (r // 2, r % 2) for r in range(world)]
    # a model group's ranks on one node; at world 4 the data groups span two
    assert [x["node"] for x in layouts] == [x["data_rank"] for x in layouts]
    assert {x["ranks_per_node"] for x in layouts} == {2}
    check_against_jax(setup, runs, jax_steps[name], step, clip)


def check_against_jax(setup, runs, jax_step, step: int, clip: float, **overrides) -> None:
    """Every rank's consolidated step against JAX's single-device step and
    the parameters against the port's one-process step, at TOL."""
    want_g, want_l, want_bn = jax_step
    data_ranks = runs[::2]             # one rank of each model group
    for k in LOSS_KEYS:
        got = float(np.mean([r["losses"][k] for r in data_ranks]))
        np.testing.assert_allclose(got, want_l[k], err_msg=k, **TOL)
    assert sorted(runs[0]["grads"]) == sorted(want_g)
    for n, w in want_g.items():
        np.testing.assert_allclose(runs[0]["grads"][n].numpy(), w.numpy(), err_msg=n, **TOL)
    for n, w in want_bn.items():
        np.testing.assert_allclose(runs[0]["buffers"][n].numpy(), w.numpy(), err_msg=n, **TOL)
    one = port_step(setup, step, clip, **overrides)
    for n, p in one.items():
        np.testing.assert_allclose(runs[0]["params"][n].numpy(), p.numpy(), err_msg=n, **TOL)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_tp_route_step_matches_jax_single_device(setup, tp_runs, jax_steps, world, route,
                                                 one_torch_thread):
    """Step 0 of the split model on the fused_attn_train route (both forms:
    #6-#8's tensor-parallel modes where the heads split) and through the
    MLM logits (the vocabulary-parallel cross entropy) against JAX's
    single-device step 0, which computes the same function: the losses,
    every consolidated gradient and BatchNorm statistic at TOL, the
    parameters after AdamW against the port's one-process step on the same
    route; every rank the same tensors."""
    runs = [r[route] for r in tp_runs[world]["tp"]]
    for r in runs[1:]:
        for key in ("grads", "params", "buffers"):
            for n, t in runs[0][key].items():
                assert torch.equal(t, r[key][n]), (key, n)
    check_against_jax(setup, runs, jax_steps["step0"], 0, 0.0, **ROUTES[route])


def test_tp_checkpoint_resumes_at_tp1(setup, tp_runs, one_torch_thread):
    """Rank 0 wrote the whole model with the reference's names and the whole
    AdamW moments; one process restores them strictly and holds the split
    run's consolidated parameters."""
    root = setup[7] / "tp2_run"
    saved = torch.load(root / "checkpoint" / "last" / STATE_FILE, weights_only=True)
    model = create_model(setup[4], device="cpu", input_size=IMG)
    state = create_train_state(model, config.OptimConfig(warmup_epochs=0), GLOBAL_B, 10)
    assert sorted(saved["model"]) == sorted(model.state_dict())
    assert all(saved["model"][n].shape == t.shape for n, t in model.state_dict().items())
    state, epoch = CheckpointManager(str(root)).restore(state, "last")
    assert (state.step, epoch) == (2, 1)
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), tp_runs[2]["tp"][0]["step1"]["params"][n]), n
        moments = state.optimizer.state[p]
        assert moments["exp_avg"].shape == p.shape and moments["exp_avg_sq"].shape == p.shape
    assert len(saved["generators"]) == 1


def test_split_vocabulary_decode(tp_runs):
    """nll and argmax of each rank's half equal the whole logits' (ties:
    the lowest index)."""
    for r in tp_runs[2]["tp_decode"]:
        logits, labels = r["logits"], r["labels"]
        want = -torch.log_softmax(logits, -1).gather(-1, labels.clamp(min=0)[..., None])[..., 0]
        want = torch.where(labels >= 0, want, 0.0)
        np.testing.assert_allclose(r["nll"].numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
        assert torch.equal(r["argmax"], logits.argmax(-1))
        assert r["argmax"][0, 0] == 3 and r["argmax"][1, 0] == 16 and r["argmax"][2, 0] == 0


def _torchrun(args, out):
    out.mkdir(parents=True, exist_ok=True)
    logs = sorted(out.glob("torchrun*.log"))
    return torchrun(2, ["-m", "mvlt_tpu_torch.cli", "--config", "configs/test_micro.py",
                        "--synthetic-data", "--device", "cpu", "--batch-size", "16",
                        "--output-dir", str(out)] + args, out / f"torchrun{len(logs)}.log")


def test_cli_tp2_then_resume_at_tp1(tmp_path, one_torch_thread):
    """An epoch at --tp-size 2 with its VL eval and checkpoint; the run
    resumes at tp = 1 in one process (``--eval --resume``: the whole train
    state restored strictly), whose VL eval equals the split model's; a CLS
    fine-tune epoch at --tp-size 2 starts from it (the weights merged
    whole, then split)."""
    out = tmp_path / "run"
    first = _torchrun(["--tp-size", "2", "--epochs", "1"], out)
    assert first.count("device: cpu; 2 ranks (gloo)") == 1
    assert "stage 1 (2 blocks): attention replicated (1 heads); MLP hidden sharded, 8 of 16 " \
           "a rank" in first
    assert "stage 4 (2 blocks): attention sharded, 2 of 4 heads a rank" in first
    assert "vocabulary: sharded, 15261 of 30522 rows a rank" in first
    with open(out / "train_log.jsonl") as f:
        (line,) = [json.loads(ln) for ln in f]
    saved = torch.load(out / "checkpoint" / "last" / STATE_FILE, weights_only=True)
    assert saved["model"]["text_embeddings.word_embeddings.weight"].shape == (30522, 32)
    base = ["--config", "configs/test_micro.py", "--synthetic-data", "--device", "cpu",
            "--batch-size", "16", "--output-dir", str(out)]
    one = cli.main(base + ["--eval", "--resume", "last"])
    for k, v in one.items():
        want = line[f"eval_{k}"]
        if k.endswith("acc") or k == "quality_score":
            assert round(v, 6) == want, k
        else:
            np.testing.assert_allclose(v, want, rtol=1e-5, atol=1e-6, err_msg=k)
    assert not mesh.initialized()
    # the CLS fine-tune of configs/test_micro_ft.py from it, split again
    ft = tmp_path / "ft"
    _torchrun(["--config", "configs/test_micro_ft.py", "--finetune", str(out), "--tp-size", "2",
               "--output-dir", str(ft)], ft)
    with open(ft / "train_log.jsonl") as f:
        (line,) = [json.loads(ln) for ln in f]
    assert np.isfinite(line["loss_sup_cls"]) and line["loss_sup_cls"] > 0
    assert "eval_sup_cls_acc" in line and line["loss_mlm"] == 0.0


REFUSED = [("--model", "pvlt_v2_tiny"), ("--model", "pvlt_v2_linear_tiny"),
           ("--model", "pvlt_swin_tiny"), ("--remat",), ("--zero1",), ("fused_attn_train",),
           ("drop_rate",), ("attn_drop_rate",), ("mlm_loss_chunk",)]
OVERRIDES = {"fused_attn_train": True, "mlm_loss_chunk": 0}


@pytest.mark.parametrize("combo", REFUSED, ids=lambda c: c[-1].lstrip("-"))
def test_tp_refusals(combo, tmp_path, monkeypatch):
    """Under torchrun, --tp-size 2 with each combination once refused (the
    v2, linear-SR v2 and Swin backbones, --remat, --zero1, dropout, and
    since the tensor-parallel modes of #6-#8 and the vocabulary-parallel
    cross entropy, fused_attn_train and mlm_loss_chunk <= 0) passes the
    gate, which refuses nothing, before any process group starts; the
    refusal list is gone from parallel/tensor.py."""
    for key, val in zip(mesh.ENV_KEYS, ("0", "2", "0", "127.0.0.1", "1")):
        monkeypatch.setenv(key, val)
    flags = [c for c in combo if c.startswith("-") or c.startswith("pvlt")]
    argv = ["--config", "configs/test_micro.py", "--synthetic-data", "--device", "cpu",
            "--tp-size", "2"] + flags
    if not flags:   # a model override, from a JSON config
        path = tmp_path / "cfg.json"
        path.write_text(json.dumps({"model": "pvlt_tiny", "model_overrides": {
            combo[0]: OVERRIDES.get(combo[0], 0.1)}}))
        argv[1] = str(path)
    args = cli.get_args_parser().parse_args(argv)
    cfg = cli.build_run_config(args)
    cli._check_flags(args, cfg)
    assert cfg.tp_size == 2
    assert not mesh.initialized()
    assert not hasattr(tensor, "refusals")


def test_split_decode_refuses_a_gradient(monkeypatch):
    """The MLM head's decode through the logits on a split vocabulary, once
    refused where a gradient is wanted, now trains: its input enters
    through copy_to_model and the loss is the vocabulary-parallel cross
    entropy. On two thread ranks (tests/_thread_ranks.py) the loss, the
    hidden rows' gradient, the transform's and each rank's table rows' and
    bias's gradients equal one process's F.cross_entropy(ignore_index=-1)
    of the whole logits, in fp64."""
    patched(monkeypatch)
    torch.manual_seed(4)
    head = MLMHead(vocab_size=8, hidden_size=16).double()
    with torch.no_grad():
        head.bias.normal_()
    x, table = torch.randn(2, 3, 16, dtype=torch.float64), torch.randn(8, 16, dtype=torch.float64)
    labels = torch.tensor([[1, -1, 6], [7, 0, -1]])
    xw, tw = x.clone().requires_grad_(), table.clone().requires_grad_()
    logits = head(xw, tw)
    loss = torch.nn.functional.cross_entropy(logits.reshape(-1, 8), labels.reshape(-1),
                                             ignore_index=-1)
    loss.backward()
    want = {"x": xw.grad, "table": tw.grad, **{n: p.grad.clone() for n, p in
                                              head.named_parameters()}}
    group = ThreadGroup(2)

    def rank(r):
        mine = MLMHead(vocab_size=4, hidden_size=16).double()
        sd = {n: (t[4 * r:4 * (r + 1)] if n == "bias" else t) for n, t in head.state_dict().items()}
        mine.load_state_dict(sd)
        xr, tr = x.clone().requires_grad_(), table[4 * r:4 * (r + 1)].clone().requires_grad_()
        shard = mine(xr, tr, vocab_group=group)
        loss_r = tensor.vocab_parallel_cross_entropy(shard.local, labels, shard.start, group)
        loss_r.backward()
        return loss_r.detach(), xr.grad, tr.grad, {n: p.grad for n, p in mine.named_parameters()}

    res = run_ranks(group, rank)
    tol = dict(rtol=1e-12, atol=1e-12)
    for r, (loss_r, dx, dtable, grads) in enumerate(res):
        torch.testing.assert_close(loss_r, loss.detach(), **tol)
        torch.testing.assert_close(dx, want["x"], **tol)
        torch.testing.assert_close(dtable, want["table"][4 * r:4 * (r + 1)], **tol)
        torch.testing.assert_close(grads["bias"], want["bias"][4 * r:4 * (r + 1)], **tol)
        for n, g in grads.items():
            if n != "bias":
                torch.testing.assert_close(g, want[n], **tol, msg=n)
