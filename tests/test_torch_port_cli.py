"""The port's command line (mvlt_tpu_torch/cli.py) on the CPU: the micro
pre-training config on synthetic data for 2 epochs (12 steps each at
B = 16), then ``--resume``, the CLS fine-tune init from its checkpoint,
``--eval``, the step options, ``--remat``, ``--steps-per-dispatch 2`` against
k = 1, and ``--tp-size`` without ranks; the
checkpoint manager's policy; and the run config built from the same flags
equal to the JAX package's."""

import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

from mvlt_tpu_torch import cli
from mvlt_tpu_torch.config import config_to_dict, load_config_file
from mvlt_tpu_torch.models import pvlt
from mvlt_tpu_torch.models.pvlt import create_model
from mvlt_tpu_torch.train.state import create_train_state
from mvlt_tpu_torch.utils.checkpoint import (STATE_FILE, CheckpointManager, load_finetune_state,
                                             resolve_checkpoint_path)
from tests.test_torch_port_train import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

BASE = ["--config", "configs/test_micro.py", "--synthetic-data", "--device", "cpu",
        "--batch-size", "16"]
# the keys of mvlt_tpu/cli.py's train_log.jsonl: the epoch, its time, the
# step's losses and the LR (train/engine.py), and in the last third of the
# epochs the VL eval's statistics under eval_
TRAIN_KEYS = {"epoch", "time", "loss_mlm", "loss_itm", "loss_sup_cls", "loss_sub_cls",
              "loss_t2i", "total_loss", "lr"}
EVAL_KEYS = {"eval_mlm_acc", "eval_itm_acc", "eval_total_loss", "eval_t2i_psnr",
             "eval_quality_score"}


def _log(run):
    with open(os.path.join(run, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _saved(run, tag="last"):
    return torch.load(os.path.join(run, "checkpoint", tag, STATE_FILE), weights_only=True)


def _assert_tensors_equal(got, want, where=""):
    """Two nested dicts / lists of tensors and numbers, equal in bits."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _assert_tensors_equal(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tensors_equal(g, w, f"{where}/{i}")
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got, want), where
    else:
        assert got == want, where


@pytest.fixture(scope="module")
def pretrain_run(tmp_path_factory):
    run = str(tmp_path_factory.mktemp("cli") / "pretrain")
    assert cli.main(BASE + ["--output-dir", run]) is None
    return run


def test_two_epochs_log_checkpoint_and_eval(pretrain_run):
    lines = _log(pretrain_run)
    assert [line["epoch"] for line in lines] == [0, 1]
    assert set(lines[0]) == TRAIN_KEYS
    assert set(lines[1]) == TRAIN_KEYS | EVAL_KEYS      # eval from epoch int(2 * 2/3) = 1
    assert all(np.isfinite(v) for line in lines for v in line.values())
    for tag in ("last", "best"):
        with open(os.path.join(pretrain_run, "checkpoint", tag + ".json")) as f:
            meta = json.load(f)
        assert meta["epoch"] == 1 and meta["score"] == lines[1]["eval_quality_score"]
        assert meta["config"]["optim"]["batch_size"] == 16
    assert _saved(pretrain_run)["step"] == 24
    assert resolve_checkpoint_path(pretrain_run).endswith(os.path.join("checkpoint", "best"))


def test_resume_continues_at_the_next_epoch(pretrain_run, tmp_path):
    """A state restored from ``last`` holds the saved weights, AdamW state
    and step; the resumed run trains epoch 2 only."""
    saved = _saved(pretrain_run)
    cfg = load_config_file("configs/test_micro.py")
    model = create_model(cfg.model, device="cpu")
    state = create_train_state(model, cfg.optim, 16, 12)
    state, epoch = CheckpointManager(pretrain_run).restore(state, "last")
    assert epoch == 2 and state.step == 24
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
    assert state.optimizer.state_dict()["state"][0]["step"] == saved["optimizer"]["state"][0]["step"]

    run = str(tmp_path / "resumed")
    cli.main(BASE + ["--output-dir", run, "--epochs", "3", "--resume",
                     os.path.join(pretrain_run, "checkpoint", "last")])
    assert [line["epoch"] for line in _log(run)] == [2]
    assert _saved(run)["step"] == 36


def test_finetune_init_loads_the_backbone_and_drops_pretraining_heads(pretrain_run, tmp_path):
    saved = _saved(pretrain_run)["model"]
    cfg = load_config_file("configs/test_micro_ft.py")
    model = create_model(cfg.model, device="cpu")
    report = load_finetune_state(pretrain_run, model)
    heads = ("sup_cls_head", "sub_cls_head")
    assert sorted(report["loaded"]) == sorted(k for k in model.state_dict()
                                              if not k.startswith(heads))
    assert report["skipped_shape"] == []
    assert {k.split(".")[0] for k in report["dropped"]} == {
        "mlm_head_embed", "mlm_head", "itm_head_embed", "itm_head", "t2i_head"}
    for k in report["loaded"]:
        assert torch.equal(model.state_dict()[k], saved[k]), k

    run = str(tmp_path / "finetune")
    cli.main(["--config", "configs/test_micro_ft.py", "--synthetic-data", "--device", "cpu",
              "--batch-size", "16", "--output-dir", run, "--finetune", pretrain_run])
    (line,) = _log(run)
    assert np.isfinite(line["total_loss"]) and line["loss_sup_cls"] > 0
    assert line["loss_mlm"] == 0.0 and line["eval_sup_cls_acc"] >= 0.0


def test_eval_only_returns_the_statistics(pretrain_run):
    stats = cli.main(BASE + ["--output-dir", pretrain_run, "--resume", "last", "--eval"])
    assert {"mlm_acc", "itm_acc", "t2i_psnr", "total_loss", "quality_score"} == set(stats)


def test_step_options_through_the_cli(tmp_path):
    """--grad-accum, --device-masks and --clip-grad train one finite epoch."""
    run = str(tmp_path / "opts")
    cli.main(BASE + ["--output-dir", run, "--epochs", "1", "--grad-accum", "2",
                     "--device-masks", "--clip-grad", "1.0"])
    (line,) = _log(run)
    assert np.isfinite(line["total_loss"])
    with open(os.path.join(run, "checkpoint", "last.json")) as f:
        assert json.load(f)["config"]["optim"]["clip_grad"] == 1.0
    with pytest.raises(ValueError, match="grad-accum"):
        cli.main(BASE + ["--output-dir", run, "--grad-accum", "3"])


def test_fused_attention_route_from_a_json_config(tmp_path):
    """A JSON config whose model_overrides set fused_attn_train and
    fused_attn_stats trains one finite epoch on the fused route: its
    saved-statistics backward once per block and step, the default route's
    attention core never."""
    import runpy
    from mvlt_tpu_torch.ops import block_attention, pallas_attention

    flat = runpy.run_path("configs/test_micro.py")["cfg"]
    flat["model_overrides"] = {**flat["model_overrides"], "fused_attn_train": True,
                               "fused_attn_stats": True}
    path = tmp_path / "fused.json"
    path.write_text(json.dumps(flat))
    run = str(tmp_path / "fused")
    with mock.patch.object(block_attention, "block_attention_bwd_reference",
                           wraps=block_attention.block_attention_bwd_reference) as fused_bwd, \
            mock.patch.object(pallas_attention, "attention_stats_bwd_reference",
                              wraps=pallas_attention.attention_stats_bwd_reference) as default_bwd:
        cli.main(["--config", str(path), "--synthetic-data", "--device", "cpu",
                  "--batch-size", "16", "--epochs", "1", "--output-dir", run])
    (line,) = _log(run)
    assert np.isfinite(line["total_loss"])
    steps = _saved(run)["step"]
    assert fused_bwd.call_count == 8 * steps and default_bwd.call_count == 0
    assert all(c.kwargs["stats"] is not None for c in fused_bwd.call_args_list)
    with open(os.path.join(run, "checkpoint", "last.json")) as f:
        model = json.load(f)["config"]["model"]
    assert model["fused_attn_train"] and model["fused_attn_stats"]


@pytest.mark.parametrize("flags", [["--zero1"], ["--tp-size", "2"],
                                   ["--steps-per-dispatch", "2"], ["--remat"]])
def test_unported_flags_raise(flags, tmp_path, request):
    """--steps-per-dispatch 2 is ported: two epochs log every step's losses,
    their averages and the VL eval equal to the k = 1 run's (the LR, logged
    once a call with its last step's value, averages other steps), and save
    step 24; --tp-size 2 is ported under
    torchrun (tests/test_torch_port_tp.py) and in one process raises, as it
    has no ranks to split the model over; --remat is
    ported: one epoch runs every block under torch.utils.checkpoint and
    saves the flag in the checkpoint's config; --zero1 is ported: in one
    process it has nothing to partition, and an epoch trains with AdamW's
    own state (the two-rank run is tests/test_torch_port_ddp_eval.py's)."""
    if flags == ["--zero1"]:
        run = str(tmp_path / "zero1")
        cli.main(BASE + flags + ["--epochs", "1", "--batch-size", "48", "--output-dir", run])
        (line,) = _log(run)
        assert np.isfinite(line["total_loss"])
        saved = _saved(run)
        assert saved["step"] > 0 and saved["optimizer"]["state"]
        return
    if flags == ["--tp-size", "2"]:
        with pytest.raises(ValueError, match="torch.distributed.run"):
            cli.main(BASE + flags)
        return
    if flags == ["--steps-per-dispatch", "2"]:
        want = _log(request.getfixturevalue("pretrain_run"))
        run = str(tmp_path / "dispatch2")
        cli.main(BASE + flags + ["--output-dir", run])
        got = _log(run)
        assert [line["epoch"] for line in got] == [0, 1]
        for g, w in zip(got, want):
            assert set(g) == set(w)
            assert {k: v for k, v in g.items() if k not in ("time", "lr")} == \
                {k: v for k, v in w.items() if k not in ("time", "lr")}
        # the checkpoint equals the k = 1 run's in bits, so it resumes at any k
        saved, want = _saved(run), _saved(request.getfixturevalue("pretrain_run"))
        assert saved["step"] == want["step"] == 24
        _assert_tensors_equal(saved, want)
        return
    run = str(tmp_path / "remat")
    with mock.patch.object(pvlt, "checkpoint", wraps=pvlt.checkpoint) as ckpt:
        cli.main(BASE + flags + ["--epochs", "1", "--batch-size", "48", "--output-dir", run])
    (line,) = _log(run)
    assert np.isfinite(line["total_loss"])
    assert ckpt.call_count == 8 * _saved(run)["step"] > 0
    with open(os.path.join(run, "checkpoint", "last.json")) as f:
        assert json.load(f)["config"]["model"]["remat"]


def test_resume_of_a_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        cli.main(BASE + ["--output-dir", str(tmp_path), "--resume", "last"])


def test_run_config_matches_jax():
    """The same flags give the same RunConfig on both sides (config-file
    keys win over flags)."""
    from mvlt_tpu import cli as jax_cli

    argv = ["--config", "configs/test_micro.py", "--model", "pvlt_small", "--lr", "3e-4",
            "--clip-grad", "0.5", "--mask-ratio", "0.3", "--no-repeated-aug", "--fp32",
            "--synthetic-data", "--batch-size", "8", "--seed", "3"]
    ours = cli.build_run_config(cli.get_args_parser().parse_args(argv))
    theirs = jax_cli.build_run_config(jax_cli.get_args_parser().parse_args(argv))
    assert config_to_dict(ours) == config_to_dict(theirs)
    port_flags = {a.dest for a in cli.get_args_parser()._actions} - {"device"}
    assert port_flags == {a.dest for a in jax_cli.get_args_parser()._actions}


def test_two_phase_checkpoint_policy(tmp_path):
    """Every epoch in the first 2/3, then best only on a higher score, and
    last on every epoch (mvlt_tpu/utils/checkpoint.py:save_epoch)."""
    cfg = load_config_file("configs/test_micro.py")
    state = create_train_state(create_model(cfg.model, device="cpu"), cfg.optim, 4, 1)
    ckpt = CheckpointManager(str(tmp_path), cfg)

    def meta(tag):
        with open(os.path.join(ckpt.root, tag + ".json")) as f:
            return json.load(f)

    saved = [ckpt.save_epoch(state, e, 6, s) for e, s in
             [(0, None), (3, None), (4, 1.0), (5, 0.5)]]
    assert saved == [True, True, True, False]
    assert meta("best") == {**meta("best"), "epoch": 4, "score": 1.0}
    assert meta("last")["epoch"] == 5
    assert CheckpointManager(str(tmp_path)).best_score == 1.0
