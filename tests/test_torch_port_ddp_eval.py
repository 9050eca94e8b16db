"""The port's evals and CLI on two gloo ranks on the CPU.

Two worker processes (tests/_ddp_worker.py) score their shards of the VL
eval (each batch's rows split over the ranks; 11 samples in batches of 8
and 3, the 3 padded to 4), of the retrieval protocol (3 bundles of 101
pairs: rank 1 holds one and a padded slot) and of recognition (10 items at
batch 4, ragged within each rank's shard). The retrieval and recognition
metrics equal the one-process ones exactly, on both ranks, and rank 0's
recognition artifact equals the one-process one. The VL eval's counts and
accuracies are exact too; its loss and PSNR, taken from per-row values of
forwards at half the batch, agree to 1e-6 (the CPU's convolutions round a
row differently at another batch size, by about 1e-8), and equal exactly
one process that scores the same halves of each batch itself. The CLI
trains one epoch of configs/test_micro.py on two CPU ranks under torchrun
with --zero1 (ZeRO-1, the sharded VL eval, a checkpoint), then resumes it
for a second epoch without --zero1: only rank 0 writes the log and the
checkpoint. A partial torchrun environment raises, and --steps-per-dispatch
2 stays refused under torchrun, alone and with --tp-size 2 and --zero1 on
the fused_attn_train route, which the refusal no longer names.
"""

import json
import os
import pathlib
import runpy
import types

import numpy as np
import pytest
import torch

from mvlt_tpu_torch import cli, config
from mvlt_tpu_torch.eval.recognition import evaluate_recognition, make_cls_scorer
from mvlt_tpu_torch.eval.retrieval import evaluate_retrieval, make_itm_scorer
from mvlt_tpu_torch.eval.vl_eval import evaluate_vl, make_vl_eval_fn, pad_eval_batch
from mvlt_tpu_torch.models.pvlt import create_model
from mvlt_tpu_torch.parallel import mesh
from mvlt_tpu_torch.utils.checkpoint import STATE_FILE
from tests.test_torch_port_ddp import spawn, torchrun
from tests.test_torch_port_train import IMG, MICRO, T, one_torch_thread

ALL_HEADS = dict(itm=True, mlm=True, t2i=True, cls=True)
REC_BATCH = 4


def _vl_batch(rng, b):
    imgs = rng.random((b, IMG, IMG, 3)).astype(np.float32)
    ids = rng.integers(0, 64, (b, T)).astype(np.int32)

    def noise(rate, other):   # each token replaced by a random one with ``rate``
        return np.where(rng.random((b, T)) < rate, rng.integers(0, 64, (b, T)),
                        other).astype(np.int32)

    return {
        "images": imgs,
        "masked_images": np.where(rng.random((b, IMG, IMG, 1)) < 0.5, 1e-6,
                                  imgs).astype(np.float32),
        "input_ids": ids,
        "ori_input_ids": noise(0.2, ids),
        "mlm_labels": noise(0.3, -1),
        "itm_labels": rng.integers(0, 2, (b,)).astype(np.int32),
        "sup_cls_labels": rng.integers(0, 48, (b,)).astype(np.int32),
        "sub_cls_labels": rng.integers(0, 122, (b,)).astype(np.int32),
    }


def eval_data():
    rng = np.random.default_rng(11)
    bundles = [{"images_101": rng.integers(0, 256, (101, IMG, IMG, 3), dtype=np.uint8),
                "ori_input_ids_101": rng.integers(0, 64, (101, T)).astype(np.int32)}
               for _ in range(3)]
    items = [{"images": rng.integers(0, 256, (IMG, IMG, 3), dtype=np.uint8),
              "ori_input_ids": rng.integers(0, 64, (T,)).astype(np.int32),
              "sup_cls_labels": np.int32(rng.integers(0, 48)),
              "sub_cls_labels": np.int32(rng.integers(0, 122)),
              "info_list": f"item{i:02d}.png"} for i in range(10)]
    return {"vl_batches": [_vl_batch(rng, 8), _vl_batch(rng, 3)], "bundles": bundles,
            "items": items, "rec_batch": REC_BATCH}


@pytest.fixture(scope="module")
def eval_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp_eval")
    cfg = config.ModelConfig(**MICRO, loss_type=config.LossType(**ALL_HEADS))
    torch.manual_seed(5)
    model = create_model(cfg, device="cpu", input_size=IMG)
    torch.save(model.state_dict(), root / "weights.pt")
    data = eval_data()
    torch.save(data, root / "eval.pt")
    spec = {"micro": MICRO, "heads": ALL_HEADS, "img": IMG, "weights": str(root / "weights.pt"),
            "eval_data": str(root / "eval.pt"), "cases": ["eval"]}
    return model.eval(), cfg, data, spawn(spec, root / "out")["eval"], root / "out"


def test_sharded_evals_equal_one_process(eval_runs, tmp_path, one_torch_thread):
    model, cfg, data, runs, out = eval_runs
    vl = evaluate_vl(make_vl_eval_fn(model, cfg), data["vl_batches"], is_main=False)
    retrieval = evaluate_retrieval(make_itm_scorer(model), cli._simple_loader(data["bundles"], 1),
                                   is_main=False)
    recognition = evaluate_recognition(
        make_cls_scorer(model), cli._simple_loader(data["items"], REC_BATCH),
        num_super=cfg.num_super_classes, num_sub=cfg.num_sub_classes,
        artifact_dir=str(tmp_path), is_main=True)
    fn = make_vl_eval_fn(model, cfg)

    def halves(feed):   # one process scoring each rank's half of the padded batch
        n = feed["valid"].shape[0]
        feed = pad_eval_batch({k: v for k, v in feed.items() if k != "valid"}, 2)
        s = feed["valid"].shape[0] // 2
        rows = [fn.rows({k: v[i * s:(i + 1) * s] for k, v in feed.items()}) for i in range(2)]
        return {k: torch.cat([r[k] for r in rows])[:n] for k in rows[0]}

    vl_halves = evaluate_vl(types.SimpleNamespace(rows=halves), data["vl_batches"],
                            is_main=False)
    assert retrieval["num_queries"] == 3 and vl["itm_acc"] > 0
    for r in runs:
        assert r["vl"] == vl_halves
        for k, v in vl.items():
            if k in ("total_loss", "t2i_psnr"):
                assert abs(r["vl"][k] - v) <= 1e-6 * abs(v), k
            else:
                assert r["vl"][k] == v, k
        assert r["retrieval"] == retrieval
        assert r["recognition"] == recognition
    want, got = [json.loads((d / "recognition_predictions.json").read_text())
                 for d in (tmp_path, out)]
    assert got == want and got["names"][9] == "item09.png"


def _torchrun(args, out):
    out.mkdir(parents=True, exist_ok=True)
    logs = sorted(out.glob("torchrun*.log"))
    return torchrun(2, ["-m", "mvlt_tpu_torch.cli", "--config", "configs/test_micro.py",
                        "--synthetic-data", "--device", "cpu", "--batch-size", "16",
                        "--output-dir", str(out)] + args, out / f"torchrun{len(logs)}.log")


def test_cli_two_ranks_zero1_then_resume(tmp_path):
    """One epoch with --zero1 (gloo, ZeRO-1, the sharded VL eval), then a
    second from its checkpoint without --zero1; rank 0 alone writes."""
    out = tmp_path / "run"
    first = _torchrun(["--zero1", "--epochs", "1"], out)
    assert first.count("device: cpu; 2 ranks (gloo)") == 1 and first.count("eval:") == 1
    with open(out / "train_log.jsonl") as f:
        (line,) = [json.loads(ln) for ln in f]
    assert np.isfinite(line["total_loss"]) and "eval_quality_score" in line
    saved = torch.load(out / "checkpoint" / "last" / STATE_FILE, weights_only=True)
    steps = saved["step"]
    assert steps > 0 and len(saved["generators"]) == 2
    assert not [k for k in saved["model"] if k.startswith("module.")]
    assert not torch.equal(saved["generators"][0], saved["generators"][1])

    second = _torchrun(["--resume", "last", "--epochs", "2"], out)
    assert second.count(f"resumed at epoch 1 (step {steps})") == 1
    with open(out / "train_log.jsonl") as f:
        assert [json.loads(ln)["epoch"] for ln in f] == [0, 1]
    assert torch.load(out / "checkpoint" / "last" / STATE_FILE,
                      weights_only=True)["step"] == 2 * steps
    assert set(os.listdir(out / "checkpoint")) <= {"last", "last.json", "best", "best.json"}


def test_partial_torchrun_environment_raises(monkeypatch):
    for key in mesh.ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    assert mesh.maybe_init_distributed("cpu") is None and mesh.world_size() == 1
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="LOCAL_RANK, MASTER_ADDR, MASTER_PORT missing"):
        mesh.maybe_init_distributed("cpu")
    with pytest.raises(RuntimeError, match="partial torchrun environment"):
        cli.main(["--config", "configs/test_micro.py", "--synthetic-data", "--device", "cpu"])
    assert not mesh.initialized()


@pytest.mark.parametrize("flags", [["--tp-size", "2", "--steps-per-dispatch", "2"],
                                   ["--steps-per-dispatch", "2"]])
def test_unported_flags_raise_under_torchrun(flags, monkeypatch, tmp_path):
    """What is still refused raises before any process group starts:
    --steps-per-dispatch above 1, named alone, also with --tp-size 2 and
    --zero1 on the fused_attn_train route (both covered now)."""
    for key, val in zip(mesh.ENV_KEYS, ("0", "2", "0", "127.0.0.1", "1")):
        monkeypatch.setenv(key, val)
    config = "configs/test_micro.py"
    if "--tp-size" in flags:
        micro = runpy.run_path(config)["cfg"]
        micro["model_overrides"] = {**micro["model_overrides"], "fused_attn_train": True}
        config = str(tmp_path / "fused.json")
        pathlib.Path(config).write_text(json.dumps(micro))
    with pytest.raises(NotImplementedError, match="not ported") as refused:
        cli.main(["--config", config, "--synthetic-data", "--device", "cpu", "--zero1"] + flags)
    assert str(refused.value) == ("not ported to mvlt_tpu_torch yet: --steps-per-dispatch "
                                  "above 1")
    assert not mesh.initialized()
