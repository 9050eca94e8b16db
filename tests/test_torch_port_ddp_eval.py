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
checkpoint. A partial torchrun environment raises. One more launch runs the
CLI four times on its two ranks: --steps-per-dispatch 2 equals k = 1 under
--zero1, alone and with --tp-size 2 on the fused_attn_train route.
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

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

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


@pytest.fixture(scope="module")
def zero1_run(tmp_path_factory):
    """One epoch on two ranks with --zero1: (its directory, the launch's
    output, its train_log.jsonl line, its checkpoint's step)."""
    out = tmp_path_factory.mktemp("zero1") / "run"
    first = _torchrun(["--zero1", "--epochs", "1"], out)
    with open(out / "train_log.jsonl") as f:
        (line,) = [json.loads(ln) for ln in f]
    return out, first, line, torch.load(out / "checkpoint" / "last" / STATE_FILE,
                                        weights_only=True)["step"]


def test_cli_two_ranks_zero1_then_resume(zero1_run):
    """One epoch with --zero1 (gloo, ZeRO-1, the sharded VL eval), then a
    second from its checkpoint without --zero1 and at --steps-per-dispatch
    2; rank 0 alone writes."""
    out, first, line, _ = zero1_run
    assert first.count("device: cpu; 2 ranks (gloo)") == 1 and first.count("eval:") == 1
    assert np.isfinite(line["total_loss"]) and "eval_quality_score" in line
    saved = torch.load(out / "checkpoint" / "last" / STATE_FILE, weights_only=True)
    steps = saved["step"]
    assert steps > 0 and len(saved["generators"]) == 2
    assert not [k for k in saved["model"] if k.startswith("module.")]
    assert not torch.equal(saved["generators"][0], saved["generators"][1])

    second = _torchrun(["--resume", "last", "--epochs", "2", "--steps-per-dispatch", "2"], out)
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


_DISPATCH_RUNS = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from mvlt_tpu_torch import cli
from mvlt_tpu_torch.parallel import mesh
try:
    for argv in json.loads(open(sys.argv[2]).read()):
        cli.main(argv)
finally:
    mesh.destroy()
"""


@pytest.fixture(scope="module")
def dispatch_runs(tmp_path_factory, zero1_run):
    """One torchrun launch of two gloo ranks running the CLI three times in
    its process group, one epoch each with --zero1: at k = 2 on
    configs/test_micro.py (``zero1_run`` is its k = 1), then at --tp-size 2
    on the fused_attn_train route at k = 1 and 2. Returns ({(tp, k): (the
    epoch's log line, the checkpoint's step)}, the launch's output)."""
    tmp = tmp_path_factory.mktemp("dispatch")
    micro = runpy.run_path("configs/test_micro.py")["cfg"]
    micro["model_overrides"] = {**micro["model_overrides"], "fused_attn_train": True}
    fused = tmp / "fused.json"
    fused.write_text(json.dumps(micro))
    runs, argvs = {(1, 1): zero1_run[0]}, []
    for tp, k, config_path in ((1, 2, "configs/test_micro.py"), (2, 1, str(fused)),
                               (2, 2, str(fused))):
        runs[(tp, k)] = tmp / f"tp{tp}_k{k}"
        argvs.append(["--config", config_path, "--synthetic-data", "--device", "cpu",
                      "--batch-size", "16", "--epochs", "1", "--zero1", "--output-dir",
                      str(runs[(tp, k)]), "--tp-size", str(tp), "--steps-per-dispatch", str(k)])
    (tmp / "runs.json").write_text(json.dumps(argvs))
    (tmp / "runs.py").write_text(_DISPATCH_RUNS)
    text = torchrun(2, [str(tmp / "runs.py"), str(pathlib.Path(__file__).resolve().parents[1]),
                        str(tmp / "runs.json")], tmp / "torchrun.log")
    logs = {(1, 1): (zero1_run[2], zero1_run[3])}
    for key, out in runs.items():
        if key != (1, 1):
            with open(out / "train_log.jsonl") as f:
                (line,) = [json.loads(ln) for ln in f]
            logs[key] = (line, torch.load(out / "checkpoint" / "last" / STATE_FILE,
                                          weights_only=True)["step"])
    return logs, text


@pytest.mark.parametrize("flags", [["--tp-size", "2", "--steps-per-dispatch", "2"],
                                   ["--steps-per-dispatch", "2"]])
def test_unported_flags_raise_under_torchrun(flags, dispatch_runs):
    """--steps-per-dispatch 2 (once refused, hence the name) trains under
    torchrun with --zero1, alone and with --tp-size 2 on the fused_attn_train
    route: the epoch's losses and VL eval equal the k = 1 epoch's on the same
    ranks (the LR, logged once a call, averages other steps) and the
    checkpoint holds as many steps."""
    logs, text = dispatch_runs
    tp = 2 if "--tp-size" in flags else 1
    (once, steps1), (twice, steps2) = logs[(tp, 1)], logs[(tp, 2)]
    assert steps1 == steps2 > 0 and steps2 % 2 == 0
    assert "eval_quality_score" in once
    drop = ("time", "lr")
    assert {k: v for k, v in twice.items() if k not in drop} == \
        {k: v for k, v in once.items() if k not in drop}
    assert text.count("device: cpu; 2 ranks (gloo)") == 3
