"""The port's downstream eval entry points against the JAX package's, on
the CPU, on a small Fashion-Gen tree made here with PIL and the micro
config (fp32).

The weights: a JAX micro model with every head, its variables shaped by
``jax.eval_shape`` and filled from numpy by parameter path, exported with
``export_state_dict`` to a reference-style ``.pth``. The port's command line
(``--device cpu --resume w.pth``) runs ``--eval-retrieval-itr`` and
``-tir`` (ITM head only, and every pre-training head with
``--parity-heads``) and ``--eval-recognition``; the JAX side runs its
readers, ``make_itm_scorer`` / ``make_cls_scorer`` and ``evaluate_*`` on the
same weights. Scores and logits agree within 2e-4; ranks and argmaxes are
equal wherever the deciding margin of the JAX side exceeds 4e-4 (the
test counts those it skips); acc@k, accuracy, F1 and the recognition
artifact are equal. ``--viz`` writes the JAX ``visualize_vl``'s PNGs byte for
byte, ``--profile-dir`` writes a trace of a pre-training epoch on the tree,
and the parity harness skips without its files and passes on a synthetic
``.pth``. The port's metrics equal the JAX ones."""

import argparse
import json
import os
import pickle
import zlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mvlt_tpu import cli as jax_cli
from mvlt_tpu.config import apply_overrides as jax_apply_overrides
from mvlt_tpu.convert.torch_to_jax import export_state_dict
from mvlt_tpu.data import fashion_gen as jax_fg
from mvlt_tpu.data.pipeline import collate as jax_collate
from mvlt_tpu.eval import metrics as jax_metrics
from mvlt_tpu.eval import recognition as jax_recognition
from mvlt_tpu.eval import retrieval as jax_retrieval
from mvlt_tpu.eval.visualize import visualize_vl as jax_visualize_vl
from mvlt_tpu.models import create_model as jax_create_model
from mvlt_tpu_torch import cli
from mvlt_tpu_torch.config import apply_overrides, load_config_file
from mvlt_tpu_torch.eval import metrics, parity, recognition, retrieval
from tests.test_torch_port_train import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

CONFIG = "configs/test_micro.py"
TOL = 2e-4
MARGIN = 4e-4
HEAD_PREFIXES = {"mlm": "mlm_head", "itm": "itm_head", "cls": ("sup_cls_head", "sub_cls_head"),
                 "t2i": "t2i_head"}
VALID = 10
ITM_ONLY = {"itm": 1, "mlm": 0, "t2i": 0, "cls": 0}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("fg")
    rng = np.random.default_rng(0)
    for split, n in (("train", 6), ("valid", VALID)):
        (root / f"extracted_{split}_images").mkdir()
        (root / f"full_{split}_info_PAI").mkdir()
        for i in range(n):
            name = f"prod{i:04d}_img.png"
            arr = np.full((40, 44, 3), 255, np.uint8)
            arr[6:34, 5 + i % 4:38] = rng.integers(0, 220, (28, 33 - i % 4, 3), np.uint8)
            Image.fromarray(arr).save(root / f"extracted_{split}_images" / name)
            # labels among the classes the fixture's weights predict, so that
            # accuracy and F1 are not all 0
            info = {"product_id": i, "img_name": name,
                    "super_cls_id": int(rng.choice([23, 5, 17])),
                    "sub_cls_id": int(rng.choice([113, 89, 3])),
                    "captions": f"item {i} wool coat with {['buttons', 'a belt'][i % 2]}"}
            with open(root / f"full_{split}_info_PAI" / f"prod{i:04d}_info.pkl", "wb") as f:
                pickle.dump(info, f)
    for step, direction in ((1, "ITR"), (3, "TIR")):
        d = root / f"retrieve_{direction}"
        d.mkdir()
        for q in range(3):
            bundle = {c: {"img_name": f"prod{(q + step * c) % VALID:04d}_img.png",
                          "captions": f"item {(q + 2 * c) % VALID} wool coat"}
                      for c in range(5)}
            with open(d / f"q{q:04d}.pkl", "wb") as f:
                pickle.dump(bundle, f)
    return str(root)


def _fill(path, leaf):
    """A leaf filled from a numpy stream seeded by its path, so that every
    head configuration of the model gets the same values for what it
    shares: matrices of std 1/sqrt(fan_in), LayerNorm and BatchNorm scales
    and running variances near 1."""
    name = jax.tree_util.keystr(path)
    gen = np.random.default_rng(zlib.crc32(name.encode()))
    base = 1.0 if ("scale" in name or "'var'" in name) else 0.0
    std = 0.1 if leaf.ndim == 1 else 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
    return (base + std * gen.standard_normal(leaf.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def weights(tree, tmp_path_factory):
    """(the JAX run config, variables of the every-head micro model, the
    path of its exported .pth)."""
    jcfg = jax_cli.build_run_config(jax_cli.get_args_parser().parse_args(
        ["--config", CONFIG, "--data-path", tree]))
    every = jax_apply_overrides(jcfg, {"loss_type": {"itm": 1, "mlm": 1, "t2i": 1, "cls": 1}})
    shapes = jax.eval_shape(jax_create_model(every.model).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 16), jnp.int32))
    variables = jax.tree_util.tree_map_with_path(_fill, shapes)
    sd = export_state_dict(variables["params"], variables["batch_stats"])
    pth = tmp_path_factory.mktemp("w") / "w.pth"
    # a reference checkpoint also pickles its argparse namespace
    torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                "args": argparse.Namespace(model="pvlt_tiny"), "epoch": 0}, str(pth))
    return jcfg, variables, str(pth)


def _jax_model(jcfg, variables, loss_type):
    """The JAX model of ``loss_type``'s heads and its subset of
    ``variables``."""
    cfg = jax_apply_overrides(jcfg, {"loss_type": loss_type})
    lt = cfg.model.loss_type
    drop = tuple(p for head, prefixes in HEAD_PREFIXES.items() if not getattr(lt, head)
                 for p in ((prefixes,) if isinstance(prefixes, str) else prefixes))
    sub = {col: {k: v for k, v in tree.items() if not k.startswith(drop)}
           for col, tree in variables.items()}
    return cfg, jax_create_model(cfg.model), {k: v for k, v in sub.items() if v}


def _recording(module, name):
    """A patch of ``module.name`` that records (arguments, result) of each
    call, and the list it records into."""
    fn, seen = getattr(module, name), []

    def record(*args):
        out = fn(*args)
        seen.append((args, out))
        return out

    return mock.patch.object(module, name, record), seen


def _heads(model) -> dict:
    return {k: bool(v) for k, v in model.cfg.loss_type.to_dict().items()}


def _port(tree, *flags):
    return ["--config", CONFIG, "--device", "cpu", "--data-path", tree, *flags]


def _ranks_agree(got: np.ndarray, want: np.ndarray) -> int:
    """Asserts the ground truth's rank is equal per query wherever the JAX
    scores' margin between candidate 0 and every other exceeds MARGIN;
    returns the number of queries skipped."""
    skipped = 0
    for g, w in zip(got, want):
        if np.abs(w[1:] - w[0]).min() <= MARGIN:
            skipped += 1
            continue
        assert retrieval.rank_of_ground_truth(g) == jax_retrieval.rank_of_ground_truth(w)
    return skipped


@pytest.mark.parametrize("direction", ["itr", "tir"])
@pytest.mark.parametrize("parity_heads", [False, True])
def test_retrieval_cli_matches_jax(tree, weights, direction, parity_heads, capsys):
    jcfg, variables, pth = weights
    flags = [f"--eval-retrieval-{direction}", "--resume", pth] + ["--parity-heads"] * parity_heads
    patch, seen = _recording(retrieval, "_score")
    with patch:
        got = cli.main(_port(tree, *flags))
    assert f"retrieval {direction.upper()}: acc@1" in capsys.readouterr().out
    heads = jcfg.model.loss_type.to_dict() if parity_heads else ITM_ONLY
    cfg, jmodel, jvars = _jax_model(jcfg, variables, heads)
    assert _heads(seen[0][0][0]) == {k: bool(v) for k, v in cfg.model.loss_type.to_dict().items()}
    scorer = jax_retrieval.make_itm_scorer(jmodel, jvars)
    want_scores = []
    want = jax_retrieval.evaluate_retrieval(
        lambda i, t: want_scores.append(np.asarray(scorer(i, t))) or want_scores[-1],
        (jax_fg.FashionGenRetrieval(tree, cfg.data, direction)[q] for q in range(3)),
        is_main=False)
    got_scores = np.stack([scores.numpy() for _, scores in seen])
    want_scores = np.stack(want_scores)
    np.testing.assert_allclose(got_scores, want_scores, rtol=0, atol=TOL)
    assert _ranks_agree(got_scores, want_scores) <= 1
    assert got == want and got["num_queries"] == 3


def test_recognition_cli_matches_jax(tree, weights, tmp_path):
    jcfg, variables, pth = weights
    patch, seen = _recording(recognition, "cls_logits")
    with patch:
        got = cli.main(_port(tree, "--eval-recognition", "--resume", pth,
                             "--output-dir", str(tmp_path / "port")))
    ((args, (sup, sub)),) = seen          # the 10 items in one batch of at most 64
    sup, sub = sup.numpy(), sub.numpy()
    cfg, jmodel, jvars = _jax_model(jcfg, variables, {"cls": 1})
    assert _heads(args[0]) == {k: bool(v) for k, v in cfg.model.loss_type.to_dict().items()}
    dataset = jax_fg.FashionGenRecognition(tree, cfg.data)
    batch = jax_collate([dataset[i] for i in range(VALID)])
    out = jax.jit(lambda v, i, t: jmodel.apply(v, i, t, train=False))(
        jvars, batch["images"].astype(np.float32) / np.float32(255), batch["ori_input_ids"])
    skipped = 0
    for got_l, key in ((sup, "sup_cls_logits"), (sub, "sub_cls_logits")):
        want_l = np.asarray(out[key]).reshape(VALID, -1)
        np.testing.assert_allclose(got_l, want_l, rtol=0, atol=TOL)
        top2 = np.sort(want_l, axis=-1)[:, -2:]
        decided = top2[:, 1] - top2[:, 0] > MARGIN
        skipped += int((~decided).sum())
        assert np.array_equal(got_l.argmax(-1)[decided], want_l.argmax(-1)[decided])
    assert skipped <= 2

    want = jax_recognition.evaluate_recognition(
        jax_recognition.make_cls_scorer(jmodel, jvars), [batch],
        num_super=cfg.model.num_super_classes, num_sub=cfg.model.num_sub_classes,
        artifact_dir=str(tmp_path / "jax"))
    assert got == want
    artifacts = [json.loads((tmp_path / side / "recognition_predictions.json").read_text())
                 for side in ("port/visualization", "jax")]
    assert artifacts[0] == artifacts[1]
    assert len(artifacts[0]["sup_preds"]) == VALID and artifacts[0]["names"][3] == "prod0003_img.png"


def test_viz_matches_jax(tree, weights, tmp_path):
    """--viz on the every-pre-training-head model: the original and masked
    images byte for byte, the reconstruction within one level, and the MLM
    and ITM lines where the JAX margins decide them."""
    jcfg, variables, pth = weights
    out = tmp_path / "port"
    cli.main(_port(tree, "--viz", "--viz-samples", "3", "--finetune", pth,
                   "--output-dir", str(out)))
    cfg, jmodel, jvars = _jax_model(jcfg, variables, jcfg.model.loss_type.to_dict())
    valid = jax_fg.FashionGenPretrain(tree, "valid", cfg.data, itm_enabled=True,
                                      seed=cfg.seed + 10_000)
    batch = jax_collate([valid[i] for i in range(cfg.optim.batch_size)])
    seen = []
    step = jax.jit(lambda v, i, t: jmodel.apply(v, i, t, train=False))
    n = jax_visualize_vl(lambda *a: seen.append(step(*a)) or seen[-1], jvars, [batch],
                         valid.tokenizer, str(tmp_path / "jax"), max_samples=3)
    assert n == 3 and len(os.listdir(out / "visualization")) == 3
    mlm = np.asarray(seen[1]["mlm_logits"])
    skipped = 0
    for i in range(3):
        ours, theirs = out / "visualization" / f"sample_{i:04d}", tmp_path / "jax" / f"sample_{i:04d}"
        for name in ("original.png", "masked.png"):
            assert (ours / name).read_bytes() == (theirs / name).read_bytes(), (i, name)
        recon = [np.asarray(Image.open(d / "reconstruction.png"), np.int16) for d in (ours, theirs)]
        assert np.abs(recon[0] - recon[1]).max() <= 1
        got_lines = (ours / "predictions.txt").read_text().splitlines()
        want_lines = (theirs / "predictions.txt").read_text().splitlines()
        assert len(got_lines) == len(want_lines) and want_lines[-1].startswith("ITM:")
        positions = np.nonzero(batch["mlm_labels"][i] != -1)[0]
        for p, g, w in zip(positions, got_lines, want_lines):
            top2 = np.sort(mlm[i, p])[-2:]
            if top2[1] - top2[0] > MARGIN:
                assert g == w
            else:
                skipped += 1
        prob = lambda line: float(line.split("p(match)=")[1].split()[0])
        assert abs(prob(got_lines[-1]) - prob(want_lines[-1])) <= 1e-4 + TOL
    assert skipped <= 2


def test_profile_dir_traces_a_pretraining_epoch_on_the_tree(tree, tmp_path):
    """Pre-training on the on-disk reader for one epoch with --profile-dir:
    a Chrome trace with the step's operators, and the epoch's log line."""
    run, prof = tmp_path / "run", tmp_path / "prof"
    assert cli.main(_port(tree, "--epochs", "1", "--output-dir", str(run),
                          "--profile-dir", str(prof))) is None
    (trace,) = os.listdir(prof)
    events = json.loads((prof / trace).read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    (line,) = [json.loads(x) for x in (run / "train_log.jsonl").read_text().splitlines()]
    assert line["epoch"] == 0 and np.isfinite(line["total_loss"])


def test_profiling_helpers(tmp_path):
    from mvlt_tpu_torch.utils import profiling

    with profiling.trace(""):
        pass
    with profiling.trace(str(tmp_path)):
        with profiling.step_marker(3), profiling.annotate("host_phase"):
            torch.ones(4).sum()
    (trace,) = os.listdir(tmp_path)
    names = {e.get("name") for e in json.loads((tmp_path / trace).read_text())["traceEvents"]}
    assert {"train_step_3", "host_phase"} <= names


def test_eval_on_the_card_without_one_raises(tree):
    with mock.patch.object(torch.cuda, "is_available", return_value=False), \
            pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config", CONFIG, "--data-path", tree, "--eval-recognition"])


def test_load_eval_model_raises_when_nothing_matches(tmp_path):
    cfg = load_config_file(CONFIG)
    pth = tmp_path / "other.pth"
    torch.save({"model": {"not.a.tensor.of.the.model": torch.zeros(3)}}, str(pth))
    with pytest.raises(ValueError, match="no checkpoint tensor matched"):
        cli.load_eval_model(apply_overrides(cfg, {"resume": str(pth)}), "cpu")


def test_parity_harness_skips_when_blobs_absent(tree, tmp_path, capsys):
    rc = parity.main(["--data-path", tree, "--device", "cpu",
                      "--retrieval-pth", str(tmp_path / "nope.pth"),
                      "--recognition-pth", str(tmp_path / "nope2.pth")])
    out = capsys.readouterr().out
    assert rc == 0
    assert "SKIP retrieval parity" in out and "SKIP recognition parity" in out
    assert "PARITY SKIPPED" in out


def test_parity_harness_runs_a_synthetic_pth(tree, weights, tmp_path, capsys):
    """The harness on the port's command line: OK against the fixture's own
    metrics, FAIL against the README's numbers."""
    pth = weights[2]
    base = _port(tree, "--resume", pth)
    expected = {f"retrieval-{d}": cli.main(base + [f"--eval-retrieval-{d}", "--parity-heads"])
                for d in ("itr", "tir")}
    rec = cli.main(base + ["--eval-recognition", "--output-dir", str(tmp_path)])
    expected["recognition"] = {k: rec[k] for k in parity.EXPECTED["recognition"]}
    override = tmp_path / "expected.json"
    override.write_text(json.dumps(expected))
    capsys.readouterr()
    argv = ["--data-path", tree, "--config", CONFIG, "--device", "cpu",
            "--retrieval-pth", pth, "--recognition-pth", pth]
    assert parity.main(argv + ["--expected-override", str(override)]) == 0
    assert "PARITY OK (3 protocol run(s) checked)" in capsys.readouterr().out
    assert parity.main(argv + ["--skip-recognition"]) == 1
    assert "PARITY FAIL" in capsys.readouterr().out


@pytest.mark.parametrize("num_classes,present", [(48, 48), (122, 30), (7, 3)])
def test_cls_metrics_match_jax(num_classes, present):
    """Accuracy and F1 over labels and predictions that leave classes out
    (absent from both, from the labels only, from the predictions only)."""
    rng = np.random.default_rng(num_classes)
    labels = rng.integers(0, present, 300)
    preds = np.where(rng.random(300) < 0.6, labels, rng.integers(0, num_classes, 300))
    assert metrics.cls_metrics(labels, preds, num_classes) == \
        jax_metrics.cls_metrics(labels, preds, num_classes)
    assert metrics.f1_scores(labels, preds, num_classes) == \
        jax_metrics.f1_scores(labels, preds, num_classes)
    for a, b in zip(metrics._confusion_counts(labels, preds, num_classes),
                    jax_metrics._confusion_counts(labels, preds, num_classes)):
        assert np.array_equal(a, b)


def test_token_metrics_and_psnr_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 16, 50)).astype(np.float32)
    labels = np.where(rng.random((3, 16)) < 0.3, rng.integers(0, 50, (3, 16)), -1)
    labels[0, :4] = logits[0, :4].argmax(-1)
    t_logits, t_labels = torch.from_numpy(logits), torch.from_numpy(labels)
    assert float(metrics.mlm_accuracy(t_logits, t_labels)) == pytest.approx(
        float(jax_metrics.mlm_accuracy(jnp.asarray(logits), jnp.asarray(labels))), abs=1e-7)
    assert float(metrics.mlm_accuracy(t_logits, torch.full_like(t_labels, -1))) == 0.0
    rows, row_labels = logits[:, 0], labels[:, 0].clip(0)
    assert int(metrics.argmax_accuracy_count(torch.from_numpy(rows), torch.from_numpy(row_labels))) \
        == int(jax_metrics.argmax_accuracy_count(jnp.asarray(rows), jnp.asarray(row_labels)))
    pred, target = rng.random((2, 8, 8, 3)).astype(np.float32)
    assert metrics.psnr(torch.from_numpy(pred), torch.from_numpy(target)) == pytest.approx(
        jax_metrics.psnr(jnp.asarray(pred), jnp.asarray(target)), rel=1e-6)
    assert metrics.psnr(torch.from_numpy(pred), torch.from_numpy(pred)) == 100.0
