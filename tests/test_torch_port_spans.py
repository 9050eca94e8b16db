"""The program's spans (mvlt_tpu_torch/utils/profiling.py) under
torch.profiler: the retrieval call's phases and the model's embeddings on
micro v1 and v2 models, the training step's phases, one ``mvlt.op::``
span a wrapper call, and no ``record_function`` entered by the program
while no profiler records. The last test is marked ``cuda``: on the card
the ``mvlt.op::`` spans of a traced forward equal the rise of the
wrappers' ``.launches`` counters (it skips without a card; this file
imports no JAX, so it runs there with ``--noconftest``).
"""

import json
import sys
from contextlib import ExitStack
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mvlt_tpu_torch import config
from mvlt_tpu_torch.eval.retrieval import evaluate_retrieval, make_itm_scorer
from mvlt_tpu_torch.models.pvlt import create_model
from mvlt_tpu_torch.train.engine import train_one_epoch
from mvlt_tpu_torch.train.state import create_train_state
from mvlt_tpu_torch.train.step import make_train_step
from mvlt_tpu_torch.utils import profiling

B, IMG, T, Q, C = 4, 32, 16, 2, 3
MICRO = dict(img_size=IMG, embed_dims=(8, 16, 32, 64), num_heads=(1, 2, 2, 4),
             mlp_ratios=(2, 2, 2, 2), token_hidden_size=32, num_text_tokens=T,
             vocab_size=64, max_position_embeddings=32, itg_channel=8,
             compute_dtype="float32", drop_path_rate=0.0, bert_dropout=0.0,
             mlm_ce_kernel=False)
ITM = config.LossType(itm=True, mlm=False, t2i=False, cls=False)
PRETRAIN = config.LossType(itm=True, mlm=True, t2i=True, cls=False)
TRAIN_PHASES = ["mvlt.train.h2d", "mvlt.train.forward", "mvlt.train.loss",
                "mvlt.train.backward", "mvlt.train.clip", "mvlt.train.optimizer"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(name, loss_type, **kw):
    torch.manual_seed(0)
    cfg = config.ModelConfig(name=name, loss_type=loss_type, **{**MICRO, **kw})
    return create_model(cfg, device="cpu", input_size=IMG)


def _items(n, rng):
    return [{"images_101": rng.integers(0, 256, (Q, C, IMG, IMG, 3), dtype=np.uint8),
             "ori_input_ids_101": rng.integers(1, 64, (Q, C, T))} for _ in range(n)]


def _batch(rng, b=B):
    imgs = rng.random((b, IMG, IMG, 3)).astype(np.float32)
    return {"images": imgs,
            "masked_images": np.where(rng.random((b, IMG, IMG, 1)) < 0.5, 1e-6,
                                      imgs).astype(np.float32),
            "input_ids": rng.integers(0, 64, (b, T)).astype(np.int32),
            "mlm_labels": np.where(rng.random((b, T)) < 0.3, rng.integers(0, 64, (b, T)),
                                   -1).astype(np.int32),
            "itm_labels": rng.integers(0, 2, (b,)).astype(np.int32)}


def _train_state(model):
    optim = config.OptimConfig(warmup_epochs=0, clip_grad=1.0)
    return create_train_state(model, optim, B, 10)


def _ranges(prof, tmp_path, prefix="mvlt."):
    """(name, start, end) of every host range named ``prefix``... in the
    exported trace, by start (on the card the profiler also copies a range
    that launched work onto the device's timeline: left out)."""
    path = tmp_path / f"trace_{len(list(tmp_path.iterdir()))}.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith(prefix)), key=lambda r: r[1])


def _spans_by_wrapper(ranges):
    out = {}
    for name, _, _ in ranges:
        k = name[len(profiling.OP_PREFIX):]
        out[k] = out.get(k, 0) + 1
    return out


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _count(ranges, name):
    return sum(r[0] == name for r in ranges)


@pytest.mark.parametrize("name", ["pvlt_tiny", "pvlt_v2_tiny"])
def test_retrieval_call_spans(name, tmp_path):
    """One fetch, stage, score, h2d, forward, readback and rank span a call
    (one more call and fetch: the last finds the loader at its end), h2d
    and forward inside score, score inside call, five embed spans, four
    blocks spans and one heads span a forward."""
    model = _model(name, ITM).eval()
    items = _items(2, np.random.default_rng(0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = evaluate_retrieval(make_itm_scorer(model), items, is_main=False)
    assert out["num_queries"] == 2 * Q
    ranges = _ranges(prof, tmp_path)
    n = len(items)
    for span in ("stage", "score", "h2d", "forward", "readback", "rank"):
        assert _count(ranges, f"mvlt.retrieval.{span}") == n, span
    assert _count(ranges, "mvlt.retrieval.call") == _count(ranges, "mvlt.retrieval.fetch") == n + 1
    assert (_count(ranges, "mvlt.model.embed"), _count(ranges, "mvlt.model.blocks"),
            _count(ranges, "mvlt.model.heads")) == (5 * n, 4 * n, n)
    calls = [r for r in ranges if r[0] == "mvlt.retrieval.call"]
    scores = [r for r in ranges if r[0] == "mvlt.retrieval.score"]
    for r in ranges:
        if r[0] in ("mvlt.retrieval.h2d", "mvlt.retrieval.forward"):
            assert any(_inside(r, s) for s in scores), r
        if r[0].startswith("mvlt.retrieval.") and r[0] != "mvlt.retrieval.call":
            assert any(_inside(r, c) for c in calls), r
    forwards = [r for r in ranges if r[0] == "mvlt.retrieval.forward"]
    for r in ranges:
        if r[0].startswith("mvlt.model."):
            assert any(_inside(r, f) for f in forwards), r


def test_train_step_spans(tmp_path):
    """A direct call of the step opens its six phases in order; under
    train_one_epoch each step is one ``mvlt.train.step`` range, under that
    one name, enclosing the six phases in order, beside a fetch a step (and
    one at the loader's end) and a drain a step."""
    rng = np.random.default_rng(1)
    state = _train_state(_model("pvlt_tiny", PRETRAIN))
    step = make_train_step(state.model.cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, _ = step(state, _batch(rng))
    assert [r[0] for r in _ranges(prof, tmp_path, "mvlt.train.")] == TRAIN_PHASES

    batches = [_batch(rng), _batch(rng)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, stats = train_one_epoch(step, state, batches, is_main=False)
    assert np.isfinite(stats["total_loss"])
    ranges = _ranges(prof, tmp_path, "")
    assert not any(r[0].startswith("train_step") for r in ranges)
    steps = [r for r in ranges if r[0] == profiling.STEP]
    assert len(steps) == len(batches)
    for s in steps:
        inner = [r[0] for r in ranges if r[0] in TRAIN_PHASES and _inside(r, s)]
        assert inner == TRAIN_PHASES
    assert _count(ranges, "mvlt.train.fetch") == len(batches) + 1
    assert _count(ranges, "mvlt.train.drain") == len(batches)


def _wrappers():
    """name -> function of every launch-counted op wrapper of the program."""
    out = {}
    for mod_name, mod in list(sys.modules.items()):
        if mod is not None and mod_name.startswith("mvlt_tpu_torch.ops."):
            for attr, fn in vars(mod).items():
                if callable(fn) and hasattr(fn, "launches") and fn.__module__ == mod_name:
                    out[attr] = fn
    return out


def _counted(stack):
    """Each wrapper replaced, in every module of the program that holds it,
    by a mock that calls it: name -> mock."""
    mocks = {}
    for name, fn in _wrappers().items():
        mocks[name] = mock.Mock(wraps=fn)
        for mod_name, mod in list(sys.modules.items()):
            if mod is not None and mod_name.startswith("mvlt_tpu_torch") \
                    and vars(mod).get(name) is fn:
                stack.enter_context(mock.patch.object(mod, name, mocks[name]))
    return mocks


@pytest.mark.parametrize("case", ["serve_v1", "serve_v2", "train_v1"])
def test_one_op_span_a_wrapper_call(case, tmp_path):
    """A traced CPU forward (or step) opens one ``mvlt.op::<wrapper>`` span
    for each call of each wrapper, counted by a mock around it."""
    rng = np.random.default_rng(2)
    if case == "train_v1":
        state = _train_state(_model("pvlt_tiny", PRETRAIN))
        step = make_train_step(state.model.cfg)
        run = lambda: step(state, _batch(rng))  # noqa: E731
    else:
        model = _model("pvlt_v2_tiny" if case == "serve_v2" else "pvlt_tiny", ITM).eval()
        scorer = make_itm_scorer(model)
        item = _items(1, rng)[0]
        run = lambda: scorer(item["images_101"].reshape(Q * C, IMG, IMG, 3),  # noqa: E731
                             item["ori_input_ids_101"].reshape(Q * C, T))
    with ExitStack() as stack:
        mocks = _counted(stack)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            run()
    calls = {name: m.call_count for name, m in mocks.items() if m.call_count}
    assert calls and _spans_by_wrapper(_ranges(prof, tmp_path, profiling.OP_PREFIX)) == calls


def test_no_record_function_without_a_profiler():
    """With no profiler, a retrieval run and a train step enter no span of
    the program (torch's own optimizer step opens its range regardless:
    only the program's names count); under one, the same count sees them."""
    enter = torch.ops.profiler._record_function_enter_new
    rng = np.random.default_rng(3)
    model = _model("pvlt_tiny", ITM).eval()
    state = _train_state(_model("pvlt_tiny", PRETRAIN))
    step = make_train_step(state.model.cfg)

    def work():
        evaluate_retrieval(make_itm_scorer(model), _items(1, rng), is_main=False)
        train_one_epoch(step, state, [_batch(rng)], is_main=False)

    def ours(m):
        return sum(str(c.args[0]).startswith("mvlt.") for c in m.call_args_list)

    with mock.patch.object(torch.ops.profiler, "_record_function_enter_new",
                           mock.Mock(wraps=enter)) as m:
        work()
        off = ours(m)
        with profile(activities=[ProfilerActivity.CPU]):
            work()
        on = ours(m) - off
    assert off == 0 and on > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pvlt_tiny", "pvlt_v2_tiny"])
def test_op_spans_equal_launches_on_the_card(name, tmp_path):
    """A traced serving forward of the model at its widths on the card: the
    ``mvlt.op::`` spans of each wrapper equal the rise of its launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    torch.manual_seed(0)
    cfg = config.ModelConfig(name=name, compute_dtype="bfloat16", loss_type=ITM)
    model = create_model(cfg, device="cuda").eval()
    gen = torch.Generator().manual_seed(1)
    images = torch.randint(0, 256, (2, 256, 256, 3), dtype=torch.uint8, generator=gen)
    ids = torch.randint(1000, 8000, (2, 128), generator=gen)
    scorer = make_itm_scorer(model)
    scorer(images, ids)                            # builds the kernels
    torch.cuda.synchronize()
    wrappers = _wrappers()
    before = {k: fn.launches for k, fn in wrappers.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        scorer(images, ids)
        torch.cuda.synchronize()
    rise = {k: fn.launches - before[k] for k, fn in wrappers.items() if fn.launches > before[k]}
    assert rise and _spans_by_wrapper(_ranges(prof, tmp_path, profiling.OP_PREFIX)) == rise


def test_step_marker_and_annotate_share_one_null_context():
    """Off the profiler both hand back the same shared null context."""
    assert profiling.annotate("mvlt.x") is profiling.annotate("mvlt.y") is \
        profiling.step_marker(3)
