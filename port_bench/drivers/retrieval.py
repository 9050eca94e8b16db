"""Retrieval serving: the port's zero-shot retrieval protocol under a closed
loop of one client.

The entry is the program's ``evaluate_retrieval(make_itm_scorer(model),
loader)`` on the model the CLI's retrieval eval builds (the configuration
with the ITM head alone). The loader cycles a pool of items made from the
seed, each ``queries_per_call`` bundles of ``candidates`` pairs in the
retrieval reader's types (uint8 images, int64 ids); the scorer copies each
call's images to the card, as the program does. A query's time runs from
the start of the scorer call that holds it to the moment the protocol asks
for the next item, after it has ranked the call's queries; the queries of a
call share that time.

Correctness: after the window, a sample of the window's calls drawn from
the seed is scored again by the plain reference in float32, and each
served positive-class probability p is compared as the logit difference
log p - log(1 - p) with the reference's l1 - l0: the widest gap, over the
sample, over the scale that the ITM head gives l1 - l0: the norm of the
difference of its two weight rows times the root mean square, over the
sample, of the norm of the reference's head input (``score_gap``). Since
|l1 - l0| can be no larger than that (bias aside), the number is a relative
error of the served scores that does not swing with where l1 - l0 lies.
The ranks that the protocol's host step gave each query of the window are
recorded as it returns them, and ``rank_miss`` counts the queries whose
rank is wrong: against a stable descending sort of the scores the program
served (every query of the window), against the reference's rank (the
sampled queries; a candidate whose reference score lies within twice the
score limit of the true pair's may fall on either side), and the counts
behind the accuracies that the protocol returned against those ranks.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench import common, data, weights
from port_bench.profiling import TracedSpan
from port_bench.reference import pvlt as ref


def build(ctx):
    """The program's scoring model with the benchmark's weights, and the weights."""
    from mvlt_tpu_torch.models.pvlt import create_model

    cfg = ctx.model_config(itm=True, mlm=False, t2i=False, cls=False)
    model = create_model(cfg, device=ctx.device, input_size=ctx.config["input_size"])
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    sd = weights.make_weights(shapes, ctx.seed, ctx.device)
    model.load_state_dict(sd)
    return model.eval(), sd


# a fault's tensor zeroed in the program's model alone, as a kernel that drops it
DROPPED = {"ln_shift": "block1.0.norm1.bias", "bias": "block1.0.attn.kv.bias"}


def _plant(ctx, scorer, model):
    """A fault planted under the timed path (tests, control.py): ``answer``:
    in every call the first pair of each bundle is given the score of the
    bundle's 51st; ``ln_shift`` and ``bias``: the program's model serves
    with a LayerNorm shift or a product's bias of ``DROPPED`` set to 0;
    ``rank``: the host's rank step ranks the second candidate as the true
    pair (see ``_rank_step``)."""
    if ctx.fault in DROPPED:
        with torch.no_grad():
            dict(model.named_parameters())[DROPPED[ctx.fault]].zero_()
    if ctx.fault != "answer":
        return scorer
    c = ctx.mix["candidates"]

    def altered(images, ids):
        s = scorer(images, ids).clone().reshape(-1, c)
        s[:, 0] = s[:, c // 2]
        return s.reshape(-1)

    return altered


class _rank_step:
    """Records, while open, every rank that the protocol's host step
    (``mvlt_tpu_torch.eval.retrieval.rank_of_ground_truth``) returns; with
    the fault ``rank`` the step ranks candidate 1 in place of candidate 0."""

    def __init__(self, ctx):
        from mvlt_tpu_torch.eval import retrieval as program

        self.program, self.ranks = program, []
        self.step = program.rank_of_ground_truth
        if ctx.fault == "rank":
            self.step = lambda scores: int(np.nonzero(np.argsort(-scores, kind="stable") == 1)[0][0])

    def __enter__(self):
        def recorded(scores):
            r = self.step(scores)
            self.ranks.append(r)
            return r

        self.kept = self.program.rank_of_ground_truth
        self.program.rank_of_ground_truth = recorded
        return self

    def __exit__(self, *exc):
        self.program.rank_of_ground_truth = self.kept


def run(ctx) -> dict:
    from mvlt_tpu_torch.eval.retrieval import evaluate_retrieval, make_itm_scorer

    mix = ctx.mix
    model, sd = build(ctx)
    pool = data.retrieval_pool(ctx.seed, mix, ctx.device)
    items = [{"images_101": pool["images_101"][i], "ori_input_ids_101": pool["ori_input_ids_101"][i]}
             for i in range(mix["pool_items"])]
    scorer = _plant(ctx, make_itm_scorer(model), model)
    per_call = mix["queries_per_call"] * mix["candidates"]

    # warm-up: the window's shapes, through the same entry
    evaluate_retrieval(scorer, items[: mix["warmup_calls"]], log_every=10 ** 9)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)

    calls = []          # [start, ranked, pool item]
    outputs = []        # the scores each call returned
    traced = TracedSpan(ctx.device) if ctx.trace else None
    span = {"first": mix["trace_skip_calls"], "last": mix["trace_skip_calls"] + mix["trace_calls"]}
    result = {}

    def timed(images, ids):
        calls.append([time.perf_counter(), None, current[0]])
        out = scorer(images, ids)
        outputs.append(out)
        return out

    current = [0]

    def loader(deadline):
        i = 0
        while True:
            now = time.perf_counter()
            if calls and calls[-1][1] is None:
                calls[-1][1] = now
            if traced is not None and i == span["first"]:
                traced.start()
            if traced is not None and i == span["last"]:
                result["trace"] = traced.stop()
            if now >= deadline and (traced is None or i >= span["last"]):
                return
            current[0] = i % len(items)
            yield items[current[0]]
            i += 1

    setup_s = time.time() - ctx.started
    t0 = time.perf_counter()
    with _rank_step(ctx) as ranked:
        returned = evaluate_retrieval(timed, loader(t0 + ctx.seconds), log_every=50)
    t1 = calls[-1][1]
    memory_peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0

    lat = np.repeat([c[1] - c[0] for c in calls], mix["queries_per_call"])
    out = {
        "setup_s": setup_s,
        "e2e": {"serve_pairs_per_s": len(calls) * per_call / (t1 - t0),
                "query_ms_p95": float(np.percentile(lat, 95)) * 1e3},
        "memory_peak_bytes": memory_peak,
        "attempted": len(calls) * mix["queries_per_call"],
        "info": {"calls": len(calls), "queries": len(lat), "window_s": t1 - t0,
                 "query_ms_p50": float(np.percentile(lat, 50)) * 1e3},
    }
    if traced is not None:
        first, last = span["first"], span["last"]
        host = [c[1] - c[0] for c in calls[first:last]]
        cfg = ctx.config["model"]
        from port_bench.flops import serve_flops

        out["readings"] = traced.readings(
            result["trace"], last - first, {"call_host": host},
            serve_flops(cfg, ctx.config["input_size"], (last - first) * per_call))

    scores = [outputs[i] for i in range(len(calls))]
    del model, scorer, outputs
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    out.update(check(ctx, sd, items, calls, scores, ranked.ranks, returned))
    return out


def _logit_diff(p: np.ndarray) -> np.ndarray:
    p = p.astype(np.float64)
    return np.log(p) - np.log1p(-p)


def reference_logits(ctx, sd, item: dict, precision: ref.Precision) -> tuple:
    """(l1 - l0 [Q * C], the squared norms of the ITM head's input [Q * C])
    of one pool item by the plain reference, in blocks of one bundle."""
    arch = ref.Arch.from_dict(ctx.config["model"])
    imgs, ids = item["images_101"], item["ori_input_ids_101"]
    q, c = imgs.shape[:2]
    diff, norms = [], []
    with torch.no_grad():
        for b in range(q):
            x = torch.as_tensor(imgs[b], device=ctx.device).float() / 255.0
            t = torch.as_tensor(ids[b], device=ctx.device).long()
            lg, f = ref.serve_itm(arch, sd, x, t, precision, features=True)
            lg = lg.double()
            diff.append((lg[:, 1] - lg[:, 0]).cpu().numpy())
            norms.append(f.double().square().sum(-1).cpu().numpy())
    return np.concatenate(diff), np.concatenate(norms)


def sample_calls(ctx, n_calls: int) -> np.ndarray:
    k = min(ctx.mix["check_calls"], n_calls)
    return np.sort(data.rng(ctx.seed, 9).choice(n_calls, k, replace=False))


def stable_rank(scores: np.ndarray, tol: float = 0.0) -> tuple:
    """(fewest, most) candidates that may rank above candidate 0 of a bundle
    of scores: those above it by more than ``tol``, and those not below it
    by more than ``tol``."""
    others = scores[1:]
    return int((others > scores[0] + tol).sum()), int((others >= scores[0] - tol).sum())


def rank_misses(ctx, calls, scores, ranks, returned, sampled: dict, tol: float) -> int:
    """Queries given a wrong rank: the recorded ranks against the served
    scores' stable descending order (every query of the window) and the
    sampled queries' served order against the reference's within ``tol``
    (``sampled``: call -> (served l1 - l0, reference l1 - l0)), and the
    counts behind the returned accuracies against the recorded ranks."""
    q, c = ctx.mix["queries_per_call"], ctx.mix["candidates"]
    served = np.concatenate([torch.as_tensor(s).float().cpu().numpy() for s in scores])
    served = served.reshape(-1, c)
    misses = abs(len(ranks) - len(served)) + abs(int(returned["num_queries"]) - len(served))
    for r, row in zip(ranks, served):
        misses += int(r != stable_rank(row)[0])
    for ci, (got, want) in sampled.items():
        for b in range(q):
            lo, hi = stable_rank(want.reshape(q, c)[b], tol)
            mine = stable_rank(got.reshape(q, c)[b])[0]
            misses += int(not lo <= mine <= hi)
    for k in (1, 5, 10):
        misses += abs(round(returned[f"acc@{k}"] * 1000) - sum(r < k for r in ranks))
    return misses


def check(ctx, sd, items, calls, scores, ranks, returned) -> dict:
    """The comparison that decides ``correct``; with ``ctx.control`` the
    reference in float8 stands in the program's place."""
    ref.exact_float32()
    picked = sample_calls(ctx, len(calls))
    gaps, wants, norms, failed, sampled = [], [], [], 0, {}
    for ci in picked:
        item = items[calls[ci][2]]
        want, sq = reference_logits(ctx, sd, item, ref.Precision("fp32"))
        if ctx.control:
            got, _ = reference_logits(ctx, sd, item, ref.Precision("fp8"))
        else:
            got = _logit_diff(torch.as_tensor(scores[ci]).float().cpu().numpy())
        bad = ~np.isfinite(got)
        failed += int(bad.reshape(-1, ctx.mix["candidates"]).any(1).sum())
        gaps.append(np.abs(np.where(bad, np.inf, got) - want))
        wants.append(want)
        norms.append(sq)
        sampled[ci] = (np.where(bad, -np.inf, got), want)
    w = sd["itm_head.linear.weight"].double()
    scale = float((w[1] - w[0]).norm()) * float(np.sqrt(np.mean(np.concatenate(norms))))
    widest = float(np.max(np.concatenate(gaps)))
    gap = widest / scale
    limit = ctx.limits["numbers"]["score_gap"]["limit"]
    misses = rank_misses(ctx, calls, scores, ranks, returned, sampled, 2 * limit * scale)
    rank_limit = ctx.limits["numbers"]["rank_miss"]["limit"]
    d = np.concatenate(wants)
    common.log(f"checked {len(picked)} calls ({len(d)} pairs): widest gap {widest!r} in "
               f"l1 - l0 against the head's scale {scale!r}; l1 - l0 mean "
               f"{float(d.mean())!r}, std {float(d.std())!r}; ranks of {len(ranks)} queries, "
               f"{misses} wrong; acc@1/5/10 {returned['acc@1_true']!r} "
               f"{returned['acc@5_true']!r} {returned['acc@10_true']!r}")
    return {"compared": {"score_gap": (gap, limit), "rank_miss": (misses, rank_limit)},
            "correct": bool(gap <= limit and misses <= rank_limit), "failed": failed}
