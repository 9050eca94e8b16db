"""Tensor parallelism of the fused_attn_train route (the tensor-parallel
modes of kernels #6-#8), of the MLM loss through the logits, and the
model groups' node rule, on the CPU.

  * #6/#7/#8's tensor-parallel modes, plain versions
    (ops/block_attention.py: ``block_attention_train_reference(partial=
    True)``, ``block_attention_bwd_reference(partial=True)``): summed over
    2 and 4 slices of the heads, with s bp, x and dy added once, they equal
    the whole in fp64, in both backward forms; the written-out backward of
    a rank's slice passes gradcheck against its forward;
  * the split step on that route (parallel/tensor.py:fused_attn_tp), the
    ranks of a model group as threads of this process
    (tests/_thread_ranks.py), against one process's fp64 step within 1e-6
    of each gradient's largest magnitude, at tp 2 and 4 and in both forms;
    with one sum too few (the ranks' LN1 partials left unsummed) or one
    too many (bp's whole gradient summed over the ranks) the losses stay
    and the gradients land far off;
  * the vocabulary-parallel cross entropy (parallel/tensor.py:
    vocab_parallel_cross_entropy) against F.cross_entropy(ignore_index=-1)
    in fp64, forward and gradient, with labels in every rank's range and
    ignored rows, and the step with ``mlm_loss_chunk = 0`` against one
    process;
  * parallel/mesh.py:init_model_parallel in a simulated two-node torchrun
    environment (WORLD_SIZE 4, LOCAL_WORLD_SIZE 2): tp 2 keeps each model
    group inside a node, tp 4 raises.

The split steps against JAX's single-device step are
tests/test_torch_port_tp.py's (worker case ``tp``).
"""

import copy

import pytest
import torch
import torch.nn.functional as F

from mvlt_tpu_torch import config
from mvlt_tpu_torch.models.pvlt import create_model
from mvlt_tpu_torch.ops import block_attention as fba
from mvlt_tpu_torch.parallel import mesh, tensor
from mvlt_tpu_torch.train.state import create_train_state
from mvlt_tpu_torch.train.step import make_train_step
from tests._thread_ranks import ThreadGroup, patched, run_ranks
from tests.test_torch_port_ddp import PORT_TOL, assert_close_to_max
from tests.test_torch_port_tp_families import global_batch
from tests.test_torch_port_train import MICRO, one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

F64 = dict(rtol=1e-12, atol=1e-12)
HEADS = dict(itm=True, mlm=True, t2i=True, cls=False)
EPS = 1e-6


def fba_inputs(seed: int, b: int = 2, n: int = 7, d: int = 32, heads: int = 4, m: int = 5):
    """fp64 inputs of the attention half: (x, k, v, gamma, beta, Wq, bq, Wp,
    bp, s, dy), one sample dropped."""
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, dtype=torch.float64)
    hd = d // heads
    s = torch.tensor([1.0 / 0.9, 0.0] + [1.0] * (b - 2), dtype=torch.float64)
    return (r(b, n, d), r(b, heads, m, hd), r(b, heads, m, hd), 1 + 0.1 * r(d), 0.1 * r(d),
            r(d, d) / d ** 0.5, 0.1 * r(d), r(d, d) / d ** 0.5, 0.1 * r(d), s, r(b, n, d))


def head_slice(args, rank: int, tp: int, heads: int) -> tuple:
    """(K, V, Wq, bq, Wp) of rank ``rank``'s heads."""
    _, k, v, _, _, wq, bq, wp, _, _, _ = args
    hr, dh = heads // tp, wq.shape[0] // tp
    cols = slice(rank * dh, (rank + 1) * dh)
    return (k[:, rank * hr:(rank + 1) * hr], v[:, rank * hr:(rank + 1) * hr], wq[cols],
            bq[cols], wp[:, cols])


@pytest.mark.parametrize("with_stats", [False, True], ids=["recompute", "stats"])
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_modes_sum_to_the_whole(tp, with_stats):
    """The forward's partials plus s bp and x, and the backward's partial
    dx plus dy, dgamma and dbeta summed over the slices, the shards' dWq,
    dbq, dWp, dK and dV put together, equal the whole attention half's in
    fp64; every slice's dbp is the whole one."""
    heads = 4
    args = fba_inputs(3)
    x, k, v, g, be, wq, bq, wp, bp, s, dy = args
    out, st = fba.block_attention_train_reference(x, k, v, g, be, wq, bq, wp, bp, s,
                                                  heads=heads, eps=EPS, save_stats=True)
    want = fba.block_attention_bwd_reference(x, k, v, g, be, wq, bq, wp, s, dy, heads=heads,
                                             eps=EPS, stats=st if with_stats else None)
    parts, grads = [], []
    for r in range(tp):
        kr, vr, wqr, bqr, wpr = head_slice(args, r, tp, heads)
        part, st_r = fba.block_attention_train_fwd_tp(x, kr, vr, g, be, wqr, bqr, wpr, s,
                                                      heads=heads // tp, eps=EPS,
                                                      save_stats=True)
        hr = heads // tp
        torch.testing.assert_close(st_r[..., :2], st[..., :2], **F64)
        torch.testing.assert_close(st_r[..., 2:], st[..., 2 + 2 * r * hr:2 + 2 * (r + 1) * hr],
                                   **F64)
        parts.append(part)
        grads.append(fba.block_attention_train_bwd_tp(x, kr, vr, g, be, wqr, bqr, wpr, s, dy,
                                                      heads=hr, eps=EPS,
                                                      stats=st_r if with_stats else None))
    torch.testing.assert_close(x + sum(parts) + s[:, None, None] * bp, out, **F64)
    got = (dy + sum(o[0] for o in grads), torch.cat([o[1] for o in grads], 1),
           torch.cat([o[2] for o in grads], 1), sum(o[3] for o in grads),
           sum(o[4] for o in grads), torch.cat([o[5] for o in grads]),
           torch.cat([o[6] for o in grads]), torch.cat([o[7] for o in grads], 1), grads[0][8])
    for name, a, b in zip(("dx", "dk", "dv", "dgamma", "dbeta", "dWq", "dbq", "dWp", "dbp"),
                          got, want):
        torch.testing.assert_close(a, b, **F64, msg=name)
    for o in grads:
        assert torch.equal(o[8], grads[0][8])


class _RankHalf(torch.autograd.Function):
    """One rank's tensor-parallel mode as a differentiable function of its
    inputs: the partial forward, the written-out partial backward."""

    @staticmethod
    def forward(ctx, x, k, v, g, be, wq, bq, wp, s, heads, with_stats):
        part, st = fba.block_attention_train_fwd_tp(x, k, v, g, be, wq, bq, wp, s, heads=heads,
                                                    eps=EPS, save_stats=True)
        ctx.heads = heads
        ctx.save_for_backward(x, k, v, g, be, wq, bq, wp, s, st if with_stats else None)
        return part

    @staticmethod
    def backward(ctx, dy):
        x, k, v, g, be, wq, bq, wp, s, st = ctx.saved_tensors
        dx, dk, dv, dg, dbe, dwq, dbq, dwp, _ = fba.block_attention_train_bwd_tp(
            x, k, v, g, be, wq, bq, wp, s, dy, heads=ctx.heads, eps=EPS, stats=st)
        return dx, dk, dv, dg, dbe, dwq, dbq, dwp, None, None, None


@pytest.mark.parametrize("with_stats", [False, True], ids=["recompute", "stats"])
def test_tp_mode_passes_gradcheck(with_stats):
    """A rank's written-out backward (dx without dy, the rank's dgamma and
    dbeta, its shard's dWq, dbq, dWp, its heads' dK and dV) is the
    derivative of its partial forward."""
    args = fba_inputs(5, b=2, n=4, d=8, heads=2, m=3)
    x, _, _, g, be, *_ = args
    k, v, wq, bq, wp = head_slice(args, 1, 2, 2)
    inputs = [t.detach().clone().requires_grad_() for t in (x, k, v, g, be, wq, bq, wp)]
    assert torch.autograd.gradcheck(
        lambda *t: _RankHalf.apply(*t, args[9], 1, with_stats), inputs, eps=1e-6, atol=1e-8)


def micro_cfg(**overrides) -> config.ModelConfig:
    return config.ModelConfig(**{**MICRO, "img_size": 64, "name": "pvlt_tiny",
                                 "compute_dtype": "float64", **overrides},
                              loss_type=config.LossType(**HEADS))


def one_process(cfg, sd, batch) -> tuple:
    """This process's fp64 step: (gradients, losses)."""
    model = create_model(cfg, device="cpu", input_size=64).double()
    model.load_state_dict(sd, strict=True)
    state = create_train_state(model, config.OptimConfig(warmup_epochs=0), 8, 10, seed=0)
    _, losses = make_train_step(cfg)(state, batch)
    return {k: p.grad for k, p in model.named_parameters()}, losses


def split_step(cfg, sd, batch, group: ThreadGroup) -> list:
    """Each thread rank's (consolidated gradients, losses) of the step with
    the weights split over the ranks of ``group``."""

    def rank(r):
        model = create_model(cfg, device="cpu", input_size=64).double()
        model.load_state_dict(sd, strict=True)
        tensor.shard_model(model, group)
        state = create_train_state(model, config.OptimConfig(warmup_epochs=0), 8, 10, seed=0,
                                   model_group=group)
        _, losses = make_train_step(cfg)(state, batch)
        grads = tensor.consolidate({k: p.grad for k, p in model.named_parameters()}, group, cfg)
        return grads, losses

    return run_ranks(group, rank)


@pytest.fixture(scope="module")
def weights():
    torch.manual_seed(7)
    return copy.deepcopy(create_model(micro_cfg(), device="cpu", input_size=64).double()
                         .state_dict()), global_batch(43)


ROUTES = {"fused": dict(fused_attn_train=True),
          "fused_stats": dict(fused_attn_train=True, fused_attn_stats=True),
          "mlm_logits": dict(mlm_loss_chunk=0)}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("tp", [2, 4])
def test_split_step_matches_one_process(monkeypatch, weights, tp, route):
    """The step with the weights split over tp thread ranks on the fused
    route (both forms: #6-#8's modes on the stages whose heads split, the
    unsharded launch on the others) or through the MLM logits (the
    vocabulary-parallel cross entropy) equals this process's fp64 step
    from the same weights: every consolidated gradient within PORT_TOL of
    its largest magnitude, the losses, on every rank."""
    patched(monkeypatch)
    sd, batch = weights
    cfg = micro_cfg(**ROUTES[route])
    want, want_l = one_process(cfg, sd, batch)
    calls = []
    real = tensor.block_attention_train_fwd_tp
    monkeypatch.setattr(tensor, "block_attention_train_fwd_tp",
                        lambda *a, **k: calls.append(k["heads"]) or real(*a, **k))
    for grads, losses in split_step(cfg, sd, batch, ThreadGroup(tp)):
        assert_close_to_max(grads, want, PORT_TOL, f"{route} tp {tp}")
        for k, v in want_l.items():
            assert abs(float(losses[k]) - float(v)) <= PORT_TOL * max(abs(float(v)), 1e-12), k
    split_blocks = sum(2 for h in MICRO["num_heads"] if h % tp == 0)
    if route.startswith("fused"):     # each rank, each split block, its heads
        assert sorted(calls) == sorted(
            [h // tp for h in MICRO["num_heads"] if h % tp == 0 for _ in range(2 * tp)])
        assert len(calls) == tp * split_blocks
    else:
        assert calls == []


@pytest.mark.parametrize("wrong", ["one_sum_too_few", "one_sum_too_many"])
def test_split_step_with_a_wrong_sum(monkeypatch, weights, wrong):
    """The bookkeeping of the fused route's sums shown by planting each
    mistake: the ranks' LN1 partials (dx, dgamma, dbeta) left unsummed, or
    bp's whole gradient summed over the ranks as if it were a partial. The
    losses stay those of one process; gradients land far off."""
    patched(monkeypatch)
    sd, batch = weights
    cfg = micro_cfg(**ROUTES["fused"])
    want, want_l = one_process(cfg, sd, batch)
    group = ThreadGroup(2)
    if wrong == "one_sum_too_few":
        monkeypatch.setattr(tensor, "sum_ln_partials", lambda dx, dg, db, group: (dx, dg, db))
    else:
        real = tensor.block_attention_train_bwd_tp

        def summed_dbp(*a, **k):
            out = list(real(*a, **k))
            out[8] = tensor._model_sum(out[8], group)
            return tuple(out)

        monkeypatch.setattr(tensor, "block_attention_train_bwd_tp", summed_dbp)
    grads, losses = split_step(cfg, sd, batch, group)[0]
    for k, v in want_l.items():
        assert abs(float(losses[k]) - float(v)) <= PORT_TOL * max(abs(float(v)), 1e-12), k
    gaps = [float((grads[k] - w).abs().max() / w.abs().max()) for k, w in want.items()
            if w.abs().max() > 0]
    assert max(gaps) > 1e3 * PORT_TOL, wrong


@pytest.mark.parametrize("tp", [2, 4])
def test_vocab_parallel_cross_entropy(monkeypatch, tp):
    """Each rank's columns of the logits give F.cross_entropy(ignore_index
    = -1) of the whole logits and, put together, its gradient, in fp64:
    labels in every rank's range, ignored rows, a row whose maximum lies in
    another rank's range; all rows ignored gives 0 and a zero gradient."""
    patched(monkeypatch)
    gen = torch.Generator().manual_seed(11)
    rows, vocab = 24, 40
    logits = torch.randn(rows, vocab, generator=gen, dtype=torch.float64) * 3
    logits[0, 37] = 30.0
    labels = torch.randint(0, vocab, (rows,), generator=gen)
    labels[::5] = -1
    labels[0] = 1
    width = vocab // tp
    assert all(((labels >= r * width) & (labels < (r + 1) * width)).any() for r in range(tp))
    for labs in (labels, torch.full_like(labels, -1)):
        whole = logits.clone().requires_grad_()
        want = F.cross_entropy(whole, labs, ignore_index=-1) if (labs >= 0).any() \
            else (whole * 0).sum()
        want.backward()
        group = ThreadGroup(tp)

        def rank(r):
            local = logits[:, r * width:(r + 1) * width].clone().requires_grad_()
            loss = tensor.vocab_parallel_cross_entropy(local, labs, r * width, group)
            loss.backward()
            return loss.detach(), local.grad

        res = run_ranks(group, rank)
        for loss, _ in res:
            torch.testing.assert_close(loss, want.detach(), **F64)
        torch.testing.assert_close(torch.cat([g for _, g in res], 1), whole.grad, **F64)


def test_model_groups_stay_inside_a_node(monkeypatch):
    """torchrun's two-node environment (WORLD_SIZE 4, LOCAL_WORLD_SIZE 2, a
    node's ranks consecutive): at tp 2 each model group holds the two ranks
    of one node and each data group spans both nodes; tp 4 would put a
    model group across the nodes and raises ValueError; without
    LOCAL_WORLD_SIZE every rank counts as one machine's."""
    made = []
    monkeypatch.setattr(mesh, "_layout", None)
    monkeypatch.setattr(mesh, "world_size", lambda: 4)
    monkeypatch.setattr(mesh, "_layouts", {})
    monkeypatch.setattr(mesh.dist, "new_group", lambda ranks: made.append(tuple(ranks))
                        or tuple(ranks))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    for r in range(4):
        monkeypatch.setattr(mesh, "rank", lambda r=r: r)
        monkeypatch.setattr(mesh, "_layouts", {})
        mesh.init_model_parallel(2)
        node = r // 2
        assert mesh.model_group() == (2 * node, 2 * node + 1)
        assert mesh.data_group() == (r % 2, r % 2 + 2)
    assert set(made) == {(0, 1), (2, 3), (0, 2), (1, 3)}
    with pytest.raises(ValueError, match="straddle two nodes"):
        mesh.init_model_parallel(4)
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    assert mesh.ranks_per_node() == 4
    monkeypatch.setattr(mesh, "_layouts", {})
    mesh.init_model_parallel(4)
    assert mesh.model_group() == (0, 1, 2, 3)
    mesh.init_model_parallel(1)
    assert mesh.model_group() is None
