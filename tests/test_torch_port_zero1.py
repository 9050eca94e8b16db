"""ZeRO-1 by element (parallel/sharding.py:Zero1AdamW) on the CPU, the data
ranks as threads of this process (tests/_thread_ranks.py).

The JAX package's contract (tests/test_train_step.py:
test_zero1_matches_single_device) is that ZeRO-1 leaves the step's
numerics untouched while the moments really are sharded over the data
axis (mvlt_tpu/parallel/sharding.py:_zero1_spec: the first dim the data
size divides and the model axis has not taken). Here, on the micro
model's parameters (whole, and a tensor-parallel shard of them):

  * the dim each moment splits along is the one _zero1_spec picks for the
    same shape and tensor-parallel placement;
  * two AdamW steps under ZeRO-1 at dp 2 and 4 (with weight decay on the
    matrices, none on the vectors, and a changed LR) equal
    torch.optim.AdamW's bit for bit, every rank's parameters whole after the
    gather; each rank's moments are its slices of AdamW's, their bytes
    exactly the sharded moments / dp plus the moments that split nowhere;
  * AdamW's state dict (a world-1 checkpoint's) loads into every rank's
    slices, and gathered whole again it is AdamW's state dict; the step
    after it equals AdamW's. A state dict of sharded moments is refused
    until they are gathered.

The world-4 (dp 2 x tp 2) checkpoint's round trip through the gloo ranks
is tests/test_torch_port_tp_families.py's; the DDP step under ZeRO-1
against plain DDP's is tests/test_torch_port_ddp.py's.
"""

import copy
import types

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mvlt_tpu.parallel.sharding import DATA_AXIS, MODEL_AXIS, _zero1_spec
from mvlt_tpu_torch import config
from mvlt_tpu_torch.models.pvlt import create_model
from mvlt_tpu_torch.parallel import tensor
from mvlt_tpu_torch.parallel.sharding import Zero1AdamW, zero1_dim
from mvlt_tpu_torch.train.schedule import make_optimizer, set_lr
from tests._thread_ranks import ThreadGroup, patched, run_ranks
from tests.test_torch_port_train import MICRO, one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

OPT = config.OptimConfig(warmup_epochs=0, weight_decay=0.05)


def named_params(tp: int = 1) -> dict:
    """The micro model's parameters, or rank 0's tensor-parallel shard of
    them (``tp_split`` marked), by name."""
    cfg = config.ModelConfig(**MICRO, loss_type=config.LossType(itm=True, mlm=True, t2i=True))
    torch.manual_seed(1)
    model = create_model(cfg, device="cpu", input_size=MICRO["img_size"])
    if tp == 1:
        return dict(model.named_parameters())
    out = {}
    for n, p in model.named_parameters():
        kind = tensor.split_of(n, cfg, tp)
        q = torch.nn.Parameter(tensor.shard_tensor(p.detach(), kind, 0, tp))
        if kind:
            q.tp_split = kind
        out[n] = q
    return out


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("dp", [2, 4])
def test_zero1_dim_is_jax_zero1_spec(dp, tp):
    """zero1_dim of each parameter (its shard's shape under tp) is the dim
    _zero1_spec shards over the data axis for that shape with the model
    axis where the tensor-parallel split lies; none where it picks none."""
    dims = {"row": 0, "kv": 0, "col": 1}
    picked = 0
    for name, p in named_params(tp).items():
        tp_dim = dims.get(getattr(p, "tp_split", None))
        spec = P(*[MODEL_AXIS if i == tp_dim else None for i in range(p.dim())])
        leaf = types.SimpleNamespace(shape=tuple(p.shape), ndim=p.dim())
        jax_spec = list(_zero1_spec(spec, leaf, {DATA_AXIS: dp, MODEL_AXIS: tp}))
        want = jax_spec.index(DATA_AXIS) if DATA_AXIS in jax_spec else None
        assert zero1_dim(p, dp) == want, name
        picked += want is not None
    assert picked > 0


def moment_bytes(params, dp: int) -> tuple:
    """(bytes of the moments that split, of those that do not), fp32 x 2."""
    sharded = sum(2 * p.numel() * p.element_size() for p in params if zero1_dim(p, dp) is not None)
    whole = sum(2 * p.numel() * p.element_size() for p in params if zero1_dim(p, dp) is None)
    return sharded, whole


def grads_for(params, seed: int) -> list:
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(p.shape, generator=gen) for p in params]


def holder(params) -> torch.nn.Module:
    """A module holding copies of ``params`` in their order."""
    model = torch.nn.Module()
    model.ps = torch.nn.ParameterList([torch.nn.Parameter(p.detach().clone()) for p in params])
    return model


def run_steps(model, opt, steps) -> None:
    """One step of ``opt`` per (grads in the model's order, lr) of ``steps``."""
    for grads, lr in steps:
        for p, g in zip(model.ps, grads):
            p.grad = g.clone()
        set_lr(opt, lr)
        opt.step()


def adamw_run(params, steps) -> torch.optim.AdamW:
    """torch.optim.AdamW over copies of ``params`` (make_optimizer's groups)
    after ``steps``."""
    model = holder(params)
    opt = make_optimizer(OPT, model)
    run_steps(model, opt, steps)
    return opt


@pytest.mark.parametrize("dp", [2, 4])
def test_zero1_steps_equal_adamw(monkeypatch, dp):
    """Two steps: every rank's parameters equal AdamW's bit for bit; each
    rank's moments are its slices of AdamW's (the whole moment where no dim
    splits), in exactly sharded / dp + whole bytes."""
    patched(monkeypatch)
    params = list(named_params().values())
    steps = [(grads_for(params, 3), 1e-3), (grads_for(params, 4), 5e-4)]
    want = adamw_run(params, steps)
    want_params = [p for g in want.param_groups for p in g["params"]]
    sharded, whole = moment_bytes(params, dp)
    assert sharded > 0 and whole > 0
    group = ThreadGroup(dp)

    def rank(r):
        model = holder(params)
        opt = make_optimizer(OPT, model, zero1_group=group)
        assert isinstance(opt, Zero1AdamW)
        run_steps(model, opt, steps)
        return opt

    for r, opt in enumerate(run_ranks(group, rank)):
        got = [p for g in opt.param_groups for p in g["params"]]
        nbytes = 0
        for p, w in zip(got, want_params):
            assert torch.equal(p, w)
            st, ws = opt.state[p], want.state[w]
            dim = zero1_dim(p, dp)
            for key in ("exp_avg", "exp_avg_sq"):
                piece = ws[key] if dim is None else ws[key].chunk(dp, dim)[r]
                assert torch.equal(st[key], piece), key
                nbytes += st[key].numel() * st[key].element_size()
            assert float(st["step"]) == float(ws["step"]) == 2.0
        assert nbytes == sharded // dp + whole


@pytest.mark.parametrize("dp", [2, 4])
def test_zero1_state_dict_round_trip(monkeypatch, dp):
    """AdamW's state dict after two steps (a world-1 checkpoint's) loads
    into each rank's slices; gathered whole it equals AdamW's, and the
    next step equals AdamW's next step. Before the gather the sharded
    state dict is refused."""
    patched(monkeypatch)
    params = list(named_params().values())
    plain_model = holder(params)
    plain = make_optimizer(OPT, plain_model)
    run_steps(plain_model, plain, [(grads_for(params, 5), 1e-3), (grads_for(params, 6), 1e-3)])
    saved = copy.deepcopy(plain.state_dict())   # the live state moves on
    start = [p.detach().clone() for p in plain_model.ps]
    last = [(grads_for(params, 7), 1e-3)]
    run_steps(plain_model, plain, last)
    after = [p.detach() for p in plain_model.ps]
    # the state dict's index order: make_optimizer's groups, matrices first
    order = [i for g in plain.param_groups for i, p in enumerate(plain_model.ps)
             for q in g["params"] if q is p]
    group = ThreadGroup(dp)

    def rank(r):
        model = holder(start)
        opt = make_optimizer(OPT, model, zero1_group=group)
        opt.load_state_dict(saved)
        listed = [p for g in opt.param_groups for p in g["params"]]
        sliced = {i: {k: v.clone() for k, v in opt.state[p].items()}
                  for i, p in enumerate(listed)}
        with pytest.raises(RuntimeError, match="consolidate_state_dict"):
            opt.state_dict()
        opt.consolidate_state_dict()
        whole = copy.deepcopy(opt.state_dict())   # before the step moves it
        run_steps(model, opt, last)
        return sliced, whole, [p.detach() for p in model.ps]

    for r, (sliced, whole, got) in enumerate(run_ranks(group, rank)):
        assert whole["param_groups"] == saved["param_groups"]
        assert sorted(whole["state"]) == sorted(saved["state"])
        for i, st in saved["state"].items():
            dim = zero1_dim(params[order[i]], dp)
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(whole["state"][i][key], st[key]), (i, key)
                piece = st[key] if dim is None else st[key].chunk(dp, dim)[r]
                assert torch.equal(sliced[i][key], piece), (i, key)
        for p, w in zip(got, after):
            assert torch.equal(p, w)
    assert np.isfinite(float(sum(p.abs().sum() for p in after)))
