"""Swin under sequence parallelism and sequence parallelism together with
tensor-parallel weights, piece by piece, with the ranks of a model group as
threads of this process (tests/_thread_ranks.py: torch.distributed's
all_reduce sums the threads' tensors), in fp64 against the whole tensors of
one process.

  * the shifted windows' exchange (parallel/sequence.py:roll_rows): each
    rank's band of the grid rolled by -s and by +s rows is the band of
    ``torch.roll`` of the whole grid, cyclically (the last rank takes rank
    0's rows);
  * a band's windows and masks: the band of whole window rows, rolled
    across the bands and along x locally, cuts into the whole grid's
    windows of its window rows (sequence.band_windows), and only the last
    rank's last window row holds the shifted region masks along y;
  * the text queries' pooled K/V: each rank pools its band (whole pool
    windows) and the gathered rows are the whole grid's average pool;
    a band's own grid would take a pool window of half the size;
  * the all-gather / reduce-scatter pair (sequence.gather_kv,
    sequence.scatter_rows): each one's forward and backward against the
    whole tensors;
  * SwinJointAttention on each rank's band (training mode, and eval mode
    on the serving route, kernel F's plain version on the CPU) against the
    whole stream's rows, and the rank's input and parameter gradients
    summed over the ranks against the whole ones;
  * the whole train step of sequence parallelism with tensor-parallel
    weights (v1 on both attention routes, the fused one in both forms, v2,
    linear v2 and Swin at sp 2, Swin at sp 4, and with dropout, DropPath
    and --remat) against one process's: the consolidated
    gradients within 1e-6 of each tensor's largest magnitude, the generator
    at one process's state, and the gradient bookkeeping (a shard's
    gradient whole, every other parameter of a split stage's block summed
    once) shown by planting each wrong choice.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mvlt_tpu_torch import config
from mvlt_tpu_torch.models.pvlt import create_model
from mvlt_tpu_torch.models.swin import (TEXT_POOL, SwinJointAttention, window_masks,
                                        window_partition)
from mvlt_tpu_torch.parallel import sequence, tensor
from mvlt_tpu_torch.train.state import create_train_state
from mvlt_tpu_torch.train.step import make_train_step
from tests._thread_ranks import ThreadGroup, patched, run_ranks
from tests.test_torch_port_ddp import PORT_TOL, assert_close_to_max
from tests.test_torch_port_tp_families import global_batch
from tests.test_torch_port_train import MICRO, one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

F64 = dict(rtol=1e-12, atol=1e-12)


def _f64(gen, *shape):
    return torch.randn(*shape, generator=gen, dtype=torch.float64)


@pytest.mark.parametrize("n,s", [(2, 2), (2, -2), (4, 1), (4, -4)])
def test_roll_rows_is_torch_roll_of_the_whole_grid(n, s):
    gen = torch.Generator().manual_seed(n + 10 * s)
    h, w, b, c = 16, 5, 2, 3
    grid = _f64(gen, b, h * w, c)
    want = torch.roll(grid.reshape(b, h, w, c), s, 1).reshape(b, h * w, c)
    plans = [sequence.row_plan(h, w, 8, 4, n, r) for r in range(n)]
    bands = [grid[:, r * p.hb * w:(r + 1) * p.hb * w] for r, p in enumerate(plans)]
    edges = [sequence.roll_edge(x, p, s) for x, p in zip(bands, plans)]
    for r, p in enumerate(plans):
        got = sequence.roll_join(bands[r], edges[sequence.roll_partner(p, s)], p, s)
        torch.testing.assert_close(got, want[:, r * p.hb * w:(r + 1) * p.hb * w], **F64)


@pytest.mark.parametrize("n,w", [(2, 12), (4, 10)])
def test_band_windows_and_masks_are_the_whole_grids(n, w):
    """Rolled by -s across the bands and along x locally, each band cuts
    into the whole grid's windows of its window rows; the whole masks'
    window-row slices carry the region masks along y on the last rank's
    last window row only (w = 10: the last window column padded)."""
    gen = torch.Generator().manual_seed(n)
    h, ws, b, c = 16, 4, 2, 3
    s = ws // 2
    grid = _f64(gen, b, h * w, c)
    whole = window_partition(grid, (h, w), ws, s)
    masks = torch.from_numpy(window_masks(h, w, ws, s))
    per_row = -(-w // ws)
    for r in range(n):
        plan = sequence.row_plan(h, w, 8, ws, n, r)
        band = torch.roll(grid.reshape(b, h, w, c), -s, 1).reshape(b, h * w, c)[
            :, r * plan.hb * w:(r + 1) * plan.hb * w]
        got = window_partition(band, plan.hw, ws, s, rows=False)
        sl = sequence.band_windows(plan, ws)
        torch.testing.assert_close(got, whole[:, sl], **F64)
        band_masks = masks[sl]
        last_row = band_masks[-per_row:]
        if r < n - 1:          # no y region boundary: the first window row's masks
            assert torch.equal(band_masks, masks[:per_row].repeat(plan.hb // ws, 1, 1))
        else:
            assert not torch.equal(last_row, masks[:per_row])


@pytest.mark.parametrize("n", [2, 4])
def test_pooled_kv_of_the_bands_is_the_whole_pool(monkeypatch, n):
    """Each rank pools its band in windows of the whole grid's
    (h // TEXT_POOL) and the gathered pooled rows are the whole grid's
    average pool; the band's own grid would give windows of another size."""
    patched(monkeypatch)
    gen = torch.Generator().manual_seed(n)
    h, w, b, c, t = 32, 12, 2, 5, 8
    win = h // TEXT_POOL
    grid = _f64(gen, b, h, w, c)
    want = F.avg_pool2d(grid.permute(0, 3, 1, 2), win, win).flatten(2).transpose(1, 2)
    group = ThreadGroup(n)

    def rank(r):
        plan = sequence.row_plan(h, w, t, win, n, r, group)
        band = grid[:, r * plan.hb:(r + 1) * plan.hb].permute(0, 3, 1, 2)
        assert max(1, plan.hb // TEXT_POOL) != win
        pooled = F.avg_pool2d(band, win, win).flatten(2).transpose(1, 2)
        return sequence.gather_kv(pooled, plan, pooled.shape[1], dim=1)

    for got in run_ranks(group, rank):
        torch.testing.assert_close(got, want, **F64)


@pytest.mark.parametrize("n", [2, 4])
def test_all_gather_and_reduce_scatter_pair(monkeypatch, n):
    """gather_kv gives the whole stream from the bands and its backward the
    band's rows of the ranks' gradients summed; scatter_rows gives the
    band's rows of the ranks' partials summed and its backward the whole
    gradient from the bands'."""
    patched(monkeypatch)
    gen = torch.Generator().manual_seed(n)
    h, w, t, b, c = 8, 3, 8, 2, 4
    whole = _f64(gen, b, h * w + t, c)
    partials = _f64(gen, n, b, h * w + t, c)
    cot = _f64(gen, n, b, h * w + t, c)        # each rank's gradient of the gathered stream
    group = ThreadGroup(n)

    def rank(r):
        plan = sequence.row_plan(h, w, t, 1, n, r, group)
        mv = plan.hb * w
        band = sequence.take(whole, plan, mv).requires_grad_(True)
        gathered = sequence.gather_kv(band, plan, mv, dim=1)
        (gathered * cot[r]).sum().backward()
        part = partials[r].clone().requires_grad_(True)
        scattered = sequence.scatter_rows(part, plan)
        (scattered * sequence.take(cot[0], plan, mv)).sum().backward()
        return (gathered.detach(), band.grad, sequence.take(cot.sum(0), plan, mv),
                scattered.detach(), sequence.take(partials.sum(0), plan, mv), part.grad)

    for gathered, dband, want_dband, scattered, want_scattered, dpart in run_ranks(group, rank):
        torch.testing.assert_close(gathered, whole, **F64)
        torch.testing.assert_close(dband, want_dband, **F64)
        torch.testing.assert_close(scattered, want_scattered, **F64)
        torch.testing.assert_close(dpart, cot[0], **F64)


@pytest.mark.parametrize("n,hw,shift,training", [
    (2, (16, 12), True, True), (2, (16, 12), False, True), (2, (16, 10), True, False),
    (4, (16, 16), True, True), (4, (32, 8), True, False),
])
def test_swin_attention_on_bands_is_the_whole_streams(monkeypatch, n, hw, shift, training):
    """SwinJointAttention on each rank's band (windows of 4, x padded where
    4 does not divide w; pool windows of h // 8) equals the whole stream's
    rows; in training mode the rank's input gradients are the whole input
    gradient's rows and the parameter gradients, summed over the ranks, the
    whole ones (the bias table's within fp32, in which its bias is formed)."""
    patched(monkeypatch)
    gen = torch.Generator().manual_seed(n + 7 * shift)
    b, c, heads, ws, t = 2, 16, 2, 4, 8
    h, w = hw
    torch.manual_seed(n)
    attn = SwinJointAttention(c, heads, ws, shift, True, ws).double()
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(_f64(gen, *p.shape) * 0.5)
    attn.train(training)
    x = _f64(gen, b, h * w + t, c).requires_grad_(training)
    cot = _f64(gen, b, h * w + t, c)
    with torch.set_grad_enabled(training):
        want = attn(x, hw, t)
    if training:
        (want * cot).sum().backward()
    group = ThreadGroup(n)

    def rank(r):
        mine = copy.deepcopy(attn)
        mine.zero_grad()
        plan = sequence.row_plan(h, w, t, sequence.stage_unit(
            config.ModelConfig(variant="swin", window_size=ws), 0, hw), n, r, group)
        assert plan.split
        mv = plan.hb * w
        xb = sequence.take(x.detach(), plan, mv).requires_grad_(training)
        with torch.set_grad_enabled(training):
            out = mine(xb, plan.hw, t, sp=plan)
        if training:
            (out * sequence.take(cot, plan, mv)).sum().backward()
        return (out.detach(), xb.grad, {k: p.grad for k, p in mine.named_parameters()},
                sequence.take(want.detach(), plan, mv),
                sequence.take(x.grad, plan, mv) if training else None)

    res = run_ranks(group, rank)
    for out, dx, _, want_rows, want_dx in res:
        torch.testing.assert_close(out, want_rows, **F64)
        if training:
            torch.testing.assert_close(dx, want_dx, **F64)
    if training:
        for k, p in attn.named_parameters():
            got = sum(r[2][k] for r in res)
            tol = 2e-6 if k == "relative_position_bias_table" else 1e-12
            assert float((got - p.grad).abs().max()) <= tol * float(p.grad.abs().max()), k


HEADS = dict(itm=True, mlm=True, t2i=True, cls=True)
DROP = dict(drop_rate=0.1, drop_path_rate=0.1, bert_dropout=0.1)
# label: (registry model, overrides, model group size)
SPTP_STEPS = {
    "v1": ("pvlt_tiny", {}, 2),
    "v1_fused": ("pvlt_tiny", {"fused_attn_train": True}, 2),
    "v1_fused_stats": ("pvlt_tiny", {"fused_attn_train": True, "fused_attn_stats": True}, 2),
    "v2": ("pvlt_v2_tiny", {}, 2),
    "linear": ("pvlt_v2_linear_tiny", {}, 2),
    "swin": ("pvlt_swin_tiny", {"window_size": 4}, 2),
    "swin_sp4": ("pvlt_swin_tiny", {"window_size": 4}, 4),
    "dropout_v1": ("pvlt_tiny", {"sr_ratios": (4, 2, 1, 1), **DROP, "attn_drop_rate": 0.1}, 2),
    "dropout_v2": ("pvlt_v2_tiny", {"sr_ratios": (4, 2, 1, 1), **DROP}, 2),
    "remat_swin": ("pvlt_swin_tiny", {"window_size": 4, **DROP, "remat": True}, 2),
}


def sptp_step(cfg, sd, batch, n, sum_shards: bool = False, skip_bias: bool = False):
    """One step of sequence parallelism with tensor-parallel weights over n
    thread ranks: each rank's (consolidated gradients, losses, stages
    split, generator state). ``sum_shards`` / ``skip_bias`` plant the two
    wrong choices of the gradient bookkeeping."""
    group = ThreadGroup(n)

    def params(model):
        return [p for i, split in enumerate(model.sp_split) if split
                for name, p in getattr(model, f"block{i + 1}").named_parameters()
                if sum_shards or not (getattr(p, "tp_split", None) or (
                    skip_bias and name.endswith(("proj.bias", "fc2.bias"))))]

    def rank(r):
        model = create_model(cfg, device="cpu", input_size=64, sp_group=group).double()
        model.load_state_dict(sd, strict=True)
        tensor.shard_model(model, group)
        state = create_train_state(model, config.OptimConfig(warmup_epochs=0), 8, 10, seed=0,
                                   model_group=group)
        state, losses = make_train_step(cfg)(state, batch)
        grads = tensor.consolidate({k: p.grad for k, p in model.named_parameters()}, group, cfg)
        return grads, losses, model.sp_split, state.generator.get_state()

    if sum_shards or skip_bias:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sequence, "row_grad_params", params)
            return run_ranks(group, rank)
    return run_ranks(group, rank)


@pytest.mark.parametrize("label", sorted(SPTP_STEPS))
def test_sptp_step_matches_one_process(monkeypatch, label):
    """The step of a model whose model group splits both its stages' rows
    and its weights equals one process's step from the same weights and
    seed (fp64): every consolidated gradient within PORT_TOL of its largest
    magnitude, the losses, the generator's state after (every mask the
    one-process mask's part); the ranks hold the same consolidated
    gradients. With the shards' gradients summed too, or the band's
    out-projection and fc2 biases left unsummed, gradients land far
    outside."""
    patched(monkeypatch)
    name, overrides, n = SPTP_STEPS[label]
    cfg = config.ModelConfig(**{**MICRO, "img_size": 64, "name": name,
                                "compute_dtype": "float64", **overrides},
                             loss_type=config.LossType(**HEADS))
    batch = global_batch(41)
    torch.manual_seed(3)
    model = create_model(cfg, device="cpu", input_size=64).double()
    sd = copy.deepcopy(model.state_dict())
    state = create_train_state(model, config.OptimConfig(warmup_epochs=0), 8, 10, seed=0)
    state, losses = make_train_step(cfg)(state, batch)
    want = {k: p.grad for k, p in model.named_parameters()}
    res = sptp_step(cfg, sd, batch, n)
    assert any(res[0][2])
    for grads, got_losses, _, gen in res:
        assert_close_to_max(grads, want, PORT_TOL, f"{label} grads")
        for k, v in losses.items():
            assert abs(float(got_losses[k]) - float(v)) <= PORT_TOL * max(abs(float(v)), 1e-12)
        assert torch.equal(gen, state.generator.get_state())
    if label in ("v1", "v1_fused", "swin"):
        for wrong in (dict(sum_shards=True), dict(skip_bias=True)):
            grads = sptp_step(cfg, sd, batch, n, **wrong)[0][0]
            gaps = [float((grads[k] - w).abs().max() / w.abs().max()) for k, w in want.items()
                    if w.abs().max() > 0]
            assert max(gaps) > 1e3 * PORT_TOL, wrong
    np.testing.assert_equal([r[2] for r in res], [res[0][2]] * n)
