"""Training-time dropout and ``--remat`` of the port, on the CPU.

The two frameworks draw different random streams, so dropout is held to its
law: the stage dropout after the pos-embeds, the projection and MLP dropout
and the attention-probability dropout keep an element with probability
1 - rate and scale it by 1 / (1 - rate); DropPath draws once per sample, on
Swin blocks too. Dropout picks the routes the JAX package picks
(mvlt_tpu/models/pvlt.py:227, :861-866, :925-930): no LN-MLP kernel with
``drop_rate``, no fused attention half with either rate, no attention kernel
with ``attn_drop_rate`` in training mode. ``--remat`` (torch.utils.checkpoint
per block) gives the step of the same generator without it: the same losses
and gradients and the same generator state after, with DropPath and dropout
on, on the default route, on fused_attn_stats, for v2 with linear SR and for
Swin; a recompute that drew new masks would fail it.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from mvlt_tpu_torch import config
from mvlt_tpu_torch.models import pvlt
from mvlt_tpu_torch.models.pvlt import Block, SwinBlock, attention_dropout, create_model
from mvlt_tpu_torch.ops import block_attention, fused_mlp, pallas_attention
from mvlt_tpu_torch.train.state import create_train_state
from mvlt_tpu_torch.train.step import make_train_step
from tests.test_torch_port_train import MICRO, make_batch, one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

HEADS = config.LossType(itm=True, mlm=True, t2i=True, cls=False)


def _cfg(name="pvlt_tiny", img=32, **extra):
    return config.ModelConfig(**{**MICRO, "img_size": img, **extra}, name=name, loss_type=HEADS)


def _keep_law(got: torch.Tensor, base: torch.Tensor, rate: float, tol: float) -> None:
    """got is base with each element kept at probability 1 - rate, scaled
    by 1 / (1 - rate), or zeroed."""
    keep = 1.0 - rate
    kept = got != 0
    assert abs(kept.float().mean().item() - keep) < tol
    torch.testing.assert_close(got[kept], base[kept] / keep)


def test_attention_dropout_statistics():
    """Uniform probabilities 1/M times an identity V: the output is the
    dropped probability matrix itself."""
    m = 64
    q = torch.zeros(4, 2, 128, m)
    v = torch.eye(m).expand(4, 2, m, m)
    gen = torch.Generator().manual_seed(0)
    out = attention_dropout(q, q[:, :, :m], v, 1.0, 0.2, gen)
    _keep_law(out, torch.full_like(out, 1.0 / m), 0.2, 0.01)


def test_projection_and_mlp_dropout_statistics():
    blk = Block(16, 1, 2.0, 1, True, drop=0.3).train()
    gen = torch.Generator().manual_seed(1)
    ones = torch.ones(64, 50, 16)
    _keep_law(blk.dropout(ones, gen), ones, 0.3, 0.01)
    assert blk.eval().dropout(ones, gen) is ones


def test_stage_dropout_statistics():
    """Stage 1's joint stream after the pos-embeds, as its first block sees
    it, against the same model without drop_rate."""
    seen = {}
    for rate in (0.0, 0.25):
        torch.manual_seed(0)
        model = create_model(_cfg(drop_rate=rate, drop_path_rate=0.0, bert_dropout=0.0),
                             device="cpu").train()
        for i in range(1, 5):
            getattr(model, f"block{i}")[0].register_forward_pre_hook(
                lambda m, args, i=i: seen.__setitem__((rate, i), args[0].detach()))
        model(torch.rand(8, 32, 32, 3, generator=torch.Generator().manual_seed(2)),
              torch.zeros(8, 16, dtype=torch.long), generator=torch.Generator().manual_seed(3))
    _keep_law(seen[(0.25, 1)], seen[(0.0, 1)], 0.25, 0.02)


def test_drop_path_is_one_draw_per_sample_on_swin():
    """A Swin block at drop path 0.5: a sample whose two draws both drop
    leaves the block unchanged, one with a kept draw does not; the draws
    are per sample (B of them per residual)."""
    blk = SwinBlock(16, 2, 2.0, True, 4, True, 4, drop_path=0.5).train()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(400, 64 + 3, 16, generator=gen)
    draws = []
    real = blk.drop_path_scale
    with mock.patch.object(blk, "drop_path_scale",
                           lambda x, g: draws.append(real(x, g)) or draws[-1]):
        out = blk(x, (8, 8), gen)
    assert [tuple(d.shape) for d in draws] == [(400,), (400,)]
    both_dropped = (draws[0] == 0) & (draws[1] == 0)
    unchanged = (out == x).flatten(1).all(1)
    assert torch.equal(unchanged, both_dropped)
    assert abs(both_dropped.float().mean().item() - 0.25) < 0.07
    assert set(torch.cat(draws).unique().tolist()) == {0.0, 2.0}


@pytest.mark.parametrize("rates,train_mode,ln_mlp,attention,fused", [
    (dict(drop_rate=0.1), True, 0, 8, 0),           # glue MLP; #10 kept
    (dict(attn_drop_rate=0.1), True, 8, 0, 0),      # LN-MLP kernel kept; no #10
    (dict(attn_drop_rate=0.1), False, 8, 8, 0),     # eval mode: dropout off, #10 back
    (dict(), True, 8, 0, 8),                        # fused route without dropout
])
def test_dropout_routes_as_jax(rates, train_mode, ln_mlp, attention, fused):
    """Calls of the LN-MLP, attention and fused attention wrappers in one
    step with fused_attn_train on (a v1 model: 8 blocks)."""
    cfg = _cfg(fused_attn_train=True, **rates)
    torch.manual_seed(0)
    state = create_train_state(create_model(cfg, device="cpu"),
                               config.OptimConfig(warmup_epochs=0), 8, 2)
    batch = make_batch(np.random.default_rng(0), b=8)
    with mock.patch.object(fused_mlp, "ln_mlp_fwd", wraps=fused_mlp.ln_mlp_fwd) as mlp, \
            mock.patch.object(pallas_attention, "attention_fwd",
                              wraps=pallas_attention.attention_fwd) as attn, \
            mock.patch.object(block_attention, "block_attention_train_fwd",
                              wraps=block_attention.block_attention_train_fwd) as fba:
        _, losses = make_train_step(cfg, train_mode=train_mode)(state, batch)
    assert (mlp.call_count, attn.call_count, fba.call_count) == (ln_mlp, attention, fused)
    assert all(np.isfinite(float(v)) for v in losses.values())


REMAT_CASES = {
    "default": ("pvlt_tiny", 32, dict(drop_rate=0.1, attn_drop_rate=0.1)),
    "fused_attn_stats": ("pvlt_tiny", 32, dict(fused_attn_train=True, fused_attn_stats=True)),
    "v2_linear": ("pvlt_v2_linear_tiny", 64, dict(drop_rate=0.1, attn_drop_rate=0.1)),
    "swin": ("pvlt_swin_tiny", 96, dict(drop_rate=0.1)),
}


@pytest.mark.parametrize("case", list(REMAT_CASES))
def test_remat_step_equals_the_step_without_it(case):
    """Two steps (clean, then masked images) with DropPath 0.3 and BERT
    dropout on, plus the case's dropout: remat recomputes each block in the
    backward with the masks it drew in the forward."""
    name, img, extra = REMAT_CASES[case]
    runs = {}
    for remat in (False, True):
        cfg = _cfg(name, img, drop_path_rate=0.3, bert_dropout=0.1, remat=remat, **extra)
        torch.manual_seed(0)
        state = create_train_state(create_model(cfg, device="cpu", input_size=img),
                                   config.OptimConfig(warmup_epochs=0), 8, 2, seed=5)
        batch = make_batch(np.random.default_rng(0), b=8, img=img)
        step = make_train_step(cfg)
        with mock.patch.object(pvlt, "checkpoint", wraps=pvlt.checkpoint) as ckpt:
            losses = [step(state, batch)[1] for _ in range(2)]
        assert ckpt.call_count == (2 * sum(cfg.depths) if remat else 0)
        runs[remat] = (losses, {n: p.grad.clone() for n, p in state.model.named_parameters()
                                if p.grad is not None},
                       {n: p.detach().clone() for n, p in state.model.named_parameters()},
                       state.generator.get_state())
    (l0, g0, p0, r0), (l1, g1, p1, r1) = runs[False], runs[True]
    for a, b in zip(l0, l1):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=1e-6, atol=1e-7, msg=k)
    assert sorted(g0) == sorted(g1)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-5, atol=1e-7, msg=n)
    for n in p0:
        torch.testing.assert_close(p1[n], p0[n], rtol=1e-5, atol=1e-7, msg=n)
    assert torch.equal(r0, r1)


def test_remat_draws_nothing_outside_training():
    """In eval mode with no gradient wanted remat is off: serving runs the
    blocks as they are."""
    model = create_model(_cfg(remat=True), device="cpu").eval()
    with mock.patch.object(pvlt, "checkpoint") as ckpt, torch.no_grad():
        model(torch.rand(2, 32, 32, 3), torch.zeros(2, 16, dtype=torch.long))
    assert ckpt.call_count == 0
