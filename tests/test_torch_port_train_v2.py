"""The port's PVT-v2 and linear-SR PVT-v2 training steps against the JAX
package's, on the CPU.

The micro config of tests/test_torch_port_train.py (ITM + MLM + T2I, fp32,
DropPath and BERT dropout off, B = 40 so that the MLM gather plan is active)
as ``pvlt_v2_tiny`` and ``pvlt_v2_linear_tiny`` at 64x64, where stage 1's
16x16 grid pools to 8x8 under linear SR (windows of 16 // 7 = 2; an
adaptive 7x7 pool would differ). The JAX side runs its XLA path
(use_pallas_attention=False): conv-SR or linear-SR JointSRAttention and the
XLA DWConvMlp. At step 0, step 1 (masked images) and train_mode=False the
losses agree to 2e-4, every gradient to 1e-3 of its tensor's largest
magnitude and the BatchNorm statistics to 2e-4, as for v1. Then linear-SR
serving against JAX (ITM logits to 2e-4), the floored pool's arithmetic at
the 256x256 grids, and the v1-only fused attention route.
"""

import dataclasses
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from mvlt_tpu import config as jax_config
from mvlt_tpu_torch import config
from mvlt_tpu_torch.convert import state_dict_from_jax
from mvlt_tpu_torch.models.pvlt import Block, create_model
from mvlt_tpu_torch.ops import block_attention, pallas_attention
from mvlt_tpu_torch.ops.sr_kv import linear_reduce_kv_input
from mvlt_tpu_torch.train.state import create_train_state
from mvlt_tpu_torch.train.step import make_train_step
from tests.test_torch_port_train import (HEADS, MICRO, _numpy_weights, build_jax_step,
                                         check_step_against_jax, make_batch, one_torch_thread)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

IMG = 64
NAMES = ("pvlt_v2_tiny", "pvlt_v2_linear_tiny")


def _configs(name, heads=HEADS, **extra):
    micro = {**MICRO, "img_size": IMG, **extra}
    return (jax_config.ModelConfig(**micro, name=name, use_pallas_attention=False,
                                   loss_type=jax_config.LossType(**heads)),
            config.ModelConfig(**micro, name=name, loss_type=config.LossType(**heads)))


@pytest.fixture(scope="module", params=NAMES)
def v2_step(request):
    return build_jax_step(*_configs(request.param), img=IMG)


@pytest.mark.parametrize("step,train_mode", [(0, True), (1, True), (0, False)])
def test_v2_step_matches_jax(v2_step, step, train_mode):
    """Losses, every gradient (the depthwise conv's and, under linear SR,
    the 1x1 conv's too) and the new BatchNorm statistics."""
    check_step_against_jax(v2_step, v2_step[1], step, train_mode)


def test_linear_sr_serving_matches_jax():
    """pvlt_v2_linear_tiny in eval mode: the five logits against the JAX
    model's, to 2e-4; stages 1-3 pool, stage 4 (sr = 1) does not."""
    from mvlt_tpu.models import create_model as jax_create_model

    heads = dict(itm=True, mlm=True, t2i=True, cls=True)
    jcfg, pcfg = _configs("pvlt_v2_linear_tiny", heads)
    model = jax_create_model(jcfg)
    params, stats = _numpy_weights(model, seed=3, img=IMG)
    batch = make_batch(np.random.default_rng(4), b=2, img=IMG)
    want = jax.jit(lambda p, s, im, ids: model.apply(
        {"params": p, "batch_stats": s}, im, ids, train=False))(
        params, stats, batch["images"], batch["input_ids"])
    port = create_model(pcfg, device="cpu").eval()
    port.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    blocks = [m for m in port.modules() if isinstance(m, Block)]
    assert [b.attn.linear_sr for b in blocks] == [True] * 6 + [False] * 2
    with torch.no_grad():
        got = port(torch.from_numpy(batch["images"]), torch.from_numpy(batch["input_ids"]).long())
    for k in ("mlm_logits", "itm_logits", "sup_cls_logits", "sub_cls_logits", "t2i_logits"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=2e-4, atol=2e-4,
                                   err_msg=k)


@pytest.mark.parametrize("grid,pooled", [(64, 7), (32, 8), (16, 8), (8, 8), (5, 5)])
def test_linear_sr_pool_floors_its_windows(grid, pooled):
    """The pool's windows are (h // p, w // p) with p = min(7, h, w), as
    strides too, the partial last window dropped: M = pooled^2 + T (177,
    192, 192 at the 256x256 stages), each pooled cell the mean of its
    window."""
    gen = torch.Generator().manual_seed(0)
    d, t = 8, 3
    normed = torch.randn(2, grid * grid + t, d, generator=gen)
    eye = torch.eye(d)[:, :, None, None]
    out = linear_reduce_kv_input(normed, (grid, grid), eye, None, torch.ones(d),
                                 torch.zeros(d), 1e-5)
    assert out.shape == (2, pooled * pooled + t, d)
    torch.testing.assert_close(out[:, pooled * pooled:], normed[:, grid * grid:])
    win = grid // min(7, grid)
    cells = normed[:, : grid * grid].reshape(2, grid, grid, d)[:, : pooled * win, : pooled * win]
    mean = cells.reshape(2, pooled, win, pooled, win, d).mean((2, 4)).reshape(2, -1, d)
    want = torch.nn.functional.gelu(torch.nn.functional.layer_norm(mean, (d,), eps=1e-5))
    torch.testing.assert_close(out[:, : pooled * pooled], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_v2_ignores_fused_attn_train(name):
    """fused_attn_train is v1's route (mvlt_tpu/models/pvlt.py:861-866): a v2
    step with the flag set runs its attention on #10/#11's wrappers, once
    per block, and never the fused attention half; the step equals one
    without the flag."""
    pcfg = _configs(name)[1]
    torch.manual_seed(0)
    weights = create_model(pcfg, device="cpu").state_dict()
    batch = make_batch(np.random.default_rng(0), b=8, img=IMG)
    losses = {}
    for fused in (False, True):
        cfg = dataclasses.replace(pcfg, fused_attn_train=fused, fused_attn_stats=fused)
        model = create_model(cfg, device="cpu")
        model.load_state_dict(weights)
        state = create_train_state(model, config.OptimConfig(warmup_epochs=0), 8, 1)
        with mock.patch.object(block_attention, "block_attention_train_fwd",
                               wraps=block_attention.block_attention_train_fwd) as fba, \
                mock.patch.object(pallas_attention, "attention_fwd",
                                  wraps=pallas_attention.attention_fwd) as attn:
            state, losses[fused] = make_train_step(cfg)(state, batch)
        assert fba.call_count == 0 and attn.call_count == sum(cfg.depths)
    for k, v in losses[False].items():
        assert float(v) == float(losses[True][k]), k
