"""The training path's kernel twins and helpers against the JAX package.

The plain versions the Hopper kernels are held to on the card
(ops/pallas_attention.py, ops/fused_mlp.py) are held here to the Pallas
kernels they replace, run in interpret mode on the CPU, forward and
gradients, in fp32 at rtol = atol = 1e-4 (the JAX kernels take one-pass LN
statistics and exp2 softmax). Both autograd Functions pass gradcheck in
fp64. The heads' BatchNorm, the upsample, the MLM gather plan, the LR
schedule and AdamW are held to their JAX counterparts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mvlt_tpu_torch.config import OptimConfig
from mvlt_tpu_torch.models.heads import ConvBN
from mvlt_tpu_torch.ops.fused_mlp import (fused_ln_mlp, ln_mlp_bwd_reference,
                                          ln_mlp_reference)
from mvlt_tpu_torch.ops.pallas_attention import (attention_bwd_reference,
                                                 attention_reference, fused_attention)
from mvlt_tpu_torch.ops.upsample import upsample_bilinear_align_corners
from mvlt_tpu_torch.train import losses, schedule
from tests.kernel_utils import run_interpret

TOL = dict(rtol=1e-4, atol=1e-4)
T = torch.from_numpy


@pytest.mark.parametrize("b,h,n,m,hd", [(2, 2, 96, 48, 32),    # stage-like
                                        (1, 2, 40, 20, 16)])   # ragged M
def test_attention_twins_match_pallas(b, h, n, m, hd):
    from mvlt_tpu.ops.pallas_attention import fused_attention_vjp

    rng = np.random.default_rng(n)
    q, k, v, do = (rng.normal(size=s).astype(np.float32)
                   for s in ((b, h, n, hd), (b, h, m, hd), (b, h, m, hd), (b, h, n, hd)))
    scale = 1.5 * hd ** -0.5      # peaked softmax, not near uniform

    def loss(q, k, v):
        return jnp.sum(fused_attention_vjp(q, k, v, scale) * do)

    want_o = run_interpret(fused_attention_vjp, q, k, v, scale)
    want_g = run_interpret(jax.grad(loss, argnums=(0, 1, 2)), q, k, v)
    np.testing.assert_allclose(attention_reference(T(q), T(k), T(v), scale).numpy(),
                               np.asarray(want_o), **TOL)
    for got, want in zip(attention_bwd_reference(T(q), T(k), T(v), T(do), scale), want_g):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ln_mlp_twins_match_pallas():
    from mvlt_tpu.ops.fused_mlp import fused_ln_mlp as jax_fused_ln_mlp

    rng = np.random.default_rng(3)
    b, n, d, hid = 3, 40, 32, 128
    mk = lambda *s, std=1.0, mean=0.0: (mean + std * rng.normal(size=s)).astype(np.float32)
    x, dy = mk(b, n, d), mk(b, n, d)
    g, be = mk(d, std=0.1, mean=1.0), mk(d, std=0.1)
    w1, b1 = mk(d, hid, std=d ** -0.5), mk(hid, std=0.05)      # JAX layout [in, out]
    w2, b2 = mk(hid, d, std=hid ** -0.5), mk(d, std=0.05)
    s = np.asarray([0.0, 1.25, 1.25], np.float32)               # a dropped sample

    def loss(*a):
        return jnp.sum(jax_fused_ln_mlp(*a, s, eps=1e-6, gelu="erf") * dy)

    want_y = run_interpret(jax_fused_ln_mlp, x, g, be, w1, b1, w2, b2, s, eps=1e-6, gelu="erf")
    want_g = run_interpret(jax.grad(loss, argnums=tuple(range(7))), x, g, be, w1, b1, w2, b2)
    tw1, tw2 = T(w1.T.copy()), T(w2.T.copy())                  # torch layout [out, in]
    got_y = ln_mlp_reference(T(x), T(g), T(be), tw1, T(b1), tw2, T(b2), T(s), 1e-6)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    dx, dg, dbe, dw1, db1, dw2, db2 = ln_mlp_bwd_reference(
        T(x), T(g), T(be), tw1, T(b1), tw2, T(s), 1e-6, T(dy))
    got = (dx, dg, dbe, dw1.T, db1, dw2.T, db2)
    for name, a, w in zip(("dx", "dgamma", "dbeta", "dW1", "db1", "dW2", "db2"), got, want_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL, err_msg=name)
    # a dropped sample's rows: dx is dy alone
    np.testing.assert_array_equal(dx[0].numpy(), dy[0])


def test_autograd_functions_pass_gradcheck():
    gen = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda q, k, v: fused_attention(q, k, v, 0.4),
                                    (r(2, 2, 5, 8), r(2, 2, 7, 8), r(2, 2, 7, 8)))
    s = torch.tensor([0.0, 1.25], dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda *a: fused_ln_mlp(*a, row_scale=s, eps=1e-6),
        (r(2, 5, 8), r(8), r(8), r(16, 8), r(16), r(8, 16), r(8)))


def test_conv_bn_training_matches_flax():
    """Output and new running statistics. flax (and so the JAX package)
    puts the biased batch variance into running_var; torch's BatchNorm2d
    would put the unbiased one."""
    from mvlt_tpu.models.heads import ConvBN as JaxConvBN

    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 6, 5, 4)).astype(np.float32)
    mod = JaxConvBN(features=8)
    variables = jax.eval_shape(mod.init, jax.random.PRNGKey(0), x)
    params = {"conv": {"kernel": rng.normal(size=(3, 3, 4, 8)).astype(np.float32) * 0.3},
              "bn": {"scale": 1 + 0.1 * rng.normal(size=8).astype(np.float32),
                     "bias": 0.1 * rng.normal(size=8).astype(np.float32)}}
    stats = {"bn": {"mean": 0.1 * rng.normal(size=8).astype(np.float32),
                    "var": 1 + 0.1 * rng.random(8).astype(np.float32)}}
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(
        variables["params"])
    want, new = mod.apply({"params": params, "batch_stats": stats}, x, train=True,
                          mutable=["batch_stats"])
    port = ConvBN(4, 8).train()
    with torch.no_grad():
        port[0].weight.copy_(T(params["conv"]["kernel"].transpose(3, 2, 0, 1).copy()))
        port[1].weight.copy_(T(params["bn"]["scale"]))
        port[1].bias.copy_(T(params["bn"]["bias"]))
        port[1].running_mean.copy_(T(stats["bn"]["mean"]))
        port[1].running_var.copy_(T(stats["bn"]["var"]))
        got = port(T(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(port[1].running_mean.numpy(),
                               np.asarray(new["batch_stats"]["bn"]["mean"]), **TOL)
    np.testing.assert_allclose(port[1].running_var.numpy(),
                               np.asarray(new["batch_stats"]["bn"]["var"]), **TOL)


@pytest.mark.parametrize("h,w,scale", [(4, 4, 2), (3, 5, 2), (8, 8, 8), (1, 2, 2)])
def test_upsample_matches_jax(h, w, scale):
    from mvlt_tpu.ops.upsample import upsample_bilinear_align_corners as jax_up

    x = np.random.default_rng(h * w).normal(size=(2, h, w, 3)).astype(np.float32)
    got = upsample_bilinear_align_corners(T(x), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_up(jnp.asarray(x), scale)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rate,frac", [(0.15, 0.16), (0.3, 0.25), (0.9, 0.25)])
def test_mlm_gather_plan_matches_jax(rate, frac):
    """Equal indices, labels and chunk; rate 0.9 overflows the capacity."""
    from mvlt_tpu.train.losses import mlm_gather_plan as jax_plan

    rng = np.random.default_rng(int(rate * 100))
    labels = np.where(rng.random((40, 32)) < rate, rng.integers(0, 50, (40, 32)), -1)
    idx, sel, chunk = losses.mlm_gather_plan(T(labels), capacity_frac=frac, chunk=2048)
    j_idx, j_sel, j_chunk = jax_plan(jnp.asarray(labels, jnp.int32), capacity_frac=frac,
                                     chunk=2048)
    assert chunk == j_chunk
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(j_sel))
    assert losses.mlm_gather_plan(T(labels[:8]), capacity_frac=frac) is None


def test_lr_schedule_matches_optax():
    from mvlt_tpu.train.schedule import make_lr_schedule as jax_schedule

    cfg = OptimConfig(epochs=6, warmup_epochs=2)
    ours, theirs = schedule.make_lr_schedule(cfg, 150, 7), jax_schedule(cfg, 150, 7)
    got = np.asarray([ours(s) for s in range(50)])
    np.testing.assert_allclose(got, np.asarray([theirs(s) for s in range(50)]), rtol=1e-5)
    assert got[0] == cfg.warmup_lr and np.isclose(got.max(), cfg.lr * 150 / 512)


def test_adamw_matches_optax():
    """Three AdamW updates on the same numpy gradients; decay only on
    parameters with more than one dimension."""
    from mvlt_tpu.train.schedule import make_optimizer as jax_make_optimizer

    rng = np.random.default_rng(9)
    cfg = OptimConfig(epochs=4, warmup_epochs=1, weight_decay=0.3)
    init = {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in init.items()}
             for _ in range(3)]
    tx = jax_make_optimizer(cfg, 64, 2)
    params, opt_state = init, tx.init(init)
    module = torch.nn.Module()
    module.w = torch.nn.Parameter(T(init["w"].copy()))
    module.b = torch.nn.Parameter(T(init["b"].copy()))
    opt = schedule.make_optimizer(cfg, module)
    lr = schedule.make_lr_schedule(cfg, 64, 2)
    for step, g in enumerate(grads):
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        module.w.grad, module.b.grad = T(g["w"]), T(g["b"])
        schedule.set_lr(opt, lr(step))
        opt.step()
    for name in ("w", "b"):
        np.testing.assert_allclose(getattr(module, name).detach().numpy(),
                                   np.asarray(params[name]), rtol=1e-5, atol=1e-6)
