"""The training path's kernel twins and helpers against the JAX package.

The plain versions the Hopper kernels are held to on the card
(ops/pallas_attention.py, ops/fused_mlp.py) are held here to the Pallas
kernels they replace, run in interpret mode on the CPU, forward and
gradients, in fp32 at rtol = atol = 1e-4 (the JAX kernels take one-pass LN
statistics and exp2 softmax). Both autograd Functions pass gradcheck in
fp64. The heads' BatchNorm, the upsample, the MLM gather plan, the LR
schedule, AdamW and the model's initialisation are held to their JAX
counterparts. The LN-MLP backward kernels' host-side plan (the row ranges
of the weight-gradient GEMMs) and scratch sizes, and the forward's choice of
form and its scratch, are checked at the stage shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mvlt_tpu_torch.config import OptimConfig
from mvlt_tpu_torch.models.heads import ConvBN
from mvlt_tpu_torch.ops.fused_mlp import (BWD_CHUNK, MAX_SPLITS, bwd_plan, bwd_scratch,
                                          fused_ln_mlp, fwd_fused, fwd_scratch,
                                          ln_mlp_bwd_reference, ln_mlp_reference)
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


@pytest.mark.parametrize("rows,d,hidden,splits", [(633_600, 64, 512, 15), (172_800, 128, 1024, 8),
                                                   (57_600, 320, 1280, 2), (28_800, 512, 2048, 1)])
def test_ln_mlp_bwd_plan_at_the_stage_shapes(rows, d, hidden, splits):
    """The four pvlt_tiny stages at B = 150 on 132 SMs: dW1 and dW2 take 2 x
    ceil(D/128) x ceil(H/128) output tiles (8, 16, 60, 128), times the row
    ranges the fewest blocks that fill 90% of a wave (120, 128, 120, 128)."""
    assert bwd_plan(rows, d, hidden, 132) == splits


@pytest.mark.parametrize("rows,d,hidden,sms", [(666, 320, 1280, 132), (210, 64, 512, 132),
                                               (308, 96, 384, 132), (40, 512, 2048, 8),
                                               (1, 16, 16, 132)])
def test_ln_mlp_bwd_plan_covers_every_chunk_with_nonempty_ranges(rows, d, hidden, sms):
    splits = bwd_plan(rows, d, hidden, sms)
    chunks = -(-rows // BWD_CHUNK)
    per = -(-chunks // splits)
    assert 1 <= splits <= min(MAX_SPLITS, chunks)
    assert (splits - 1) * per < chunks <= splits * per      # no range empty, none left out


def test_ln_mlp_bwd_scratch_sizes():
    """Stage 1 at B = 150 (633,600 rows, D = 64, H = 512, 15 row ranges):
    LN(x) and s.dy 81 MB each, G and dh1 649 MB each, dn in G's space, the
    partial sums and slots 23 MB: 1.48 GB. dn takes its own fp32 space
    where H < 2D; one row range has no slots."""
    def nbytes(sizes):
        return {k: n * torch.empty(0, dtype=dt).element_size() for k, (n, dt) in sizes.items()}
    got = nbytes(bwd_scratch(633_600, 64, 512, 15))
    assert got == {"nhat": 81_100_800, "dys": 81_100_800, "stats": 5_068_800,
                   "g": 648_806_400, "dh": 648_806_400, "dn": 0, "db1p": 10_137_600,
                   "colp": 3_801_600, "wslots": 3_932_160}
    assert sum(got.values()) == 1_482_754_560
    assert bwd_scratch(100, 64, 96, 1)["dn"] == (6400, torch.float32)
    assert bwd_scratch(100, 64, 512, 1)["wslots"][0] == 0
    assert bwd_scratch(100, 64, 512, 3)["wslots"][0] == 2 * 3 * 512 * 64


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


def test_init_follows_the_jax_initialisers():
    """create_model initialises as the JAX package's flax modules: each
    parameter's standard deviation within 5% (plus three times its sampling
    spread) of the same flax initialiser's draws at the same fan, the
    truncation bound shared, and every bias, LayerNorm and BatchNorm tensor
    at its constant."""
    import flax.linen as fnn

    from mvlt_tpu_torch.config import LossType, ModelConfig
    from mvlt_tpu_torch.models.pvlt import create_model

    torch.manual_seed(0)
    cfg = ModelConfig(img_size=32, embed_dims=(8, 16, 32, 64), num_heads=(1, 2, 2, 4),
                      mlp_ratios=(2, 2, 2, 2), token_hidden_size=32, num_text_tokens=16,
                      vocab_size=500, max_position_embeddings=32, itg_channel=8,
                      loss_type=LossType(itm=True, mlm=True, t2i=True, cls=True))
    model = create_model(cfg, device="cpu")
    trunc02 = fnn.initializers.truncated_normal(stddev=0.02)
    normal02 = fnn.initializers.normal(stddev=0.02)
    lecun = fnn.initializers.lecun_normal()
    he_fan_out = fnn.initializers.variance_scaling(2.0, "fan_out", "normal")
    key = jax.random.PRNGKey(0)
    draws = {}
    for name, p in model.named_parameters():
        p = p.detach()
        if p.dim() == 1:
            const = 1.0 if name.endswith("weight") and ("norm" in name or "LayerNorm" in name
                                                        or ".1." in name) else 0.0
            assert torch.all(p == const), name
            continue
        # flax conv kernels are [kh, kw, in, out]; many draws of the same
        # fan: more inputs for a fan-out law, more outputs for a fan-in one
        m = -(-20000 // p.numel())
        kh, kw = p.shape[2:] if p.dim() == 4 else (1, 1)
        if name.startswith("text_embeddings."):
            init, shape = normal02, (20000,)
        elif name == "t2i_head.score.0.weight":
            init, shape = lecun, (kh, kw, p.shape[1], p.shape[0] * m)
        elif name.startswith("t2i_head."):
            init, shape = he_fan_out, (kh, kw, p.shape[1] * m, p.shape[0])
        else:
            init, shape = trunc02, (20000,)
        if (id(init), shape) not in draws:
            draws[id(init), shape] = np.asarray(init(key, shape)).std()
        tol = 0.05 + 3 / np.sqrt(2 * p.numel())     # the sample std's spread
        want = draws[id(init), shape]
        assert abs(float(p.std()) / want - 1) < tol, (name, float(p.std()), want)
        if init is trunc02:
            assert float(p.abs().max()) <= 0.04 + 1e-7, name
    for name, b in model.named_buffers():
        assert torch.all(b == (1.0 if name.endswith("running_var") else 0.0)), name


@pytest.mark.parametrize("d,fused", [(16, True), (64, True), (96, True), (128, True),
                                     (144, False), (320, False), (512, False)])
def test_ln_mlp_fwd_form_by_width(d, fused):
    """The forward keeps the hidden on chip (one launch, the fc2 sum [64, D]
    in registers) up to D = 128 and goes through LN(x) and G in device
    memory above."""
    assert fwd_fused(d) is fused
    sizes = fwd_scratch(10, d, 4 * d, fused)
    assert list(sizes) == ["nrm", "g"]
    assert sizes["nrm"] == (0 if fused else 10 * d, torch.bfloat16)
    assert sizes["g"] == (0 if fused else 40 * d, torch.bfloat16)


def test_ln_mlp_fwd_scratch_at_the_stage_shapes():
    """B = 150: none at stages 1-2; LN(x) and G at stages 3 (57,600 rows,
    D = 320, H = 1,280: 37 MB + 147 MB) and 4 (28,800 rows, D = 512, H =
    2,048: 29 MB + 118 MB)."""
    def nbytes(rows, d, hidden):
        return [n * 2 for n, _ in fwd_scratch(rows, d, hidden, fwd_fused(d)).values()]
    assert nbytes(633_600, 64, 512) == [0, 0]
    assert nbytes(172_800, 128, 1024) == [0, 0]
    assert nbytes(57_600, 320, 1280) == [36_864_000, 147_456_000]
    assert nbytes(28_800, 512, 2048) == [29_491_200, 117_964_800]
