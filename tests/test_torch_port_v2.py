"""The port's PVT-v2 model (itm head only, eval) against the JAX package's.

Micro v2 configurations (the dims of tests/test_v2_fused_routing.py, plus a
variant whose stage 1 is 64 wide with one head, so the JAX package packs it
two tokens per row) run at fp32 on the CPU: the port's plain path against
the JAX XLA path at rtol = atol = 2e-4, and against the JAX package's default
serving routing with its gates forced open (backend mocked as a TPU, Pallas
in interpret mode, block_attn_kernel="full", pack_stage1=True,
dwconv_mlp_kernel=True, kernel_gelu="erf") at 2e-3, the bound
tests/test_v2_fused_routing.py holds that routing to. Then pvlt_v2_tiny at
its widths (256x256, 128 tokens, B = 2), the initialisers, the strict load of
a full v2 tree, and the refusal to train. Parameter trees are shaped by
tracing the JAX init (jax.eval_shape) and filled from a numpy seed.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu.config import LossType, ModelConfig
from mvlt_tpu_torch.convert import state_dict_from_jax
from mvlt_tpu_torch.models.pvlt import create_model
from tests.kernel_utils import run_interpret

ITM_ONLY = LossType(itm=True, mlm=False, t2i=False, cls=False)
MICRO_V2 = ModelConfig(
    name="pvlt_v2_tiny", variant="v2", img_size=64, embed_dims=(16, 32, 64, 128),
    num_heads=(1, 2, 2, 4), mlp_ratios=(4, 4, 2, 2), token_hidden_size=32,
    num_text_tokens=16, vocab_size=64, max_position_embeddings=32, itg_channel=8,
    compute_dtype="float32", use_pallas_attention=False, drop_path_rate=0.0,
    kernel_gelu="erf", loss_type=ITM_ONLY)
TINY_V2 = ModelConfig(name="pvlt_v2_tiny", compute_dtype="float32",
                      use_pallas_attention=False, loss_type=ITM_ONLY)
# the JAX package's default serving routing, gates open
JAX_DEFAULT = dict(use_pallas_attention=True, block_attn_kernel="full", pack_stage1=True,
                   dwconv_mlp_kernel=True, kernel_gelu="erf")


def _jax_params(cfg, init_size, seed=11):
    """(JAX model, a params tree of its shapes: LayerNorm scales 1 + 0.1 N,
    every other leaf 0.05 N)."""
    from mvlt_tpu.models import create_model as jax_create_model

    model = jax_create_model(cfg)
    shapes = jax.eval_shape(
        lambda key: model.init(key, jnp.zeros((1, init_size, init_size, 3)),
                               jnp.zeros((1, cfg.num_text_tokens), jnp.int32)),
        jax.random.PRNGKey(0))
    gen = np.random.default_rng(seed)

    def leaf(path, s):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.05 * gen.standard_normal(s.shape)).astype(np.float32)
    return model, jax.tree_util.tree_map_with_path(leaf, shapes["params"])


def _port(cfg, params):
    port = create_model(cfg, device="cpu").eval()
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    return port


def _inputs(cfg, size, batch, seed):
    gen = np.random.default_rng(seed)
    images = gen.uniform(0, 1, size=(batch, size, size, 3)).astype(np.float32)
    ids = gen.integers(0, cfg.vocab_size, size=(batch, cfg.num_text_tokens)).astype(np.int32)
    return images, ids


def _port_logits(port, images, ids):
    with torch.no_grad():
        out = port(torch.from_numpy(images), torch.from_numpy(ids).long())
    assert all(out[k] is None for k in ("mlm_logits", "sup_cls_logits", "sub_cls_logits",
                                        "t2i_logits"))
    return out["itm_logits"].numpy()


@pytest.fixture(scope="module", params=[16, 64], ids=["stage1_16", "stage1_64_packed"])
def micro(request):
    """(config, JAX model, params, port model, images, ids, port logits); the
    64-wide variant's stage 1 is the one the JAX package packs."""
    cfg = dataclasses.replace(MICRO_V2, embed_dims=(request.param, 32, 64, 128))
    model, params = _jax_params(cfg, 64)
    port = _port(cfg, params)
    images, ids = _inputs(cfg, 64, 2, seed=request.param)
    return cfg, model, params, port, images, ids, _port_logits(port, images, ids)


def test_micro_v2_itm_logits_match_jax_xla(micro):
    cfg, model, params, _, images, ids, got = micro
    want = jax.jit(lambda p: model.apply({"params": p}, images, ids, train=False))(
        params)["itm_logits"]
    assert got.shape == tuple(want.shape) == (2, 1, 2)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)


def test_micro_v2_itm_logits_match_jax_default_serving(micro):
    """The JAX package's serving routing at its defaults, every gate open:
    stage 1 packed (64 wide) or lane-padded (16 wide) through Pallas #3/#5/#17
    or #1/#9/#16, stage 2 lane-padded through #1/#9/#16, stages 3-4 (grids of
    4 and 2, below the kernels' 8-aligned grid) on its modular path."""
    from mvlt_tpu.models import create_model as jax_create_model

    cfg, _, params, _, images, ids, got = micro
    model = jax_create_model(dataclasses.replace(cfg, **JAX_DEFAULT))
    with mock.patch.object(jax, "default_backend", return_value="tpu"):
        want = run_interpret(
            lambda: model.apply({"params": params}, images, ids, train=False)["itm_logits"])
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-3, atol=2e-3)


def test_pvlt_v2_tiny_itm_logits_match_jax():
    """The slice's own configuration: pvlt_v2_tiny built at 224, run at 256,
    T = 128, B = 2."""
    model, params = _jax_params(TINY_V2, 224)
    port = _port(TINY_V2, params)
    assert port.cfg.variant == "v2" and port.cfg.depths == (2, 2, 2, 2)
    images, ids = _inputs(TINY_V2, 256, 2, seed=0)
    want = jax.jit(lambda p, im, i: model.apply({"params": p}, im, i, train=False))(
        params, images, ids)["itm_logits"]
    np.testing.assert_allclose(_port_logits(port, images, ids), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_v2_init_follows_flax():
    """create_model's v2 parameters start as the JAX package's flax modules
    start them: the depthwise convs (no kernel_init given, flax's default)
    LeCun normal over fan-in 3*3*1, std within 5% plus three sampling
    spreads of flax's own draws, the overlapping patch embeds and the
    matrices truncated normal 0.02, the biases 0. A blanket truncated normal
    0.02 would start the depthwise convs ~17x weaker."""
    import flax.linen as fnn

    torch.manual_seed(0)
    model = create_model(MICRO_V2, device="cpu")
    lecun = np.asarray(fnn.initializers.lecun_normal()(jax.random.PRNGKey(0), (3, 3, 1, 20000)))
    dwconvs = 0
    for name, p in model.named_parameters():
        p = p.detach()
        if p.dim() == 1:
            const = 1.0 if name.endswith("weight") and ("norm" in name or "LayerNorm" in name
                                                        or ".1." in name) else 0.0
            assert torch.all(p == const), name
            continue
        tol = 0.05 + 3 / np.sqrt(2 * p.numel())
        if name.endswith("dwconv.dwconv.weight"):
            dwconvs += 1
            assert abs(float(p.std()) / lecun.std() - 1) < tol, (name, float(p.std()))
            assert float(p.abs().max()) <= np.abs(lecun).max() * 1.05, name
            assert float(p.std()) / 0.02 > 10
        elif not name.startswith("text_embeddings."):
            assert float(p.abs().max()) <= 0.04 + 1e-7, name
            assert abs(float(p.std()) / 0.0176 - 1) < tol, (name, float(p.std()))
    assert dwconvs == sum(MICRO_V2.depths)


def test_full_v2_tree_loads_strictly():
    """A whole JAX pvlt_v2 tree with every head (params and the T2I
    BatchNorm statistics) maps through the port's bridge exactly as through
    the JAX package's exporter, and loads with strict=True."""
    from mvlt_tpu.convert.torch_to_jax import export_state_dict
    from mvlt_tpu.models import create_model as jax_create_model

    cfg = dataclasses.replace(MICRO_V2, img_size=32, embed_dims=(8, 16, 32, 64),
                              loss_type=LossType(itm=True, mlm=True, t2i=True, cls=True))
    variables = jax.eval_shape(
        lambda key: jax_create_model(cfg).init(key, jnp.zeros((1, 32, 32, 3)),
                                               jnp.zeros((1, 16), jnp.int32)),
        jax.random.PRNGKey(0))
    gen = np.random.default_rng(1)
    fill = lambda a: gen.standard_normal(a.shape).astype(np.float32)
    params = jax.tree_util.tree_map(fill, variables["params"])
    stats = jax.tree_util.tree_map(fill, variables["batch_stats"])
    got = state_dict_from_jax(params, stats)
    want = export_state_dict(params, stats)
    assert sorted(got) == sorted(want)
    assert sum(k.endswith("mlp.dwconv.dwconv.weight") for k in got) == sum(cfg.depths)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    create_model(cfg, device="cpu").load_state_dict(got, strict=True)


def test_v2_training_and_gradients_raise():
    """v2 serves only: training mode, or a gradient wanted through a block,
    raises NotImplementedError (ROADMAP Queue 1 item 14), as Swin training
    does; linear SR stays unported."""
    model = create_model(MICRO_V2, device="cpu")
    images, ids = torch.zeros(1, 64, 64, 3), torch.zeros(1, 16, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        model.train()(images, ids)
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        model.eval()(images, ids)                 # parameters want gradients
    with torch.no_grad():
        assert model(images, ids)["itm_logits"].shape == (1, 1, 2)
    with pytest.raises(NotImplementedError):
        create_model(dataclasses.replace(MICRO_V2, name="pvlt_v2_linear_tiny"), device="cpu")
    swin = create_model(dataclasses.replace(MICRO_V2, name="pvlt_swin_tiny"), device="cpu",
                        input_size=64)
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        swin.train()(images, ids)
