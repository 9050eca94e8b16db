"""The port's itm-only PVLT against the JAX package's, and its registry.

The JAX side runs its XLA path in fp32 on the CPU (compute_dtype="float32",
use_pallas_attention=False: exact-erf GELU, no Pallas); every parameter leaf
is perturbed so zero-initialised biases and pos-embeds carry signal, and the
port loads the same weights through state_dict_from_jax with strict=True.
ITM logits agree at rtol = atol = 2e-4, the tolerance of the full-model
parity test against the torch reference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu.config import LossType, ModelConfig
from mvlt_tpu_torch.convert import state_dict_from_jax
from mvlt_tpu_torch.models import registry
from mvlt_tpu_torch.models.pvlt import create_model

ITM_ONLY = LossType(itm=True, mlm=False, t2i=False, cls=False)
MICRO = ModelConfig(
    img_size=64, patch_size=4, embed_dims=(8, 16, 32, 64), num_heads=(1, 2, 2, 4),
    mlp_ratios=(2, 2, 2, 2), depths=(2, 2, 2, 2), sr_ratios=(8, 4, 2, 1),
    token_hidden_size=32, num_text_tokens=16, max_position_embeddings=64,
    compute_dtype="float32", use_pallas_attention=False, loss_type=ITM_ONLY)
TINY = ModelConfig(name="pvlt_tiny", compute_dtype="float32",
                   use_pallas_attention=False, loss_type=ITM_ONLY)


def _jax_pair(cfg, init_size):
    """(JAX model, perturbed params, port model with the same weights)."""
    from mvlt_tpu.models import create_model as jax_create_model

    model = jax_create_model(cfg)
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, init_size, init_size, 3), jnp.float32),
        jnp.zeros((1, cfg.num_text_tokens), jnp.int32))
    gen = np.random.default_rng(11)
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.03 * gen.standard_normal(np.shape(x))
                   ).astype(np.float32), variables["params"])
    port = create_model(cfg, device="cpu").eval()
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    return model, params, port


def _compare(pair, cfg, input_size, batch, seed):
    model, params, port = pair
    gen = np.random.default_rng(seed)
    images = gen.uniform(0, 1, size=(batch, input_size, input_size, 3)).astype(np.float32)
    ids = gen.integers(0, cfg.vocab_size, size=(batch, cfg.num_text_tokens)).astype(np.int32)
    want = jax.jit(lambda p, im, i: model.apply({"params": p}, im, i, train=False))(
        params, images, ids)["itm_logits"]
    with torch.no_grad():
        got = port(torch.from_numpy(images), torch.from_numpy(ids).long())
    assert got["itm_logits"].shape == tuple(want.shape) == (batch, 1, 2)
    assert all(got[k] is None for k in ("mlm_logits", "sup_cls_logits",
                                        "sub_cls_logits", "t2i_logits"))
    np.testing.assert_allclose(got["itm_logits"].numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)
    return images, ids, got["itm_logits"]


@pytest.fixture(scope="module")
def micro_pair():
    return _jax_pair(MICRO, 64)


@pytest.mark.parametrize("input_size", [64, 96])
def test_micro_itm_logits_match_jax(micro_pair, input_size):
    """Input 96 on a model built at 64 exercises the pos-embed resize."""
    _compare(micro_pair, MICRO, input_size, batch=2, seed=input_size)


def test_nchw_input_matches_nhwc(micro_pair):
    images, ids, want = _compare(micro_pair, MICRO, 64, batch=2, seed=5)
    with torch.no_grad():
        got = micro_pair[2](torch.from_numpy(images).permute(0, 3, 1, 2),
                            torch.from_numpy(ids).long())["itm_logits"]
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_pvlt_tiny_itm_logits_match_jax():
    """The slice's own configuration: pvlt_tiny built at 224, run at 256,
    T = 128, B = 2."""
    _compare(_jax_pair(TINY, 224), TINY, 256, batch=2, seed=0)


def test_registry_matches_jax():
    from mvlt_tpu.models import pvlt as jax_pvlt

    assert registry.MODEL_REGISTRY == jax_pvlt.MODEL_REGISTRY
    for name in jax_pvlt.MODEL_REGISTRY:
        cfg = ModelConfig(name=name)
        assert registry.resolve_model_config(cfg) == jax_pvlt.resolve_model_config(cfg)
    for bad in (dict(block_attn_kernel="x"), dict(kernel_gelu="x"),
                dict(mlm_capacity_frac=0.0),
                dict(name="pvlt_swin_tiny", variant="swin", attn_drop_rate=0.1)):
        cfg = dataclasses.replace(ModelConfig(), **bad)
        with pytest.raises((ValueError, NotImplementedError)) as want:
            jax_pvlt.validate_model_config(cfg)
        with pytest.raises(want.type):
            registry.validate_model_config(cfg)
    with pytest.raises(KeyError):
        registry.resolve_model_config(ModelConfig(name="nope"))


@pytest.mark.parametrize("loss_type", [LossType(), LossType(itm=True, mlm=False, t2i=False, cls=True)])
def test_unported_heads_raise(loss_type):
    """Every head is ported now, with any choice of heads, on the v1, v2 and
    Swin backbones; what is still unported, v2's linear SR, raises whatever
    heads are on."""
    model = create_model(dataclasses.replace(MICRO, loss_type=loss_type), device="cpu")
    assert hasattr(model, "sup_cls_head") == loss_type.cls
    assert hasattr(model, "t2i_head") == loss_type.t2i
    v2 = create_model(dataclasses.replace(MICRO, name="pvlt_v2_tiny", loss_type=loss_type),
                      device="cpu")
    assert v2.cfg.variant == "v2" and hasattr(v2, "t2i_head") == loss_type.t2i
    swin = create_model(dataclasses.replace(MICRO, name="pvlt_swin_tiny", loss_type=loss_type),
                        device="cpu")
    assert swin.cfg.variant == "swin" and hasattr(swin, "t2i_head") == loss_type.t2i
    with pytest.raises(NotImplementedError):
        create_model(dataclasses.replace(MICRO, name="pvlt_v2_linear_tiny", loss_type=loss_type),
                     device="cpu")


def test_training_mode_raises(micro_pair):
    """Training mode runs now; it raises only for the regularisers not
    ported yet (dropout after the pos-embeds and on the attention
    probabilities), which eval mode does not use."""
    port = create_model(dataclasses.replace(MICRO, drop_rate=0.1, attn_drop_rate=0.1),
                        device="cpu")
    port.load_state_dict(micro_pair[2].state_dict())
    images, ids = torch.zeros(1, 64, 64, 3), torch.zeros(1, 16, dtype=torch.long)
    with pytest.raises(NotImplementedError):
        port.train()(images, ids)
    with torch.no_grad():
        torch.testing.assert_close(port.eval()(images, ids)["itm_logits"],
                                   micro_pair[2](images, ids)["itm_logits"])
