"""The port's Swin model (eval, all five heads) against the JAX package's.

The port routes each stage the way it does on the card: kernel E's stages
(an even window dividing the grid, the text-pool window dividing it) on the
split stream through fused_swin_block's plain version, the others on the
joint stream through SwinJointAttention (fused_swin_attention's plain
version) and the LN-MLP's. At fp32 on the CPU it is held to the JAX XLA path
(use_pallas_attention=False) at rtol = atol = 2e-4 on every logits key,
each key divided by its largest magnitude where that exceeds 1 (the T2I
decoder's outputs reach the hundreds at pvlt_swin_tiny's widths):
micro widths at 64 (every stage on kernel E's route, stage 4 a 2x2 grid) and
96 (stages 1 and 3 on E's, stage 3 with a 6x6 window of 36 rows; stage 2 a
12x12 grid padded to 16x16 and shifted, stage 4 a 3x3 window on the window
route), then pvlt_swin_tiny at its widths at 256 (every stage on E's route)
and 224 (stage 1 on E's, stages 2-4 on the window route), B = 2. Then
against the JAX package's own routing with its gates forced open (backend
mocked as a TPU, Pallas in interpret mode, block_attn_kernel="full",
kernel_gelu="erf": Pallas #18 at stages 1-3, #19 at stage 4) at 2e-3, the
bound tests/test_swin_band.py holds that routing to. Parameter trees are
shaped by tracing the JAX init (jax.eval_shape) at the run size and filled
from a numpy seed, the relative-position tables at std 0.5; they load into
the port through state_dict_from_jax with strict=True.
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
from mvlt_tpu_torch.models.pvlt import SwinBlock, create_model
from tests.kernel_utils import run_interpret

ALL_HEADS = LossType(itm=True, mlm=True, t2i=True, cls=True)
KEYS = ("mlm_logits", "itm_logits", "sup_cls_logits", "sub_cls_logits", "t2i_logits")
MICRO_SWIN = ModelConfig(
    name="pvlt_swin_tiny", variant="swin", img_size=64, embed_dims=(16, 32, 64, 128),
    num_heads=(1, 2, 2, 4), mlp_ratios=(4, 4, 2, 2), token_hidden_size=32,
    num_text_tokens=16, vocab_size=64, max_position_embeddings=32, itg_channel=8,
    num_super_classes=5, num_sub_classes=7, compute_dtype="float32",
    use_pallas_attention=False, drop_path_rate=0.0, kernel_gelu="erf", loss_type=ALL_HEADS)
TINY_SWIN = ModelConfig(name="pvlt_swin_tiny", compute_dtype="float32",
                        use_pallas_attention=False, drop_path_rate=0.0, loss_type=ALL_HEADS)


def _jax_state(cfg, size, seed=7):
    """(JAX model, params, batch_stats) of the shapes the JAX init gives at
    ``size``: LayerNorm and BatchNorm scales 1 + 0.05 N, running variances
    1 + 0.1 |N|, relative-position tables 0.5 N, every other leaf 0.05 N."""
    from mvlt_tpu.models import create_model as jax_create_model

    model = jax_create_model(cfg)
    shapes = jax.eval_shape(
        lambda key: model.init(key, jnp.zeros((1, size, size, 3)),
                               jnp.zeros((1, cfg.num_text_tokens), jnp.int32)),
        jax.random.PRNGKey(0))
    gen = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        noise = gen.standard_normal(s.shape)
        value = {"scale": 1.0 + 0.05 * noise, "var": 1.0 + 0.1 * np.abs(noise),
                 "rel_pos_bias": 0.5 * noise}.get(name, 0.05 * noise)
        return value.astype(np.float32)
    state = jax.tree_util.tree_map_with_path(leaf, shapes)
    return model, state["params"], state.get("batch_stats")


def _port(cfg, params, stats, size):
    port = create_model(cfg, device="cpu", input_size=size).eval()
    port.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    return port


def _inputs(cfg, size, batch, seed):
    gen = np.random.default_rng(seed)
    images = gen.uniform(0, 1, size=(batch, size, size, 3)).astype(np.float32)
    ids = gen.integers(0, cfg.vocab_size, size=(batch, cfg.num_text_tokens)).astype(np.int32)
    return images, ids


def _port_logits(port, images, ids) -> dict:
    with torch.no_grad():
        out = port(torch.from_numpy(images), torch.from_numpy(ids).long())
    return {k: v.numpy() for k, v in out.items() if v is not None}


def _compare_xla(cfg, size, batch, seed):
    model, params, stats = _jax_state(cfg, size)
    images, ids = _inputs(cfg, size, batch, seed)
    want = jax.jit(lambda p, s: model.apply({"params": p, "batch_stats": s}, images, ids,
                                            train=False))(params, stats)
    got = _port_logits(_port(cfg, params, stats, size), images, ids)
    for k in KEYS:
        assert got[k].shape == tuple(want[k].shape), k
        scale = max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k] / scale, np.asarray(want[k]) / scale, rtol=2e-4,
                                   atol=2e-4, err_msg=k)


@pytest.mark.parametrize("size", [64, 96])
def test_micro_swin_logits_match_jax_xla(size):
    _compare_xla(MICRO_SWIN, size, batch=2, seed=size)


@pytest.mark.parametrize("size", [256, 224])
def test_pvlt_swin_tiny_logits_match_jax_xla(size):
    """The slice's own configuration at its widths (64/128/320/512, heads
    1/2/5/8, window 8, T = 128), built at 224 (pos-embeds), run at 256 and,
    on the window route from stage 2, at 224; B = 2."""
    _compare_xla(TINY_SWIN, size, batch=2, seed=size)


def test_micro_swin_matches_jax_default_serving():
    """The JAX package's Swin serving routing, every gate open, at 64: the
    band kernel (Pallas #18) at stages 1-3, the windowed-attention kernel
    (#19) and the LN-MLP kernel at stage 4 (its 2-wide band fails the TPU's
    16-row alignment); the port runs all four stages on kernel E's route."""
    from mvlt_tpu.models import create_model as jax_create_model

    cfg = dataclasses.replace(MICRO_SWIN, loss_type=LossType(itm=True, mlm=False, t2i=False,
                                                             cls=False))
    _, params, _ = _jax_state(cfg, 64, seed=3)
    images, ids = _inputs(cfg, 64, 2, seed=3)
    model = jax_create_model(dataclasses.replace(cfg, use_pallas_attention=True,
                                                 block_attn_kernel="full"))
    with mock.patch.object(jax, "default_backend", return_value="tpu"):
        want = run_interpret(
            lambda: model.apply({"params": params}, images, ids, train=False)["itm_logits"])
    got = _port_logits(_port(cfg, params, None, 64), images, ids)["itm_logits"]
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-3, atol=2e-3)


def test_swin_init_follows_flax():
    """create_model draws the relative-position tables as flax's _trunc02
    (truncated normal 0.02): standard deviation within 5% of flax's draw,
    the truncation bound shared."""
    import flax.linen as fnn

    torch.manual_seed(0)
    model = create_model(dataclasses.replace(MICRO_SWIN, loss_type=ALL_HEADS), device="cpu",
                         input_size=64)
    tables = torch.cat([p.detach().flatten() for n, p in model.named_parameters()
                        if n.endswith("attn.relative_position_bias_table")])
    assert tables.numel() == 2 * 225 * (1 + 2) + 2 * 49 * 2 + 2 * 9 * 4
    want = np.asarray(fnn.initializers.truncated_normal(stddev=0.02)(
        jax.random.PRNGKey(0), (20000,))).std()
    assert abs(float(tables.std()) / want - 1) < 0.05
    assert float(tables.abs().max()) <= 0.04 + 1e-7


def test_swin_serves_only():
    """A Swin block in training mode, or with a gradient wanted, raises; a
    model built for one input size refuses a grid of another window."""
    model = create_model(MICRO_SWIN, device="cpu", input_size=64)
    images, ids = (torch.zeros(1, 64, 64, 3), torch.zeros(1, 16, dtype=torch.long))
    with pytest.raises(NotImplementedError, match="Swin training"):
        model.train()(images, ids)
    with pytest.raises(NotImplementedError, match="Swin training"):
        model.eval()(images, ids)                           # parameters want gradients
    block = next(m for m in model.modules() if isinstance(m, SwinBlock))
    with torch.no_grad():
        with pytest.raises(NotImplementedError):
            block.train()(torch.zeros(1, 256 + 16, 16), (16, 16))
        with pytest.raises(ValueError, match="input size"):
            model.eval()(torch.zeros(1, 32, 32, 3), ids)      # stage 3 window 2, table of 4
