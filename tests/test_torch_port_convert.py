"""The port's own copies of the JAX package's host code, pinned to the
originals: the config dataclasses, the WordPiece tokenizer and the
reference-name weight mapping (on a full pre-training model: every head and
the T2I BatchNorm statistics)."""

import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mvlt_tpu import config as jax_config
from mvlt_tpu_torch import config, convert
from mvlt_tpu_torch.data import tokenizer
from tests.test_torch_port_train import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "configs"
FULL = dict(img_size=32, embed_dims=(8, 16, 32, 64), num_heads=(1, 2, 2, 4),
            mlp_ratios=(2, 2, 2, 2), token_hidden_size=32, num_text_tokens=16,
            vocab_size=64, max_position_embeddings=32, itg_channel=8,
            compute_dtype="float32", use_pallas_attention=False)


@pytest.mark.parametrize("name", ["LossType", "ModelConfig", "DataConfig", "OptimConfig",
                                  "RunConfig"])
def test_config_fields_and_defaults_match_jax(name):
    ours, theirs = getattr(config, name), getattr(jax_config, name)
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())
    if name == "ModelConfig":
        assert ours().num_stages == theirs().num_stages


@pytest.mark.parametrize("name", sorted(p.name for p in CONFIGS.glob("*.py")))
def test_config_files_load_as_in_jax(name):
    """load_config_file, apply_overrides and config_to_dict of the port's
    copy give the JAX package's tree for every preset, and for flat
    overrides on top of it."""
    path = CONFIGS / name
    ours, theirs = config.load_config_file(path), jax_config.load_config_file(path)
    assert config.config_to_dict(ours) == jax_config.config_to_dict(theirs)
    flat = {"batch_size": 8, "loss_type": {"cls": 1}, "model_overrides": {"num_text_tokens": 24},
            "mixup": 0.8, "clip_grad": 1.0}
    assert (config.config_to_dict(config.apply_overrides(ours, flat))
            == jax_config.config_to_dict(jax_config.apply_overrides(theirs, flat)))
    assert config._FLAT_KEYS == jax_config._FLAT_KEYS


def test_tokenizer_ids_match_jax():
    from mvlt_tpu.data import tokenizer as jax_tokenizer

    vocab = "preweights/bert-base-uncased-vocab.txt"
    ours = tokenizer.make_tokenizer(vocab)
    theirs = jax_tokenizer.WordPieceTokenizer(vocab)
    texts = ["A red cotton T-shirt, with a round neck & short sleeves!",
             "Café crème jacket -- 100% merino (size M/L)", "日本 denim\tjeans\n",
             "unaffordablyextraordinarily longwordpiece xyzzyqq", ""]
    for text in texts:
        assert ours.tokenize(text) == theirs.tokenize(text)
        assert ours.encode(text, 16) == theirs.encode(text, 16)
    assert (ours.mask_id, ours.pad_id, len(ours)) == (theirs.mask_id, theirs.pad_id, len(theirs))


@pytest.fixture(scope="module")
def full_model_trees():
    """The trees of the JAX micro model with every head (params and the T2I
    BatchNorm statistics), shaped by tracing its init and filled from a
    numpy seed."""
    from mvlt_tpu.models import create_model as jax_create_model

    cfg = jax_config.ModelConfig(**FULL, loss_type=jax_config.LossType(
        itm=True, mlm=True, t2i=True, cls=True))
    variables = jax.eval_shape(jax_create_model(cfg).init, jax.random.PRNGKey(0),
                               jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 16), jnp.int32))
    gen = np.random.default_rng(1)
    fill = lambda a: gen.standard_normal(a.shape).astype(np.float32)
    return (jax.tree_util.tree_map(fill, variables["params"]),
            jax.tree_util.tree_map(fill, variables["batch_stats"]))


def test_state_dict_from_jax_matches_export_state_dict(full_model_trees):
    from mvlt_tpu.convert.torch_to_jax import export_state_dict

    params, stats = full_model_trees
    want = export_state_dict(params, stats)
    got = convert.state_dict_from_jax(params, stats)
    assert sorted(got) == sorted(want)
    assert any(k.endswith("running_var") for k in got) and "sup_cls_head.linear_bias" in got
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v)


def test_full_state_dict_loads_strictly(full_model_trees):
    from mvlt_tpu_torch.models.pvlt import create_model

    model = create_model(config.ModelConfig(**FULL, loss_type=config.LossType(
        itm=True, mlm=True, t2i=True, cls=True)), device="cpu")
    model.load_state_dict(convert.state_dict_from_jax(*full_model_trees), strict=True)


def test_export_refuses_unmapped_parameters():
    with pytest.raises(ValueError, match="no reference name"):
        convert.export_state_dict({"mystery": {"kernel": np.zeros((2, 2))}})


@pytest.mark.parametrize("key", ["mlm_head.mlm_decoder.weight", "t2i_head.conv4.1.num_batches_tracked",
                                 "text_embeddings.position_ids", "cls_token", "norm.weight",
                                 "head.bias", "block1.0.attn.q.weight"])
def test_skip_list_matches_jax(key):
    from mvlt_tpu.convert.torch_to_jax import _SKIP_PATTERNS, translate_torch_key

    skipped_there = any(re.search(p, key) for p in _SKIP_PATTERNS)
    assert convert.skipped(key) == skipped_there
    assert skipped_there == (translate_torch_key(key) is None)
