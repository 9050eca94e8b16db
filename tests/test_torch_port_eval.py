"""The port's VL eval (mvlt_tpu_torch/eval/vl_eval.py) against the JAX
package's, on the CPU: the micro model with every head, the same numpy
weights on both sides (the port's through state_dict_from_jax), batches of
5 and 3 samples. The per-batch sums and counts of a batch padded to 4 rows
and the aggregated statistics (accuracies, loss, PSNR, quality score) agree
to 2e-4 in fp32; padded rows count nothing."""

import jax
import numpy as np
import pytest

from mvlt_tpu import config as jax_config
from mvlt_tpu_torch import config
from mvlt_tpu_torch.convert import state_dict_from_jax
from mvlt_tpu_torch.eval.vl_eval import evaluate_vl, make_vl_eval_fn, pad_eval_batch
from mvlt_tpu_torch.models.pvlt import create_model
from tests.test_torch_port_train import IMG, MICRO, T, _numpy_weights, one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

TOL = 2e-4
HEADS = dict(itm=True, mlm=True, t2i=True, cls=True)


def _batch(rng, b):
    imgs = rng.random((b, IMG, IMG, 3)).astype(np.float32)
    ids = rng.integers(0, 64, (b, T)).astype(np.int32)
    return {
        "images": imgs,
        "masked_images": np.where(rng.random((b, IMG, IMG, 1)) < 0.5, 1e-6, imgs).astype(np.float32),
        "input_ids": ids,
        "ori_input_ids": np.where(rng.random((b, T)) < 0.2, rng.integers(0, 64, (b, T)), ids).astype(np.int32),
        "mlm_labels": np.where(rng.random((b, T)) < 0.3, rng.integers(0, 64, (b, T)), -1).astype(np.int32),
        "itm_labels": rng.integers(0, 2, (b,)).astype(np.int32),
        "sup_cls_labels": rng.integers(0, 48, (b,)).astype(np.int32),
        "sub_cls_labels": rng.integers(0, 122, (b,)).astype(np.int32),
    }


@pytest.fixture(scope="module")
def both_sides():
    from mvlt_tpu.eval import vl_eval as jax_vl_eval
    from mvlt_tpu.models import create_model as jax_create_model

    micro = {**MICRO, "mlm_ce_kernel": True}
    jcfg = jax_config.ModelConfig(**micro, use_pallas_attention=False,
                                  loss_type=jax_config.LossType(**HEADS))
    pcfg = config.ModelConfig(**micro, loss_type=config.LossType(**HEADS))
    jmodel = jax_create_model(jcfg)
    params, stats = _numpy_weights(jmodel, seed=5)
    variables = {"params": params, "batch_stats": stats}
    model = create_model(pcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    rng = np.random.default_rng(6)
    loader = [_batch(rng, 5), _batch(rng, 3)]
    return (jax_vl_eval, jax_vl_eval.make_vl_eval_fn(jmodel, jcfg), variables,
            make_vl_eval_fn(model, pcfg), loader)


def test_padded_batch_sums_match_jax(both_sides):
    jax_vl_eval, jax_fn, variables, port_fn, loader = both_sides
    feed = pad_eval_batch(loader[1], 4)
    want_feed = jax_vl_eval.pad_eval_batch(loader[1], 4)
    assert sorted(feed) == sorted(want_feed)
    for k in feed:
        np.testing.assert_array_equal(feed[k], want_feed[k], err_msg=k)
    assert feed["valid"].tolist() == [1, 1, 1, 0] and feed["mlm_labels"][3].tolist() == [-1] * T
    want = jax.device_get(jax_fn(variables, {k: np.asarray(v) for k, v in want_feed.items()}))
    got = port_fn(feed)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=TOL, atol=TOL, err_msg=k)
    assert float(got["n_valid"]) == 3.0


def test_evaluate_vl_matches_jax_on_a_ragged_loader(both_sides):
    jax_vl_eval, jax_fn, variables, port_fn, loader = both_sides
    want = jax_vl_eval.evaluate_vl(jax_fn, variables, loader, is_main=False)
    got = evaluate_vl(port_fn, loader, is_main=False)
    assert sorted(got) == sorted(want)
    assert {"mlm_acc", "itm_acc", "sup_cls_acc", "sub_cls_acc", "t2i_psnr",
            "quality_score"} <= set(got)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=TOL, atol=TOL, err_msg=k)


def test_eval_heads_follow_the_config(both_sides):
    """An itm-only model reports only ITM and the loss; no T2I or MLM."""
    _, _, _, _, loader = both_sides
    pcfg = config.ModelConfig(**MICRO, loss_type=config.LossType(itm=True, mlm=False, t2i=False))
    stats = evaluate_vl(make_vl_eval_fn(create_model(pcfg, device="cpu"), pcfg), loader,
                        is_main=False)
    assert sorted(stats) == ["itm_acc", "quality_score", "total_loss"]
    assert stats["quality_score"] == stats["itm_acc"]
