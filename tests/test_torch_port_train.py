"""The port's pre-training step against the JAX package's, on the CPU.

Micro config of tests/test_train_step.py (ITM + MLM + T2I, fp32, DropPath
and BERT dropout off, mlm_ce_kernel off) at B = 40, so that the MLM gather
plan is active (640 text rows, capacity 512). The same numpy weights reach
both sides (the port through state_dict_from_jax) with the same batch. At
step 0 (clean images), step 1 (masked images) and with train_mode=False
the step's losses agree to 2e-4, every parameter's gradient to 1e-3 of
that tensor's largest magnitude (sums run in another order), and the new
BatchNorm statistics to 2e-4. Parameters after the update are not
compared: Adam's first step is about lr * sign(g), so noise at g ~ 0 flips
it. The JAX side mirrors mvlt_tpu/train/step.py:_forward_backward with the
package's own model, gather plan and losses, so that its gradients can be
read.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu import config as jax_config
from mvlt_tpu_torch import config
from mvlt_tpu_torch.convert import state_dict_from_jax
from mvlt_tpu_torch.data.fashion_gen import SyntheticFashionGen, batches
from mvlt_tpu_torch.models.bert_embeddings import dropout
from mvlt_tpu_torch.models.pvlt import Block, create_model
from mvlt_tpu_torch.train.engine import train_one_epoch
from mvlt_tpu_torch.train.state import create_train_state
from mvlt_tpu_torch.train.step import make_train_step

B, IMG, T = 40, 32, 16
MICRO = dict(img_size=IMG, embed_dims=(8, 16, 32, 64), num_heads=(1, 2, 2, 4),
             mlp_ratios=(2, 2, 2, 2), token_hidden_size=32, num_text_tokens=T,
             vocab_size=64, max_position_embeddings=32, itg_channel=8,
             compute_dtype="float32", drop_path_rate=0.0, bert_dropout=0.0,
             mlm_ce_kernel=False)
HEADS = dict(itm=True, mlm=True, t2i=True, cls=False)
ALL_HEADS = dict(itm=True, mlm=True, t2i=True, cls=True)
LOSS_KEYS = ("loss_mlm", "loss_itm", "loss_sup_cls", "loss_sub_cls", "loss_t2i", "total_loss")


def _configs(heads):
    return (jax_config.ModelConfig(**MICRO, use_pallas_attention=False,
                                   loss_type=jax_config.LossType(**heads)),
            config.ModelConfig(**MICRO, loss_type=config.LossType(**heads)))


def _numpy_weights(model, seed):
    """Trees shaped by tracing the JAX init, filled from a numpy seed: matrices
    small, LayerNorm and BatchNorm scales near 1, running variances
    positive."""
    variables = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                               jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1, T), jnp.int32))
    gen = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        base = 1.0 if ("scale" in name or "'var'" in name) else 0.0
        std = 0.1 if leaf.ndim == 1 else 0.2 / np.sqrt(np.prod(leaf.shape[:-1]))
        return (base + std * gen.standard_normal(leaf.shape)).astype(np.float32)

    return (jax.tree_util.tree_map_with_path(fill, variables["params"]),
            jax.tree_util.tree_map_with_path(fill, variables["batch_stats"]))


def make_batch(rng, b=B):
    imgs = rng.random((b, IMG, IMG, 3)).astype(np.float32)
    return {
        "images": imgs,
        "masked_images": np.where(rng.random((b, IMG, IMG, 1)) < 0.5, 1e-6, imgs).astype(np.float32),
        "input_ids": rng.integers(0, 64, (b, T)).astype(np.int32),
        "mlm_labels": np.where(rng.random((b, T)) < 0.15,
                               rng.integers(0, 64, (b, T)), -1).astype(np.int32),
        "itm_labels": rng.integers(0, 2, (b,)).astype(np.int32),
        "sup_cls_labels": rng.integers(0, 48, (b,)).astype(np.int32),
        "sub_cls_labels": rng.integers(0, 122, (b,)).astype(np.int32),
    }


@pytest.fixture(scope="module")
def jax_step():
    """(JAX config, port config, params, batch_stats, batch, jitted
    grads-losses-stats-outputs function of (params, stats, images, train))."""
    from mvlt_tpu.models import create_model as jax_create_model
    from mvlt_tpu.train.losses import compute_losses, mlm_gather_plan

    jcfg, pcfg = _configs(HEADS)
    model = jax_create_model(jcfg)
    params, stats = _numpy_weights(model, seed=1)
    batch = make_batch(np.random.default_rng(2))

    def grads(params, stats, images, train):
        kwargs, loss_batch = {}, batch
        chunk, frac = max(jcfg.mlm_loss_chunk, 1), jcfg.mlm_capacity_frac
        if train and frac < 1.0:
            plan = mlm_gather_plan(batch["mlm_labels"], capacity_frac=frac, chunk=chunk)
            assert plan is not None
            kwargs["mlm_row_idx"], sel, chunk = plan
            loss_batch, frac = {**batch, "mlm_labels": sel[None]}, 1.0

        def loss_fn(p):
            out, new = model.apply({"params": p, "batch_stats": stats}, images,
                                   batch["input_ids"], train=train, mutable=["batch_stats"],
                                   rngs={"dropout": jax.random.PRNGKey(0)}, **kwargs)
            losses = compute_losses(out, loss_batch, mlm_chunk=chunk, mlm_capacity_frac=frac,
                                    mlm_ce_kernel=False)
            keep = {k: out[k] for k in ("mlm_hidden", "mlm_logits", "itm_logits", "t2i_logits")
                    if out.get(k) is not None}
            return losses["total_loss"], (losses, new["batch_stats"], keep)

        return jax.grad(loss_fn, has_aux=True)(params)

    return jcfg, pcfg, params, stats, batch, jax.jit(grads, static_argnames=("train",))


def _port_state(pcfg, params, stats, step):
    model = create_model(pcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    state = create_train_state(model, config.OptimConfig(warmup_epochs=0), B, 10)
    state.step = step
    return state


@pytest.mark.parametrize("step,train_mode", [(0, True), (1, True), (0, False)])
def test_step_matches_jax(jax_step, step, train_mode):
    """Losses, every gradient and the new BatchNorm statistics; step 1 runs
    on the masked images; train_mode=False is the fine-tune quirk (eval-mode
    forward, full MLM decode, gradients to every parameter)."""
    jcfg, pcfg, params, stats, batch, grads = jax_step
    images = batch["masked_images"] if step % 2 else batch["images"]
    g_jax, (l_jax, stats_jax, _) = grads(params, stats, images, train=train_mode)

    state = _port_state(pcfg, params, stats, step)
    state, l_port = make_train_step(pcfg, train_mode=train_mode)(state, batch)
    assert state.step == step + 1
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(l_port[k]), float(l_jax[k]), rtol=2e-4, atol=2e-4,
                                   err_msg=k)
    want = state_dict_from_jax(jax.device_get(g_jax))
    got = dict(state.model.named_parameters())
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name].grad
        g = torch.zeros_like(w) if g is None else g
        bound = 1e-3 * float(w.abs().max()) + 1e-12
        assert float((g - w).abs().max()) <= bound, (name, float((g - w).abs().max()), bound)
    new_stats = state_dict_from_jax({}, jax.device_get(stats_jax))
    buffers = dict(state.model.named_buffers())
    assert sorted(buffers) == sorted(new_stats)
    for name, w in new_stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), w.numpy(), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


def test_training_outputs_match_jax(jax_step):
    """The training forward's MLM hidden rows (gathered by the plan), ITM
    logits and T2I pixels."""
    from mvlt_tpu_torch.train.losses import mlm_gather_plan

    jcfg, pcfg, params, stats, batch, grads = jax_step
    _, (_, _, out_jax) = grads(params, stats, batch["images"], train=True)
    model = _port_state(pcfg, params, stats, 0).model.train()
    idx, _, _ = mlm_gather_plan(torch.from_numpy(batch["mlm_labels"]),
                                capacity_frac=pcfg.mlm_capacity_frac)
    with torch.no_grad():
        out = model(torch.from_numpy(batch["images"]),
                    torch.from_numpy(batch["input_ids"]).long(), mlm_row_idx=idx)
    assert out["mlm_logits"] is None and out["mlm_table"] is model.text_embeddings.word_embeddings.weight
    for k in ("mlm_hidden", "itm_logits", "t2i_logits"):
        assert tuple(out[k].shape) == tuple(out_jax[k].shape), k
        np.testing.assert_allclose(out[k].numpy(), np.asarray(out_jax[k]), rtol=2e-4,
                                   atol=2e-4, err_msg=k)


def test_eval_logits_match_jax():
    """Eval mode with every head: the five logits keys."""
    from mvlt_tpu.models import create_model as jax_create_model

    jcfg, pcfg = _configs(ALL_HEADS)
    model = jax_create_model(jcfg)
    params, stats = _numpy_weights(model, seed=3)
    batch = make_batch(np.random.default_rng(4), b=2)
    want = jax.jit(lambda p, s, im, ids: model.apply(
        {"params": p, "batch_stats": s}, im, ids, train=False))(
        params, stats, batch["images"], batch["input_ids"])
    port = create_model(pcfg, device="cpu").eval()
    port.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(batch["images"]), torch.from_numpy(batch["input_ids"]).long())
    for k in ("mlm_logits", "itm_logits", "sup_cls_logits", "sub_cls_logits", "t2i_logits"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=2e-4, atol=2e-4,
                                   err_msg=k)


def test_drop_path_and_dropout_statistics():
    """The two RNG streams differ from JAX's, so the masks are held to their
    law: DropPath keeps a sample with probability 1 - rate and scales it by
    1 / keep; dropout keeps an element likewise; both are off in eval."""
    blk = Block(16, 1, 2.0, 1, True, drop_path=0.3).train()
    gen = torch.Generator().manual_seed(0)
    s = blk.drop_path_scale(torch.zeros(20000, 1, 16), gen)
    kept = s[s > 0]
    assert abs(kept.numel() / s.numel() - 0.7) < 0.015
    torch.testing.assert_close(kept, torch.full_like(kept, 1 / 0.7))
    assert blk.eval().drop_path_scale(torch.zeros(8, 1, 16), gen) is None
    y = dropout(torch.ones(200, 100), 0.1, gen)
    kept = y[y > 0]
    assert abs(kept.numel() / y.numel() - 0.9) < 0.01
    torch.testing.assert_close(kept, torch.full_like(kept, 1 / 0.9))


def test_train_one_epoch_on_synthetic_data(capsys):
    """Three synthetic batches with DropPath and dropout on: finite losses,
    three steps; a non-finite loss warns and the epoch goes on."""
    pcfg = dataclasses.replace(_configs(HEADS)[1], drop_path_rate=0.1, bert_dropout=0.1,
                               vocab_size=30522)   # the synthetic captions' vocab
    torch.manual_seed(0)
    state = create_train_state(create_model(pcfg, device="cpu"),
                               config.OptimConfig(warmup_epochs=0), 2, 3)
    data = SyntheticFashionGen(config.DataConfig(input_size=IMG, num_text_tokens=T), size=6)
    step = make_train_step(pcfg)
    state, stats = train_one_epoch(step, state, batches(data, 2), lr_schedule=state.lr_schedule)
    assert state.step == 3
    assert all(np.isfinite(stats[k]) for k in LOSS_KEYS) and stats["loss_mlm"] > 0

    def nan_step(state, batch):
        state.step += 1
        return state, {"total_loss": torch.tensor(float("nan"))}

    capsys.readouterr()
    state, stats = train_one_epoch(nan_step, state, [{}, {}], is_main=False)
    assert state.step == 5 and capsys.readouterr().out.count("non-finite total loss") == 2


@pytest.mark.parametrize("kw", [dict(grad_accum=2), dict(scan_steps=2), dict(device_masks=True)])
def test_unported_step_options_raise(kw):
    with pytest.raises(NotImplementedError):
        make_train_step(_configs(HEADS)[1], **kw)
