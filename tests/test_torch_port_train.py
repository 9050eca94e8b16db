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
import types

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


def _numpy_weights(model, seed, img=IMG):
    """Trees shaped by tracing the JAX init at ``img`` x ``img``, filled from
    a numpy seed: matrices small, LayerNorm and BatchNorm scales near 1,
    running variances positive."""
    variables = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                               jnp.zeros((1, img, img, 3)), jnp.zeros((1, T), jnp.int32))
    gen = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        base = 1.0 if ("scale" in name or "'var'" in name) else 0.0
        std = 0.1 if leaf.ndim == 1 else 0.2 / np.sqrt(np.prod(leaf.shape[:-1]))
        return (base + std * gen.standard_normal(leaf.shape)).astype(np.float32)

    return (jax.tree_util.tree_map_with_path(fill, variables["params"]),
            jax.tree_util.tree_map_with_path(fill, variables["batch_stats"]))


def make_batch(rng, b=B, img=IMG):
    imgs = rng.random((b, img, img, 3)).astype(np.float32)
    return {
        "images": imgs,
        "masked_images": np.where(rng.random((b, img, img, 1)) < 0.5, 1e-6, imgs).astype(np.float32),
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
    return build_jax_step(*_configs(HEADS))


def build_jax_step(jcfg, pcfg, img=IMG):
    """The fixture's tuple for any pair of configs, at ``img`` x ``img``."""
    from mvlt_tpu.models import create_model as jax_create_model
    from mvlt_tpu.train.losses import compute_losses, mlm_gather_plan

    model = jax_create_model(jcfg)
    params, stats = _numpy_weights(model, seed=1, img=img)
    batch = make_batch(np.random.default_rng(2), img=img)

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


@pytest.fixture(scope="module")
def one_torch_thread():
    """Runs a module's models on one torch thread: their many small ops
    wait on the thread pool's barriers in a loaded multi-worker run (a
    gradcheck took 420 s there on eight threads a worker, 2.5 s on one).
    Every tests/test_torch_port_*.py module takes it (pytestmark)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


def _port_state(pcfg, params, stats, step, img=IMG):
    model = create_model(pcfg, device="cpu", input_size=img)
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    state = create_train_state(model, config.OptimConfig(warmup_epochs=0), B, 10)
    state.step = step
    return state


@pytest.mark.parametrize("step,train_mode", [(0, True), (1, True), (0, False)])
def test_step_matches_jax(jax_step, step, train_mode):
    """Losses, every gradient and the new BatchNorm statistics; step 1 runs
    on the masked images; train_mode=False is the fine-tune quirk (eval-mode
    forward, full MLM decode, gradients to every parameter)."""
    check_step_against_jax(jax_step, jax_step[1], step, train_mode)


def check_step_against_jax(jax_step, pcfg, step, train_mode):
    """One port step of ``pcfg`` against the JAX step of the fixture: losses
    to 2e-4, every gradient to 1e-3 of its largest magnitude, the new
    BatchNorm statistics to 2e-4."""
    jcfg, _, params, stats, batch, grads = jax_step
    images = batch["masked_images"] if step % 2 else batch["images"]
    g_jax, (l_jax, stats_jax, _) = grads(params, stats, images, train=train_mode)

    state = _port_state(pcfg, params, stats, step, img=images.shape[1])
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
    idx, _, _, _ = mlm_gather_plan(torch.from_numpy(batch["mlm_labels"]),
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


def test_train_one_epoch_drains_k_rows_a_call(capsys):
    """steps_per_dispatch=2 (mvlt_tpu/train/engine.py:_drain): each call's
    two rows are logged once each, row i as step step_idx + i (a non-finite
    one warns with its own index), the LR logged is the call's last step's,
    and the stacked info lists never reach the step."""
    lrs = []

    def lr_schedule(step):
        lrs.append(step)
        return float(step)

    def step(state, batch):
        assert sorted(batch) == ["v"]
        state.step += 2
        v = torch.as_tensor(batch["v"])
        return state, {"total_loss": v, "loss_mlm": torch.arange(2.0) + state.step}

    calls = [{"v": np.array([1.0, 2.0]), "info_list": [["a"], ["b"]]},
             {"v": np.array([float("nan"), 4.0]), "info_list": [["c"], ["d"]]},
             {"v": np.array([5.0, float("inf")]), "info_list": [["e"], ["f"]]}]
    state = types.SimpleNamespace(step=10)
    capsys.readouterr()
    state, stats = train_one_epoch(step, state, calls, lr_schedule=lr_schedule, is_main=False,
                                   steps_per_dispatch=2)
    assert state.step == 16 and lrs == [11, 13, 15] and stats["lr"] == 13.0
    assert stats["loss_mlm"] == np.mean([12, 13, 14, 15, 16, 17])
    warned = [ln for ln in capsys.readouterr().out.splitlines() if "non-finite" in ln]
    assert [ln.split(" at step ")[1].split(":")[0] for ln in warned] == ["12", "15"]
    with pytest.raises(ValueError, match="rows"):
        train_one_epoch(step, state, calls[:1], is_main=False, steps_per_dispatch=3)


@pytest.mark.parametrize("kw", [dict(scan_steps=2), dict(scan_steps=2, grad_accum=2),
                                dict(scan_steps=2, drop_path_rate=0.1, bert_dropout=0.1)])
def test_unported_step_options_raise(jax_step, kw):
    """scan_steps=2 (once refused, hence the name) on a batch stacked [2, B]
    equals two single steps in bits, from an even and from an odd step, also
    with grad_accum=2 and with DropPath and dropout on: the stacked losses,
    every parameter and buffer, every AdamW moment, the step and the
    generator's state."""
    jcfg, pcfg, params, stats, batch, _ = jax_step
    opts = {k: v for k, v in kw.items() if k in ("scan_steps", "grad_accum")}
    pcfg = dataclasses.replace(pcfg, **{k: v for k, v in kw.items() if k not in opts})
    second = make_batch(np.random.default_rng(7))
    stacked = {k: np.stack([batch[k], second[k]]) for k in batch}
    single = make_train_step(pcfg, grad_accum=opts.get("grad_accum", 1))
    for start in (1, 0):   # the last, from step 0, is held to JAX below
        a = _port_state(pcfg, params, stats, start)
        b = _port_state(pcfg, params, stats, start)
        a, l0 = single(a, batch)
        a, l1 = single(a, second)
        b, losses = make_train_step(pcfg, **opts)(b, stacked)
        assert a.step == b.step == start + 2
        for k in LOSS_KEYS:
            assert losses[k].shape == (2,) and torch.equal(losses[k], torch.stack([l0[k], l1[k]]))
        sa, sb = a.model.state_dict(), b.model.state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
        oa, ob = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
        assert sorted(oa) == sorted(ob) and all(torch.equal(oa[i][k], ob[i][k])
                                                for i in oa for k in oa[i])
        assert torch.equal(a.generator.get_state(), b.generator.get_state())
    if kw == dict(scan_steps=2):
        check_scan_against_jax(jax_step, stacked, b, losses)


def check_scan_against_jax(jax_step, stacked, state, losses):
    """The port's two steps from step 0 against mvlt_tpu/train/step.py's
    make_train_step(scan_steps=2) from the same weights and AdamW schedule:
    the stacked losses and the BatchNorm statistics to 2e-4, and AdamW's
    first moments (0.1 (0.9 g0 + g1)) to 1e-3 of each tensor's largest
    magnitude, the tolerances of test_step_matches_jax."""
    import optax

    from mvlt_tpu.models import create_model as jax_create_model
    from mvlt_tpu.train.schedule import make_optimizer
    from mvlt_tpu.train.state import TrainState
    from mvlt_tpu.train.step import make_train_step as jax_make_train_step

    jcfg, _, params, stats, _, _ = jax_step
    tx = make_optimizer(jax_config.OptimConfig(warmup_epochs=0), B, 10)
    jstate = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                        opt_state=tx.init(params), tx=tx)
    scan = jax_make_train_step(jax_create_model(jcfg), jcfg, donate=False, scan_steps=2)
    jstate, jlosses = scan(jstate, stacked, jax.random.PRNGKey(0))
    assert int(jstate.step) == state.step == 2
    for k in LOSS_KEYS:
        np.testing.assert_allclose(losses[k].numpy(), np.asarray(jlosses[k]), rtol=2e-4,
                                   atol=2e-4, err_msg=k)
    buffers = dict(state.model.named_buffers())
    for name, w in state_dict_from_jax({}, jax.device_get(jstate.batch_stats)).items():
        np.testing.assert_allclose(buffers[name].numpy(), w.numpy(), rtol=2e-4, atol=2e-4,
                                   err_msg=name)
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    got = dict(state.model.named_parameters())
    for name, w in state_dict_from_jax(jax.device_get(adam.mu)).items():
        m = state.optimizer.state[got[name]]["exp_avg"]
        bound = 1e-3 * float(w.abs().max()) + 1e-12
        assert float((m - w).abs().max()) <= bound, (name, float((m - w).abs().max()), bound)


def test_grad_accum_step_matches_jax(jax_step):
    """grad_accum=2 at step 1 (masked images) against mvlt_tpu/train/step.py's
    microbatch loop: the halves in order, each with its own gather plan, the
    BatchNorm statistics threaded from the first half into the second, the
    gradients averaged and the losses the means of the halves'; at the
    tolerances of test_step_matches_jax."""
    from mvlt_tpu.models import create_model as jax_create_model
    from mvlt_tpu.train.losses import compute_losses, mlm_gather_plan

    jcfg, pcfg, params, stats, batch, _ = jax_step
    model = jax_create_model(jcfg)

    @jax.jit
    def micro_grads(params, stats, mb):
        kwargs, loss_batch = {}, mb
        chunk, frac = max(jcfg.mlm_loss_chunk, 1), jcfg.mlm_capacity_frac
        plan = mlm_gather_plan(mb["mlm_labels"], capacity_frac=frac, chunk=chunk)
        if plan is not None:
            kwargs["mlm_row_idx"], sel, chunk = plan
            loss_batch, frac = {**mb, "mlm_labels": sel[None]}, 1.0

        def loss_fn(p):
            out, new = model.apply({"params": p, "batch_stats": stats}, mb["masked_images"],
                                   mb["input_ids"], train=True, mutable=["batch_stats"],
                                   rngs={"dropout": jax.random.PRNGKey(0)}, **kwargs)
            losses = compute_losses(out, loss_batch, mlm_chunk=chunk, mlm_capacity_frac=frac,
                                    mlm_ce_kernel=False)
            return losses["total_loss"], (losses, new["batch_stats"])

        return jax.grad(loss_fn, has_aux=True)(params)

    half = B // 2
    g_acc, s, parts = jax.tree_util.tree_map(jnp.zeros_like, params), stats, []
    for i in range(2):
        mb = {k: v[i * half:(i + 1) * half] for k, v in batch.items()}
        g, (losses, s) = micro_grads(params, s, mb)
        g_acc = jax.tree_util.tree_map(lambda a, b: a + b / 2, g_acc, g)
        parts.append(losses)

    state = _port_state(pcfg, params, stats, 1)
    state, l_port = make_train_step(pcfg, grad_accum=2)(state, batch)
    assert state.step == 2
    for k in LOSS_KEYS:
        want = (float(parts[0][k]) + float(parts[1][k])) / 2
        np.testing.assert_allclose(float(l_port[k]), want, rtol=2e-4, atol=2e-4, err_msg=k)
    got = dict(state.model.named_parameters())
    for name, w in state_dict_from_jax(jax.device_get(g_acc)).items():
        g = got[name].grad
        g = torch.zeros_like(w) if g is None else g
        bound = 1e-3 * float(w.abs().max()) + 1e-12
        assert float((g - w).abs().max()) <= bound, (name, float((g - w).abs().max()), bound)
    buffers = dict(state.model.named_buffers())
    for name, w in state_dict_from_jax({}, jax.device_get(s)).items():
        np.testing.assert_allclose(buffers[name].numpy(), w.numpy(), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


def test_device_masks_on_odd_steps_only(jax_step):
    """device_masks=True: an even step feeds the clean images and draws
    nothing; an odd step feeds the images with exactly half of the 8x8
    patches filled with 1e-6, the rest untouched, and needs no
    masked_images in the batch."""
    _, pcfg, params, stats, batch, _ = jax_step
    cfg = dataclasses.replace(pcfg, img_size=IMG)
    batch = {k: v for k, v in batch.items() if k != "masked_images"}
    state = _port_state(cfg, params, stats, 0)
    seen = []
    state.model.register_forward_pre_hook(lambda m, args: seen.append(args[0].clone()))
    step = make_train_step(cfg, device_masks=True, mask_ratio=0.5, mask_patch_size=8)
    rng_before = state.generator.get_state()
    state, _ = step(state, batch)
    assert torch.equal(seen[0], torch.from_numpy(batch["images"]))
    assert torch.equal(state.generator.get_state(), rng_before)
    state, losses = step(state, batch)
    images = torch.from_numpy(batch["images"])
    filled = seen[1] == torch.tensor(1e-6)
    assert torch.equal(seen[1][~filled], images[~filled])
    per_patch = filled.all(-1).reshape(B, 4, 8, 4, 8).float().mean((2, 4))
    assert set(per_patch.unique().tolist()) == {0.0, 1.0}
    assert per_patch.sum((1, 2)).tolist() == [8.0] * B
    assert all(np.isfinite(float(v)) for v in losses.values())
