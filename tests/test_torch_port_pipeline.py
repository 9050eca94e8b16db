"""The port's input pipeline and clipping against the JAX package's, on the
CPU: device grid masks fed with JAX's own uniforms (bit-equal), the
samplers' index streams and the DataLoader's batches (equal for the same
seed and epoch, also stacked two steps a group), the dataset factory, and gradient clipping against
optax.clip_by_global_norm (2e-7 relative, fp32)."""

import functools

import jax
import numpy as np
import optax
import pytest
import torch

from mvlt_tpu.data import masks as jax_masks
from mvlt_tpu.data import pipeline as jax_pipeline
from mvlt_tpu.data import samplers as jax_samplers
from mvlt_tpu.data.fashion_gen import SyntheticFashionGen as JaxSynthetic
from mvlt_tpu_torch.config import DataConfig
from mvlt_tpu_torch.data import samplers
from mvlt_tpu_torch.data.fashion_gen import SyntheticFashionGen, build_dataset
from mvlt_tpu_torch.data.masks import (device_apply_mask, device_grid_masks,
                                       grid_masks_from_uniforms)
from mvlt_tpu_torch.data.pipeline import DataLoader, stack_group, to_device
from mvlt_tpu_torch.train.schedule import clip_by_global_norm
from tests.test_torch_port_train import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

SMALL = dict(input_size=32, num_text_tokens=16)


@pytest.mark.parametrize("batch,size,ratio,patch", [(4, 256, 0.5, 16), (3, 64, 0.3, 8)])
def test_device_grid_masks_bit_equal_to_jax(batch, size, ratio, patch):
    key = jax.random.PRNGKey(batch)
    g = size // patch
    u = np.array(jax.random.uniform(key, (batch, g * g)))
    want = np.asarray(jax_masks.device_grid_masks(key, batch, size, ratio, patch))
    got = grid_masks_from_uniforms(torch.from_numpy(u), size, ratio, patch).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    images = np.random.default_rng(0).random((batch, size, size, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        device_apply_mask(torch.from_numpy(images), torch.from_numpy(got)).numpy(),
        np.asarray(jax_masks.device_apply_mask(images, want)))


def test_device_grid_masks_count_per_sample():
    """From the port's own generator: exactly int(ratio * patches) whole
    patches per sample, and other draws on the next call."""
    gen = torch.Generator().manual_seed(3)
    a = device_grid_masks(gen, 5, 64, 0.5, 16)
    b = device_grid_masks(gen, 5, 64, 0.5, 16)
    patches = a.reshape(5, 4, 16, 4, 16)[:, :, 0, :, 0]
    assert torch.equal(a, patches[:, :, None, :, None].expand(5, 4, 16, 4, 16).reshape(5, 64, 64))
    assert patches.sum((1, 2)).tolist() == [8.0] * 5
    assert not torch.equal(a, b)


@pytest.mark.parametrize("kind,args", [
    ("RepeatedAugmentSampler", (64, 0, 1, 3, 0)),
    ("RepeatedAugmentSampler", (1000, 1, 4, 3, 7)),
    ("DistributedSampler", (37, 2, 4)),
    ("SequentialSampler", (11,)),
])
def test_sampler_streams_match_jax(kind, args):
    ours, theirs = getattr(samplers, kind)(*args), getattr(jax_samplers, kind)(*args)
    for epoch in (0, 3):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        assert len(ours) == len(theirs)
        assert list(ours) == list(theirs)


@pytest.mark.parametrize("drop_last", [True, False])
def test_dataloader_batches_match_jax(drop_last):
    """The same items, order, batches and dropped keys for the same seed and
    epoch; put_fn turns the arrays into tensors on the device."""
    cfg = DataConfig(**SMALL)
    ours_ds = SyntheticFashionGen(cfg, size=10, seed=4)
    theirs_ds = JaxSynthetic(cfg, size=10, seed=4)
    kw = dict(batch_size=4, num_workers=2, drop_last=drop_last, drop_keys=("t2i_labels",))
    ours = DataLoader(ours_ds, samplers.RepeatedAugmentSampler(10, 0, 1, 3, 4),
                      put_fn=functools.partial(to_device, device="cpu"), **kw)
    theirs = jax_pipeline.DataLoader(theirs_ds, jax_samplers.RepeatedAugmentSampler(10, 0, 1, 3, 4),
                                     **kw)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours) == len(theirs)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w) and "t2i_labels" not in g
            for k in w:
                assert isinstance(g[k], torch.Tensor)
                np.testing.assert_array_equal(g[k].numpy(), w[k], err_msg=k)
    assert len(got[-1]["images"]) == (4 if drop_last else 2)


def test_stacked_dataloader_matches_jax():
    """stack_steps=2 on 7 batches of 4: three groups (the seventh batch
    dropped), each array [2, 4, ...] equal to JAX's DataLoader(stack_steps=2)
    and to the unstacked loader's consecutive batches; put_fn moves each
    group to the device once; an info list becomes a 2-list of lists."""
    cfg = DataConfig(**SMALL)
    kw = dict(batch_size=4, num_workers=2, drop_keys=("t2i_labels",))
    puts = []

    def put(batch):
        puts.append(sorted(batch))
        return to_device(batch, "cpu")

    ours = DataLoader(SyntheticFashionGen(cfg, size=28, seed=2), samplers.SequentialSampler(28),
                      put_fn=put, stack_steps=2, **kw)
    theirs = jax_pipeline.DataLoader(JaxSynthetic(cfg, size=28, seed=2),
                                     jax_samplers.SequentialSampler(28), stack_steps=2, **kw)
    single = list(DataLoader(SyntheticFashionGen(cfg, size=28, seed=2),
                             samplers.SequentialSampler(28), **kw))
    got, want = list(ours), list(theirs)
    assert len(ours) == len(theirs) == len(got) == len(want) == 3 and len(puts) == 3
    for j, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w) and "t2i_labels" not in g
        for k in w:
            assert isinstance(g[k], torch.Tensor) and g[k].shape[:2] == (2, 4), k
            np.testing.assert_array_equal(g[k].numpy(), w[k], err_msg=k)
            for i in range(2):
                np.testing.assert_array_equal(g[k][i].numpy(), single[2 * j + i][k], err_msg=k)
    groups = [{"x": np.full((2,), i), "info_list": [f"a{i}", f"b{i}"]} for i in range(2)]
    stacked = stack_group(groups)
    assert stacked["x"].shape == (2, 2) and stacked["info_list"] == [["a0", "b0"], ["a1", "b1"]]
    assert stacked["info_list"] == jax_pipeline._stack_group(groups)["info_list"]


def test_dataloader_raises_producer_errors_in_the_consumer():
    class Broken:
        def __len__(self):
            return 6

        def __getitem__(self, i):
            if i == 4:
                raise KeyError("item 4")
            return {"x": np.zeros(2, np.float32)}

    loader = DataLoader(Broken(), samplers.SequentialSampler(6), 2)
    it = iter(loader)
    assert next(it)["x"].shape == (2, 2)
    with pytest.raises(KeyError, match="item 4"):
        list(it)


def test_build_dataset_synthetic_or_refused():
    cfg = DataConfig(**SMALL)
    assert isinstance(build_dataset("train", cfg), SyntheticFashionGen)
    assert isinstance(build_dataset("valid", DataConfig(data_path="/data/fg", synthetic=True)),
                      SyntheticFashionGen)
    # a data_path takes the on-disk reader, which raises where there is no
    # tree instead of standing in synthetic data
    with pytest.raises(FileNotFoundError, match="extracted_train_images"):
        build_dataset("train", DataConfig(data_path="/data/fg"))


@pytest.mark.parametrize("max_norm", [0.5, 50.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    """Clipped (norm above max_norm) and untouched (below): the gradients
    equal optax's to fp32 rounding; a parameter without a gradient is
    skipped."""
    rng = np.random.default_rng(0)
    grads = {"a": rng.standard_normal((5, 7)).astype(np.float32),
             "b": rng.standard_normal(3).astype(np.float32)}
    want, _ = optax.clip_by_global_norm(max_norm).update(grads, optax.EmptyState())
    params = []
    for g in grads.values():
        p = torch.zeros(g.shape, requires_grad=True)
        p.grad = torch.from_numpy(g.copy())
        params.append(p)
    params.append(torch.zeros(2, requires_grad=True))
    norm = clip_by_global_norm(params, max_norm)
    np.testing.assert_allclose(float(norm), np.sqrt(sum((g ** 2).sum() for g in grads.values())),
                               rtol=1e-6)
    for p, w in zip(params, want.values()):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=2e-7, atol=0)
    clipped = float(norm) >= max_norm
    assert clipped == (max_norm == 0.5)
    if not clipped:
        assert all(np.array_equal(p.grad.numpy(), g) for p, g in zip(params, grads.values()))
