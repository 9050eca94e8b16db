"""The port's Fashion-Gen readers, image ops and masks against the JAX
package's, on a small on-disk tree made here with PIL: every item of the
pre-training reader (train and valid splits, two epochs, grid, square and
stroke masks, the valid split's pickled masks in CHW and HW form, with and
without ITM negatives; both splits smaller than 52 items, where the
negative offset is clamped), of the retrieval reader (ITR and TIR) and of
the recognition reader, equal array by array to the JAX reader's with the
native crop-resize of the train split off on both sides, and with it on
(the default) on both sides."""

import pickle

import numpy as np
import pytest
from PIL import Image

from mvlt_tpu import config as jax_config
from mvlt_tpu.data import fashion_gen as jax_fg
from mvlt_tpu.data import image_ops as jax_image_ops
from mvlt_tpu.data import masks as jax_masks
from mvlt_tpu_torch import config
from mvlt_tpu_torch.data import fashion_gen, image_ops, masks
from tests.test_torch_port_train import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

VOCAB = "preweights/bert-base-uncased-vocab.txt"
SIZE = 32
SPLITS = {"train": 14, "valid": 9}
CAPTIONS = ["wool blend twill coat with double breasted buttons",
            "ribbed knit beanie in heathered merino wool",
            "leather ankle boots with a stacked heel"]


def _image(rng, i):
    """A product photo on white: a coloured block, somewhere off centre, on
    a canvas of varying shape, with grey specks the dithered crop sees."""
    h, w = 36 + 4 * (i % 3), 44 - 2 * (i % 4)
    arr = np.full((h, w, 3), 255, np.uint8)
    y, x = rng.integers(2, 10), rng.integers(2, 12)
    arr[y:h - 6, x:w - 5] = rng.integers(0, 230, (h - 6 - y, w - 5 - x, 3), np.uint8)
    arr[rng.integers(0, h, 6), rng.integers(0, w, 6)] = 200
    return arr


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("fashion_gen")
    rng = np.random.default_rng(0)
    for split, n in SPLITS.items():
        (root / f"extracted_{split}_images").mkdir()
        (root / f"full_{split}_info_PAI").mkdir()
        for i in range(n):
            name = f"prod{i:04d}_img.{'png' if i % 2 else 'jpg'}"
            Image.fromarray(_image(rng, i)).save(root / f"extracted_{split}_images" / name)
            info = {"product_id": i, "img_name": name, "super_cls_id": int(rng.integers(0, 48)),
                    "sub_cls_id": int(rng.integers(0, 122)), "super_cls_name": "x",
                    "sub_cls_name": "y", "captions": f"item {i} {CAPTIONS[i % 3]}"}
            with open(root / f"full_{split}_info_PAI" / f"prod{i:04d}_info.pkl", "wb") as f:
                pickle.dump(info, f)
    # the valid split's stored masks: grid masks pickled CHW (ratio 0.5,
    # patch 16), noise masks pickled HW
    grid_dir = root / "generated_valid_masking0.50_size16_images"
    noise_dir = root / "generated_valid_noise_images"
    grid_dir.mkdir()
    noise_dir.mkdir()
    for i in range(SPLITS["valid"]):
        with open(grid_dir / f"m{i:04d}.pkl", "wb") as f:
            pickle.dump((rng.random((3, SIZE, SIZE)) < 0.5).astype(np.float32), f)
        with open(noise_dir / f"m{i:04d}.pkl", "wb") as f:
            pickle.dump((rng.random((SIZE, SIZE)) < 0.3).astype(np.float64), f)
    for direction in ("ITR", "TIR"):
        d = root / f"retrieve_{direction}"
        d.mkdir()
        for q in range(3):
            bundle = {c: {"img_name": f"prod{(q + c) % SPLITS['valid']:04d}_img."
                                      f"{'png' if (q + c) % SPLITS['valid'] % 2 else 'jpg'}",
                          "captions": f"item {q + c} {CAPTIONS[(q + 2 * c) % 3]}"}
                      for c in range(5)}
            with open(d / f"q{q:04d}.pkl", "wb") as f:
                pickle.dump(bundle, f)
    return str(root)


def _cfgs(native=False, **kw):
    kw = dict(input_size=SIZE, num_text_tokens=16, vocab_file=VOCAB, word_mask_rate=0.3,
              use_native_image_ops=native, **kw)
    return config.DataConfig(**kw), jax_config.DataConfig(**kw)


def _assert_items_equal(got, want, where):
    assert sorted(got) == sorted(want), where
    for k, w in want.items():
        if isinstance(w, np.ndarray) or np.isscalar(w):
            g = np.asarray(got[k])
            assert g.dtype == np.asarray(w).dtype, (where, k)
            assert np.array_equal(g, w), (where, k)
        else:
            assert got[k] == w, (where, k)


@pytest.mark.parametrize("split,strategy,ratio,itm", [
    ("train", "random_grid", 0.5, True),
    ("train", "random_grid", 0.5, False),
    ("train", "square", 4.0, True),
    ("train", "stroke", 0.5, True),
    ("valid", "random_grid", 0.5, True),     # pickled CHW grid masks
    ("valid", "random_grid", 0.25, True),    # no stored masks at this ratio
    ("valid", "stroke", 0.5, True),          # pickled HW noise masks
])
def test_pretrain_items_match_jax(tree, split, strategy, ratio, itm):
    cfg, jcfg = _cfgs(mask_strategy=strategy, mask_ratio=ratio)
    ours = fashion_gen.FashionGenPretrain(tree, split, cfg, itm_enabled=itm, seed=3)
    theirs = jax_fg.FashionGenPretrain(tree, split, jcfg, itm_enabled=itm, seed=3)
    assert len(ours) == len(theirs) == SPLITS[split]
    assert (ours.mask_files is None) == (theirs.mask_dir is None)
    labels = []
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for i in range(len(ours)):
            got, want = ours[i], theirs[i]
            _assert_items_equal(got, want, (split, epoch, i))
            labels.append(int(got["itm_labels"]))
    assert set(labels) == ({0, 1} if itm else {1})


def test_pretrain_native_images_within_tolerance(tree):
    """With the native crop-resize on (the default on both sides), every
    array of every train item equals the JAX reader's, the images in bits;
    they differ from the PIL path's (by at most 1.5/255), so the native
    path ran; the valid split keeps PIL, as in JAX."""
    cfg, jcfg = _cfgs(native=True, mask_strategy="random_grid", mask_ratio=0.5)
    assert config.DataConfig().use_native_image_ops and cfg.use_native_image_ops
    ours = fashion_gen.FashionGenPretrain(tree, "train", cfg, seed=1)
    theirs = jax_fg.FashionGenPretrain(tree, "train", jcfg, seed=1)
    pil = fashion_gen.FashionGenPretrain(tree, "train", _cfgs()[0], seed=1)
    differs = 0
    for i in range(len(ours)):
        got = ours[i]
        _assert_items_equal(got, theirs[i], i)
        plain = pil[i]["images"]
        assert np.abs(got["images"] - plain).max() < 1.5 / 255
        differs += not np.array_equal(got["images"], plain)
    assert differs == len(ours)
    valid = fashion_gen.FashionGenPretrain(tree, "valid", cfg, seed=1)
    _assert_items_equal(valid[0], jax_fg.FashionGenPretrain(tree, "valid", jcfg, seed=1)[0],
                        "valid")
    assert np.array_equal(valid[0]["images"], image_ops.load_image(valid.images[0], SIZE))


@pytest.mark.parametrize("direction", ["itr", "tir"])
def test_retrieval_items_match_jax(tree, direction):
    cfg, jcfg = _cfgs()
    ours = fashion_gen.FashionGenRetrieval(tree, cfg, direction)
    theirs = jax_fg.FashionGenRetrieval(tree, jcfg, direction)
    assert len(ours) == len(theirs) == 3
    for i in range(3):
        got = ours[i]
        _assert_items_equal(got, theirs[i], (direction, i))
        assert got["images_101"].dtype == np.uint8 and got["images_101"].shape == (5, SIZE, SIZE, 3)


def test_recognition_items_match_jax(tree):
    cfg, jcfg = _cfgs()
    ours = fashion_gen.FashionGenRecognition(tree, cfg)
    theirs = jax_fg.FashionGenRecognition(tree, jcfg)
    assert len(ours) == len(theirs) == SPLITS["valid"]
    for i in range(len(ours)):
        _assert_items_equal(ours[i], theirs[i], i)
    assert ours[0]["images"].dtype == np.uint8


def test_image_ops_match_jax(tree):
    """The dithered whitespace crop, the uint8 and float loads and the
    decoded-array path give the JAX package's pixels."""
    import glob

    rng = np.random.default_rng(5)
    for i in range(6):
        arr = _image(rng, i)
        img = Image.fromarray(arr)
        assert image_ops.whitespace_crop(img).size == jax_image_ops.whitespace_crop(img).size
        for crop in (True, False):
            assert np.array_equal(image_ops.image_from_array(arr, SIZE, crop),
                                  jax_image_ops.image_from_array(arr, SIZE, crop))
    blank = Image.fromarray(np.full((8, 8, 3), 255, np.uint8))
    assert image_ops.whitespace_crop(blank) is blank
    for path in sorted(glob.glob(f"{tree}/extracted_valid_images/*"))[:4]:
        u8 = image_ops.load_image_u8(path, SIZE)
        assert np.array_equal(u8, jax_image_ops.load_image_u8(path, SIZE))
        assert np.array_equal(image_ops.load_image(path, SIZE), jax_image_ops.load_image(path, SIZE))
        assert np.array_equal(image_ops.load_image(path, SIZE), u8.astype(np.float32) / 255.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_square_and_stroke_masks_match_jax(seed):
    for size, box in ((32, 8), (64, 16)):
        assert np.array_equal(masks.generate_square_mask(size, box, np.random.default_rng(seed)),
                              jax_masks.generate_square_mask(size, box, np.random.default_rng(seed)))
        got = masks.generate_stroke_mask(size, rng=np.random.default_rng(seed))
        want = jax_masks.generate_stroke_mask(size, rng=np.random.default_rng(seed))
        assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
        assert 0 < got.sum() < size * size


def test_build_dataset_reads_the_tree_and_missing_trees_raise(tree, tmp_path):
    """A data_path gives the on-disk reader; a missing directory raises, as
    os.listdir does, and nothing falls back to synthetic data."""
    cfg = config.DataConfig(input_size=SIZE, num_text_tokens=16, vocab_file=VOCAB,
                            data_path=tree)
    ds = fashion_gen.build_dataset("valid", cfg, seed=2)
    assert isinstance(ds, fashion_gen.FashionGenPretrain) and len(ds) == SPLITS["valid"]
    synthetic = fashion_gen.build_dataset("train", config.DataConfig(synthetic=True, data_path=tree))
    assert isinstance(synthetic, fashion_gen.SyntheticFashionGen)
    missing = str(tmp_path / "absent")
    with pytest.raises(FileNotFoundError):
        fashion_gen.build_dataset("train", config.DataConfig(data_path=missing))
    with pytest.raises(FileNotFoundError):
        fashion_gen.FashionGenRetrieval(missing, cfg, "itr")
    with pytest.raises(FileNotFoundError):
        fashion_gen.FashionGenRecognition(missing, cfg)
    with pytest.raises(ValueError, match="split"):
        fashion_gen.FashionGenPretrain(tree, "test", cfg)
