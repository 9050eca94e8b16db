"""The port's native host library (mvlt_tpu_torch/data/native.py) against
the JAX package's (mvlt_tpu/data/native.py) and the port's Python twins, on
the CPU: the port's copy of the C++ source is the JAX package's byte for
byte; the batch tokenizer gives the Python WordPiece's ids and the JAX
native tokenizer's (truncation, accents, an unsupported script re-tokenized
in Python); the crop-resize (crop on and off) equals the JAX one in bits and
stays within 1.5/255 of the port's PIL path; the mask fill equals JAX's; a
build that fails raises and returns no image; three threads building at
once share one library."""

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from mvlt_tpu.data import native as jax_native
from mvlt_tpu_torch.data import image_ops, native
from mvlt_tpu_torch.data.tokenizer import WordPieceTokenizer, make_tokenizer
from tests.test_torch_port_train import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = "preweights/bert-base-uncased-vocab.txt"
TEXTS = [
    "Long sleeve shirt in midnight blue stretch cotton poplin.",
    "WOOL-BLEND twill coat, Double-breasted button closure at front!",
    "Zippered pocket & logo plaque: 3M reflective trim...",
    "item number 4217 unaffable preconditions overengineering",
    "",
    "Café ÉPONGE slippers w/ 100% leather soles",     # Latin-1 accents
    "sizes 36–42 available",                          # en dash (U+2013)
    "日本語のキャプション fallback row",                 # CJK: the Python WordPiece
    "embroidered " * 40,                              # past max_length: truncated
]


@pytest.fixture(scope="module")
def tokenizers():
    return make_tokenizer(VOCAB), WordPieceTokenizer(VOCAB), jax_native.NativeTokenizer(VOCAB)


def test_source_is_the_jax_packages_copy():
    with open(os.path.join(REPO, "native", "mvlt_native.cc"), "rb") as f:
        want = f.read()
    assert native.SOURCE.read_bytes() == want
    assert native.CXX_FLAGS == ("-O3", "-std=c++17", "-shared", "-fPIC")
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.parent.parts[-2:] == ("build", "mvlt_tpu_torch")


@pytest.mark.parametrize("max_length", [16, 32])
def test_encode_batch_matches_python_and_jax(tokenizers, max_length):
    ours, plain, theirs = tokenizers
    assert isinstance(ours, native.NativeTokenizer) and theirs.native_available
    got = ours.encode_batch(TEXTS, max_length)
    want = np.stack([np.asarray(plain.encode(t, max_length), np.int32) for t in TEXTS])
    assert got.dtype == np.int32 and got.shape == (len(TEXTS), max_length)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, theirs.encode_batch(TEXTS, max_length))
    assert ours.encode_batch([], max_length).shape == (0, max_length)
    for text in TEXTS:
        assert ours.tokenize_to_ids(text) == plain.tokenize_to_ids(text) == \
            theirs.tokenize_to_ids(text), text
    assert (ours.cls_id, ours.sep_id, ours.pad_id, ours.mask_id, len(ours)) == \
        (plain.cls_id, plain.sep_id, plain.pad_id, plain.mask_id, len(plain))


def test_unsupported_script_goes_through_python(tokenizers, monkeypatch):
    """The C++ tokenizer flags the CJK row, and only that row is encoded
    again by the Python WordPiece."""
    ours, _, _ = tokenizers
    seen = []
    encode = WordPieceTokenizer.encode
    monkeypatch.setattr(WordPieceTokenizer, "encode",
                        lambda self, text, n: seen.append(text) or encode(self, text, n))
    ours.encode_batch(TEXTS, 16)
    assert seen == [TEXTS[7]]


def _photo(rng, h, w):
    arr = np.full((h, w, 3), 255, np.uint8)
    arr[h // 6:h - h // 4, w // 7:w - w // 5] = rng.integers(0, 120, (
        h - h // 4 - h // 6, w - w // 5 - w // 7, 3), np.uint8)
    arr[rng.integers(0, h, 5), rng.integers(0, w, 5)] = 200
    return arr


@pytest.mark.parametrize("crop", [True, False])
def test_crop_resize_equals_jax_and_is_near_pil(crop):
    rng = np.random.default_rng(3)
    for h, w, size in ((80, 70, 32), (37, 53, 24), (64, 64, 64)):
        arr = _photo(rng, h, w)
        got = native.native_crop_resize(arr, size, crop=crop)
        assert got.dtype == np.float32 and got.shape == (size, size, 3)
        np.testing.assert_array_equal(got, jax_native.native_crop_resize(arr, size, crop=crop))
        pil = image_ops.image_from_array(arr, size, crop=crop)
        assert np.abs(got - pil).max() < 1.5 / 255
    with pytest.raises(ValueError, match="H, W, 3"):
        native.native_crop_resize(np.zeros((4, 4), np.uint8), 8)


def test_apply_mask_equals_jax():
    rng = np.random.default_rng(4)
    images = rng.random((3, 16, 12, 3)).astype(np.float32)
    masks = (rng.random((3, 16, 12)) < 0.4).astype(np.float32)
    got = native.native_apply_mask(images, masks)
    np.testing.assert_array_equal(got, jax_native.native_apply_mask(images, masks))
    np.testing.assert_array_equal(got, np.where(masks[..., None] > 0.5, np.float32(1e-6), images))


@pytest.fixture
def no_library(monkeypatch, tmp_path):
    """A build into an empty directory with a compiler that does not exist;
    the loaded library is forgotten before and after."""
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.load_library.cache_clear()
    yield tmp_path
    native.load_library.cache_clear()


def test_failed_build_raises(no_library):
    """No fallback: the crop-resize, the mask fill and the tokenizer raise
    with the compiler's error, and nothing is left in the build directory."""
    arr = _photo(np.random.default_rng(5), 40, 30)
    with pytest.raises(RuntimeError, match="no-such-g"):
        native.native_crop_resize(arr, 16)
    with pytest.raises(RuntimeError, match="no-such-g"):
        native.native_apply_mask(np.zeros((1, 2, 2, 3), np.float32), np.zeros((1, 2, 2), np.float32))
    with pytest.raises(RuntimeError, match="no-such-g"):
        make_tokenizer(VOCAB)
    assert not list((no_library / "build").glob("*"))


def test_concurrent_first_builds(monkeypatch, tmp_path):
    """Three threads build into one empty directory at once (as the
    loader's decode threads and the test workers do at first use): each
    gets the same library, which loads, and no temporary file is left."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    with ThreadPoolExecutor(3) as pool:
        paths = [f.result(timeout=120) for f in [pool.submit(native.build) for _ in range(3)]]
    assert len(set(paths)) == 1 and paths[0].parent == tmp_path
    assert sorted(p.name for p in tmp_path.iterdir()) == [paths[0].name]
    assert ctypes.CDLL(str(paths[0])).mvlt_crop_resize
