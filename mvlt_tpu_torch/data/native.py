"""The native host library: batch WordPiece tokenizer, crop-resize and mask
fill in C++, loaded with ctypes.

Counterpart of mvlt_tpu/data/native.py, built from the port's own copy of
its source (``mvlt_tpu_torch/native/mvlt_native.cc``, pinned byte for byte
to ``native/mvlt_native.cc`` by tests/test_torch_port_native.py) with the
JAX package's flags (``g++ -O3 -std=c++17 -shared -fPIC``), so the two
libraries compute the same bits. The library is built at first use into
``build/mvlt_tpu_torch/`` at the root of the checkout, named by a hash of
the source and the flags, written under a temporary name and moved into
place, so processes that build at once never load a half-written file.

Kept from the JAX package: the C++ tokenizer flags the rows whose text
holds a script it does not handle, and those rows are tokenized again by
the Python WordPiece (``WordPieceTokenizer``), which is the ground truth.
Not kept: its quiet fallback. Where the library does not build or load,
every entry point raises with the compiler's or the loader's message;
nothing falls back to PIL or to the Python tokenizer.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import List

import numpy as np

from mvlt_tpu_torch.data.tokenizer import WordPieceTokenizer, resolve_vocab_path

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "mvlt_native.cc"
BUILD_DIR = _PKG.parent / "build" / "mvlt_tpu_torch"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_TOKENIZE_CAP = 4096   # ids one mvlt_tokenize call may write (the JAX wrapper's)

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_SIGNATURES = {   # name: (restype, argtypes)
    "mvlt_tokenizer_create": (_P, [ctypes.c_char_p]),
    "mvlt_tokenizer_destroy": (None, [_P]),
    "mvlt_tokenize": (_I32, [_P, ctypes.c_char_p, ctypes.POINTER(_I32), _I32]),
    "mvlt_encode_batch": (None, [_P, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), _I32,
                                 _I32, ctypes.POINTER(_I32), ctypes.POINTER(ctypes.c_uint8)]),
    "mvlt_crop_resize": (_I32, [ctypes.POINTER(ctypes.c_uint8), _I32, _I32, _I32, _I32,
                                ctypes.POINTER(ctypes.c_float)]),
    "mvlt_apply_mask": (None, [ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                               _I32, _I32, _I32, ctypes.POINTER(ctypes.c_float)]),
}


def library_path() -> pathlib.Path:
    """Where the library of the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join((CXX, *CXX_FLAGS)).encode())
    return BUILD_DIR / f"libmvlt_native_{digest.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the library unless it exists; raises RuntimeError with the
    compiler's output when the compiler is missing or fails."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    # a name of this process and thread: the loader's decode threads and
    # the test workers may all build at first use
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        try:
            proc = subprocess.run([CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True, timeout=300, check=False)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"native host library: {CXX} could not run: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"native host library: {CXX} failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return path


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the library, with its C signatures set."""
    path = build()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"native host library: {path} does not load: {e}") from e
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class NativeTokenizer(WordPieceTokenizer):
    """The WordPiece tokenizer with its bare ids and batch encoding done in
    C++; rows the C++ code flags (scripts it does not handle) go through
    the Python WordPiece. The same ids as ``WordPieceTokenizer``."""

    def __init__(self, vocab_file: str):
        super().__init__(vocab_file)
        self._lib = load_library()
        path = resolve_vocab_path(vocab_file)
        handle = self._lib.mvlt_tokenizer_create(path.encode())
        if not handle:
            raise RuntimeError(f"native tokenizer: cannot read the vocab {path}")
        self._handle = ctypes.c_void_p(handle)

    def tokenize_to_ids(self, text: str) -> List[int]:
        """Bare ids (no [CLS] / [SEP])."""
        out = np.empty(_TOKENIZE_CAP, np.int32)
        got = self._lib.mvlt_tokenize(self._handle, text.encode("utf-8"), _ptr(out, _I32),
                                      _TOKENIZE_CAP)
        if got < 0:
            return super().tokenize_to_ids(text)
        return out[:got].tolist()

    def encode_batch(self, texts: List[str], max_length: int) -> np.ndarray:
        """``encode`` of each text in one call: [CLS] ids [SEP] padded rows,
        int32 [len(texts), max_length]."""
        n = len(texts)
        out = np.zeros((n, max_length), np.int32)
        if not n:
            return out
        blobs = [t.encode("utf-8") for t in texts]
        joined = b"\0".join(blobs) + b"\0"
        offsets = np.cumsum([0] + [len(b) + 1 for b in blobs[:-1]]).astype(np.int64)
        fallback = np.zeros(n, np.uint8)
        self._lib.mvlt_encode_batch(self._handle, joined, _ptr(offsets, ctypes.c_int64), n,
                                    max_length, _ptr(out, _I32), _ptr(fallback, ctypes.c_uint8))
        for i in np.nonzero(fallback)[0]:
            out[i] = self.encode(texts[i], max_length)
        return out

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle is not None:
            self._lib.mvlt_tokenizer_destroy(handle)


def native_crop_resize(img: np.ndarray, out_size: int, crop: bool = True) -> np.ndarray:
    """uint8 [H, W, 3] -> float32 [out_size, out_size, 3] in [0, 1]: the
    whitespace crop (luma below 128 is content) and a triangle-filter resize
    in double precision (within 1.5/255 of PIL's bilinear, which rounds to
    uint8 between its passes)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"native_crop_resize: expected uint8 [H, W, 3], got {img.shape}")
    h, w = img.shape[:2]
    out = np.empty((out_size, out_size, 3), np.float32)
    rc = load_library().mvlt_crop_resize(_ptr(img, ctypes.c_uint8), h, w, out_size, int(crop),
                                         _ptr(out, ctypes.c_float))
    if rc != 0:
        raise ValueError(f"native_crop_resize: refused a {h}x{w} image at size {out_size}")
    return out


def native_apply_mask(images: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """float32 [B, H, W, 3] images and [B, H, W] masks -> the images with
    every pixel whose mask is above 0.5 set to 1e-6."""
    images = np.ascontiguousarray(images, np.float32)
    masks = np.ascontiguousarray(masks, np.float32)
    b, h, w = masks.shape
    if images.shape != (b, h, w, 3):
        raise ValueError(f"native_apply_mask: images {images.shape} and masks {masks.shape}")
    out = np.empty_like(images)
    load_library().mvlt_apply_mask(_ptr(images, ctypes.c_float), _ptr(masks, ctypes.c_float),
                                   b, h, w, _ptr(out, ctypes.c_float))
    return out
