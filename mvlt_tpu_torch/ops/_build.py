"""Build and load the port's CUDA kernels.

``load_library()`` compiles every ``mvlt_tpu_torch/csrc/*.cu`` with ``nvcc``
for ``sm_90a`` into one shared library with a plain C interface, the first
time a kernel is launched in the process, and loads it with ``ctypes``. The
library goes to ``build/mvlt_tpu_torch/`` at the root of the checkout, named by
a hash of the sources and the flags, so a stale build is never loaded. Nothing
here runs at import time; a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "mvlt_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
# C signatures of the kernels' entries (csrc/*.cu); every pointer and the
# stream are c_void_p so ctypes never truncates them.
_SIGNATURES = {
    "mvlt_sr_kv": [_P] * 11 + [_I] * 7 + [_F, _F, _P],
    "mvlt_block_fused": [_P] * 16 + [_I] * 6 + [_F, _F, _F, _P],
    "mvlt_attention_fwd": [_P] * 4 + [_STRIDES] + [_I] * 5 + [_F, _P],
    "mvlt_attention_bwd": [_P] * 7 + [_STRIDES] + [_I] * 5 + [_F, _P],
    "mvlt_ln_mlp_fwd": [_P] * 9 + [_L] + [_I] * 3 + [_F, _P],
    "mvlt_ln_mlp_slot_floats": [_I, _I],
    "mvlt_ln_mlp_bwd": [_P] * 10 + [_I] + [_P] * 6 + [_L] + [_I] * 3 + [_F, _P],
}


def strides_arg(*tensors):
    """(batch, head, row) element strides of each [B, H, rows, hd] tensor,
    as the C entries take them."""
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of mvlt_tpu_torch "
                       "build only where the CUDA toolkit is installed")


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> pathlib.Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libmvlt_kernels_{digest.hexdigest()[:16]}.so"


def build() -> tuple[pathlib.Path, str, float]:
    """Compile the library unless it exists; returns (path, compiler log,
    seconds spent compiling, 0.0 when it was already built)."""
    path = library_path()
    if path.exists():
        return path, "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - start
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, path)
    return path, log, seconds


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels, with argtypes set."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_launch(name: str, err: int) -> None:
    """Raise if a C entry reported a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def check_stream(name: str, x) -> None:
    """The checks every kernel applies to its [B, N, D] stream input: D a
    multiple of 16 for the tensor-core tiles, 16-byte aligned rows for the
    vector loads."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the kernel takes bfloat16 only, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous [B, N, D] stream, "
                         f"got shape {tuple(x.shape)}")
    if x.shape[-1] % 16:
        raise ValueError(f"{name}: width {x.shape[-1]} is not a multiple of 16")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: the stream must start on a 16-byte boundary")


def kernel_weight(name: str, t, shape: tuple, device):
    """A weight as the kernels read it: bf16, contiguous, 32-byte aligned
    (wmma loads it straight from global memory), of the given shape."""
    if t.device != device:
        raise ValueError(f"{name}: weight on {t.device}, stream on {device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: weight shape {tuple(t.shape)}, expected {shape}")
    out = t.detach().to(torch.bfloat16).contiguous()
    return out.clone() if out.data_ptr() % 32 else out


def kernel_vector(name: str, t, size: int, device):
    """A bias or LayerNorm affine as the kernels read it: fp32 [size]; a
    missing bias (None) becomes zeros."""
    if t is None:
        return torch.zeros((size,), dtype=torch.float32, device=device)
    if t.device != device:
        raise ValueError(f"{name}: vector on {t.device}, stream on {device}")
    if tuple(t.shape) != (size,):
        raise ValueError(f"{name}: vector shape {tuple(t.shape)}, expected ({size},)")
    return t.detach().to(torch.float32).contiguous()
