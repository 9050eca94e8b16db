"""Build and load the port's CUDA kernels.

``load_library()`` compiles every ``mvlt_tpu_torch/csrc/*.cu`` with ``nvcc``
for ``sm_90a`` (one ``nvcc`` per source, all started together) and links the
objects into one shared library with a plain C interface, the first time a
kernel is launched in the process, and loads it with ``ctypes``. The
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
# C signatures of the kernels' entries (csrc/*.cu); every pointer and the
# stream are c_void_p so ctypes never truncates them.
_SIGNATURES = {
    "mvlt_sr_kv": [_P] * 14 + [_I] * 8 + [_F, _F, _P],
    "mvlt_block_fused": [_P] * 22 + [_I] * 6 + [_F, _F, _F, _P],
    "mvlt_block_attention": [_P] * 14 + [_I] * 5 + [_F, _F, _P],
    "mvlt_fba_fwd": [_P] * 17 + [_I] * 6 + [_F, _F, _P],
    "mvlt_fba_bwd": [_P] * 32 + [_I] * 9 + [_F, _F, _P],
    "mvlt_dwconv_mlp": [_P] * 11 + [_I] * 6 + [_F, _P],
    "mvlt_attention_fwd": [_P] * 5 + [_STRIDES] + [_I] * 5 + [_F, _P],
    "mvlt_attention_bwd": [_P] * 11 + [_STRIDES] + [_I] * 6 + [_F, _P],
    "mvlt_ln_mlp_fwd": [_P] * 11 + [_L] + [_I] * 5 + [_F, _P, _P],
    "mvlt_ln_mlp_bwd": [_P] * 24 + [_L] + [_I] * 4 + [_F, _P, _P],
    "mvlt_mlm_ce_fwd": [_P] * 7 + [_I] * 5 + [_P],
    "mvlt_mlm_ce_bwd": [_P] * 12 + [_I] * 5 + [_P],
    "mvlt_swin_attention": [_P] * 7 + [_STRIDES] + [_I] * 9 + [_F, _P],
    "mvlt_swin_block": [_P] * 20 + [_I] * 11 + [_F] * 3 + [_P],
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
    seconds spent compiling and linking, 0.0 when it was already built).
    The sources compile in parallel, one nvcc process each."""
    path = library_path()
    if path.exists():
        return path, "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{path.stem}.{os.getpid()}"
    start = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, obj, proc in jobs:
        logs.append(f"== {src.name}\n{proc.communicate()[0]}")
        if proc.returncode != 0:
            failed.append(src.name)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "".join(logs))
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                               *[str(obj) for _, obj, _ in jobs]],
                              capture_output=True, text=True, check=False)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
    return path, "".join(logs), time.perf_counter() - start


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


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``, asked once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(tiles: int, chunks: int, sms: int, max_splits: int) -> int:
    """Ranges of a contraction of ``chunks`` chunks for a grid of ``tiles``
    output tiles (one block an SM each): the fewest whose blocks fill at
    least 90% of their last wave on ``sms`` SMs, else the count up to
    ``max_splits`` that fills it most; trimmed so that no range is empty."""
    best, best_fill = 1, 0.0
    for s in range(1, min(max_splits, chunks) + 1):
        blocks = tiles * s
        fill = blocks / (-(-blocks // sms) * sms)
        if fill >= 0.9:
            best = s
            break
        if fill > best_fill + 1e-9:
            best, best_fill = s, fill
    per = -(-chunks // best)
    return -(-chunks // per)


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


def check_kv(name: str, k, v, batch: int, heads: int, hd: int, device) -> None:
    """K and V as the attention kernels read them: contiguous, 16-byte
    aligned bf16 [batch, heads, M, hd] on the stream's device, of one shape."""
    for t, what in ((k, "k"), (v, "v")):
        if (t.device != device or t.dtype != torch.bfloat16 or not t.is_contiguous()
                or t.dim() != 4 or t.shape[:2] != (batch, heads) or t.shape[3] != hd
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: {what} must be contiguous, 16-byte aligned bf16 "
                             f"[{batch}, {heads}, M, {hd}] on {device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if k.shape != v.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} and v {tuple(v.shape)} differ")


def kernel_weight(name: str, t, shape: tuple, device):
    """A weight as the kernels read it: bf16, contiguous, 32-byte aligned
    (cp.async copies it in 16-byte chunks), of the given shape."""
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
