"""Bilinear upsampling with align_corners=True as two interpolation products.

Counterpart of mvlt_tpu/ops/upsample.py:upsample_bilinear_align_corners
(the T2I decoder's ``nn.Upsample(scale_factor=s, mode='bilinear',
align_corners=True)``): along each axis the interpolation is a fixed
[out, in] matrix, applied to NHWC maps with the matrices in x.dtype and the
sums in fp32, as the JAX package does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mvlt_tpu_torch.ops.kernel_math import acc_dtype


@functools.lru_cache(maxsize=64)
def _interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] align-corners bilinear weights: output j samples
    input coordinate j (in - 1) / (out - 1)."""
    if in_size == 1:
        return np.ones((out_size, 1), dtype=np.float32)
    coords = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    lo = np.clip(np.floor(coords).astype(np.int64), 0, in_size - 2)
    frac = coords - lo
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    mat[np.arange(out_size), lo] = 1.0 - frac
    mat[np.arange(out_size), lo + 1] = frac
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _device_matrix(in_size: int, out_size: int, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """The weights rounded to dtype, held in its sum type on the device, made
    once: a copy from pageable host memory would wait for the card."""
    mat = torch.from_numpy(_interp_matrix(in_size, out_size)).to(dtype)
    return mat.to(acc_dtype(dtype)).to(device)


def upsample_bilinear_align_corners(x: torch.Tensor, scale: int) -> torch.Tensor:
    """NHWC [B, H, W, C] -> [B, H*scale, W*scale, C] in x.dtype."""
    _, h, w, _ = x.shape
    mat = lambda n: _device_matrix(n, n * scale, x.device, x.dtype)
    y = torch.einsum("oh,bhwc->bowc", mat(h), x.to(acc_dtype(x.dtype)))
    y = torch.einsum("ow,bhwc->bhoc", mat(w), y)
    return y.to(x.dtype)
