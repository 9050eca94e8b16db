"""Bilinear resampling as two interpolation products.

Along each axis the interpolation is a fixed [out, in] matrix, applied to
NHWC maps with sums in fp32. The products' backward is two products with
the transposed matrices, so it is deterministic on the card, where
F.interpolate's bilinear backward accumulates with atomics.

  * ``upsample_bilinear_align_corners``: counterpart of
    mvlt_tpu/ops/upsample.py:upsample_bilinear_align_corners (the T2I
    decoder's ``nn.Upsample(scale_factor=s, mode='bilinear',
    align_corners=True)``), the matrices rounded to x.dtype as the JAX
    package rounds them;
  * ``resize_bilinear``: half-pixel centres (align_corners=False), edges
    clamped, no antialias, as ``jax.image.resize(method="bilinear",
    antialias=False)`` and ``F.interpolate(mode="bilinear")`` resample, for
    the positional tables (mvlt_tpu/models/pvlt.py:_resize_pos_embed); the
    weights stay fp32, as jax.image.resize keeps them.
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
def half_pixel_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] half-pixel bilinear weights: output j samples
    input coordinate (j + 0.5) in / out - 0.5 with the triangle kernel, the
    weights over inputs inside the grid summed to 1 (so an edge sample takes
    its edge pixel: clamping). The arithmetic is jax.image.resize's, in
    fp32 (jax/_src/image/scale.py:compute_weight_mat)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    dist = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None])
    weights = np.maximum(f32(0.0), f32(1.0) - dist)
    weights = weights / weights.sum(axis=0, keepdims=True)
    return np.ascontiguousarray(weights.T.astype(f32))


@functools.lru_cache(maxsize=64)
def _device_matrix(in_size: int, out_size: int, device: torch.device,
                   dtype: torch.dtype, half_pixel: bool = False) -> torch.Tensor:
    """The weights (align-corners ones rounded to dtype) held in dtype's sum
    type on the device, made once: a copy from pageable host memory would
    wait for the card."""
    if half_pixel:
        mat = torch.from_numpy(half_pixel_matrix(in_size, out_size))
    else:
        mat = torch.from_numpy(_interp_matrix(in_size, out_size)).to(dtype)
    return mat.to(acc_dtype(dtype)).to(device)


def upsample_bilinear_align_corners(x: torch.Tensor, scale: int) -> torch.Tensor:
    """NHWC [B, H, W, C] -> [B, H*scale, W*scale, C] in x.dtype."""
    _, h, w, _ = x.shape
    mat = lambda n: _device_matrix(n, n * scale, x.device, x.dtype)
    y = torch.einsum("oh,bhwc->bowc", mat(h), x.to(acc_dtype(x.dtype)))
    y = torch.einsum("ow,bhwc->bhoc", mat(w), y)
    return y.to(x.dtype)


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NHWC [B, H0, W0, C] -> [B, h, w, C] in x.dtype, half-pixel bilinear."""
    _, h0, w0, _ = x.shape
    mh = _device_matrix(h0, h, x.device, x.dtype, half_pixel=True)
    mw = _device_matrix(w0, w, x.device, x.dtype, half_pixel=True)
    y = torch.einsum("oh,bhwc->bowc", mh, x.to(acc_dtype(x.dtype)))
    y = torch.einsum("ow,bhwc->bhoc", mw, y)
    return y.to(x.dtype)
