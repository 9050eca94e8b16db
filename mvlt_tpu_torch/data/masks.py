"""Image masks: grid, square and free-form stroke.

Counterpart of mvlt_tpu/data/masks.py (reference
mcloader/fashion_gen.py:225-319). On the host (numpy): the grid mask, where
exactly int(mask_ratio * patches) of the (H/patch)^2 patches are masked,
chosen by a uniform permutation; one random square; 5 to 13 random brush
strokes (OpenCV lines and circles, imported at first use). Masked pixels
are filled with 1e-6. On the device: the batched grid masks made inside the
step (``device_grid_masks``, ``device_apply_mask``).
"""

from __future__ import annotations

import numpy as np
import torch

MASK_FILL_VALUE = 1e-6   # masked_fill value (reference mcloader/fashion_gen.py:176)


def generate_grid_mask(input_size: int, mask_ratio: float, patch_size: int = 16,
                       rng: np.random.Generator | None = None) -> np.ndarray:
    """[H, W] float32 mask, 1 = masked pixel; exact masked-patch count."""
    rng = rng or np.random.default_rng()
    if input_size % patch_size:
        raise ValueError(f"input {input_size} not divisible by patch {patch_size}")
    g = input_size // patch_size
    flat = np.zeros(g * g, dtype=np.float32)
    flat[rng.permutation(g * g)[:int(mask_ratio * g * g)]] = 1.0
    return np.kron(flat.reshape(g, g), np.ones((patch_size, patch_size), np.float32))


def generate_square_mask(im_size: int, mask_size: int,
                         rng: np.random.Generator | None = None) -> np.ndarray:
    """[H, W] float32 mask with one random mask_size x mask_size box
    (mcloader/fashion_gen.py:256-266)."""
    rng = rng or np.random.default_rng()
    half = mask_size // 2
    cy = rng.integers(half, im_size - half)
    cx = rng.integers(half, im_size - half)
    mask = np.zeros((im_size, im_size), np.float32)
    mask[cy - half: cy + half, cx - half: cx + half] = 1.0
    return mask


def generate_stroke_mask(im_size: int, parts_range=(5, 13), mask_scale: float = 1.0,
                         rng: np.random.Generator | None = None) -> np.ndarray:
    """[H, W] float32 free-form brush mask (mcloader/fashion_gen.py:269-319);
    raises RuntimeError where OpenCV is absent."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("stroke masks require cv2") from e
    rng = rng or np.random.default_rng()
    max_vertex = int(im_size // (70 / mask_scale))
    max_brush = int(im_size // (25 / mask_scale))
    mask = np.zeros((im_size, im_size, 1), np.float32)
    parts = int(rng.integers(parts_range[0], parts_range[1] + 1))
    for _ in range(parts):
        stroke = np.zeros((im_size, im_size, 1), np.float32)
        n_vert = int(rng.integers(0, max_vertex + 1))
        y, x = int(rng.integers(im_size)), int(rng.integers(im_size))
        width = 0
        for i in range(n_vert):
            angle = rng.integers(0, 361) / 360.0 * 2 * np.pi
            if i % 2 == 0:
                angle = 2 * np.pi - angle
            length = int(rng.integers(0, im_size + 1))
            width = int(rng.integers(5, max_brush + 1)) // 2 * 2
            ny = int(np.clip(y + length * np.cos(angle), 0, im_size - 1))
            nx = int(np.clip(x + length * np.sin(angle), 0, im_size - 1))
            cv2.line(stroke, (y, x), (ny, nx), 1, width)
            cv2.circle(stroke, (y, x), width // 2, 2)
            y, x = ny, nx
        cv2.circle(stroke, (y, x), width // 2, 2)
        mask += stroke
    return np.minimum(mask, 1.0)[..., 0]


def apply_mask(image: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """image [H, W, 3] in [0, 1], mask [H, W] -> the masked image."""
    return np.where(mask[..., None].astype(bool), np.float32(MASK_FILL_VALUE), image)


def grid_masks_from_uniforms(u: torch.Tensor, input_size: int, mask_ratio: float,
                             patch_size: int = 16) -> torch.Tensor:
    """[B, H, W] float32 grid masks from uniforms u [B, patches]: in each
    sample the int(mask_ratio * patches) patches of lowest rank are masked
    (a uniform permutation; ties keep their order, as jnp.argsort's), then
    upsampled patch to pixel."""
    b = u.shape[0]
    g = input_size // patch_size
    ranks = torch.argsort(torch.argsort(u, dim=-1, stable=True), dim=-1, stable=True)
    patch = (ranks < int(mask_ratio * g * g)).float().reshape(b, g, 1, g, 1)
    return patch.expand(b, g, patch_size, g, patch_size).reshape(b, input_size, input_size)


def device_grid_masks(generator: torch.Generator, batch: int, input_size: int,
                      mask_ratio: float, patch_size: int = 16) -> torch.Tensor:
    """[B, H, W] grid masks on the generator's device, from its uniforms
    (mvlt_tpu/data/masks.py:device_grid_masks; the draws differ from
    jax.random's)."""
    g = input_size // patch_size
    u = torch.rand((batch, g * g), generator=generator, device=generator.device)
    return grid_masks_from_uniforms(u, input_size, mask_ratio, patch_size)


def device_apply_mask(images: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, 3], masks [B, H, W] -> the masked images (fill 1e-6)."""
    fill = torch.tensor(MASK_FILL_VALUE, dtype=images.dtype, device=images.device)
    return torch.where(masks[..., None] > 0.5, fill, images)
