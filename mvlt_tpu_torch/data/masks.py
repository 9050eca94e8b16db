"""Image grid masks on the host (numpy).

Counterpart of the numpy part of mvlt_tpu/data/masks.py (reference
mcloader/fashion_gen.py:225-319): exactly int(mask_ratio * patches) of the
(H/patch)^2 patches are masked, chosen by a uniform permutation, and masked
pixels are filled with 1e-6; and the batched grid masks made on the device
inside the step (``device_grid_masks``, ``device_apply_mask``). The square
and stroke masks are not ported yet.
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
