"""Image grid masks on the host (numpy).

Counterpart of the numpy part of mvlt_tpu/data/masks.py (reference
mcloader/fashion_gen.py:225-319): exactly int(mask_ratio * patches) of the
(H/patch)^2 patches are masked, chosen by a uniform permutation, and masked
pixels are filled with 1e-6. The square and stroke masks and the on-device
generator are not ported yet.
"""

from __future__ import annotations

import numpy as np

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
