"""Host-side image decode, whitespace crop and resize.

Counterpart of mvlt_tpu/data/image_ops.py (reference
mcloader/fashion_gen.py:108-112, 411-428):

  * whitespace crop: binarise with PIL ``convert('1')`` (its Floyd-Steinberg
    dither, kept for bit parity), take the bounding box of the dark (False)
    pixels and crop ``(w_min, h_min, w_max, h_max)``;
  * resize to (size, size) with PIL bilinear (torchvision's Resize default);
  * scale to [0, 1], with NO mean/std normalisation (the reference's
    transform comments it out, mcloader/fashion_gen.py:111).

NHWC layout. PIL is imported by the functions that use it, not here: the
port imports and serves on hosts without Pillow.
"""

from __future__ import annotations

import numpy as np


def whitespace_crop(img):
    """Crop a PIL image to the bounding box of its non-white content, found
    on PIL's dithered '1' binarisation as the reference finds it."""
    binary = np.array(img.convert("1"))
    dark = (~binary).nonzero()
    if dark[0].size == 0:
        return img
    h_min, h_max = dark[0].min(), dark[0].max()
    w_min, w_max = dark[1].min(), dark[1].max()
    return img.crop((w_min, h_min, w_max, h_max))


def decode_rgb(path: str) -> np.ndarray:
    """The image file decoded to uint8 [H, W, 3] RGB, uncropped: the input
    of the native crop-resize (data/native.py)."""
    from PIL import Image

    with open(path, "rb") as f:
        return np.asarray(Image.open(f).convert("RGB"))


def load_image_u8(path: str, size: int, crop: bool = True) -> np.ndarray:
    """Decode -> (optional) whitespace crop -> bilinear resize: uint8
    [size, size, 3]. PIL resizes in the uint8 domain, so
    ``load_image(p) == load_image_u8(p) / 255`` bit for bit, and the eval
    readers ship uint8 and divide on the card
    (eval/retrieval.py:uint8_to_unit)."""
    from PIL import Image

    with open(path, "rb") as f:
        img = Image.open(f)
        if crop:
            img = whitespace_crop(img)
        img = img.convert("RGB")
    img = img.resize((size, size), Image.BILINEAR)
    return np.asarray(img, np.uint8)


def load_image(path: str, size: int, crop: bool = True) -> np.ndarray:
    """``load_image_u8`` scaled to [0, 1]: float32 [size, size, 3]."""
    return load_image_u8(path, size, crop).astype(np.float32) / 255.0


def image_from_array(arr: np.ndarray, size: int, crop: bool = True) -> np.ndarray:
    """``load_image`` of an already decoded uint8 array."""
    from PIL import Image

    img = Image.fromarray(arr)
    if crop:
        img = whitespace_crop(img)
    img = img.convert("RGB").resize((size, size), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0
