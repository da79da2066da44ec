"""Texture and frame images (counterpart of solr_tpu/io/image.py).

Pillow provides the codecs (PNG, BMP, JPEG, TGA and more), as in the
reference; it is the ``viewer`` extra of pyproject.toml.  The loader
normalizes everything to the engine's (H, W, 4) uint8 RGBA texel form.
"""

from __future__ import annotations

import numpy as np

__all__ = ["load_image", "save_image"]


def load_image(path: str) -> np.ndarray:
    """Load any Pillow-supported image as (H, W, 4) uint8 RGBA."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGBA"), np.uint8)


def save_image(path: str, image) -> None:
    """Save an (H, W, 3|4) image, float in [0, 1] (scaled by 255 and
    truncated, as the reference does) or uint8.  JPEG drops the alpha."""
    from PIL import Image

    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0).astype(np.uint8)
    if arr.shape[-1] == 4 and path.lower().endswith((".jpg", ".jpeg")):
        arr = arr[..., :3]
    Image.fromarray(arr).save(path)
