"""A copy of ``eventful_transformer_tpu/data/video.py`` for the port.

Shared video-dataset helpers: JPEG frame loading via PIL (the reference
uses torchvision.io.read_image; torchvision is not a dependency here)."""

from __future__ import annotations

import numpy as np


def read_image_chw(path):
    """Read an image file to a (C, H, W) uint8 array."""
    from PIL import Image

    with Image.open(path) as img:
        arr = np.asarray(img.convert("RGB"), dtype=np.uint8)
    return np.moveaxis(arr, -1, 0)


def load_frame_stack(paths):
    """Stack frame files into a (T, C, H, W) uint8 video array."""
    return np.stack([read_image_chw(p) for p in paths])
