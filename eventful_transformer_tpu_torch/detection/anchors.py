"""Anchor generation (port of ``eventful_transformer_tpu/detection/anchors.py``:
detectron2's DefaultAnchorGenerator as configured for ViTDet). Made on the
host with numpy, once per feature-map size."""

from __future__ import annotations

import numpy as np


def cell_anchors(sizes, aspect_ratios):
    """Base anchors centred at (0, 0): for each size and aspect ratio,
    area = size^2, w = sqrt(area / ar), h = ar * w."""
    anchors = []
    for size in sizes:
        area = float(size) ** 2
        for ar in aspect_ratios:
            w = np.sqrt(area / ar)
            h = ar * w
            anchors.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(anchors, dtype=np.float32)


def grid_anchors(feature_size, stride, sizes, aspect_ratios, offset=0.0):
    """All anchors of one level: (H * W * A, 4) in row-major (y, x, anchor)
    order, detectron2's layout."""
    h, w = feature_size
    base = cell_anchors(sizes, aspect_ratios)
    shifts_x = (np.arange(w, dtype=np.float32) + offset) * stride
    shifts_y = (np.arange(h, dtype=np.float32) + offset) * stride
    sx, sy = np.meshgrid(shifts_x, shifts_y)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    anchors = shifts[:, None, :] + base[None, :, :]
    return anchors.reshape(-1, 4).astype(np.float32)


def multi_level_anchors(feature_sizes, strides, sizes_per_level, aspect_ratios, offset=0.0):
    """Anchors of every pyramid level: a list of (H_l * W_l * A, 4) arrays."""
    return [
        grid_anchors(fs, stride, sizes, aspect_ratios, offset)
        for fs, stride, sizes in zip(feature_sizes, strides, sizes_per_level)
    ]
