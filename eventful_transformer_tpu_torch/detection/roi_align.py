"""ROIAlign, aligned (V2) (port of
``eventful_transformer_tpu/detection/roi_align.py``): half-pixel aligned
coordinates, bilinear samples averaged over a static ``sampling_ratio``
grid per bin, zero outside [-1, size], and the multi-level form over the
pyramid packed into one (sum H_l * W_l, C) map with per-roi level
parameters (detectron2's canonical level assignment).

Sample coordinates are clamped into the map before the gather, as the JAX
package clamps before ``jnp.take``; torch's indexing raises where
``jnp.take`` would clamp.
"""

from __future__ import annotations

import numpy as np
import torch


def _sample_grid(x1, y1, x2, y2, output_size, n):
    """(R, out, out, n, n) sample coordinates y and x of each bin."""
    r = x1.shape[0]
    grid = torch.arange(output_size, dtype=torch.float32, device=x1.device)
    samp = (torch.arange(n, dtype=torch.float32, device=x1.device) + 0.5) / n
    bin_w = (x2 - x1) / output_size
    bin_h = (y2 - y1) / output_size
    ys = y1[:, None, None] + (grid[None, :, None] + samp[None, None, :]) * bin_h[:, None, None]
    xs = x1[:, None, None] + (grid[None, :, None] + samp[None, None, :]) * bin_w[:, None, None]
    shape = (r, output_size, output_size, n, n)
    return ys[:, :, None, :, None].expand(shape), xs[:, None, :, None, :].expand(shape)


def _bilinear_flat(flat, y, x, h, w, offset, width):
    """Bilinear samples of the packed map ``flat`` (rows, C) at float
    coordinates y, x (R, out, out, n, n); h, w, offset and width broadcast
    against them (float, float, int, int). Points outside [-1, size] give
    0."""
    outside = (y < -1.0) | (y > h) | (x < -1.0) | (x > w)
    y = torch.minimum(y.clamp(min=0.0), h - 1)
    x = torch.minimum(x.clamp(min=0.0), w - 1)
    y0 = torch.floor(y).to(torch.int64)
    x0 = torch.floor(x).to(torch.int64)
    y1 = torch.minimum(y0 + 1, h.to(torch.int64) - 1)
    x1 = torch.minimum(x0 + 1, w.to(torch.int64) - 1)
    ly = (y - y0).to(flat.dtype)
    lx = (x - x0).to(flat.dtype)
    c = flat.shape[-1]

    def at(yi, xi):
        return flat[(offset + yi * width + xi).reshape(-1)].reshape(yi.shape + (c,))

    vals = (
        at(y0, x0) * ((1 - ly) * (1 - lx))[..., None]
        + at(y0, x1) * ((1 - ly) * lx)[..., None]
        + at(y1, x0) * (ly * (1 - lx))[..., None]
        + at(y1, x1) * (ly * lx)[..., None]
    )
    return torch.where(outside[..., None], torch.zeros((), dtype=vals.dtype, device=vals.device), vals)


def roi_align(features, boxes, scale, output_size=7, sampling_ratio=2):
    """features (H, W, C); boxes (R, 4) in image coordinates; returns
    (R, output_size, output_size, C)."""
    h, w, c = features.shape
    # aligned (V2): continuous coordinate = pixel * scale - 0.5
    y, x = _sample_grid(*(boxes[:, i] * scale - 0.5 for i in (0, 1, 2, 3)), output_size,
                        sampling_ratio)
    one = torch.ones((), dtype=torch.float32, device=boxes.device)
    vals = _bilinear_flat(features.reshape(h * w, c), y, x, h * one, w * one, 0, w)
    return vals.mean(dim=(3, 4))


def assign_levels(boxes, min_level, max_level, canonical_size=224, canonical_level=4):
    """detectron2 assign_boxes_to_levels: floor(canonical_level +
    log2(sqrt(area) / canonical_size)), clamped; int32."""
    area = (boxes[:, 2] - boxes[:, 0]).clamp(min=0) * (boxes[:, 3] - boxes[:, 1]).clamp(min=0)
    level = torch.floor(canonical_level + torch.log2(torch.sqrt(area) / canonical_size + 1e-8))
    return level.clamp(min_level, max_level).to(torch.int32)


def multilevel_roi_align(features, boxes, scales, min_level, max_level, output_size=7,
                         sampling_ratio=2):
    """Pool each roi from its assigned level of the packed map: features a
    list of (H_l, W_l, C); boxes (R, 4); scales the per-level 1 / stride.
    Returns (R, output_size, output_size, C)."""
    device = boxes.device
    li = (assign_levels(boxes, min_level, max_level) - min_level).long()
    c = features[0].shape[-1]
    flat = torch.cat([f.reshape(-1, c) for f in features])
    heights = np.array([f.shape[0] for f in features])
    widths = np.array([f.shape[1] for f in features])
    offsets = np.concatenate([[0], np.cumsum(heights * widths)[:-1]])

    def per_roi(values, dtype):
        return torch.as_tensor(np.asarray(values), dtype=dtype, device=device)[li].reshape(-1, 1, 1, 1, 1)

    scale_r = per_roi(np.asarray(scales, np.float32), torch.float32).reshape(-1)
    y, x = _sample_grid(*(boxes[:, i] * scale_r - 0.5 for i in (0, 1, 2, 3)), output_size,
                        sampling_ratio)
    vals = _bilinear_flat(
        flat, y, x, per_roi(heights, torch.float32), per_roi(widths, torch.float32),
        per_roi(offsets, torch.int64), per_roi(widths, torch.int64),
    )
    return vals.mean(dim=(3, 4))
