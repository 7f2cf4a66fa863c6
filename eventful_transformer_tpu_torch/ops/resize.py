"""Separable resize and average pooling as dense matmuls (port of
``eventful_transformer_tpu/ops/resize.py``).

The reference resizes position encodings and relative-position tables with
``torch.nn.functional.interpolate(mode="bicubic", align_corners=False)``:
the cubic-convolution kernel with A = -0.75 and half-pixel source
coordinates. The JAX package builds that interpolation as an (out, in)
matrix per axis in numpy; the port builds the same matrices and applies
them in float32, so both packages resize identically. The results are
loop-invariant (``precompute``), so they run once per call, not per frame.

ViViT's preprocessing resizes frames with the bilinear filter, antialiased
as PIL does it (``resize_bilinear``): the same separable matrices as the
JAX package's, not ``F.interpolate(antialias=True)``, whose weights
differ.
"""

from __future__ import annotations

import numpy as np
import torch


def _cubic_kernel(t, a=-0.75):
    """Cubic convolution weights for the 4 taps around fractional offset t."""
    d = np.stack([t + 1.0, t, 1.0 - t, 2.0 - t])
    ad = np.abs(d)
    w_near = (a + 2.0) * ad**3 - (a + 3.0) * ad**2 + 1.0
    w_far = a * ad**3 - 5.0 * a * ad**2 + 8.0 * a * ad - 4.0 * a
    return np.where(ad <= 1.0, w_near, np.where(ad < 2.0, w_far, 0.0))


def resize_matrix_bicubic(in_size, out_size):
    """(out_size, in_size) float32 matrix of torch bicubic, align_corners=False."""
    scale = in_size / out_size
    i = np.arange(out_size, dtype=np.float64)
    src = (i + 0.5) * scale - 0.5
    x0 = np.floor(src)
    weights = _cubic_kernel(src - x0)  # (4, out)
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for tap in range(4):
        idx = np.clip(x0 + tap - 1, 0, in_size - 1).astype(np.int64)
        np.add.at(mat, (np.arange(out_size), idx), weights[tap])
    return mat.astype(np.float32)


def _triangle_kernel(d):
    return np.maximum(0.0, 1.0 - np.abs(d))


def resize_matrix_bilinear(in_size, out_size, antialias=False):
    """(out_size, in_size) float32 matrix of torch bilinear,
    align_corners=False; with ``antialias`` PIL's algorithm: the triangle
    filter's support scaled by the downscale factor, taps outside the
    input dropped, the weights of each output renormalised."""
    scale = in_size / out_size
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    if antialias:
        filterscale = max(scale, 1.0)
        support = filterscale  # the triangle filter's support is 1
        for i in range(out_size):
            center = (i + 0.5) * scale
            xmin = max(int(center - support + 0.5), 0)
            xmax = min(int(center + support + 0.5), in_size)
            j = np.arange(xmin, xmax)
            w = _triangle_kernel((j - center + 0.5) / filterscale)
            mat[i, xmin:xmax] = w / w.sum()
    else:
        i = np.arange(out_size, dtype=np.float64)
        src = (i + 0.5) * scale - 0.5
        x0 = np.floor(src).astype(np.int64)
        t = src - x0
        for tap, w in ((0, 1.0 - t), (1, t)):
            idx = np.clip(x0 + tap, 0, in_size - 1)
            np.add.at(mat, (np.arange(out_size), idx), w)
    return mat.astype(np.float32)


def _matrix(mat, x):
    return torch.from_numpy(mat).to(x.device)


def resize_bicubic(x, out_size):
    """Resize the last two dims of float32 ``x`` to ``out_size``."""
    in_h, in_w = x.shape[-2:]
    out_h, out_w = out_size
    if (in_h, in_w) == (out_h, out_w):
        return x
    y = torch.einsum("oh,...hw->...ow", _matrix(resize_matrix_bicubic(in_h, out_h), x), x)
    return torch.einsum("pw,...ow->...op", _matrix(resize_matrix_bicubic(in_w, out_w), x), y)


def resize_bilinear(x, out_size, antialias=False):
    """Resize the last two dims of float32 ``x`` to ``out_size`` with torch
    bilinear, align_corners=False (PIL's antialiased filter with
    ``antialias``)."""
    in_h, in_w = x.shape[-2:]
    out_h, out_w = out_size
    if (in_h, in_w) == (out_h, out_w):
        return x
    mat_h = _matrix(resize_matrix_bilinear(in_h, out_h, antialias), x)
    mat_w = _matrix(resize_matrix_bilinear(in_w, out_w, antialias), x)
    return torch.einsum("pw,...ow->...op", mat_w, torch.einsum("oh,...hw->...ow", mat_h, x))


def resize_bicubic_1d(x, out_size):
    """Resize the last dim of float32 ``x`` to ``out_size``."""
    in_size = x.shape[-1]
    if in_size == out_size:
        return x
    return torch.einsum("ow,...w->...o", _matrix(resize_matrix_bicubic(in_size, out_size), x), x)


def avg_pool_2d(x, pool_size):
    """Average-pool the last two dims (kernel == stride; sizes must divide)."""
    ph, pw = pool_size
    h, w = x.shape[-2:]
    if h % ph or w % pw:
        raise ValueError(f"pool {pool_size} does not divide {(h, w)}")
    y = x.reshape(x.shape[:-2] + (h // ph, ph, w // pw, pw))
    return y.mean(dim=(-3, -1))


def avg_pool_1d(x, pool_size):
    """Average-pool the last dim (kernel == stride; the size must divide)."""
    n = x.shape[-1]
    if n % pool_size:
        raise ValueError(f"pool {pool_size} does not divide {n}")
    return x.reshape(x.shape[:-1] + (n // pool_size, pool_size)).mean(dim=-1)
