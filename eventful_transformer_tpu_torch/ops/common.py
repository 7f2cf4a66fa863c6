"""Plain float32 helpers shared by the kernels' plain versions (port of
``eventful_transformer_tpu/ops/pallas/common.py``).

The CUDA kernels in ``csrc/common.cuh`` compute the same formulas; the
plain versions here are what the CPU path runs and what the kernels are
held against on the card.
"""

from __future__ import annotations

import torch

LN_EPS = 1e-6
# a gate group's LN placement, and its code in the C entries: "post" the gate
# state in the LN domain, "pre" in x's with the op's rows normalised,
# "none" no LN
LN_MODES = {"none": 0, "post": 1, "pre": 2}


def ln_f32(x, scale, bias):
    """LayerNorm over the last axis in float32: two-pass mean and variance,
    ``(x - mean) * rsqrt(var + eps) * scale + bias``."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + LN_EPS) * scale.float() + bias.float()


# XLA's float32 erf (a rational minimax fit on [-4, 4], ~1 ulp), which the
# JAX kernels use for the exact GELU; csrc/common.cuh has the same
# coefficients.
_ERF_ALPHA = (
    -2.72614225801306e-10,
    2.77068142495902e-08,
    -2.10102402082508e-06,
    -5.69250639462346e-05,
    -7.34990630326855e-04,
    -2.95459980854025e-03,
    -1.60960333262415e-02,
)
_ERF_BETA = (
    -1.45660718464996e-05,
    -2.13374055278905e-04,
    -1.68282697438203e-03,
    -7.37332916720468e-03,
    -1.42647390514189e-02,
)


def _poly(x, coeffs):
    acc = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        acc = acc * x + c
    return acc


def erf_f32(x):
    x = x.clamp(-4.0, 4.0)
    x2 = x * x
    return x * _poly(x2, _ERF_ALPHA) / _poly(x2, _ERF_BETA)


def gelu_exact(x):
    """Exact (erf) GELU of a float32 tensor."""
    return x * 0.5 * (1.0 + erf_f32(x * (2.0**-0.5)))


def row_norms(e):
    """Per-row L2 norm of a float32 error tensor, over the last axis."""
    return e.square().sum(dim=-1).sqrt()
