"""NHWC convolutions of the detection head (port of
``eventful_transformer_tpu/ops/conv.py``). Uncounted, as in the reference.

The JAX package runs these as XLA convolutions outside any Pallas kernel;
here they are ``torch.nn.functional`` calls (cuDNN on the card). The
feature maps keep the JAX package's NHWC layout at every function here: a
(B, H, W, C) tensor permuted to (B, C, H, W) is channels-last in memory, so
the permutes around each call are views, and cuDNN runs channels-last.
Weights are stored in torch's layout, (Cout, Cin, kh, kw) for a conv and
(Cin, Cout, kh, kw) for a transposed conv; ``utils/params.py`` permutes
the JAX package's HWIO and (kh, kw, Cout, Cin) kernels on loading
(:data:`JAX_KERNEL_AXES`).
"""

from __future__ import annotations

from math import sqrt

import torch
from torch import nn
from torch.nn import functional as F

from eventful_transformer_tpu_torch.core.nn import uniform_

# the axes of a JAX kernel that make the torch weight, for both kinds:
# HWIO -> OIHW and (kh, kw, Cout, Cin) -> (Cin, Cout, kh, kw)
JAX_KERNEL_AXES = (3, 2, 0, 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def conv2d(x, weight, bias=None, stride=1, padding=0):
    """x (B, H, W, Cin) -> (B, H', W', Cout); weight (Cout, Cin, kh, kw).
    ``padding`` an int (the JAX package's 1x1 convs pass "SAME", which
    pads nothing at kernel size 1)."""
    w = weight.to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    return _nhwc(F.conv2d(_nchw(x), w, b, stride=stride, padding=padding))


def conv_transpose2d(x, weight, bias=None, stride=2):
    """Transposed convolution, x (B, H, W, Cin) -> (B, stride H, stride W,
    Cout) at kernel size ``stride``; weight (Cin, Cout, kh, kw)."""
    w = weight.to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    return _nhwc(F.conv_transpose2d(_nchw(x), w, b, stride=stride))


def max_pool2d(x, window, stride):
    """x (B, H, W, C), floor-mode valid pooling."""
    return _nhwc(F.max_pool2d(_nchw(x), window, stride))


class Conv2d(nn.Module):
    """Conv parameters, initialised as the JAX ``conv2d_init``: U(-s, s),
    s = (kh * kw * Cin)^-1/2, for the kernel and the bias."""

    jax_permute = {"kernel": JAX_KERNEL_AXES}

    def __init__(self, kh, kw, cin, cout, bias=True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(cout, cin, kh, kw))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def reset_parameters(self, generator):
        cout, cin, kh, kw = self.kernel.shape
        scale = 1.0 / sqrt(kh * kw * cin)
        uniform_(self.kernel, -scale, scale, generator)
        if self.bias is not None:
            uniform_(self.bias, -scale, scale, generator)

    def forward(self, x, padding=0):
        return conv2d(x, self.kernel, self.bias, padding=padding)


class ConvTranspose2d(nn.Module):
    """Transposed-conv parameters, initialised as ``conv_transpose2d_init``
    (s = (kh * kw * Cin)^-1/2)."""

    jax_permute = {"kernel": JAX_KERNEL_AXES}

    def __init__(self, kh, kw, cin, cout):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(cin, cout, kh, kw))
        self.bias = nn.Parameter(torch.zeros(cout))

    def reset_parameters(self, generator):
        cin, _, kh, kw = self.kernel.shape
        scale = 1.0 / sqrt(kh * kw * cin)
        uniform_(self.kernel, -scale, scale, generator)
        uniform_(self.bias, -scale, scale, generator)

    def forward(self, x):
        return conv_transpose2d(x, self.kernel, self.bias, stride=self.kernel.shape[-1])
