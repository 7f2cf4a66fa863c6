"""Counted primitive ops and layers (port of
``eventful_transformer_tpu/core/nn.py``).

Layers are ``nn.Module``s whose ``forward`` takes the counting
:class:`~.counting.Ctx` first. Linear kernels keep the JAX layout,
``(in_features, out_features)``, so weights move between the packages
without transposes and the CUDA kernels read them as they are.
``valid_frac`` scales a count to the valid share of fixed-capacity work,
as in the JAX package.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from eventful_transformer_tpu_torch.ops.common import LN_EPS, ln_f32


def model_device(device):
    """The device a model's constructor puts its parameters on: the card
    unless the caller names another. Without a CUDA device, asking for the
    card raises; nothing falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' to run "
            "its plain versions on the CPU"
        )
    return device


def counted_add(ctx, a, b):
    """a + b, counting add_flops = result size."""
    result = a + b
    ctx.add("add_flops", result.numel())
    return result


def counted_matmul(ctx, a, b, valid_frac=1):
    """Batched matmul counting result.numel() * a.shape[-1]."""
    result = torch.matmul(a, b)
    ctx.add("matmul_flops", valid_frac * float(result.numel() * a.shape[-1]))
    return result


def layer_norm(x, ln):
    """LayerNorm over the last axis with float32 statistics (eps 1e-6),
    returned in x's dtype; ``ln`` is a :class:`LayerNorm`. Not counted."""
    return ln_f32(x, ln.scale, ln.bias).to(x.dtype)


def gelu(x):
    """Exact (erf) GELU."""
    return nn.functional.gelu(x, approximate="none")


class LayerNorm(nn.Module):
    """LayerNorm parameters; :func:`layer_norm` applies them."""

    def __init__(self, dim):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class Linear(nn.Module):
    """Counted linear transform, kernel stored as (in, out)."""

    def __init__(self, in_features, out_features):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.kernel = nn.Parameter(torch.zeros(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def reset_parameters(self, generator):
        scale = 1.0 / math.sqrt(self.in_features)
        uniform_(self.kernel, -scale, scale, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, ctx, x, valid_frac=1):
        y = torch.matmul(x, self.kernel.to(x.dtype)) + self.bias.to(x.dtype)
        ctx.add("linear_flops", valid_frac * float(x.numel() * self.out_features))
        ctx.add("bias_flops", valid_frac * float(y.numel()))
        return y

    def apply_bias(self, ctx, x):
        """The bias add alone, counted: maps zero padding into the qkv
        domain (the pad rows of a window grid)."""
        y = x + self.bias.to(x.dtype)
        ctx.add("bias_flops", y.numel())
        return y


def _uniform(ctx, shape, x):
    """U(0, 1) of ``shape`` float32 on x's device, drawn from
    ``ctx.generator``."""
    if ctx.generator is None:
        raise ValueError("Ctx.generator is required for stochastic layers")
    return torch.rand(shape, generator=ctx.generator, device=x.device)


class Dropout(nn.Module):
    """Dropout: the identity unless ``ctx.training`` and ``rate`` > 0; then
    each element is kept with probability 1 - rate and scaled by 1 / keep
    (JAX ``core/nn.py::Dropout``)."""

    def __init__(self, rate):
        super().__init__()
        self.rate = rate

    def forward(self, ctx, x):
        if not ctx.training or self.rate <= 0.0:
            return x
        keep = 1.0 - self.rate
        mask = _uniform(ctx, x.shape, x) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class DropPath(nn.Module):
    """Stochastic depth (JAX ``core/nn.py::DropPath``, reference
    eventful_transformer/utils.py:10-29): the identity unless
    ``ctx.training`` and ``drop_rate`` > 0; then one uniform a batch row,
    the row kept where it is above the rate and scaled by 1 / (1 - rate)."""

    def __init__(self, drop_rate):
        super().__init__()
        self.drop_rate = drop_rate

    def forward(self, ctx, x):
        if not ctx.training or self.drop_rate <= 0.0:
            return x
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        keep = (_uniform(ctx, shape, x) > self.drop_rate).to(x.dtype)
        return x / (1.0 - self.drop_rate) * keep


def uniform_(param, low, high, generator):
    """Fill ``param`` from U(low, high), drawn on the CPU from ``generator``
    so the values do not depend on the device."""
    values = torch.rand(param.shape, generator=generator) * (high - low) + low
    with torch.no_grad():
        param.copy_(values)


def trunc_normal_(param, generator, std=0.02):
    """Fill ``param`` from a normal truncated to two standard deviations."""
    values = torch.empty(param.shape)
    nn.init.trunc_normal_(values, std=1.0, a=-2.0, b=2.0, generator=generator)
    with torch.no_grad():
        param.copy_(values * std)
