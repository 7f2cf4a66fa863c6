"""ViTDet backbone (port of ``eventful_transformer_tpu/models/vitdet.py``).

``ViTDet.pre_backbone`` then ``apply_backbone`` is the reference's timing
split (scripts/time/vitdet_vid.py): preprocessing and the patch embedding,
then the position encoding and the block stack, one frame per call, with
the eventful state threaded through. The detection head (``SimplePyramid``,
the RPN and the ROI heads, ``post_backbone``) is not ported yet
(ROADMAP.md, open item 14); its parameters in a JAX tree are skipped on
loading (``unported_params``).
"""

from __future__ import annotations

from math import prod, sqrt

import torch
from torch import nn

from eventful_transformer_tpu_torch.core.backbones import ViTBackbone
from eventful_transformer_tpu_torch.core.nn import not_ported, uniform_


class LinearEmbedding(nn.Module):
    """Patch embedding: Conv2d with kernel == stride == patch size, as a
    matmul over the extracted patches. Not counted, as in the reference."""

    def __init__(self, input_channels, dim, patch_size):
        super().__init__()
        self.patch_size = tuple(patch_size)
        fan_in = input_channels * prod(self.patch_size)
        # (C * ph * pw, dim), flattened in torch Conv2d (C, h, w) order
        self.kernel = nn.Parameter(torch.zeros(fan_in, dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator):
        scale = 1.0 / sqrt(self.kernel.shape[0])
        uniform_(self.kernel, -scale, scale, generator)
        uniform_(self.bias, -scale, scale, generator)

    def forward(self, ctx, x):
        """x (B, C, H, W) -> tokens (B, H/p * W/p, dim)."""
        del ctx
        b, c, h, w = x.shape
        ph, pw = self.patch_size
        x = x.reshape(b, c, h // ph, ph, w // pw, pw).permute(0, 2, 4, 1, 3, 5)
        x = x.reshape(b, (h // ph) * (w // pw), c * ph * pw)
        return torch.matmul(x, self.kernel.to(x.dtype)) + self.bias.to(x.dtype)


class ViTDetPreprocessing:
    """Normalisation and bottom-right zero padding to the input shape.
    Expects [0, 1]-scaled input. The reference normalises first and then
    pads, so the padded region is exactly 0; ``content_hw`` = (h, w) of the
    real content of a frame the caller already padded re-zeroes the rest."""

    def __init__(self, input_shape, normalize_mean, normalize_std):
        self.input_shape = tuple(input_shape)
        self.mean = torch.tensor(normalize_mean, dtype=torch.float32).reshape(-1, 1, 1)
        self.std = torch.tensor(normalize_std, dtype=torch.float32).reshape(-1, 1, 1)

    def __call__(self, x, content_hw=None):
        mean, std = self.mean.to(x.device), self.std.to(x.device)
        # normalise in float32, keep the caller's dtype
        x = ((x.float() * 255.0 - mean) / std).to(x.dtype)
        _, h, w = self.input_shape
        x = nn.functional.pad(x, (0, w - x.shape[-1], 0, h - x.shape[-2]))
        if content_hw is not None:
            rows = torch.arange(h, device=x.device) < int(content_hw[0])
            cols = torch.arange(w, device=x.device) < int(content_hw[1])
            x = x * (rows[:, None] & cols[None, :]).to(x.dtype)
        return x


class ViTDet(nn.Module):
    """ViTDet's backbone half. Parameters are initialised from ``seed`` on
    the CPU, so the weights do not depend on ``device``; cast the model
    with ``.to(dtype)`` to run in bfloat16."""

    # JAX parameter subtrees of the detection head, not ported yet
    unported_params = ("pyramid/", "proposal_generator/", "roi_heads/")

    def __init__(
        self,
        backbone_config,
        classes,
        input_shape,
        normalize_mean,
        normalize_std,
        output_channels,
        patch_size,
        scale_factors,
        detectron2_config=None,
        rpn_config=None,
        roi_config=None,
        device=None,
        seed=0,
    ):
        super().__init__()
        # the detection head's configuration: unused until it is ported
        del classes, output_channels, scale_factors, detectron2_config, rpn_config, roi_config
        input_c, input_h, input_w = input_shape
        patch_size = (patch_size, patch_size) if isinstance(patch_size, int) else tuple(patch_size)
        self.input_shape = tuple(input_shape)
        self.backbone_input_size = (input_h // patch_size[0], input_w // patch_size[1])
        self.preprocessing = ViTDetPreprocessing(input_shape, normalize_mean, normalize_std)
        self.dim = backbone_config["block_config"]["dim"]
        self.embedding = LinearEmbedding(input_c, self.dim, patch_size)
        self.backbone = ViTBackbone(input_size=self.backbone_input_size, **backbone_config)
        generator = torch.Generator().manual_seed(seed)
        for module in self.modules():
            if hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        self.to(device)

    def init_state(self, batch=1, dtype=torch.float32, device=None):
        device = device if device is not None else self.embedding.kernel.device
        return self.backbone.init_state(batch, dtype, device)

    def precompute(self):
        return self.backbone.precompute()

    @torch.no_grad()
    def pre_backbone(self, ctx, x, content_hw=None):
        """x (B, C, H, W), uint8 or [0, 1]-scaled float -> tokens (B, N, dim)."""
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        x = self.preprocessing(x, content_hw)
        return self.embedding(ctx, x)

    @torch.no_grad()
    def apply_backbone(self, ctx, state, tokens, aux=None, mode=None):
        """One frame through the backbone. ``mode``: "flush" for a stream's
        first frame, "incremental" after; the dense model ignores it.
        Inference only: the kernels update the eventful state in place and
        have no backward. Returns (tokens, state)."""
        return self.backbone(ctx, state, tokens, mode=mode, aux=aux)

    def post_backbone(self, ctx, tokens):
        raise not_ported("ViTDet's detection head (post_backbone)", 14)


class SimplePyramid(nn.Module):
    """ViTDet's feature pyramid: not ported yet."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        raise not_ported("SimplePyramid", 14)

