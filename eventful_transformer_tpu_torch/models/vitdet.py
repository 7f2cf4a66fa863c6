"""ViTDet object detection (port of ``eventful_transformer_tpu/models/vitdet.py``).

``ViTDet.apply`` takes one video frame to detections: ``pre_backbone``
(preprocessing and the patch embedding), ``apply_backbone`` (the position
encoding and the block stack, with the eventful state threaded through)
and ``post_backbone`` (``SimplePyramid``, ``RPN.propose`` and the standard
ROI heads' ``inference``), the reference's timing split
(scripts/time/vitdet_vid.py). Feature maps are NHWC, as in the JAX package.
The COCO cascade and mask heads are not ported yet (ROADMAP.md, open item
14).
"""

from __future__ import annotations

from math import prod, sqrt

import torch
from torch import nn

from eventful_transformer_tpu_torch.core.backbones import ViTBackbone
from eventful_transformer_tpu_torch.core.nn import (
    LayerNorm,
    gelu,
    layer_norm,
    model_device,
    uniform_,
)
from eventful_transformer_tpu_torch.detection.roi_heads import roi_heads
from eventful_transformer_tpu_torch.detection.rpn import RPN
from eventful_transformer_tpu_torch.ops.conv import Conv2d, ConvTranspose2d, max_pool2d


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


class SimplePyramid(nn.Module):
    """ViTDet's feature pyramid, NHWC: one stage per scale factor (4, 2, 1,
    0.5: two transposed convs with LN and GELU between them, one transposed
    conv, nothing, a 2 x 2 max pool), each then a 1x1 conv, LN, a 3x3 conv
    and LN, plus the extra stride-2 level subsampled from the last map."""

    def __init__(self, scale_factors, dim, out_channels):
        super().__init__()
        if any(s not in (4.0, 2.0, 1.0, 0.5) for s in scale_factors):
            raise ValueError(f"scale factors must be 4, 2, 1 or 0.5, got {scale_factors}")
        self.scale_factors = tuple(scale_factors)
        self.stages = nn.ModuleList()
        for scale in self.scale_factors:
            stage = nn.Module()
            if scale == 4.0:
                stage.deconv_1 = ConvTranspose2d(2, 2, dim, dim // 2)
                stage.deconv_ln = LayerNorm(dim // 2)
                stage.deconv_2 = ConvTranspose2d(2, 2, dim // 2, dim // 4)
            elif scale == 2.0:
                stage.deconv_1 = ConvTranspose2d(2, 2, dim, dim // 2)
            mid = {4.0: dim // 4, 2.0: dim // 2}.get(scale, dim)
            stage.conv_1 = Conv2d(1, 1, mid, out_channels, bias=False)
            stage.ln_1 = LayerNorm(out_channels)
            stage.conv_2 = Conv2d(3, 3, out_channels, out_channels, bias=False)
            stage.ln_2 = LayerNorm(out_channels)
            self.stages.append(stage)

    def forward(self, x):
        """x (B, H, W, dim) -> a list of NHWC maps at x4, x2, x1, x0.5 and
        the extra x0.25 level."""
        outputs = []
        for scale, stage in zip(self.scale_factors, self.stages):
            y = x
            if scale == 4.0:
                y = gelu(layer_norm(stage.deconv_1(y), stage.deconv_ln))
                y = stage.deconv_2(y)
            elif scale == 2.0:
                y = stage.deconv_1(y)
            elif scale == 0.5:
                y = max_pool2d(y, 2, 2)
            y = layer_norm(stage.conv_1(y), stage.ln_1)
            y = layer_norm(stage.conv_2(y, padding=1), stage.ln_2)
            outputs.append(y)
        outputs.append(outputs[-1][:, ::2, ::2, :])  # MaxPool2d(1, 2)
        return outputs


class ViTDet(nn.Module):
    """ViTDet detection model. Parameters are initialised from ``seed`` on
    the CPU, so the weights do not depend on ``device``, and then moved to
    ``device``, the card unless the caller asks for the CPU; cast the model
    with ``.to(dtype)`` to run in bfloat16. ``roi_config`` picks the heads
    as the JAX package does: the standard heads of the VID configurations,
    or the COCO cascade (``cascade: true``), which is not ported yet."""

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
        device="cuda",
        seed=0,
    ):
        super().__init__()
        del detectron2_config  # accepted for config parity; the head is native
        device = model_device(device)
        input_c, input_h, input_w = input_shape
        patch_size = (patch_size, patch_size) if isinstance(patch_size, int) else tuple(patch_size)
        self.input_shape = tuple(input_shape)
        self.backbone_input_size = (input_h // patch_size[0], input_w // patch_size[1])
        self.preprocessing = ViTDetPreprocessing(input_shape, normalize_mean, normalize_std)
        self.dim = backbone_config["block_config"]["dim"]
        self.embedding = LinearEmbedding(input_c, self.dim, patch_size)
        self.backbone = ViTBackbone(input_size=self.backbone_input_size, **backbone_config)
        self.pyramid = SimplePyramid(scale_factors, self.dim, output_channels)
        self.proposal_generator = RPN(in_channels=output_channels, **(rpn_config or {}))
        self.roi_heads = roi_heads(classes, output_channels, **(roi_config or {}))
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

    @torch.no_grad()
    def post_backbone(self, ctx, tokens):
        """tokens (1, N, dim) -> the detections dict: boxes (K, 4), scores
        (K,), labels (K,) int32 and mask (K,), K = the ROI heads'
        ``test_topk_per_image``, masked slots scoring 0. Uncounted, as in
        the JAX package."""
        del ctx
        b = tokens.shape[0]
        h, w = self.backbone_input_size
        features = self.pyramid(tokens.reshape(b, h, w, self.dim))
        image_size = (self.input_shape[1], self.input_shape[2])
        proposals, _, mask = self.proposal_generator.propose(features, image_size)
        return self.roi_heads.inference(features[:4], proposals, mask, image_size)

    def apply(self, ctx, state, x, aux=None, content_hw=None, mode=None):
        """One frame, (1, C, H, W), to detections: returns (detections,
        state). ``mode`` as in :meth:`apply_backbone`."""
        tokens = self.pre_backbone(ctx, x, content_hw)
        tokens, state = self.apply_backbone(ctx, state, tokens, aux, mode=mode)
        return self.post_backbone(ctx, tokens), state
