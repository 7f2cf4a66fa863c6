"""Factorized ViViT action recognition (port of
``eventful_transformer_tpu/models/vivit.py``).

``FactorizedViViT.apply`` is the eval harness's entry point: a raw video
in, through ``ViViTPreprocessing`` (on the video's device), class
probabilities out. ``apply_views`` is the bench's: preprocessed views in.
The frame loop is plain Python: step 0 of each view flushes, steps 1+ run
incrementally.
"""

from __future__ import annotations

from math import prod, sqrt

import torch
from torch import nn

from eventful_transformer_tpu_torch.core.backbones import ViTBackbone
from eventful_transformer_tpu_torch.core.nn import (
    Dropout,
    LayerNorm,
    Linear,
    layer_norm,
    model_device,
    not_ported,
    trunc_normal_,
    uniform_,
)
from eventful_transformer_tpu_torch.ops.resize import resize_bilinear


class TubeletEmbedding(nn.Module):
    """Linear tubelet embedding, Conv3d(kernel == stride == tubelet) as a
    matmul over the extracted patches. Not counted, as in the reference."""

    def __init__(self, input_channels, dim, tubelet_shape):
        super().__init__()
        self.tubelet_shape = tuple(tubelet_shape)
        fan_in = input_channels * prod(self.tubelet_shape)
        # (C * t * h * w, dim), flattened in torch Conv3d (C, t, h, w) order
        self.kernel = nn.Parameter(torch.zeros(fan_in, dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator):
        scale = 1.0 / sqrt(self.kernel.shape[0])
        uniform_(self.kernel, -scale, scale, generator)
        uniform_(self.bias, -scale, scale, generator)

    def forward(self, ctx, x):
        """x (B, T, C, H, W) -> (B, T / t, (H / h) * (W / w), dim)."""
        del ctx
        b, t, c, h, w = x.shape
        tt, th, tw = self.tubelet_shape
        x = x.reshape(b, t // tt, tt, c, h // th, th, w // tw, tw)
        x = x.permute(0, 1, 4, 6, 3, 2, 5, 7)  # (b, q, y, x, c, t, h, w)
        x = x.reshape(b, t // tt, (h // th) * (w // tw), -1)
        return torch.matmul(x, self.kernel.to(x.dtype)) + self.bias.to(x.dtype)


class ViViTSubModel(nn.Module):
    """A spatial or temporal sub-model: prepends a class token, runs the
    backbone and a final LN, and returns the class token."""

    def __init__(self, input_size, backbone_config):
        super().__init__()
        dim = backbone_config["block_config"]["dim"]
        self.class_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.backbone = ViTBackbone(input_size=input_size, has_class_token=True, **backbone_config)
        self.layer_norm = LayerNorm(dim)

    def reset_parameters(self, generator):
        trunc_normal_(self.class_token, generator)

    def init_state(self, batch, dtype, device):
        return self.backbone.init_state(batch, dtype, device)

    def forward(self, ctx, state, x, mode=None):
        cls = self.class_token.to(x.dtype).expand(x.shape[0], 1, x.shape[-1])
        x, state = self.backbone(ctx, state, torch.cat([cls, x], dim=1), mode=mode)
        return layer_norm(x, self.layer_norm)[:, 0], state


class ViViTPreprocessing:
    """Value normalisation and the spatial and temporal views (port of the
    JAX package's ``ViViTPreprocessing``, reference models/vivit.py:
    195-269). Runs on the device of the video it is given."""

    def __init__(
        self, input_shape, normalize_mean, normalize_std, spatial_views, temporal_stride,
        temporal_views,
    ):
        self.input_shape = tuple(input_shape)
        self.normalize_mean = normalize_mean
        self.normalize_std = normalize_std
        self.spatial_views = spatial_views
        self.temporal_stride = temporal_stride
        self.temporal_views = temporal_views

    def __call__(self, x):
        """x (batch, time, channel, height, width), uint8 or float. Returns
        the spatial_views x temporal_views views, spatial-major, each
        (batch, t, c, h, w) float32."""
        t, _, h, w = self.input_shape
        # a video shorter than one view repeats its last frame
        view_size = self.temporal_stride * t
        if x.shape[1] < view_size:
            pad = x[:, -1:].expand((x.shape[0], view_size - x.shape[1]) + x.shape[2:])
            x = torch.cat([x, pad], dim=1)
        if self.temporal_views == 1:
            starts = [(x.shape[1] - view_size) // 2]
        else:
            spacing = (x.shape[1] - view_size) / (self.temporal_views - 1)
            starts = [int(k * spacing) for k in range(self.temporal_views)]
        out = []
        for i in starts:
            v = x[:, i : i + view_size : self.temporal_stride]
            v = v.float() / 255.0 if v.dtype == torch.uint8 else v.float()
            v = (v - self.normalize_mean) / self.normalize_std
            # the short edge to cover the crop, antialiased bilinear
            scale = max(h / v.shape[-2], w / v.shape[-1])
            if scale != 1.0:
                size = (round(scale * v.shape[-2]), round(scale * v.shape[-1]))
                v = resize_bilinear(v, size, antialias=True)
            out.append(v)
        if self.spatial_views == 1:
            starts = [((out[0].shape[-2] - h) // 2, (out[0].shape[-1] - w) // 2)]
        else:
            h_spacing = (out[0].shape[-2] - h) / (self.spatial_views - 1)
            w_spacing = (out[0].shape[-1] - w) / (self.spatial_views - 1)
            starts = [(int(k * h_spacing), int(k * w_spacing)) for k in range(self.spatial_views)]
        return [v[..., i : i + h, j : j + w] for i, j in starts for v in out]


class FactorizedViViT(nn.Module):
    """Spatio-temporally factorized ViViT. Parameters are initialised from
    ``seed`` on the CPU, so the weights do not depend on ``device``, and
    then moved to ``device``, the card unless the caller asks for the CPU;
    cast the model with ``.to(dtype)`` to run in bfloat16."""

    def __init__(
        self,
        classes,
        input_shape,
        normalize_mean,
        normalize_std,
        spatial_config,
        spatial_views,
        temporal_config,
        temporal_stride,
        temporal_views,
        tubelet_shape,
        batch_views=True,
        dropout_rate=0.0,
        spatial_only=False,
        temporal_only=False,
        device="cuda",
        seed=0,
    ):
        super().__init__()
        device = model_device(device)
        if not batch_views:
            raise not_ported("batch_views=False", 12)
        if spatial_only or temporal_only:
            raise not_ported("spatial_only / temporal_only (spatial cache)", 12)
        self.preprocessing = ViViTPreprocessing(
            input_shape, normalize_mean, normalize_std, spatial_views, temporal_stride,
            temporal_views,
        )
        self.n_views = spatial_views * temporal_views
        input_t, input_c, input_h, input_w = tuple(input_shape)
        tubelet_shape = tuple(tubelet_shape)
        dim = spatial_config["block_config"]["dim"]
        self.embedding = TubeletEmbedding(input_c, dim, tubelet_shape)
        self.spatial_model = ViViTSubModel(
            (input_h // tubelet_shape[1], input_w // tubelet_shape[2]), spatial_config
        )
        self.temporal_model = ViViTSubModel((input_t // tubelet_shape[0],), temporal_config)
        self.dropout = Dropout(dropout_rate)
        self.classifier = Linear(dim, classes)
        generator = torch.Generator().manual_seed(seed)
        for module in self.modules():
            if hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        self.to(device)

    @torch.no_grad()
    def apply(self, ctx, video):
        """video (batch, time, channel, height, width), uint8 or float, on
        any device -> class probabilities. The views are made on the
        model's device and cast to its parameters' dtype, then run through
        :meth:`apply_views`."""
        kernel = self.classifier.kernel
        views = self.preprocessing(video.to(kernel.device))
        return self.apply_views(ctx, torch.stack(views, dim=1).to(kernel.dtype))

    @torch.no_grad()
    def apply_views(self, ctx, views):
        """views (batch, n_views, t, c, h, w) -> class probabilities.
        Inference only: the kernels update the eventful state in place and
        have no backward."""
        batch = views.shape[0]
        x = self._forward_spatial(ctx, views)
        return self._forward_temporal(ctx, x, batch)

    def _forward_spatial(self, ctx, views):
        b, v = views.shape[:2]
        return self._forward_view(ctx, views.reshape((b * v,) + views.shape[2:]))

    def _forward_view(self, ctx, x):
        """Embed, then run the spatial sub-model over the time steps: step 0
        flushes, the rest are incremental. Returns (batch, time, dim)."""
        x = self.embedding(ctx, x)
        state = self.spatial_model.init_state(x.shape[0], x.dtype, x.device)
        ys = []
        for t in range(x.shape[1]):
            mode = "flush" if t == 0 else "incremental"
            y, state = self.spatial_model(ctx, state, x[:, t], mode=mode)
            ys.append(y)
        return torch.stack(ys, dim=1)

    def _forward_temporal(self, ctx, x, batch):
        x = x.reshape((-1,) + x.shape[-2:])
        state = self.temporal_model.init_state(x.shape[0], x.dtype, x.device)
        x, _ = self.temporal_model(ctx, state, x, mode="flush")
        x = self.dropout(ctx, x)
        x = self.classifier(ctx, x)
        x = x.reshape(batch, -1, x.shape[-1]).mean(dim=-2)
        return torch.softmax(x, dim=-1)
