"""Factorized ViViT action recognition (port of
``eventful_transformer_tpu/models/vivit.py``).

``FactorizedViViT.apply_views`` is the entry point the bench and the eval
harness call: preprocessed views in, class probabilities out. The frame
loop is plain Python: step 0 of each view flushes, steps 1+ run
incrementally. ``ViViTPreprocessing`` is not ported yet (ROADMAP.md, open
item 7).
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
        del normalize_mean, normalize_std, temporal_stride  # preprocessing only
        input_t, input_c, input_h, input_w = tuple(input_shape)
        tubelet_shape = tuple(tubelet_shape)
        del spatial_views, temporal_views  # the views arrive stacked on an axis
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
