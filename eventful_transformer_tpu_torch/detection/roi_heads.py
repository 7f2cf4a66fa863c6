"""ROI heads, inference (port of ``StandardROIHeads`` from
``eventful_transformer_tpu/detection/roi_heads.py``: detectron2's
StandardROIHeads, FastRCNNConvFCHead and FastRCNNOutputLayers as configured
for ViTDet on VID). Multi-level ROIAlign over p2-p5, 4 x (3x3 conv without
bias, LN, ReLU), the flatten in (C, H, W) order, FC 1024 + ReLU, class
scores (C + 1) and class-specific box deltas (4C), then softmax, the score
threshold, per-class NMS and the top-k per image, all fixed-shape with
validity masks. The COCO cascade and its mask head are not ported yet."""

from __future__ import annotations

import torch
from torch import nn

from eventful_transformer_tpu_torch.core.nn import LayerNorm, layer_norm, not_ported, trunc_normal_
from eventful_transformer_tpu_torch.detection.boxes import apply_deltas, clip_boxes
from eventful_transformer_tpu_torch.detection.nms import batched_nms
from eventful_transformer_tpu_torch.detection.roi_align import multilevel_roi_align
from eventful_transformer_tpu_torch.ops.conv import Conv2d


class Dense(nn.Module):
    """An uncounted (in, out) linear layer, initialised as the JAX heads:
    a truncated normal kernel with standard deviation ``std``, zero bias."""

    def __init__(self, fan_in, fan_out, std):
        super().__init__()
        self.std = std
        self.kernel = nn.Parameter(torch.zeros(fan_in, fan_out))
        self.bias = nn.Parameter(torch.zeros(fan_out))

    def reset_parameters(self, generator):
        trunc_normal_(self.kernel, generator, std=self.std)

    def forward(self, x):
        return x @ self.kernel.to(x.dtype) + self.bias.to(x.dtype)


class StandardROIHeads(nn.Module):
    def __init__(
        self,
        num_classes,
        in_channels=256,
        pooler_scales=(1 / 4, 1 / 8, 1 / 16, 1 / 32),
        pooler_output=7,
        sampling_ratio=2,
        conv_dims=(256, 256, 256, 256),
        fc_dims=(1024,),
        box_weights=(10.0, 10.0, 5.0, 5.0),
        test_score_thresh=0.05,
        test_nms_thresh=0.5,
        test_topk_per_image=100,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.pooler_scales = tuple(pooler_scales)
        self.pooler_output = pooler_output
        self.sampling_ratio = sampling_ratio
        self.box_weights = tuple(box_weights)
        self.test_score_thresh = test_score_thresh
        self.test_nms_thresh = test_nms_thresh
        self.test_topk_per_image = test_topk_per_image
        self.convs = nn.ModuleList()
        cin = in_channels
        for dim in conv_dims:
            conv = Conv2d(3, 3, cin, dim, bias=False)
            conv.ln = LayerNorm(dim)
            self.convs.append(conv)
            cin = dim
        flat = cin * pooler_output**2
        self.fcs = nn.ModuleList()
        for dim in fc_dims:
            self.fcs.append(Dense(flat, dim, std=0.01))
            flat = dim
        self.cls_score = Dense(flat, num_classes + 1, std=0.01)
        self.bbox_pred = Dense(flat, num_classes * 4, std=0.001)

    def box_head(self, pooled):
        """pooled (R, 7, 7, C) -> features (R, fc_dim)."""
        x = pooled
        for conv in self.convs:
            x = torch.relu(layer_norm(conv(x, padding=1), conv.ln))
        # the flatten in torch's channel-first order (C, H, W), for weight parity
        x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
        for fc in self.fcs:
            x = torch.relu(fc(x))
        return x

    def predict(self, features):
        return self.cls_score(features), self.bbox_pred(features)

    def _pool(self, features, boxes):
        return multilevel_roi_align(
            [f[0] for f in features], boxes, self.pooler_scales, min_level=2, max_level=5,
            output_size=self.pooler_output, sampling_ratio=self.sampling_ratio,
        )

    def _nms_tail(self, probs, boxes, proposal_mask, image_size):
        """probs (P, C) foreground probabilities; boxes (P, C, 4) per-class
        boxes. The score threshold, per-class NMS and the top-k; masked
        slots score 0."""
        boxes = clip_boxes(boxes, image_size)
        p, c = probs.shape
        flat_boxes = boxes.expand(p, c, 4).reshape(p * c, 4)
        flat_scores = probs.reshape(p * c)
        classes = torch.arange(c, dtype=torch.int32, device=probs.device).repeat(p)
        valid = (flat_scores > self.test_score_thresh) & proposal_mask.repeat_interleave(c)
        flat_scores = torch.where(valid, flat_scores, -float("inf"))
        keep_idx, keep_mask = batched_nms(flat_boxes, flat_scores, classes, self.test_nms_thresh,
                                          self.test_topk_per_image)
        keep_idx = keep_idx.long()
        zero = torch.zeros((), dtype=flat_scores.dtype, device=flat_scores.device)
        return {
            "boxes": flat_boxes[keep_idx],
            "scores": torch.where(keep_mask, flat_scores[keep_idx], zero),
            "labels": classes[keep_idx],
            "mask": keep_mask,
        }

    def inference(self, features, proposals, proposal_mask, image_size):
        """features: a list of (1, H_l, W_l, C) for p2..p5; proposals (P, 4).
        Returns the detections dict: fixed-size boxes, scores, labels and
        mask."""
        pooled = self._pool(features, proposals)
        scores, deltas = self.predict(self.box_head(pooled))
        probs = torch.softmax(scores, dim=-1)[:, : self.num_classes]  # drop the background
        deltas = deltas.reshape(-1, self.num_classes, 4)
        boxes = apply_deltas(deltas, proposals[:, None, :], weights=self.box_weights)
        return self._nms_tail(probs, boxes, proposal_mask, image_size)


def roi_heads(num_classes, in_channels, cascade=False, with_mask=False, **config):
    """The ROI heads of a ``roi_config``, as the JAX ViTDet picks them: the
    standard heads unless ``cascade`` (``with_mask`` applies to the cascade
    only)."""
    if cascade:
        raise not_ported("CascadeROIHeads (the COCO cascade heads)" + (" and MaskHead" if with_mask else ""), 14)
    return StandardROIHeads(num_classes=num_classes, in_channels=in_channels, **config)
