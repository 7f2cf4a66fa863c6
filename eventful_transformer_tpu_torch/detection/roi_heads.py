"""ROI heads, inference (port of
``eventful_transformer_tpu/detection/roi_heads.py``).

``StandardROIHeads``: detectron2's StandardROIHeads, FastRCNNConvFCHead and
FastRCNNOutputLayers as configured for ViTDet on VID. Multi-level ROIAlign
over p2-p5, 4 x (3x3 conv without bias, LN, ReLU), the flatten in (C, H, W)
order, FC 1024 + ReLU, class scores (C + 1) and class-specific box deltas
(4C), then softmax, the score threshold, per-class NMS and the top-k per
image, all fixed-shape with validity masks.

``CascadeROIHeads``: the 3-stage cascade of the COCO operating point
(reference configs/detectron/vitdet_b_coco.py:22-48), each stage its own
box head and predictor with class-agnostic box regression and
Box2BoxTransform weights (10,10,5,5), (20,20,10,10), (30,30,15,15); each
stage pools the previous stage's boxes, refines and clips them; the class
probabilities are averaged over the stages, and the last stage's boxes go
through the NMS tail; with ``with_mask`` the mask head
(``detection/mask_head.py``) then runs on the final boxes and labels.
"""

from __future__ import annotations

import torch
from torch import nn

from eventful_transformer_tpu_torch.core.nn import LayerNorm, layer_norm, trunc_normal_
from eventful_transformer_tpu_torch.detection.boxes import apply_deltas, clip_boxes
from eventful_transformer_tpu_torch.detection.mask_head import MaskHead
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


class BoxLayers:
    """The box head and predictor over a module's own ``convs``, ``fcs``,
    ``cls_score`` and ``bbox_pred`` (:meth:`StandardROIHeads.add_box_layers`
    makes them)."""

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


class CascadeStage(BoxLayers, nn.Module):
    """One cascade stage's box head and predictor."""


class StandardROIHeads(BoxLayers, nn.Module):
    """``box_layers`` False leaves the box head and predictor to a subclass
    that holds one a stage (:class:`CascadeROIHeads`)."""

    # box regression: class-specific (4 a class) for the VID standard heads;
    # the COCO cascade's is class-agnostic (4)
    cls_agnostic = False

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
        *,
        box_layers=True,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.in_channels = in_channels
        self.pooler_scales = tuple(pooler_scales)
        self.pooler_output = pooler_output
        self.sampling_ratio = sampling_ratio
        self.conv_dims = tuple(conv_dims)
        self.fc_dims = tuple(fc_dims)
        self.box_weights = tuple(box_weights)
        self.test_score_thresh = test_score_thresh
        self.test_nms_thresh = test_nms_thresh
        self.test_topk_per_image = test_topk_per_image
        if box_layers:
            self.add_box_layers(self)

    def add_box_layers(self, module):
        """Give ``module`` a box head and predictor (``convs``, ``fcs``,
        ``cls_score``, ``bbox_pred``: the JAX ``init``'s names); returns
        it."""
        module.convs = nn.ModuleList()
        cin = self.in_channels
        for dim in self.conv_dims:
            conv = Conv2d(3, 3, cin, dim, bias=False)
            conv.ln = LayerNorm(dim)
            module.convs.append(conv)
            cin = dim
        flat = cin * self.pooler_output**2
        module.fcs = nn.ModuleList()
        for dim in self.fc_dims:
            module.fcs.append(Dense(flat, dim, std=0.01))
            flat = dim
        module.cls_score = Dense(flat, self.num_classes + 1, std=0.01)
        box_dim = 4 if self.cls_agnostic else self.num_classes * 4
        module.bbox_pred = Dense(flat, box_dim, std=0.001)
        return module

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
        proposal_valid = proposal_mask[:, None].expand(p, c).reshape(-1)
        valid = (flat_scores > self.test_score_thresh) & proposal_valid
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


class CascadeROIHeads(StandardROIHeads):
    """The 3-stage cascade, inference (JAX ``CascadeROIHeads``): stage k
    refines stage k - 1's boxes with its own Box2BoxTransform weights;
    the class probabilities are averaged over the stages; the final boxes
    are the last stage's. Its parameters: ``stages.<i>`` (each stage's box
    head and predictor) and, with ``with_mask``, ``mask_head``."""

    cls_agnostic = True

    def __init__(
        self,
        num_classes,
        stage_box_weights=(
            (10.0, 10.0, 5.0, 5.0),
            (20.0, 20.0, 10.0, 10.0),
            (30.0, 30.0, 15.0, 15.0),
        ),
        with_mask=False,
        **kwargs,
    ):
        kwargs.pop("box_weights", None)
        super().__init__(num_classes, box_weights=stage_box_weights[0], box_layers=False, **kwargs)
        self.stage_box_weights = tuple(tuple(w) for w in stage_box_weights)
        self.stages = nn.ModuleList(
            self.add_box_layers(CascadeStage()) for _ in self.stage_box_weights
        )
        # the COCO base config is cascade_mask_rcnn: instance masks of the
        # final detections
        self.mask_head = MaskHead(num_classes, in_channels=self.in_channels) if with_mask else None

    def inference(self, features, proposals, proposal_mask, image_size):
        """As :meth:`StandardROIHeads.inference`, and ``masks`` (K, 28, 28)
        where the heads have a mask head."""
        boxes = proposals
        stage_probs = []
        for stage, weights in zip(self.stages, self.stage_box_weights):
            scores, deltas = stage.predict(stage.box_head(self._pool(features, boxes)))
            stage_probs.append(torch.softmax(scores, dim=-1))
            # class-agnostic refinement: the refined boxes, clipped, are the
            # next stage's proposals (detectron2 _create_proposals_from_boxes)
            boxes = clip_boxes(apply_deltas(deltas.reshape(-1, 4), boxes, weights=weights),
                               image_size)
        probs = sum(stage_probs) / len(stage_probs)
        probs = probs[:, : self.num_classes]  # drop the background
        result = self._nms_tail(probs, boxes[:, None, :], proposal_mask, image_size)
        if self.mask_head is not None:
            result["masks"] = self.mask_head.inference(features, result["boxes"], result["labels"])
        return result


def roi_heads(num_classes, in_channels, cascade=False, with_mask=False, **config):
    """The ROI heads of a ``roi_config``, as the JAX ViTDet picks them: the
    standard heads, or with ``cascade`` the cascade heads (``with_mask``
    adds their mask head; it applies to the cascade only)."""
    if cascade:
        return CascadeROIHeads(num_classes=num_classes, in_channels=in_channels,
                               with_mask=with_mask, **config)
    return StandardROIHeads(num_classes=num_classes, in_channels=in_channels, **config)
