"""Region Proposal Network, inference (port of
``eventful_transformer_tpu/detection/rpn.py``: detectron2's RPN and
StandardRPNHead as configured for ViTDet). Static shapes: a per-level top-k,
then one batched (per-level) NMS with a fixed output capacity
(``post_nms_topk``) and a validity mask. Batch 1. The training side
(anchor matching, sampling, losses) is ``detection/training.py``;
``propose(training=True)`` takes the train-time top-k pair.

A frame with fewer candidates than ``post_nms_topk`` (the training pair
keeps 1000, of as few as sum(min(pre_nms_topk, anchors of a level))):
``nms_padded`` returns one index a candidate, as the JAX function does,
beside ``post_nms_topk`` mask slots, and ``propose`` fills the slots past
them with the first kept box, masked, as the NMS's blocked loop fills its
unfilled slots. The JAX ``propose`` fails there."""

from __future__ import annotations

import torch
from torch import nn

from eventful_transformer_tpu_torch.detection.anchors import multi_level_anchors
from eventful_transformer_tpu_torch.detection.boxes import apply_deltas, clip_boxes, nonempty_boxes
from eventful_transformer_tpu_torch.detection.nms import batched_nms, top_k
from eventful_transformer_tpu_torch.ops.conv import Conv2d


class RPN(nn.Module):
    def __init__(
        self,
        in_channels=256,
        num_anchors=3,
        conv_dims=(-1, -1),
        anchor_sizes=((32,), (64,), (128,), (256,), (512,)),
        aspect_ratios=(0.5, 1.0, 2.0),
        strides=(4, 8, 16, 32, 64),
        anchor_offset=0.0,
        # (train, test) pairs; a bare int is the test-time value
        pre_nms_topk=(2000, 1000),
        post_nms_topk=(1000, 300),
        nms_thresh=0.7,
        min_box_size=0.0,
    ):
        super().__init__()
        as_pair = lambda v: (v, v) if isinstance(v, int) else tuple(v)  # noqa: E731
        self.anchor_sizes = anchor_sizes
        self.aspect_ratios = tuple(aspect_ratios)
        self.strides = tuple(strides)
        self.anchor_offset = anchor_offset
        self.pre_nms_topk = as_pair(pre_nms_topk)
        self.post_nms_topk = as_pair(post_nms_topk)
        self.nms_thresh = nms_thresh
        self.min_box_size = min_box_size
        self.convs = nn.ModuleList()
        cin = in_channels
        for dim in conv_dims:
            dim = in_channels if dim == -1 else dim
            self.convs.append(Conv2d(3, 3, cin, dim))
            cin = dim
        self.objectness = Conv2d(1, 1, cin, num_anchors)
        self.deltas = Conv2d(1, 1, cin, num_anchors * 4)
        self._anchors = {}

    def anchors(self, feature_sizes, device):
        """The per-level anchors (H_l * W_l * A, 4), made once per size."""
        key = (tuple(feature_sizes), str(device))
        if key not in self._anchors:
            self._anchors[key] = [
                torch.from_numpy(a).to(device)
                for a in multi_level_anchors(feature_sizes, self.strides, self.anchor_sizes,
                                             self.aspect_ratios, self.anchor_offset)
            ]
        return self._anchors[key]

    def head(self, feature):
        """feature (B, H, W, C) -> (logits (B, H*W*A), deltas (B, H*W*A, 4))."""
        x = feature
        for conv in self.convs:
            x = torch.relu(conv(x, padding=1))
        b = feature.shape[0]
        return self.objectness(x).reshape(b, -1), self.deltas(x).reshape(b, -1, 4)

    def propose(self, features, image_size, training=False):
        """features: a list of (1, H_l, W_l, C). Returns (boxes (P, 4),
        scores (P,) with -inf at masked slots, mask (P,)), P the
        post_nms_topk of the (train, test) pair that ``training`` picks."""
        if features[0].shape[0] != 1:
            raise ValueError(f"RPN.propose takes batch 1, got {features[0].shape[0]}")
        which = 0 if training else 1
        pre_nms_topk, post_nms_topk = self.pre_nms_topk[which], self.post_nms_topk[which]
        anchors = self.anchors([tuple(f.shape[1:3]) for f in features], features[0].device)
        all_boxes, all_scores, all_levels = [], [], []
        for level, (feature, level_anchors) in enumerate(zip(features, anchors)):
            logits, deltas = self.head(feature)
            logits, deltas = logits[0], deltas[0]
            k = min(pre_nms_topk, logits.shape[0])
            top_scores, top_idx = top_k(logits, k)
            boxes = apply_deltas(deltas[top_idx], level_anchors[top_idx])
            boxes = clip_boxes(boxes, image_size)
            keep = nonempty_boxes(boxes, self.min_box_size)
            all_boxes.append(boxes)
            all_scores.append(torch.where(keep, top_scores, -float("inf")))
            all_levels.append(torch.full((k,), level, dtype=torch.int32, device=logits.device))
        boxes = torch.cat(all_boxes)
        scores = torch.cat(all_scores)
        keep_idx, mask = batched_nms(boxes, scores, torch.cat(all_levels), self.nms_thresh,
                                     post_nms_topk)
        keep_idx = keep_idx.long()
        if keep_idx.shape[0] < post_nms_topk:
            keep_idx = torch.cat([keep_idx, keep_idx[:1].expand(post_nms_topk - len(keep_idx))])
        return boxes[keep_idx], torch.where(mask, scores[keep_idx], -float("inf")), mask
