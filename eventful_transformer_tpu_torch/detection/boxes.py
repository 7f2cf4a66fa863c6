"""Box utilities (port of ``eventful_transformer_tpu/detection/boxes.py``):
detectron2's ``Box2BoxTransform.apply_deltas`` with its clamp, clipping,
areas, IoU. Boxes are (x1, y1, x2, y2) in image coordinates."""

from __future__ import annotations

import math

import torch

# detectron2's scale clamp: log(1000 / 16)
SCALE_CLAMP = math.log(1000.0 / 16.0)


def apply_deltas(deltas, boxes, weights=(1.0, 1.0, 1.0, 1.0)):
    """Apply (dx, dy, dw, dh) regression deltas to boxes. deltas (..., 4)
    or (..., C, 4); boxes broadcastable to them."""
    wx, wy, ww, wh = weights
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=SCALE_CLAMP)
    dh = (deltas[..., 3] / wh).clamp(max=SCALE_CLAMP)
    pred_ctr_x = dx * widths + ctr_x
    pred_ctr_y = dy * heights + ctr_y
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    return torch.stack(
        [
            pred_ctr_x - 0.5 * pred_w,
            pred_ctr_y - 0.5 * pred_h,
            pred_ctr_x + 0.5 * pred_w,
            pred_ctr_y + 0.5 * pred_h,
        ],
        dim=-1,
    )


def clip_boxes(boxes, image_size):
    """Clip boxes to [0, w] x [0, h]; image_size = (h, w)."""
    h, w = image_size
    return torch.stack(
        [
            boxes[..., 0].clamp(0, w),
            boxes[..., 1].clamp(0, h),
            boxes[..., 2].clamp(0, w),
            boxes[..., 3].clamp(0, h),
        ],
        dim=-1,
    )


def box_area(boxes):
    return (boxes[..., 2] - boxes[..., 0]).clamp(min=0) * (boxes[..., 3] - boxes[..., 1]).clamp(min=0)


def iou_matrix(boxes_a, boxes_b):
    """Pairwise IoU: (N, 4) x (M, 4) -> (N, M), 0 where the union is 0."""
    area_a = box_area(boxes_a)[:, None]
    area_b = box_area(boxes_b)[None, :]
    lt = torch.maximum(boxes_a[:, None, :2], boxes_b[None, :, :2])
    rb = torch.minimum(boxes_a[:, None, 2:], boxes_b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, torch.zeros((), dtype=inter.dtype, device=inter.device))


def nonempty_boxes(boxes, threshold=0.0):
    """Mask of boxes with both sides > threshold (detectron2 Boxes.nonempty)."""
    return ((boxes[..., 2] - boxes[..., 0]) > threshold) & ((boxes[..., 3] - boxes[..., 1]) > threshold)
