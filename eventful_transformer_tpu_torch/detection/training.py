"""The detector's training side (port of
``eventful_transformer_tpu/detection/training.py``): anchor matching,
proposal sampling, the RPN and Fast R-CNN losses, one image at a time
(reference configs/detectron/vitdet_b_vid.py:25-31, 37-41; detectron2's
matcher.py, sampling.py, rpn.py and fast_rcnn.py).

Static shapes, as in the JAX package: ground truth comes padded with a
validity mask, sampling returns boolean masks over every entry instead of
index lists, and the random subsample ranks per-entry uniforms instead of
permuting. The sorts are stable and ``argmax`` takes the first maximum,
as ``jnp.argsort`` and ``jnp.argmax`` do.

Random draws: :func:`subsample_labels` (and so :func:`rpn_losses` and
:func:`sample_proposals`) takes ``draws``, a ``torch.Generator`` from which
it draws two uniform arrays (positives, negatives), or those two arrays
themselves, which :func:`subsample_labels_from_uniforms` takes; so a test
can hand it JAX's own uniforms.

The formulas are the JAX package's, divisions inside ``where`` included:
a degenerate box pair's GIoU gradient is NaN on both sides.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from eventful_transformer_tpu_torch.detection.boxes import iou_matrix


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _relu(x):
    """max(x, 0) with ``jnp.maximum``'s gradient (split at a tie)."""
    return torch.maximum(x, _zero(x))


def get_deltas(src_boxes, target_boxes, weights=(1.0, 1.0, 1.0, 1.0)):
    """The (dx, dy, dw, dh) that map ``src_boxes`` onto ``target_boxes``
    (detectron2 ``Box2BoxTransform.get_deltas``); degenerate sources
    (padding) are guarded, and callers mask them out."""
    wx, wy, ww, wh = weights
    src_w = src_boxes[..., 2] - src_boxes[..., 0]
    src_h = src_boxes[..., 3] - src_boxes[..., 1]
    src_cx = src_boxes[..., 0] + 0.5 * src_w
    src_cy = src_boxes[..., 1] + 0.5 * src_h
    tgt_w = target_boxes[..., 2] - target_boxes[..., 0]
    tgt_h = target_boxes[..., 3] - target_boxes[..., 1]
    tgt_cx = target_boxes[..., 0] + 0.5 * tgt_w
    tgt_cy = target_boxes[..., 1] + 0.5 * tgt_h
    eps = torch.full((), 1e-6, dtype=src_w.dtype, device=src_w.device)
    src_w = torch.maximum(src_w, eps)
    src_h = torch.maximum(src_h, eps)
    return torch.stack(
        [
            wx * (tgt_cx - src_cx) / src_w,
            wy * (tgt_cy - src_cy) / src_h,
            ww * torch.log(torch.maximum(tgt_w, eps) / src_w),
            wh * torch.log(torch.maximum(tgt_h, eps) / src_h),
        ],
        dim=-1,
    )


class Matcher:
    """detectron2's Matcher: each prediction (anchor or proposal) bucketed
    by its best IoU against the ground truth.

    ``thresholds``: ascending cut points; ``labels``: len(thresholds) + 1
    values of {-1, 0, 1} (ignore, negative, positive).
    ``allow_low_quality_matches`` also marks positive, for every gt box,
    the predictions reaching its highest IoU (detectron2
    ``set_low_quality_matches_``)."""

    def __init__(self, thresholds, labels, allow_low_quality_matches=False):
        thresholds = list(thresholds)
        if any(low > high for low, high in zip(thresholds, thresholds[1:])):
            raise ValueError(f"thresholds must ascend, got {thresholds}")
        if len(labels) != len(thresholds) + 1 or any(l not in (-1, 0, 1) for l in labels):
            raise ValueError(f"{len(thresholds) + 1} labels of -1, 0, 1 wanted, got {labels}")
        self.thresholds = thresholds
        self.labels = list(labels)
        self.allow_low_quality_matches = allow_low_quality_matches

    def __call__(self, quality, gt_mask=None):
        """quality (G, A): IoU of gt x predictions; ``gt_mask`` (G,) marks
        the valid (non-padding) gt rows. Returns (matches (A,) int32 gt
        indices, match labels (A,) int8 in {-1, 0, 1})."""
        if gt_mask is not None:
            quality = torch.where(gt_mask[:, None], quality, torch.full_like(quality, -1.0))
        matched_vals = quality.max(dim=0).values
        matches = quality.argmax(dim=0).int()
        labels = torch.full(matched_vals.shape, self.labels[0], dtype=torch.int8,
                            device=quality.device)
        edges = [-float("inf")] + self.thresholds + [float("inf")]
        for label, low, high in zip(self.labels, edges[:-1], edges[1:]):
            in_bucket = (matched_vals >= low) & (matched_vals < high)
            labels = torch.where(in_bucket, torch.tensor(label, dtype=torch.int8,
                                                         device=quality.device), labels)
        if self.allow_low_quality_matches:
            best_per_gt = quality.max(dim=1, keepdim=True).values  # (G, 1)
            # ties included, zero-quality gt excluded (detectron2's rule)
            is_best = (quality == best_per_gt) & (best_per_gt > 0)
            labels = torch.where(is_best.any(dim=0), torch.ones_like(labels), labels)
        return matches, labels


def _pick(mask, count, uniforms):
    """The ``count`` entries of ``mask`` of the highest uniforms: the rank
    of each entry by descending priority (masked-off entries last, ties to
    the smaller index) below ``count``."""
    prio = torch.where(mask, uniforms, torch.full_like(uniforms, -1.0))
    order = torch.argsort(-prio, stable=True)
    rank = torch.argsort(order, stable=True)
    return mask & (rank < count)


def subsample_labels_from_uniforms(uniforms_pos, uniforms_neg, labels, num_samples,
                                   positive_fraction):
    """detectron2 ``subsample_labels`` with static shapes, given the draws:
    (sampled positives, sampled negatives) boolean masks over every entry.
    Positives (label 1) are capped at int(num_samples * positive_fraction);
    negatives (label 0) fill the rest; each set is chosen uniformly, by
    ranking ``uniforms_pos`` or ``uniforms_neg`` (labels' shape)."""
    pos = labels == 1
    neg = labels == 0
    num_pos = torch.clamp(pos.sum(), max=int(num_samples * positive_fraction))
    num_neg = torch.minimum(neg.sum(), num_samples - num_pos)
    return _pick(pos, num_pos, uniforms_pos), _pick(neg, num_neg, uniforms_neg)


def draw_uniforms(draws, shape, device):
    """The (positive, negative) uniforms of :func:`subsample_labels`:
    drawn from ``draws`` where it is a ``torch.Generator`` (on its device,
    then moved to ``device``), else ``draws`` itself, the two arrays."""
    if isinstance(draws, torch.Generator):
        return tuple(torch.rand(shape, generator=draws, device=draws.device).to(device)
                     for _ in range(2))
    u_pos, u_neg = draws
    return u_pos.to(device), u_neg.to(device)


def subsample_labels(draws, labels, num_samples, positive_fraction):
    """:func:`subsample_labels_from_uniforms` on the uniforms of ``draws``
    (:func:`draw_uniforms`)."""
    u_pos, u_neg = draw_uniforms(draws, labels.shape, labels.device)
    return subsample_labels_from_uniforms(u_pos, u_neg, labels, num_samples, positive_fraction)


def smooth_l1(pred, target, beta=0.0):
    diff = torch.abs(pred - target)
    if beta <= 0:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def _area(boxes):
    return _relu(boxes[..., 2] - boxes[..., 0]) * _relu(boxes[..., 3] - boxes[..., 1])


def giou_loss(pred_boxes, target_boxes):
    """1 - generalized IoU (detectron2 ``giou_loss``), elementwise."""
    lt = torch.maximum(pred_boxes[..., :2], target_boxes[..., :2])
    rb = torch.minimum(pred_boxes[..., 2:], target_boxes[..., 2:])
    wh = _relu(rb - lt)
    inter = wh[..., 0] * wh[..., 1]
    union = _area(pred_boxes) + _area(target_boxes) - inter
    zero = _zero(inter)
    iou = torch.where(union > 0, inter / union, zero)
    lt_c = torch.minimum(pred_boxes[..., :2], target_boxes[..., :2])
    rb_c = torch.maximum(pred_boxes[..., 2:], target_boxes[..., 2:])
    wh_c = _relu(rb_c - lt_c)
    enclosing = wh_c[..., 0] * wh_c[..., 1]
    giou = iou - torch.where(enclosing > 0, (enclosing - union) / enclosing, zero)
    return 1.0 - giou


def rpn_losses(
    draws,
    anchors,
    objectness_logits,
    pred_deltas,
    gt_boxes,
    gt_mask,
    anchor_matcher=None,
    batch_size_per_image=256,
    positive_fraction=0.5,
    box_weights=(1.0, 1.0, 1.0, 1.0),
    smooth_l1_beta=0.0,
):
    """The RPN's objectness and box losses of one image (detectron2
    ``rpn.py::losses``): anchors (A, 4), objectness_logits (A,),
    pred_deltas (A, 4), gt_boxes (G, 4) padded, gt_mask (G,); ``draws`` as
    :func:`subsample_labels` takes it. Returns {"loss_rpn_cls",
    "loss_rpn_loc"}, scalars, each over ``batch_size_per_image``."""
    if anchor_matcher is None:
        anchor_matcher = Matcher([0.3, 0.7], [0, -1, 1], allow_low_quality_matches=True)
    matches, labels = anchor_matcher(iou_matrix(gt_boxes, anchors), gt_mask)
    pos_mask, neg_mask = subsample_labels(draws, labels, batch_size_per_image,
                                          positive_fraction)
    sampled = pos_mask | neg_mask
    # objectness: binary cross-entropy with logits over the sampled anchors
    x = objectness_logits
    target = pos_mask.to(x.dtype)
    bce = _relu(x) - x * target + torch.log1p(torch.exp(-torch.abs(x)))
    objectness_loss = torch.where(sampled, bce, _zero(bce)).sum() / batch_size_per_image
    # box regression: deltas against the matched gt, positive anchors only
    target_deltas = get_deltas(anchors, gt_boxes[matches.long()], box_weights)
    reg = smooth_l1(pred_deltas, target_deltas, smooth_l1_beta).sum(dim=-1)
    box_loss = torch.where(pos_mask, reg, _zero(reg)).sum() / batch_size_per_image
    return {"loss_rpn_cls": objectness_loss, "loss_rpn_loc": box_loss}


def sample_proposals(
    draws,
    proposals,
    proposal_mask,
    gt_boxes,
    gt_classes,
    gt_mask,
    num_classes,
    proposal_matcher=None,
    batch_size_per_image=128,
    positive_fraction=0.25,
    append_gt=True,
):
    """The ROI heads' proposal sampling of one image (detectron2
    ``ROIHeads.label_and_sample_proposals``): the gt appended to the
    proposals, matched and subsampled. Returns (boxes, classes (background
    = ``num_classes``), sampled mask, matched gt boxes), all of fixed
    shape."""
    if proposal_matcher is None:
        proposal_matcher = Matcher([0.5], [0, 1])
    if append_gt:
        proposals = torch.cat([proposals, gt_boxes])
        proposal_mask = torch.cat([proposal_mask, gt_mask])
    quality = iou_matrix(gt_boxes, proposals)
    quality = torch.where(proposal_mask[None, :], quality, torch.full_like(quality, -1.0))
    matches, labels = proposal_matcher(quality, gt_mask)
    labels = torch.where(proposal_mask, labels, torch.full_like(labels, -1))
    pos_mask, neg_mask = subsample_labels(draws, labels, batch_size_per_image,
                                          positive_fraction)
    matches = matches.long()
    classes = torch.where(pos_mask, gt_classes[matches].int(),
                          torch.tensor(num_classes, dtype=torch.int32, device=labels.device))
    return proposals, classes, pos_mask | neg_mask, gt_boxes[matches]


def fast_rcnn_losses(
    scores,
    pred_boxes,
    classes,
    sampled_mask,
    matched_gt_boxes,
    num_classes,
    box_loss_weight=2.0,
):
    """The Fast R-CNN classification and GIoU box losses of one image
    (configs/detectron/vitdet_b_vid.py:60-62: ``box_reg_loss_type="giou"``,
    ``loss_box_reg`` weight 2.0; detectron2 ``fast_rcnn.py::losses``):
    scores (P, C + 1); pred_boxes (P, 4), the decoded boxes of the matched
    class; classes (P,), background = ``num_classes``; sampled_mask (P,).
    Returns {"loss_cls", "loss_box_reg"}."""
    log_probs = F.log_softmax(scores, dim=-1)
    picked = log_probs.gather(-1, classes.long()[:, None])[:, 0]
    n_sampled = sampled_mask.sum().clamp(min=1)
    cls_loss = -torch.where(sampled_mask, picked, _zero(picked)).sum() / n_sampled
    fg = sampled_mask & (classes < num_classes)
    reg = giou_loss(pred_boxes, matched_gt_boxes)
    box_loss = box_loss_weight * torch.where(fg, reg, _zero(reg)).sum() / n_sampled
    return {"loss_cls": cls_loss, "loss_box_reg": box_loss}
