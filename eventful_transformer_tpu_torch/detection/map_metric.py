"""COCO-style mean-average-precision, host-side numpy (port of
``eventful_transformer_tpu/detection/map_metric.py``).

Replaces torchmetrics' MeanAveragePrecision (used by the reference at
scripts/evaluate/vitdet_vid.py:33-38) with the standard COCO protocol:
IoU thresholds 0.50:0.95:0.05, 101-point interpolated precision, AP averaged
over classes present in the ground truth. Accumulates across update() calls
and computes once (matching the reference's single batched update)."""

from __future__ import annotations

import numpy as np

IOU_THRESHOLDS = np.round(np.arange(0.5, 1.0, 0.05), 2)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)


def _iou(boxes_a, boxes_b):
    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return np.zeros((len(boxes_a), len(boxes_b)), np.float32)
    lt = np.maximum(boxes_a[:, None, :2], boxes_b[None, :, :2])
    rb = np.minimum(boxes_a[:, None, 2:], boxes_b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.prod(np.clip(boxes_a[:, 2:] - boxes_a[:, :2], 0, None), -1)
    area_b = np.prod(np.clip(boxes_b[:, 2:] - boxes_b[:, :2], 0, None), -1)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


class MeanAveragePrecision:
    """``use_native=True`` (default) runs the greedy matching loop in the
    C++ matcher (``native/map_matcher.cpp``, built by ``g++`` into
    ``_build/`` at first use) when a compiler is available,
    falling back to the numpy implementation (identical results)."""

    def __init__(self, use_native=True):
        self.predictions = []  # per image: dict(boxes, scores, labels)
        self.targets = []
        self.use_native = use_native

    def reset(self):
        self.predictions, self.targets = [], []

    def update(self, predictions, targets):
        """predictions/targets: lists of per-image dicts with numpy
        ``boxes`` (N, 4), ``scores`` (preds only), ``labels``."""
        for p in predictions:
            self.predictions.append(
                {k: np.asarray(v) for k, v in p.items() if k != "mask"}
            )
        for t in targets:
            self.targets.append({k: np.asarray(v) for k, v in t.items()})

    def compute(self):
        classes = sorted(
            {int(c) for t in self.targets for c in np.atleast_1d(t["labels"])}
        )
        ap = np.full((len(IOU_THRESHOLDS), len(classes)), np.nan)
        for ci, cls in enumerate(classes):
            ap[:, ci] = self._class_ap(cls)
        valid = ~np.isnan(ap)
        result = {
            "map": float(np.mean(ap[valid])) if valid.any() else 0.0,
            "map_50": float(np.nanmean(ap[0])) if valid[0].any() else 0.0,
            "map_75": float(np.nanmean(ap[5])) if valid[5].any() else 0.0,
            "classes": len(classes),
        }
        return result

    def _class_ap(self, cls):
        # Gather detections and ground truths for this class.
        n_gt = 0
        records = []  # (score, iou_row to gts of this image)
        for img_idx, (pred, target) in enumerate(zip(self.predictions, self.targets)):
            gt_mask = np.atleast_1d(target["labels"]) == cls
            gt_boxes = target["boxes"].reshape(-1, 4)[gt_mask]
            n_gt += len(gt_boxes)
            pr_mask = np.atleast_1d(pred["labels"]) == cls
            pr_boxes = pred["boxes"].reshape(-1, 4)[pr_mask]
            pr_scores = np.atleast_1d(pred["scores"])[pr_mask]
            finite = np.isfinite(pr_scores) & (pr_scores > 0)
            pr_boxes, pr_scores = pr_boxes[finite], pr_scores[finite]
            iou = _iou(pr_boxes, gt_boxes)
            for di in range(len(pr_scores)):
                records.append((float(pr_scores[di]), img_idx, iou[di]))
        if n_gt == 0:
            return np.full(len(IOU_THRESHOLDS), np.nan)
        if not records:
            return np.zeros(len(IOU_THRESHOLDS))
        records.sort(key=lambda r: -r[0])

        if self.use_native:
            native_aps = self._class_ap_native(records, n_gt)
            if native_aps is not None:
                return native_aps

        aps = np.zeros(len(IOU_THRESHOLDS))
        for ti, thresh in enumerate(IOU_THRESHOLDS):
            gt_used = {}
            tp = np.zeros(len(records))
            for di, (_, img_idx, iou_row) in enumerate(records):
                used = gt_used.setdefault(img_idx, np.zeros(len(iou_row), bool))
                candidates = np.where(~used & (iou_row >= thresh))[0]
                if len(candidates):
                    best = candidates[np.argmax(iou_row[candidates])]
                    used[best] = True
                    tp[di] = 1.0
            cum_tp = np.cumsum(tp)
            recall = cum_tp / n_gt
            precision = cum_tp / (np.arange(len(records)) + 1)
            # Monotone non-increasing precision envelope.
            for i in range(len(precision) - 2, -1, -1):
                precision[i] = max(precision[i], precision[i + 1])
            # 101-point interpolation.
            idx = np.searchsorted(recall, RECALL_POINTS, side="left")
            prec_at = np.where(idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0)
            aps[ti] = prec_at.mean()
        return aps

    def _class_ap_native(self, records, n_gt):
        """Run the greedy matcher in C++ (native/map_matcher.cpp).
        records: [(score, img_idx, iou_row)] sorted by score desc."""
        import ctypes

        from eventful_transformer_tpu_torch.native import load

        lib = load("map_matcher")
        if lib is None:
            return None
        # Per-image GT offsets for THIS class (row lengths are per-image).
        img_gt_len = {}
        for _, img, row in records:
            img_gt_len[img] = len(row)
        images = sorted(img_gt_len)
        img_pos = {img: i for i, img in enumerate(images)}
        gt_offsets = np.zeros(len(images) + 1, np.int64)
        for i, img in enumerate(images):
            gt_offsets[i + 1] = gt_offsets[i] + img_gt_len[img]
        det_image = np.asarray([img_pos[img] for _, img, _ in records], np.int32)
        iou_flat = (
            np.concatenate([row for _, _, row in records])
            if records
            else np.zeros(0)
        ).astype(np.float32)
        iou_offsets = np.zeros(len(records) + 1, np.int64)
        for i, (_, _, row) in enumerate(records):
            iou_offsets[i + 1] = iou_offsets[i] + len(row)
        ap_out = np.zeros(len(IOU_THRESHOLDS), np.float64)
        # float64 grids: recall ties must bin exactly like the numpy path.
        thresholds = IOU_THRESHOLDS.astype(np.float64)
        points = RECALL_POINTS.astype(np.float64)

        def ptr(a, t):
            return a.ctypes.data_as(ctypes.POINTER(t))

        lib.class_ap(
            ptr(det_image, ctypes.c_int32),
            ptr(iou_flat, ctypes.c_float),
            ptr(iou_offsets, ctypes.c_int64),
            ptr(gt_offsets, ctypes.c_int64),
            ctypes.c_int64(len(records)),
            ctypes.c_int64(int(gt_offsets[-1])),
            ctypes.c_int64(int(n_gt)),
            ptr(thresholds, ctypes.c_double),
            ctypes.c_int64(len(IOU_THRESHOLDS)),
            ptr(points, ctypes.c_double),
            ctypes.c_int64(len(RECALL_POINTS)),
            ptr(ap_out, ctypes.c_double),
        )
        return np.where(ap_out < 0, np.nan, ap_out)
