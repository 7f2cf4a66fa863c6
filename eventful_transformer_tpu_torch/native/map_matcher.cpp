// Native COCO-mAP greedy matcher.
//
// The reference notes torchmetrics' MeanAveragePrecision is "extremely slow"
// (scripts/evaluate/vitdet_vid.py:33-35). The per-class, per-IoU-threshold
// greedy matching loop is the sequential hot spot of mAP and is a poor fit
// for numpy; this is the framework's host-side native runtime component,
// bound via ctypes (no pybind dependency). Semantics identical to
// detection/map_metric.py's pure-numpy fallback (tested for equality).
//
// Build: g++ -O3 -shared -fPIC -o libmap_matcher.so map_matcher.cpp

#include <cstddef>
#include <cstdint>
#include <vector>

extern "C" {

// Compute average precision for ONE class at every IoU threshold.
//
//   det_image    [n_det]    image index per detection, sorted by score desc
//   iou_flat     [sum_i gt_count(image(det_i))]  IoU rows, concatenated in
//                           detection order (row i covers the GTs of
//                           det_image[i]'s image)
//   iou_offsets  [n_det+1]  start offset of each detection's IoU row
//   gt_offsets   [n_images+1]  per-image GT offsets into a global GT index
//   n_gt_total   total ground-truth boxes of this class
//   thresholds   [n_thresh]
//   recall_points[n_points]  (the COCO 101-point grid)
//   ap_out       [n_thresh]
// n_gt_used:  GT slots of images that HAVE detections (used-flag storage)
// n_gt_total: ALL GT of this class (recall denominator — includes images
//             with no detections at all)
// thresholds / recall_points are float64 so that recall values exactly on a
// grid point (tp/n_gt rational ties) bin identically to the numpy fallback.
void class_ap(const int32_t* det_image, const float* iou_flat,
              const int64_t* iou_offsets, const int64_t* gt_offsets,
              int64_t n_det, int64_t n_gt_used, int64_t n_gt_total,
              const double* thresholds, int64_t n_thresh,
              const double* recall_points, int64_t n_points,
              double* ap_out) {
  if (n_gt_total == 0) {
    for (int64_t t = 0; t < n_thresh; ++t) ap_out[t] = -1.0;  // undefined
    return;
  }
  std::vector<uint8_t> used(static_cast<size_t>(n_gt_used));
  std::vector<double> precision(static_cast<size_t>(n_det));
  std::vector<double> recall(static_cast<size_t>(n_det));

  for (int64_t t = 0; t < n_thresh; ++t) {
    const double thresh = thresholds[t];
    std::fill(used.begin(), used.end(), 0);
    int64_t tp = 0;
    for (int64_t d = 0; d < n_det; ++d) {
      const int64_t row_start = iou_offsets[d];
      const int64_t row_len = iou_offsets[d + 1] - row_start;
      const int64_t gt_base = gt_offsets[det_image[d]];
      // Greedy: best still-unused GT with IoU >= threshold.
      double best_iou = -1.0;
      int64_t best_gt = -1;
      for (int64_t g = 0; g < row_len; ++g) {
        if (used[gt_base + g]) continue;
        const double iou = iou_flat[row_start + g];
        if (iou >= thresh && iou > best_iou) {
          best_iou = iou;
          best_gt = gt_base + g;
        }
      }
      if (best_gt >= 0) {
        used[best_gt] = 1;
        ++tp;
      }
      recall[d] = static_cast<double>(tp) / n_gt_total;
      precision[d] = static_cast<double>(tp) / (d + 1);
    }
    // Monotone non-increasing precision envelope.
    for (int64_t d = n_det - 2; d >= 0; --d)
      if (precision[d] < precision[d + 1]) precision[d] = precision[d + 1];
    // 101-point interpolated AP.
    double ap = 0.0;
    int64_t d = 0;
    for (int64_t p = 0; p < n_points; ++p) {
      const double r = recall_points[p];
      while (d < n_det && recall[d] < r) ++d;
      if (d < n_det) ap += precision[d];
    }
    ap_out[t] = n_det > 0 ? ap / n_points : 0.0;
  }
}

}  // extern "C"
