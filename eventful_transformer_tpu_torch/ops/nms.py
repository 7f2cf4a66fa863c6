"""Greedy NMS on the card with no host read (``csrc/nms.cu``).

``nms_padded`` computes ``detection/nms.py::nms_padded_plain`` exactly,
index for index and the masked slots included, on CUDA tensors;
``detection/nms.py::nms_padded`` routes CUDA tensors here and CPU tensors to
the plain version. It replaces no TPU kernel: the JAX package computes NMS
in XLA (two ``lax.while_loop``s, ``eventful_transformer_tpu/detection/nms.py:44-55``
and ``:58-145``). It is the port's own kernel because a captured frame
cannot hold a loop whose exit the host decides.

The kernel's contract:

* the boxes in score order (the stable sort of ``-scores``, as the plain
  version takes it), as float32; a box is valid where its score is
  > -inf;
* the suppression words: bit k of word [i, c] is set where box
  j = 64 c + k comes after box i and iou(i, j) > the threshold, the IoU
  computed as ``detection/boxes.py::iou_matrix`` does;
* the walk keeps each valid box that no kept box before it suppresses, in
  order, until ``max_out`` are kept; ``mask[s] = s < count``;
* the slots past the count: for n <= ``block`` (the plain version's
  fixpoint form) the boxes it did not keep, in score order, and the
  indices are ``min(n, max_out)`` long; for larger n (its blocked form)
  ``order[0]``, and ``max_out`` long.

The wrapper counts its launches (one a call, the sort and the two kernels)
in ``nms_padded.launches``.
"""

from __future__ import annotations

import torch

from eventful_transformer_tpu_torch.ops import _build

CHUNK = 64  # boxes a suppression word covers


def sorted_boxes(boxes, scores):
    """(the boxes in score order as float32, their validity, the order),
    as the plain version takes them."""
    order = torch.sort(-scores, stable=True).indices
    return boxes[order].float().contiguous(), scores[order] > -float("inf"), order


def out_len(n, max_out, block):
    """The length of the indices ``nms_padded`` returns."""
    return min(n, max_out) if n <= block else max_out


def nms_padded(boxes, scores, iou_threshold, max_out, block):
    """The plain ``nms_padded_plain(boxes, scores, iou_threshold, max_out,
    block)`` (boxes (N, 4), scores (N,), scores of invalid boxes -inf ->
    indices, mask) on CUDA tensors: the sort, then the mask and walk
    kernels of ``csrc/nms.cu``, nothing read back. Raises on any other
    device. The outputs are indices and a mask, which carry no gradient, so
    boxes and scores that require grad are taken detached."""
    name = "nms_padded"
    if not boxes.is_cuda:
        raise ValueError(f"{name}: expected CUDA tensors, got {boxes.device} "
                         "(detection/nms.py::nms_padded takes CPU tensors to the plain version)")
    boxes, scores = boxes.detach(), scores.detach()
    n = boxes.shape[0]
    if boxes.shape != (n, 4) or scores.shape != (n,):
        raise ValueError(f"{name}: boxes {tuple(boxes.shape)} and scores {tuple(scores.shape)}, "
                         "expected (N, 4) and (N,)")
    if scores.device != boxes.device:
        raise ValueError(f"{name}: scores on {scores.device}, expected {boxes.device}")
    length = out_len(n, max_out, block)
    indices = torch.empty(length, dtype=torch.int32, device=boxes.device)
    mask = torch.empty(max_out, dtype=torch.bool, device=boxes.device)
    if n == 0 or max_out == 0:
        mask.zero_()
        return indices, mask
    b, valid, order = sorted_boxes(boxes, scores)
    words = torch.empty((n, -(-n // CHUNK)), dtype=torch.int64, device=boxes.device)
    _build.launch(
        "etk_nms", b.data_ptr(), valid.data_ptr(), order.data_ptr(), words.data_ptr(), n,
        float(iou_threshold), max_out, length, int(n <= block), indices.data_ptr(),
        mask.data_ptr(), _build.stream_of(b),
    )
    nms_padded.launches += 1
    return indices, mask


nms_padded.launches = 0
