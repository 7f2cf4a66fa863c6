"""The contract of the NMS kernel pair (``csrc/nms.cu``) in Python, for the
tests: its suppression bits and words, and its walk over the words.
``tests/test_torch_nms_kernel_contract.py`` holds the walk against the
plain and the JAX ``nms_padded`` on the CPU, ``tests/test_torch_cuda.py
-k nms`` against the kernel on the card."""

import torch

from eventful_transformer_tpu_torch.detection.boxes import iou_matrix
from eventful_transformer_tpu_torch.detection.nms import BLOCK
from eventful_transformer_tpu_torch.ops.nms import CHUNK, out_len, sorted_boxes


def suppression_bits(b, iou_threshold):
    """(n, n) bool: [i, j] where j comes after i and iou(i, j) > the
    threshold, for the boxes ``b`` in score order."""
    n = b.shape[0]
    later = torch.ones((n, n), dtype=torch.bool, device=b.device).triu(1)
    return (iou_matrix(b, b) > iou_threshold) & later


def suppression_words(bits):
    """The kernel's (n, ceil(n / 64)) words of :func:`suppression_bits`, as
    int64 (bit 63 the sign bit)."""
    n = bits.shape[0]
    words = -(-n // CHUNK)
    padded = torch.zeros((n, words * CHUNK), dtype=torch.int64, device=bits.device)
    padded[:, :n] = bits.long()
    weights = torch.ones(CHUNK, dtype=torch.int64, device=bits.device) << torch.arange(
        CHUNK, device=bits.device)
    return (padded.reshape(n, words, CHUNK) * weights).sum(-1)


def greedy_walk(words, valid, order, max_out):
    """The walk of ``csrc/nms.cu`` over :func:`suppression_words`, in
    Python: (indices (out_len,) int32, mask (max_out,) bool, count)."""
    n = valid.shape[0]
    words, valid, order = words.tolist(), valid.tolist(), order.tolist()
    removed = [0] * len(words[0]) if n else []
    kept = []
    for i in range(n):
        if len(kept) == max_out:
            break
        if valid[i] and not (removed[i // CHUNK] >> (i % CHUNK)) & 1:
            kept.append(i)
            removed = [r | w for r, w in zip(removed, words[i])]
    length = out_len(n, max_out, BLOCK)
    if n <= BLOCK:
        taken = set(kept)
        pos = kept + [i for i in range(n) if i not in taken]
    else:
        pos = kept + [0] * (length - len(kept))
    indices = torch.tensor([order[p] for p in pos[:length]], dtype=torch.int32)
    mask = torch.arange(max_out) < len(kept)
    return indices, mask, len(kept)


def walk(boxes, scores, iou_threshold, max_out):
    """:func:`greedy_walk` over the words of ``boxes`` and ``scores`` (CPU
    tensors)."""
    b, valid, order = sorted_boxes(boxes, scores)
    words = suppression_words(suppression_bits(b, iou_threshold))
    return greedy_walk(words, valid, order, max_out)
