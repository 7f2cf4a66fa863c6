"""Greedy NMS on the card with no host read (``csrc/nms.cu``).

``nms_padded`` computes ``detection/nms.py::nms_padded_plain`` exactly,
index for index and the masked slots included, on CUDA tensors;
``detection/nms.py::nms_padded`` routes CUDA tensors here and CPU tensors to
the plain version. It replaces no TPU kernel: the JAX package computes NMS
in XLA (two ``lax.while_loop``s, ``eventful_transformer_tpu/detection/nms.py:44-55``
and ``:58-145``). It is the port's own kernel because a captured frame
cannot hold a loop whose exit the host decides.

The kernel's contract (``tests/torch_nms_contract.py`` models it step by
step on the CPU):

* the boxes and scores as the caller has them, float32, bfloat16 or
  float16; a box is valid where its score is > -inf;
* the order of ``torch.sort(-scores, stable=True)``: the identity where the
  scores are in that order already (every model path: ``batched_nms`` cut
  them with a stable descending sort), else a bitonic sort of (key, index)
  in shared memory, or in a scratch of ``scratch_bytes`` past
  ``SMEM_BUDGET``;
* the walk a chunk of ``CHUNK`` candidates at a time against the kept set
  in shared memory, the IoU computed as ``detection/boxes.py::iou_matrix``
  does, until ``max_out`` are kept; ``mask[s] = s < count``;
* the slots past the count: for n <= ``block`` (the plain version's
  fixpoint form) the boxes it did not keep, in score order, and the
  indices are ``min(n, max_out)`` long; for larger n (its blocked form)
  ``order[0]``, and ``max_out`` long.

One launch a call, counted in ``nms_padded.launches``.
"""

from __future__ import annotations

import torch

from eventful_transformer_tpu_torch.ops import _build

CHUNK = 32  # candidates the walk decides together: a warp's lanes
FILL_MAX = 1024  # the small form (the unkept boxes after the kept ones) up to here
SMEM_BUDGET = 200 * 1024  # dynamic shared memory of the kept set and the sort keys
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def out_len(n, max_out, block):
    """The length of the indices ``nms_padded`` returns."""
    return min(n, max_out) if n <= block else max_out


def _keys(n):
    return 1 << max(n - 1, 0).bit_length()  # the sort's keys: n rounded up to a power of two


def scratch_bytes(n, max_out):
    """Device memory the sort's keys take outside shared memory: 0 where
    the kept set (20 bytes a box) and the keys (8 bytes each) fit
    ``SMEM_BUDGET``."""
    return 0 if 20 * max_out + 8 * _keys(n) <= SMEM_BUDGET else 8 * _keys(n)


def smem_bytes(n, max_out):
    """The kernel's dynamic shared memory: the kept set and, where they
    fit, the sort's keys."""
    return 20 * max_out + (0 if scratch_bytes(n, max_out) else 8 * _keys(n))


def nms_padded(boxes, scores, iou_threshold, max_out, block):
    """The plain ``nms_padded_plain(boxes, scores, iou_threshold, max_out,
    block)`` (boxes (N, 4), scores (N,), scores of invalid boxes -inf ->
    indices, mask) on CUDA tensors: one launch of ``csrc/nms.cu``, nothing
    read back. Raises on any other device. The outputs are indices and a
    mask, which carry no gradient, so boxes and scores that require grad are
    taken detached."""
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
    if boxes.dtype not in DTYPES or scores.dtype not in DTYPES:
        raise TypeError(f"{name}: boxes {boxes.dtype} and scores {scores.dtype}, expected "
                        "float32, bfloat16 or float16")
    if 20 * max_out > SMEM_BUDGET:
        raise ValueError(f"{name}: max_out {max_out} > {SMEM_BUDGET // 20}: the kept set "
                         "lives in shared memory")
    if n <= block and n > FILL_MAX:
        raise ValueError(f"{name}: the small form takes n <= {FILL_MAX}, got {n} at block {block}")
    length = out_len(n, max_out, block)
    indices = torch.empty(length, dtype=torch.int32, device=boxes.device)
    mask = torch.empty(max_out, dtype=torch.bool, device=boxes.device)
    if n == 0 or max_out == 0:
        mask.zero_()
        return indices, mask
    boxes, scores = boxes.contiguous(), scores.contiguous()
    scratch = scratch_bytes(n, max_out)
    keys = torch.empty(scratch, dtype=torch.uint8, device=boxes.device) if scratch else None
    _build.launch(
        "etk_nms", boxes.data_ptr(), DTYPES[boxes.dtype], scores.data_ptr(), DTYPES[scores.dtype],
        n, float(iou_threshold), max_out, length, int(n <= block),
        0 if keys is None else keys.data_ptr(), indices.data_ptr(), mask.data_ptr(),
        _build.stream_of(boxes),
    )
    nms_padded.launches += 1
    return indices, mask


nms_padded.launches = 0
