"""Fixed-shape NMS (port of ``eventful_transformer_tpu/detection/nms.py``).

The output has a static capacity (``max_out``) and a validity mask, and
equals the JAX function's index for index, the masked slots included:

* small N (<= ``BLOCK``): the greedy keep-set as the fixpoint of
      keep(i) = valid(i) and not exists j < i: keep(j) and iou(i, j) > t
  over boxes in score order, by Jacobi iteration from keep = valid;
* large N: blocked kept-set greedy. Score-sorted blocks go in order
  against a kept set of at most ``max_out`` boxes, each block through the
  fixpoint above, and the loop stops once ``max_out`` boxes are kept (the
  JAX package's exact early exit: later keeps are unobservable).

:func:`nms_padded` routes by the tensors' device: CUDA tensors go to the
kernel of ``csrc/nms.cu`` (``ops/nms.py::nms_padded``), which orders and
walks the boxes on the card in one launch and reads nothing back, so a
captured frame holds it.
CPU tensors take the plain version, :func:`nms_padded_plain`, whose loops
are data-dependent: each convergence check reads one small tensor back to
the host (a device synchronisation): the fixpoint runs ``_FIXPOINT_STEPS``
Jacobi steps between checks (steps past the fixpoint change nothing), and
reads the kept count with its last check, which is all the blocked loop's
early exit needs. ``host_syncs`` counts them (0 on the card).

Ties: the score order is a stable sort, as ``jnp.argsort``, and
:func:`top_k` keeps the smaller index among equal values, as
``lax.top_k``; ``torch.topk`` promises neither.
"""

from __future__ import annotations

import torch

from eventful_transformer_tpu_torch.detection.boxes import iou_matrix
from eventful_transformer_tpu_torch.ops import nms as nms_kernel

BLOCK = 1024  # the fixpoint form up to here, the blocked form above
_FIXPOINT_STEPS = 4

host_syncs = 0


def top_k(x, k):
    """(values, indices) of the k largest of the 1-D ``x``, in descending
    order, the smaller index first among equal values (``lax.top_k``)."""
    values, indices = torch.sort(x, descending=True, stable=True)
    return values[:k], indices[:k]


def _fixpoint_keep(valid, suppressor):
    """Greedy keep-set as a Jacobi fixpoint. valid (N,) bool; suppressor
    (N, N) bool where [i, j] means j (earlier in score order) can suppress
    i. Returns (keep, the number kept) with one host read per
    ``_FIXPOINT_STEPS`` steps."""
    global host_syncs
    keep = valid
    while True:
        for _ in range(_FIXPOINT_STEPS):
            prev, keep = keep, valid & ~(suppressor & keep[None, :]).any(dim=1)
        changed, count = torch.stack([(keep != prev).any().long(), keep.sum()]).tolist()
        host_syncs += 1
        if not changed:
            return keep, count


def nms_padded(boxes, scores, iou_threshold, max_out):
    """Exact greedy NMS with static output capacity. boxes (N, 4), scores
    (N,); scores of invalid or padded boxes must be -inf. Returns
    (indices (max_out,) int32, mask (max_out,)): kept box indices in
    descending score order (for N <= 1024 and N < max_out the indices are
    N long, the boxes not kept after the kept ones). CPU tensors take
    :func:`nms_padded_plain`, CUDA tensors the kernel of ``csrc/nms.cu``;
    a failed build or launch raises."""
    if boxes.is_cpu:
        return nms_padded_plain(boxes, scores, iou_threshold, max_out)
    return nms_kernel.nms_padded(boxes, scores, iou_threshold, max_out, BLOCK)


def nms_padded_plain(boxes, scores, iou_threshold, max_out, block=BLOCK):
    """:func:`nms_padded` by the fixpoint (N <= ``block``) and blocked
    loops (blocks of ``block`` boxes), reading the host (``host_syncs``)."""
    n = boxes.shape[0]
    device = boxes.device
    order = torch.sort(-scores, stable=True).indices
    b = boxes[order].float()
    s = scores[order]
    valid = s > -float("inf")
    slots = torch.arange(max_out, device=device)

    if n <= block:
        iou = iou_matrix(b, b)
        earlier = torch.ones((n, n), dtype=torch.bool, device=device).tril(-1)
        keep, count = _fixpoint_keep(valid, (iou > iou_threshold) & earlier)
        kept_rank = keep.long().cumsum(0) - 1
        sort_key = torch.where(keep, kept_rank, n + torch.arange(n, device=device))
        pos = torch.sort(sort_key, stable=True).indices[:max_out]
        return order[pos].int(), slots < count

    earlier = torch.ones((block, block), dtype=torch.bool, device=device).tril(-1)
    kept_boxes = torch.zeros((max_out + 1, 4), dtype=torch.float32, device=device)
    kept_pos = torch.zeros(max_out + 1, dtype=torch.long, device=device)  # slot max_out: a sink
    kept_cnt = 0
    for start in range(0, n, block):
        if kept_cnt >= max_out:
            break
        blk, alive = b[start : start + block], valid[start : start + block]
        m = blk.shape[0]
        if kept_cnt:  # suppression by the kept set of earlier blocks
            iou_k = iou_matrix(blk, kept_boxes[:kept_cnt])
            alive = alive & ~(iou_k > iou_threshold).any(dim=1)
        iou_b = iou_matrix(blk, blk)
        keep, count = _fixpoint_keep(alive, (iou_b > iou_threshold) & earlier[:m, :m])
        pos_in_kept = kept_cnt + keep.long().cumsum(0) - 1
        dest = torch.where(keep & (pos_in_kept < max_out), pos_in_kept, max_out)
        kept_boxes.index_copy_(0, dest, blk)
        kept_pos.index_copy_(0, dest, start + torch.arange(m, device=device))
        kept_cnt += count
    return order[kept_pos[:max_out]].int(), slots < kept_cnt


def batched_nms(boxes, scores, group_ids, iou_threshold, max_out, max_candidates=4096):
    """Groupwise NMS by the coordinate-offset trick (detectron2
    layers/nms.py): each group's boxes shifted to a region of their own,
    then one plain NMS. Above ``max_candidates`` boxes, the top candidates
    by score only (exact while fewer are valid)."""
    finite = torch.isfinite(scores)[:, None]
    max_coord = torch.where(finite, boxes, torch.zeros((), dtype=boxes.dtype, device=boxes.device)).max() + 1.0
    shifted = boxes + (group_ids.to(boxes.dtype) * max_coord)[:, None]
    n = boxes.shape[0]
    if max_candidates is not None and n > max_candidates:
        top_scores, top_idx = top_k(scores, max_candidates)
        indices, mask = nms_padded(shifted[top_idx], top_scores, iou_threshold, max_out)
        return top_idx[indices.long()].int(), mask
    return nms_padded(shifted, scores, iou_threshold, max_out)
