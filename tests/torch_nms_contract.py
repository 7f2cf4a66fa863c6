"""The design of the NMS kernel (``csrc/nms.cu``) in Python, for the tests:
its sort key and its bitonic sort, its IoU test without a division and
the fallback to one, and its walk over a kept set a chunk of 32 candidates
at a time, each in numpy float32 op for op.
``tests/test_torch_nms_kernel_contract.py`` holds the model against
``torch.sort``, numpy's division, the plain and the JAX ``nms_padded`` on
the CPU; ``tests/test_torch_cuda.py -k nms`` holds the kernel against the
model on the card."""

import numpy as np
import torch

from eventful_transformer_tpu_torch.detection.nms import BLOCK
from eventful_transformer_tpu_torch.ops.nms import CHUNK, out_len

KEY_INF = 0xFF800000  # the key of -score = +inf: a score of -inf, an invalid box
LO, HI = np.float32(1 - 2.0**-20), np.float32(1 + 2.0**-20)  # the product's margins
P_MIN, P_MAX = np.float32(2.0**-100), np.float32(2.0**100)  # the product's range
F32 = np.finfo(np.float32)


def sort_keys(scores):
    """The kernel's 32-bit key of each score (a uint64 array): that of
    -score, -0.0 folded into +0.0, sign-flipped so that keys ascend as the
    floats do, every NaN the largest."""
    v = -scores.detach().float().cpu().numpy()
    v = np.where(v == 0, np.float32(0), v).astype(np.float32)
    b = v.view(np.uint32).astype(np.uint64)
    key = np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)
    return np.where(np.isnan(v), np.uint64(0xFFFFFFFF), key).astype(np.uint64)


def bitonic_order(keys):
    """The kernel's bitonic network over (key << 32 | index), padded to a
    power of two with all ones: the permutation it leaves."""
    n = keys.shape[0]
    np2 = 1 << max(n - 1, 0).bit_length()
    comp = np.full(np2, np.iinfo(np.uint64).max, dtype=np.uint64)
    comp[:n] = (keys << np.uint64(32)) | np.arange(n, dtype=np.uint64)
    p = np.arange(np2 // 2)
    k = 2
    while k <= np2:
        j = k // 2
        while j:
            i = 2 * p - (p & (j - 1))
            a, b = comp[i], comp[i + j]
            swap = (a > b) == ((i & k) == 0)
            comp[i], comp[i + j] = np.where(swap, b, a), np.where(swap, a, b)
            j //= 2
        k *= 2
    return (comp[:n] & np.uint64(0xFFFFFFFF)).astype(np.int64)


def kernel_order(scores):
    """(the order, whether the scores were in order already, the number of
    valid boxes) as the kernel finds them."""
    keys = sort_keys(scores)
    in_order = bool(np.all(keys[:-1] <= keys[1:]))
    order = np.arange(keys.shape[0]) if in_order else bitonic_order(keys)
    return order, in_order, int((keys < KEY_INF).sum())


def suppresses(inter, union, t):
    """(iou > t, whether the division decided): the kernel's test on
    float32 ``inter`` and ``union`` arrays, where the IoU is inter / union
    for union > 0 and else 0. Without a division where
    fl(union * t) lies in [2^-100, 2^100] and inter lies outside its
    margins (t a normal positive float32); else by the division."""
    inter, union, t = np.float32(inter), np.float32(union), np.float32(t)
    fast = bool(F32.tiny <= t <= F32.max)
    with np.errstate(all="ignore"):
        positive = union > 0
        p = union * t
        ranged = fast & positive & (p >= P_MIN) & (p <= P_MAX)
        below, above = ranged & (inter < p * LO), ranged & (inter > p * HI)
        divided = np.where(positive, inter / np.where(positive, union, 1), np.float32(0)) > t
    decision = np.where(below | above, above, divided)
    if fast:
        decision = np.where(inter == 0, False, decision)
    return decision, positive & ~(below | above) & ~(fast & (inter == 0))


def inter_union(a, b):
    """float32 (inter, union) of every box of ``a`` (m, 4) against every
    box of ``b`` (k, 4), as ``iou_matrix`` computes them, each step
    rounded."""
    a, b = np.float32(a), np.float32(b)
    zero = np.float32(0)

    def clamp0(x):
        return np.where(x < zero, zero, x)

    def area(x):
        return clamp0(x[:, 2] - x[:, 0]) * clamp0(x[:, 3] - x[:, 1])

    with np.errstate(all="ignore"):
        w = clamp0(np.minimum(a[:, None, 2], b[None, :, 2])
                   - np.maximum(a[:, None, 0], b[None, :, 0]))
        h = clamp0(np.minimum(a[:, None, 3], b[None, :, 3])
                   - np.maximum(a[:, None, 1], b[None, :, 1]))
        inter = w * h
        union = (area(a)[:, None] + area(b)[None, :]) - inter
    return inter.astype(np.float32), union.astype(np.float32)


def walk(boxes, scores, iou_threshold, max_out, block=BLOCK):
    """The kernel's walk in Python on CPU tensors: (indices (out_len,)
    int32, mask (max_out,) bool, count, stats), stats the order's
    ``in_order``, the ``chunks`` walked, the largest number of fixpoint
    ``steps`` a chunk took and the IoU tests the division decided
    (``divisions``)."""
    n = scores.shape[0]
    order, in_order, nvalid = kernel_order(scores)
    b = boxes.detach().float().numpy()[order]
    kept, kept_set = [], set()
    chunks = steps = divisions = 0
    for base in range(0, nvalid, CHUNK):
        cand = np.arange(base, min(base + CHUNK, nvalid))
        hit = np.zeros(cand.shape[0], bool)
        if kept:
            hit, divided = suppresses(*inter_union(b[cand], b[kept]), iou_threshold)
            # a lane stops at its first hit in its warp's share; count every test here
            divisions += int(divided.sum())
            hit = hit.any(1)
        rows, divided = suppresses(*inter_union(b[cand], b[cand]), iou_threshold)
        later = np.triu(np.ones((cand.shape[0],) * 2, bool), 1)
        rows &= later
        divisions += int((divided & later).sum())
        alive = ~hit
        keep = alive
        step = 0
        while True:
            step += 1
            nxt = alive & ~(rows & keep[:, None]).any(0)
            if (nxt == keep).all():
                break
            keep = nxt
        steps = max(steps, step)
        room = max_out - len(kept)
        taken = cand[keep][:room].tolist()
        kept += taken
        kept_set.update(taken)
        chunks += 1
        if len(kept) >= max_out:
            break
    length = out_len(n, max_out, block)
    if n <= block:
        pos = kept + [i for i in range(n) if i not in kept_set]
    else:
        pos = kept + [0] * (length - len(kept))
    indices = torch.tensor(order[np.asarray(pos[:length], dtype=np.int64)], dtype=torch.int32)
    mask = torch.arange(max_out) < len(kept)
    stats = dict(in_order=in_order, chunks=chunks, steps=steps, divisions=divisions)
    return indices, mask, len(kept), stats
