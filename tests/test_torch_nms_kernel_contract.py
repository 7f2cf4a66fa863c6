"""The contract of the NMS kernel pair (``csrc/nms.cu``, ``ops/nms.py``) on
the CPU, where the kernel cannot run: its suppression words, its IoU
arithmetic emulated in numpy float32 op for op, and its walk over the words
(``tests/torch_nms_contract.py::greedy_walk``, the kernel's loop in
Python), held index for
index, the masked slots included, against the port's plain ``nms_padded``
(the fixpoint form at N = 900, the blocked form at N = 4096) and the JAX
package's ``nms_padded`` at ``max_out`` 64, 100, 300 and 1000 (the training
pair's), on clustered boxes with tied scores, planted ties, IoUs planted at
the float32 threshold and one ulp either side, suppression chains 12 deep,
every score -inf and fewer valid boxes than ``max_out``.

Every comparison is exact (indices, mask, count and bits). The kernel
itself is held against the plain version on the card
(``tests/test_torch_cuda.py -k nms``, ``chip_smoke.py`` phase
``nms_kernel``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.detection import nms as jax_nms
from eventful_transformer_tpu_torch.detection import nms
from eventful_transformer_tpu_torch.detection.boxes import iou_matrix
from eventful_transformer_tpu_torch.ops import kernel_check
from eventful_transformer_tpu_torch.ops import nms as nms_kernel
from torch_nms_contract import suppression_bits, suppression_words, walk

CASES = ["random", "ties", "threshold", "chains", "all_invalid", "few_valid"]
# the heads' thresholds: the ROI heads' 0.5 at their 100 and the mask of 64,
# the RPN's 0.7 at its 300 (test) and 1000 (training)
THRESHOLDS = {64: 0.5, 100: 0.5, 300: 0.7, 1000: 0.7}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("max_out", sorted(THRESHOLDS))
@pytest.mark.parametrize("n", [900, 4096], ids=["n900_fixpoint", "n4096_blocked"])
def test_walk_matches_plain_and_jax(n, max_out, case):
    """The walk over the suppression words against the plain version and
    the JAX function: indices and mask equal, the count the mask's."""
    threshold = THRESHOLDS[max_out]
    boxes, scores = kernel_check.nms_inputs(n, max_out, threshold, seed=n + max_out, case=case)
    indices, mask, count = walk(boxes, scores, threshold, max_out)
    plain_idx, plain_mask = nms.nms_padded(boxes, scores, threshold, max_out)
    jax_idx, jax_mask = jax_nms.nms_padded(jnp.asarray(boxes.numpy()),
                                           jnp.asarray(scores.numpy()), threshold, max_out)
    assert indices.shape == (nms_kernel.out_len(n, max_out, nms.BLOCK),)
    np.testing.assert_array_equal(indices.numpy(), plain_idx.numpy())
    np.testing.assert_array_equal(mask.numpy(), plain_mask.numpy())
    np.testing.assert_array_equal(indices.numpy(), np.asarray(jax_idx))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jax_mask))
    assert count == int(mask.sum())
    if case == "all_invalid":
        assert count == 0
    elif case == "few_valid":
        assert 0 < count < max_out


def test_threshold_case_plants_the_ulps():
    """The "threshold" case's pairs give IoUs of exactly the float32
    threshold, and the float32 values one ulp above and below it; only the
    one above suppresses."""
    for t in (0.5, 0.7):
        boxes, _ = kernel_check.nms_inputs(6, 6, t, case="threshold")
        ious = [iou_matrix(boxes[i + 1:i + 2], boxes[i:i + 1]).item() for i in (0, 2, 4)]
        t32 = np.float32(t)
        assert ious == [float(t32), float(np.nextafter(t32, np.float32(1))),
                        float(np.nextafter(t32, np.float32(0)))]
        bits = suppression_bits(boxes, t)
        assert [bool(bits[i, i + 1]) for i in (0, 2, 4)] == [False, True, False]


def test_chains_are_deeper_than_four():
    """Each chain keeps every other box: a suppression chain 12 deep, past
    the plain version's 4 Jacobi steps between host checks."""
    boxes, scores = kernel_check.nms_inputs(24, 24, 0.7, case="chains")
    indices, mask, count = walk(boxes, scores, 0.7, 24)
    assert count == 12
    assert indices[:count].tolist() == list(range(0, 24, 2))


def _emulated_bits(b, threshold):
    """csrc/nms.cu's mask pass in numpy float32, op for op: the areas, the
    clamped overlap, inter, union = (area_i + area_j) - inter, inter / union
    where union > 0, compared with the float32 threshold; bit [i, j] for
    j after i."""
    b = b.numpy().astype(np.float32)
    zero = np.float32(0)

    def clamp0(x):
        return np.where(x < zero, zero, x)

    area = clamp0(b[:, 2] - b[:, 0]) * clamp0(b[:, 3] - b[:, 1])
    w = clamp0(np.minimum(b[None, :, 2], b[:, None, 2]) - np.maximum(b[None, :, 0], b[:, None, 0]))
    h = clamp0(np.minimum(b[None, :, 3], b[:, None, 3]) - np.maximum(b[None, :, 1], b[:, None, 1]))
    inter = w * h
    union = (area[None, :] + area[:, None]) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > zero, inter / union, zero).astype(np.float32)
    n = b.shape[0]
    return (iou > np.float32(threshold)) & np.triu(np.ones((n, n), bool), 1)


@pytest.mark.parametrize("case", ["random", "threshold", "chains"])
@pytest.mark.parametrize("threshold", [0.5, 0.7])
def test_kernel_iou_arithmetic_gives_the_plain_bits(case, threshold):
    """The kernel's IoU arithmetic (numpy float32, each step rounded) gives
    the suppression bits of ``iou_matrix`` exactly, the planted
    threshold IoUs included; the words pack them bit for bit."""
    boxes, scores = kernel_check.nms_inputs(700, 100, threshold, seed=3, case=case)
    b, _, _ = nms_kernel.sorted_boxes(boxes, scores)
    bits = suppression_bits(b, threshold)
    np.testing.assert_array_equal(_emulated_bits(b, threshold), bits.numpy())
    words = suppression_words(bits).numpy().view(np.uint64)
    unpacked = (words[:, :, None] >> np.arange(64, dtype=np.uint64)) & np.uint64(1)
    np.testing.assert_array_equal(unpacked.reshape(700, -1)[:, :700].astype(bool), bits.numpy())


def test_cpu_wrapper_is_the_plain_version():
    """On CPU tensors ``nms_padded`` is the plain version (its host reads
    counted) and launches nothing; the kernel's own wrapper refuses them.
    The entry is registered with its plain version, its bound (the larger
    of the bytes of boxes, scores, indices and mask over 3.35 TB/s and 15
    float32 steps for each IoU the greedy walk needs over 67 TFLOP/s) and
    no library call."""
    boxes, scores = kernel_check.nms_inputs(300, 100, 0.7, seed=1)
    launches, syncs = nms_kernel.nms_padded.launches, nms.host_syncs
    got = nms.nms_padded(boxes, scores, 0.7, 100)
    want = nms.nms_padded_plain(boxes, scores, 0.7, 100)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert nms_kernel.nms_padded.launches == launches
    assert nms.host_syncs > syncs
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        nms_kernel.nms_padded(boxes, scores, 0.7, 100, nms.BLOCK)
    wrapper, plain, source, replaces, outputs = kernel_check.KERNELS["nms_padded"]
    assert (wrapper, plain, outputs) == (nms_kernel.nms_padded, nms.nms_padded_plain,
                                         ("indices", "mask"))
    assert source.endswith("csrc/nms.cu") and "no Pallas kernel" in replaces
    d = dict(nms_boxes=boxes, nms_scores=scores.bfloat16(), nms_threshold=0.7,
             nms_max_out=100)
    ms, by = kernel_check.bound("nms_padded", d)
    io = 300 * 16 + 300 * 2 + 100 * 4 + 100
    assert kernel_check.nms_bytes(d) == io
    assert (ms, by) == (io / kernel_check.PEAK_BYTES * 1e3, "bytes")
    assert kernel_check.library_call("nms_padded", d) is None
    plain_rows = [kernel_check.compare_exact(a, b) for a, b in zip(
        kernel_check.call("nms_padded", d, plain=True),
        nms.nms_padded(boxes, d["nms_scores"], 0.7, 100))]
    assert all(row["ok"] for row in plain_rows)


def _ious_by_walk(boxes, scores, threshold, max_out):
    """The IoUs a greedy walk computes that stops testing a box at the
    first kept box that suppresses it, counted in Python."""
    b, valid, _ = nms_kernel.sorted_boxes(boxes, scores)
    iou = iou_matrix(b, b)
    kept, ious = [], 0
    for i in range(b.shape[0]):
        if len(kept) == max_out:
            break
        if not valid[i]:
            continue
        for j in kept:
            ious += 1
            if iou[i, j] > threshold:
                break
        else:
            kept.append(i)
    return ious, kept


@pytest.mark.parametrize("case", ["random", "chains", "few_valid", "all_invalid"])
@pytest.mark.parametrize("n,max_out", [(300, 100), (1100, 20)])
def test_nms_ious_are_the_least_a_walk_needs(n, max_out, case):
    """``kernel_check.nms_ious`` counts, from the plain result, every kept
    box against each kept before it and one IoU for each suppressed box,
    up to the walk's stop; a walk that tests the kept boxes in order needs
    at least that many, and exactly that many where each suppressed box's
    first kept neighbour suppresses it."""
    boxes, scores = kernel_check.nms_inputs(n, max_out, 0.7, seed=n, case=case)
    d = dict(nms_boxes=boxes, nms_scores=scores, nms_threshold=0.7, nms_max_out=max_out)
    counted = kernel_check.nms_ious(d)
    walked, kept = _ious_by_walk(boxes, scores, 0.7, max_out)
    least = len(kept) * (len(kept) - 1) // 2
    assert least <= counted <= walked
    if case == "all_invalid":
        assert counted == walked == 0
