"""The contract of the NMS kernel (``csrc/nms.cu``, ``ops/nms.py``) on the
CPU, where the kernel cannot run, through the Python model of its design
(``tests/torch_nms_contract.py``):

* its sort key and its bitonic network, held against
  ``torch.sort(-scores, stable=True)`` in float32, bfloat16 and float16,
  with ties, +-0.0, -inf, +inf and NaN, in and out of order;
* its IoU test without a division and the fallback to one, held against
  numpy's float32 division on every pair of the contract boxes, on the
  planted threshold ulps (which must take the division) and on
  hypothesis-drawn (inter, union, threshold) triples, zeros, denormals,
  infinities, NaN and unions <= 0 among them;
* its walk a chunk of 32 candidates at a time over the kept set, held index
  for index, the masked slots included, against the port's plain
  ``nms_padded`` (the fixpoint form at N = 900, the blocked form at
  N = 4096) and the JAX package's ``nms_padded`` at ``max_out`` 64, 100,
  300 and 1000 (the training pair's), on clustered boxes with tied scores,
  planted ties, IoUs planted at the float32 threshold and one ulp either
  side, suppression chains 12 deep, every score -inf, fewer valid boxes
  than ``max_out``, scores already in order and scores of +-0.0.

Every comparison is exact. The kernel itself is held against the plain
version and this model on the card (``tests/test_torch_cuda.py -k nms``,
``chip_smoke.py`` phase ``nms_kernel``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from eventful_transformer_tpu.detection import nms as jax_nms
from eventful_transformer_tpu_torch.detection import nms
from eventful_transformer_tpu_torch.detection.boxes import iou_matrix
from eventful_transformer_tpu_torch.ops import kernel_check
from eventful_transformer_tpu_torch.ops import nms as nms_kernel
from torch_nms_contract import (bitonic_order, inter_union, kernel_order, sort_keys,
                                suppresses, walk)

CASES = ["random", "ties", "threshold", "chains", "all_invalid", "few_valid", "sorted",
         "signed_zeros"]
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
    """The model's walk against the plain version and the JAX function:
    indices and mask equal, the count the mask's; "sorted" takes the
    in-order path, the out-of-order cases the sort."""
    threshold = THRESHOLDS[max_out]
    boxes, scores = kernel_check.nms_inputs(n, max_out, threshold, seed=n + max_out, case=case)
    indices, mask, count, stats = walk(boxes, scores, threshold, max_out)
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
        assert count == 0 and stats["chunks"] == 0
    elif case == "few_valid":
        assert 0 < count < max_out
    if case in ("sorted", "threshold", "chains", "all_invalid"):
        assert stats["in_order"]
    elif case in ("random", "signed_zeros"):
        assert not stats["in_order"]


def test_threshold_case_plants_the_ulps():
    """The "threshold" case's pairs give IoUs of exactly the float32
    threshold, and the float32 values one ulp above and below it; only the
    one above suppresses, and each of the three takes the division."""
    for t in (0.5, 0.7):
        boxes, _ = kernel_check.nms_inputs(6, 6, t, case="threshold")
        ious = [iou_matrix(boxes[i + 1:i + 2], boxes[i:i + 1]).item() for i in (0, 2, 4)]
        t32 = np.float32(t)
        assert ious == [float(t32), float(np.nextafter(t32, np.float32(1))),
                        float(np.nextafter(t32, np.float32(0)))]
        decided, divided = [], []
        for i in (0, 2, 4):
            hit, div = suppresses(*inter_union(boxes[i + 1:i + 2].numpy(),
                                               boxes[i:i + 1].numpy()), t)
            decided.append(bool(hit[0, 0]))
            divided.append(bool(div[0, 0]))
        assert decided == [False, True, False] and divided == [True, True, True]


def test_chains_are_deeper_than_four():
    """Each chain keeps every other box: a suppression chain 12 deep, past
    the plain version's 4 Jacobi steps between host checks; the kernel's
    fixpoint inside a chunk takes 12 steps."""
    boxes, scores = kernel_check.nms_inputs(24, 24, 0.7, case="chains")
    indices, mask, count, stats = walk(boxes, scores, 0.7, 24)
    assert count == 12
    assert indices[:count].tolist() == list(range(0, 24, 2))
    assert stats["chunks"] == 1 and stats["steps"] == 12


@pytest.mark.parametrize("case", ["random", "threshold", "chains"])
@pytest.mark.parametrize("threshold", [0.5, 0.7])
def test_kernel_iou_arithmetic_gives_the_plain_bits(case, threshold):
    """The kernel's IoU arithmetic (numpy float32, each step rounded) and
    its test without a division give ``iou_matrix(b, b) > t`` exactly on
    every pair, the planted threshold IoUs included; the division decides
    the planted pairs and next to nothing else."""
    boxes, scores = kernel_check.nms_inputs(700, 100, threshold, seed=3, case=case)
    b = boxes[torch.sort(-scores, stable=True).indices].float()
    want = (iou_matrix(b, b) > threshold).numpy()
    got, divided = suppresses(*inter_union(b.numpy(), b.numpy()), threshold)
    np.testing.assert_array_equal(got, want)
    if case == "threshold":  # 350 pairs, a third each at t and one ulp either side
        assert int(np.triu(divided, 1).sum()) == 350
    else:
        assert int(divided.sum()) <= 10


def test_cpu_wrapper_is_the_plain_version():
    """On CPU tensors ``nms_padded`` is the plain version (its host reads
    counted) and launches nothing; the kernel's own wrapper refuses them.
    The entry is registered with its plain version, its bound (the larger
    of the bytes of boxes, scores, indices and mask over 3.35 TB/s and 15
    float32 steps for each IoU the greedy walk needs over 67 TFLOP/s), no
    library call, and the design's bytes beside it: the kept set and the
    sort's keys in shared memory, no scratch."""
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
    assert kernel_check.nms_design_bytes(d) == (20 * 100 + 8 * 512, 0)
    plain_rows = [kernel_check.compare_exact(a, b) for a, b in zip(
        kernel_check.call("nms_padded", d, plain=True),
        nms.nms_padded(boxes, d["nms_scores"], 0.7, 100))]
    assert all(row["ok"] for row in plain_rows)


def test_design_bytes_and_the_scratch_rule():
    """The kept set takes 20 bytes a box of shared memory and the sort's
    keys 8 bytes each, n rounded up to a power of two; past the 200 KB
    budget the keys go to a device scratch of the same size. Every model
    path (4096 boxes, max_out up to 1000) sorts in shared memory."""
    for n, max_out in ((4096, 300), (4096, 1000), (900, 64), (5, 3)):
        keys = 1 << (n - 1).bit_length()
        assert nms_kernel.scratch_bytes(n, max_out) == 0
        assert nms_kernel.smem_bytes(n, max_out) == 20 * max_out + 8 * keys
    assert nms_kernel.scratch_bytes(20000, 300) == 8 * 32768
    assert nms_kernel.smem_bytes(20000, 300) == 20 * 300
    assert nms_kernel.scratch_bytes(16384, 1000) == 0  # 151,072 bytes
    assert nms_kernel.scratch_bytes(16384, 4000) == 8 * 16384  # 211,072 bytes: over
    assert nms_kernel.smem_bytes(16384, 300) == 20 * 300 + 8 * 16384


SORT_CASES = ["random", "ties", "signed_zeros", "infinities", "nan", "in_order", "topk_order",
              "all_equal"]


def _scores(case, n, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    if case == "random":
        s = torch.rand(n, generator=g)
    elif case == "ties":
        s = torch.randint(0, 8, (n,), generator=g).float() / 8
    elif case == "signed_zeros":
        s = torch.tensor([0.0, -0.0, 0.5, -0.5])[torch.randint(0, 4, (n,), generator=g)]
    elif case == "infinities":
        s = torch.tensor([float("inf"), -float("inf"), 1.0, -1.0, 0.0])[
            torch.randint(0, 5, (n,), generator=g)]
    elif case == "nan":
        s = torch.rand(n, generator=g)
        s[torch.rand(n, generator=g) < 0.2] = float("nan")
        s[torch.rand(n, generator=g) < 0.1] = -float("inf")
    elif case == "in_order":  # -scores ascending, ties and -inf at the end
        s = torch.randint(0, 50, (n,), generator=g).float().sort(descending=True).values
        s[n // 2:] = -float("inf")
    elif case == "topk_order":  # batched_nms's top_k: a stable descending sort
        s = torch.sort(torch.randint(0, 20, (n,), generator=g).float() / 7, descending=True,
                       stable=True).values
    else:
        s = torch.full((n,), 0.25)
    return s.to(dtype)


@pytest.mark.parametrize("case", SORT_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
def test_sort_key_order_is_torch_sort(dtype, case):
    """The kernel's order (the identity where its keys ascend already, else
    its bitonic network) is ``torch.sort(-scores, stable=True)``'s, index
    for index: ties by index, -0.0 == +0.0, +inf first, -inf then NaN
    last; the valid boxes (score > -inf) are counted as the first
    positions. Scores in order take the identity."""
    scores = _scores(case, 1000, dtype)
    order, in_order, nvalid = kernel_order(scores)
    want = torch.sort(-scores, stable=True).indices.numpy()
    np.testing.assert_array_equal(order, want)
    assert nvalid == int((scores > -float("inf")).sum())
    assert bool((scores[torch.as_tensor(order[:nvalid])] > -float("inf")).all())
    assert in_order == (case in ("in_order", "topk_order", "all_equal"))
    if in_order:
        np.testing.assert_array_equal(order, np.arange(1000))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 70, 900, 1025, 4096])
def test_bitonic_network_is_the_stable_sort(n):
    """The network over (key << 32 | index), padded to a power of two, sorts
    bfloat16 scores with many ties, -inf and NaN exactly as the stable
    sort, at every size the card tests take."""
    g = torch.Generator().manual_seed(n)
    s = (torch.randint(0, 16, (n,), generator=g).float() / 16 - 0.5)
    s[torch.rand(n, generator=g) < 0.1] = -float("inf")
    s[torch.rand(n, generator=g) < 0.05] = float("nan")
    s = s.bfloat16()
    np.testing.assert_array_equal(bitonic_order(sort_keys(s)),
                                  torch.sort(-s, stable=True).indices.numpy())


def _divided(inter, union, t):
    inter, union, t = np.float32(inter), np.float32(union), np.float32(t)
    with np.errstate(all="ignore"):
        return bool(np.where(union > 0, inter / union if union > 0 else np.float32(0),
                             np.float32(0)) > t)


@settings(max_examples=600, deadline=None, derandomize=True)
@given(inter=st.floats(width=32), union=st.floats(width=32),
       t=st.one_of(st.sampled_from([0.5, 0.7, 0.3, 0.9]), st.floats(width=32)))
def test_division_free_compare_matches_division(inter, union, t):
    """On any float32 (inter, union, threshold): NaN, infinities, zeros,
    denormals, negative unions, thresholds outside (0, inf), the kernel's
    test equals numpy's fl(inter / union) > t (0 where union <= 0)."""
    got, _ = suppresses(np.array([inter]), np.array([union]), t)
    assert bool(got[0]) == _divided(inter, union, t)


EDGES = [  # (inter, union, t): the paths of the test one by one
    (0.0, 1.0, 0.5), (-0.0, 1.0, 0.5), (0.0, 0.0, 0.5), (1.0, 0.0, 0.5), (1.0, -1.0, -0.5),
    (1e-45, 2e-45, 0.4), (1e-45, 3e-45, 0.5), (1e-40, 1e-38, 1e-3), (3e38, 3.2e38, 0.9),
    (1.0, float("inf"), 0.5), (float("nan"), 1.0, 0.5), (1.0, float("nan"), 0.5),
    (1.0, 2.0, 0.5), (1.0, 2.0, float(np.nextafter(np.float32(0.5), np.float32(0)))),
    (1.0, 2.0, 1e-45), (0.5, 1.0, 0.0), (0.7, 1.0, 0.7), (7.0, 10.0, 0.7),
]


@pytest.mark.parametrize("inter,union,t", EDGES)
def test_division_free_compare_at_the_edges(inter, union, t):
    """The test on each edge of its paths equals the division: an empty
    overlap, unions <= 0, infinite and NaN operands, products outside
    [2^-100, 2^100] (which take the division), ratios exactly at t."""
    got, divided = suppresses(np.array([inter]), np.array([union]), t)
    assert bool(got[0]) == _divided(inter, union, t)
    if union > 0 and inter != 0 and 1e-30 < union * t < 1e30 and t > 0:
        ratio = float(np.float32(inter) / np.float32(union)) / float(np.float32(t))
        if ratio == 1:
            assert divided[0]
        elif abs(ratio - 1) > 1e-5:
            assert not divided[0]


def _ious_by_walk(boxes, scores, threshold, max_out):
    """The IoUs a greedy walk computes that stops testing a box at the
    first kept box that suppresses it, counted in Python."""
    order = torch.sort(-scores, stable=True).indices
    b, valid = boxes[order].float(), scores[order] > -float("inf")
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
