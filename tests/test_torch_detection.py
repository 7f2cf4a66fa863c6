"""The detection head of the port against the JAX package on the same
numpy inputs and weights: boxes, anchors, NMS (both formulations, index
for index, and against a greedy numpy oracle of this file's own), top-k
with ties, ROIAlign, the convolutions, ``RPN.propose``,
``StandardROIHeads.inference`` and a tiny ViTDet through ``ViTDet.apply``
(dense and eventful, with rel-pos on its global blocks).

Tolerances, float32 on both sides at "highest" matmul precision: 1e-5
for boxes, ROIAlign and convolutions (sums in other orders); NMS, top-k,
level assignment, labels and masks exactly; the tiny model's detections
at 1e-4 (scores) and 1e-3 (boxes, in pixels of a 64 x 64 image), the
backbone's tokens differing by summation order.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from eventful_transformer_tpu.core.blocks import EventfulBlock as JaxEventfulBlock
from eventful_transformer_tpu.core.counting import Ctx as JaxCtx
from eventful_transformer_tpu.core.policies import TokenNormTopK as JaxTopK
from eventful_transformer_tpu.detection import anchors as jax_anchors
from eventful_transformer_tpu.detection import boxes as jax_boxes
from eventful_transformer_tpu.detection import nms as jax_nms
from eventful_transformer_tpu.detection import roi_align as jax_roi_align
from eventful_transformer_tpu.detection.roi_heads import StandardROIHeads as JaxROIHeads
from eventful_transformer_tpu.detection.rpn import RPN as JaxRPN
from eventful_transformer_tpu.models.vitdet import ViTDet as JaxViTDet
from eventful_transformer_tpu.ops import conv as jax_conv
from eventful_transformer_tpu.utils.misc import set_policies as jax_set_policies
from eventful_transformer_tpu.utils.params import fill_like
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.core.nn import layer_norm
from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
from eventful_transformer_tpu_torch.detection import anchors, boxes, nms, roi_align
from eventful_transformer_tpu_torch.detection.roi_heads import StandardROIHeads
from eventful_transformer_tpu_torch.detection.rpn import RPN
from eventful_transformer_tpu_torch.models import ViTDet
from eventful_transformer_tpu_torch.ops import conv
from eventful_transformer_tpu_torch.utils.misc import set_policies
from eventful_transformer_tpu_torch.utils.params import flatten_tree, params_from_jax, params_to_numpy

TOL = 1e-5


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, dtype=np.float32),
                               rtol=tol, atol=tol)


def _perturbed(like, seed, scale=0.1):
    flat = flatten_tree(jax.tree_util.tree_map(np.asarray, like))
    rng = np.random.default_rng(seed)
    flat = {k: (v + scale * rng.standard_normal(v.shape)).astype(np.float32) for k, v in flat.items()}
    return flat, fill_like(like, flat)


def _random_boxes(rng, n, extent=80.0, size=12.0):
    corner = np.abs(rng.standard_normal((n, 2)) * extent / 2)
    wh = 2 + np.abs(rng.standard_normal((n, 2)) * size)
    return np.concatenate([corner, corner + wh], 1).astype(np.float32)


# -- boxes and anchors ----------------------------------------------------------


def test_box_ops_match_jax():
    rng = np.random.default_rng(0)
    b = _random_boxes(rng, 30)
    b[3] = [5, 5, 5, 9]  # empty width
    deltas = rng.standard_normal((30, 4, 4)).astype(np.float32)
    deltas[0, 0, 2:] = 9.0  # past the dw/dh clamp
    _close(boxes.apply_deltas(_t(deltas), _t(b)[:, None]),
           jax_boxes.apply_deltas(jnp.asarray(deltas), jnp.asarray(b)[:, None]))
    _close(boxes.apply_deltas(_t(deltas), _t(b)[:, None], (10.0, 10.0, 5.0, 5.0)),
           jax_boxes.apply_deltas(jnp.asarray(deltas), jnp.asarray(b)[:, None], (10.0, 10.0, 5.0, 5.0)))
    _close(boxes.clip_boxes(_t(b) - 10, (40, 50)), jax_boxes.clip_boxes(jnp.asarray(b) - 10, (40, 50)))
    _close(boxes.box_area(_t(b)), jax_boxes.box_area(jnp.asarray(b)))
    _close(boxes.iou_matrix(_t(b), _t(b[:7])), jax_boxes.iou_matrix(jnp.asarray(b), jnp.asarray(b[:7])))
    np.testing.assert_array_equal(boxes.nonempty_boxes(_t(b), 1.0).numpy(),
                                  np.asarray(jax_boxes.nonempty_boxes(jnp.asarray(b), 1.0)))


def test_anchors_match_jax():
    sizes, strides = [(16, 24), (8, 12), (3, 5)], (4, 8, 16)
    per_level = ((32,), (64,), (128, 160))
    got = anchors.multi_level_anchors(sizes, strides, per_level, (0.5, 1.0, 2.0), 0.5)
    want = jax_anchors.multi_level_anchors(sizes, strides, per_level, (0.5, 1.0, 2.0), 0.5)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# -- NMS --------------------------------------------------------------------------


def _greedy_oracle(b, s, thresh):
    """Greedy NMS in numpy, in descending score order (stable among
    ties); -inf scores are never kept."""
    order = np.argsort(-s, kind="stable")
    keep, suppressed = [], np.zeros(len(b), bool)
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    for i in order:
        if suppressed[i] or not np.isfinite(s[i]):
            continue
        keep.append(int(i))
        w = np.maximum(np.minimum(b[i, 2], b[:, 2]) - np.maximum(b[i, 0], b[:, 0]), 0)
        h = np.maximum(np.minimum(b[i, 3], b[:, 3]) - np.maximum(b[i, 1], b[:, 1]), 0)
        inter = w * h
        suppressed |= inter / np.maximum(area[i] + area - inter, 1e-9) > thresh
    return keep


def _nms_inputs(n, seed, ties=False):
    rng = np.random.default_rng(seed)
    b = _random_boxes(rng, n, extent=80.0 if n < 1000 else 160.0)
    s = rng.standard_normal(n).astype(np.float32)
    if ties:
        s = np.round(s * 4) / 4  # many equal scores
    s[::7] = -np.inf  # invalid candidates interleaved
    return b, s


@pytest.mark.parametrize("max_out", [16, 300])
@pytest.mark.parametrize("n,ties", [(64, False), (64, True), (2500, False), (2500, True)],
                         ids=["64", "64_ties", "2500_blocked", "2500_blocked_ties"])
def test_nms_padded_matches_jax_and_oracle(n, ties, max_out):
    """Both formulations (n <= 1024: the Jacobi fixpoint; 2500: three
    blocks, the last ragged), index for index against the JAX function,
    the masked slots included, and the kept prefix against the oracle."""
    b, s = _nms_inputs(n, seed=n + max_out, ties=ties)
    idx, mask = nms.nms_padded(_t(b), _t(s), 0.5, max_out)
    want_idx, want_mask = jax_nms.nms_padded(jnp.asarray(b), jnp.asarray(s), 0.5, max_out)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    # above n slots the JAX function returns n indices beside max_out mask slots
    want = _greedy_oracle(b, s, 0.5)[:max_out]
    assert int(mask.sum()) == len(want)
    assert idx.numpy()[: len(want)].tolist() == want


def test_nms_capacity_overflow():
    """More keeps than max_out on the blocked path: the first max_out in
    score order, the mask saturated, the loop stopped after block 1."""
    n = 1100
    x = np.arange(n, dtype=np.float32) * 20
    b = np.stack([x, x * 0, x + 10, x * 0 + 10], 1)
    s = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    before = nms.host_syncs
    idx, mask = nms.nms_padded(_t(b), _t(s), 0.5, 64)
    assert mask.all()
    np.testing.assert_array_equal(idx.numpy(), np.argsort(-s, kind="stable")[:64])
    want_idx, _ = jax_nms.nms_padded(jnp.asarray(b), jnp.asarray(s), 0.5, 64)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert nms.host_syncs - before == 1  # one fixpoint check; block 2 never runs


@pytest.mark.parametrize("n,max_candidates", [(600, 4096), (1500, 1024)],
                         ids=["no_truncation", "top_candidates"])
def test_batched_nms_matches_jax(n, max_candidates):
    """Groupwise NMS: identical boxes in different groups do not suppress
    each other; above max_candidates the top candidates by score, ties to
    the smaller index."""
    b, s = _nms_inputs(n, seed=3, ties=True)
    groups = np.random.default_rng(4).integers(0, 5, n).astype(np.int32)
    b[1], groups[:2] = b[0], [0, 1]
    idx, mask = nms.batched_nms(_t(b), _t(s), _t(groups), 0.5, 100, max_candidates)
    want_idx, want_mask = jax_nms.batched_nms(jnp.asarray(b), jnp.asarray(s), jnp.asarray(groups),
                                              0.5, 100, max_candidates)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))


def test_top_k_ties_match_lax():
    x = np.round(np.random.default_rng(5).standard_normal(500) * 2).astype(np.float32)
    x[::11] = -np.inf
    values, indices = nms.top_k(_t(x), 120)
    want_values, want_indices = jax.lax.top_k(jnp.asarray(x), 120)
    np.testing.assert_array_equal(values.numpy(), np.asarray(want_values))
    np.testing.assert_array_equal(indices.numpy(), np.asarray(want_indices))


# -- ROIAlign and convolutions -----------------------------------------------------


def test_roi_align_matches_jax():
    rng = np.random.default_rng(6)
    fm = rng.standard_normal((13, 17, 5)).astype(np.float32)
    b = _random_boxes(rng, 20, extent=60.0)
    b[0] = [-30, -30, 200, 250]  # samples outside the map
    got = roi_align.roi_align(_t(fm), _t(b), 0.25, output_size=7, sampling_ratio=2)
    _close(got, jax_roi_align.roi_align(jnp.asarray(fm), jnp.asarray(b), 0.25, 7, 2))


def test_multilevel_roi_align_matches_jax():
    rng = np.random.default_rng(7)
    maps = [rng.standard_normal((32 // s, 40 // s, 6)).astype(np.float32) for s in (1, 2, 4, 8)]
    b = np.concatenate([_random_boxes(rng, 30, extent=60.0, size=s) for s in (8.0, 60.0, 200.0)])
    b[0] = [-20, -10, 170, 130]
    levels = roi_align.assign_levels(_t(b), 2, 5)
    np.testing.assert_array_equal(levels.numpy(), np.asarray(jax_roi_align.assign_levels(jnp.asarray(b), 2, 5)))
    assert len(set(levels.tolist())) >= 3
    scales = (1 / 4, 1 / 8, 1 / 16, 1 / 32)
    got = roi_align.multilevel_roi_align([_t(m) for m in maps], _t(b), scales, 2, 5)
    _close(got, jax_roi_align.multilevel_roi_align([jnp.asarray(m) for m in maps], jnp.asarray(b),
                                                   scales, 2, 5))


def test_convolutions_match_jax():
    """H != W and Cin != Cout, so a transposed kernel or spatial axes
    swapped on the way across would show: the JAX kernels (HWIO and
    (kh, kw, Cout, Cin)) go through the param bridge's permutes."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 5, 7, 6)).astype(np.float32)
    c3 = conv.Conv2d(3, 3, 6, 4)
    ct = conv.ConvTranspose2d(2, 2, 6, 3)
    jax_c3 = jax_conv.conv2d_init(jax.random.PRNGKey(0), 3, 3, 6, 4)
    jax_ct = jax_conv.conv_transpose2d_init(jax.random.PRNGKey(1), 2, 2, 6, 3)
    for module, params in ((c3, jax_c3), (ct, jax_ct)):
        flat = {k: np.asarray(v) for k, v in flatten_tree(params).items()}
        params_from_jax(module, flat)
        for key, value in params_to_numpy(module).items():
            np.testing.assert_array_equal(value, flat[key])  # the inverse permute
    xj = jnp.asarray(x)
    _close(c3(_t(x), padding=1), jax_conv.conv2d(xj, jax_c3["kernel"], jax_c3["bias"], padding=1))
    _close(conv.conv2d(_t(x), c3.kernel), jax_conv.conv2d(xj, jax_c3["kernel"], padding="VALID"))
    _close(ct(_t(x)), jax_conv.conv_transpose2d(xj, jax_ct["kernel"], jax_ct["bias"]))
    _close(conv.max_pool2d(_t(x), 2, 2), jax_conv.max_pool2d(xj, 2, 2))


# -- RPN and ROI heads ------------------------------------------------------------------


def _features(rng, sizes, channels):
    return [rng.standard_normal((1, h, w, channels)).astype(np.float32) for h, w in sizes]


def test_rpn_propose_matches_jax():
    """Five levels of a 64 x 96 image: 1384 candidates after the per-level
    top-k, so the blocked NMS; quantised features make tied logits."""
    rng = np.random.default_rng(9)
    kw = dict(in_channels=8, pre_nms_topk=(2000, 1000), post_nms_topk=(1000, 300))
    jax_rpn, rpn = JaxRPN(**kw), RPN(**kw)
    flat, params = _perturbed(jax_rpn.init(jax.random.PRNGKey(2)), seed=10)
    params_from_jax(rpn, flat)
    sizes = JaxRPN.feature_sizes_for((64, 96), jax_rpn.strides)
    feats = [np.round(f * 2) / 2 for f in _features(rng, sizes, 8)]
    want = jax_rpn.propose(params, [jnp.asarray(f) for f in feats], (64, 96))
    with torch.no_grad():
        got = rpn.propose([_t(f) for f in feats], (64, 96))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    m = got[2].numpy()
    assert m.sum() > 20
    _close(got[0], want[0])
    _close(got[1][m], np.asarray(want[1])[m])


@pytest.mark.parametrize("proposals", [40, 900], ids=["jacobi", "top_candidates_blocked"])
def test_roi_heads_inference_matches_jax(proposals):
    """Seeded p2-p5 features and proposals, some masked: 40 x 5 scores
    take the fixpoint NMS, 900 x 5 the top 4096 and the blocked form."""
    rng = np.random.default_rng(11)
    kw = dict(num_classes=5, in_channels=8, conv_dims=(8, 8), fc_dims=(32,), test_topk_per_image=30)
    jax_heads, heads = JaxROIHeads(**kw), StandardROIHeads(**kw)
    flat, params = _perturbed(jax_heads.init(jax.random.PRNGKey(3)), seed=12, scale=0.2)
    params_from_jax(heads, flat)
    feats = _features(rng, [(16, 24), (8, 12), (4, 6), (2, 3)], 8)
    props = _random_boxes(rng, proposals, extent=60.0, size=20.0)
    mask = rng.random(proposals) < 0.8
    want = jax_heads.inference(params, [jnp.asarray(f) for f in feats], jnp.asarray(props),
                               jnp.asarray(mask), (64, 96))
    with torch.no_grad():
        got = heads.inference([_t(f) for f in feats], _t(props), _t(mask), (64, 96))
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    assert got["mask"].sum() > 5
    _close(got["boxes"], want["boxes"], 1e-4)
    _close(got["scores"], want["scores"])


# -- the tiny ViTDet end to end ---------------------------------------------------------


def _tiny_config(eventful):
    """tests/test_detection.py's TINY_VITDET with rel-pos on, and k/v
    pooling on the global block when eventful."""
    block = dict(dim=48, heads=6, mlp_ratio=2, window_size=[2, 2], relative_embedding_size=[4, 4])
    backbone = dict(depth=2, position_encoding_size=[4, 4], window_indices=[0], block_config=block)
    if eventful:
        block["pool_size"] = 2
        backbone.update(block_class="EventfulBlock", windowed_class="EventfulTokenwiseBlock",
                        windowed_overrides=dict(pool_size=None))
    return dict(
        classes=5, input_shape=[3, 64, 64], normalize_mean=[123.675, 116.28, 103.53],
        normalize_std=[58.395, 57.12, 57.375], output_channels=32, patch_size=[16, 16],
        scale_factors=[4.0, 2.0, 1.0, 0.5], backbone_config=backbone,
        rpn_config=dict(pre_nms_topk=200, post_nms_topk=50), roi_config=dict(test_topk_per_image=20),
    )


def _tiny_pair(eventful):
    jax_model = JaxViTDet(**_tiny_config(eventful))
    model = ViTDet(**_tiny_config(eventful), device="cpu")
    for blk in jax_model.backbone.blocks:
        blk.fused_window_attention = blk.fused_dense_mlp = True
    if eventful:
        jax_set_policies(jax_model, JaxTopK, k=10)
        set_policies(model, TokenNormTopK, k=10)
        for jax_blk, blk in zip(jax_model.backbone.blocks, model.backbone.blocks):
            jax_blk.fused_gates = blk.fused_gates = "v2"
            if isinstance(jax_blk, JaxEventfulBlock):
                jax_blk.av_kernel = jax_blk.fuse_matmul_1 = True  # the port's batch-1 rule
    flat, params = _perturbed(jax_model.init(jax.random.PRNGKey(0)), seed=13, scale=0.05)
    params_from_jax(model, flat)
    return jax_model, model, params


@pytest.mark.parametrize("eventful", [False, True], ids=["dense", "eventful"])
def test_tiny_vitdet_apply_matches_jax(eventful, monkeypatch):
    """Three frames through ``ViTDet.apply`` (eventful: a flush, then two
    incremental frames): the detections dict of each frame."""
    monkeypatch.setenv("EVT_UNROLL_BLOCKS", "1")
    jax_model, model, params = _tiny_pair(eventful)
    frames = np.random.default_rng(14).integers(0, 255, (3, 1, 3, 56, 60), dtype=np.uint8)
    jax_state, state = jax_model.init_state(1), model.init_state(1)
    aux, port_aux = jax_model.precompute(params), model.precompute()
    kept = 0
    for t in range(3):
        mode = ("flush" if t == 0 else "incremental") if eventful else None
        want, jax_state = jax_model.apply(JaxCtx(), params, jax_state, jnp.asarray(frames[t]), aux, mode=mode)
        got, state = model.apply(Ctx(), state, _t(frames[t]), port_aux, mode=mode)
        assert set(got) == set(want)
        np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
        np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
        _close(got["scores"], want["scores"], 1e-4)
        _close(got["boxes"], want["boxes"], 1e-3)
        kept += int(got["mask"].sum())
    assert kept > 0


def test_detection_match_bound_fails_a_planted_fault():
    """``chip_smoke.match_detections``, the bound that holds the card's
    detections to the CPU's: the same model passes against itself with
    sub-bound noise, and a planted fault fails it (the box head's flatten
    taken in (H, W, C) order, silent at square shapes)."""
    _, model, _ = _tiny_pair(False)
    frame = _t(np.random.default_rng(15).integers(0, 255, (1, 3, 64, 64), dtype=np.uint8))
    ref, _ = model.apply(Ctx(), model.init_state(1), frame)
    noisy = dict(ref, boxes=ref["boxes"] + 1e-4, scores=ref["scores"] * (1 + 1e-6))
    assert chip_smoke.match_detections(noisy, ref)["ok"]
    faulty = copy.deepcopy(model)
    heads = faulty.roi_heads

    def box_head_hwc(pooled):
        x = pooled
        for c in heads.convs:
            x = torch.relu(layer_norm(c(x, padding=1), c.ln))
        x = x.reshape(x.shape[0], -1)
        for fc in heads.fcs:
            x = torch.relu(fc(x))
        return x

    heads.box_head = box_head_hwc
    bad, _ = faulty.apply(Ctx(), faulty.init_state(1), frame)
    assert not chip_smoke.match_detections(bad, ref)["ok"]


def test_vitdet_defaults_to_the_card():
    """Without ``device`` the parameters go to the card; without a card
    that raises instead of falling back to the CPU."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ViTDet(**_tiny_config(False))
        return
    assert ViTDet(**_tiny_config(False)).embedding.kernel.device.type == "cuda"
