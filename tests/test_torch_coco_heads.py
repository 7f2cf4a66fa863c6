"""The COCO operating point's heads of the port against the JAX package on
the same numpy inputs and weights: ``MaskHead.inference`` (and its pick of
the detected class's channel), ``CascadeROIHeads.inference`` with and
without the mask head, a tiny ViTDet with ``cascade: true, with_mask:
true`` through ``ViTDet.apply`` (dense and eventful), the parameter bridge
of the new keys in both directions, and ``vitdet_b_coco.yml`` building the
cascade.

Tolerances, float32 on both sides at "highest" matmul precision: 1e-5 for
scores and mask probabilities of the heads alone (sums in other orders),
1e-4 for their boxes (pixels, the refinements of three stages); the tiny
model's scores at 1e-4, boxes at 1e-3 pixels and masks at 1e-3 (their
ROIAlign samples move with the boxes), the backbone's tokens differing by
summation order; NMS masks and labels exactly; the bridge exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.core.blocks import EventfulBlock as JaxEventfulBlock
from eventful_transformer_tpu.core.counting import Ctx as JaxCtx
from eventful_transformer_tpu.core.policies import TokenNormTopK as JaxTopK
from eventful_transformer_tpu.detection.mask_head import MaskHead as JaxMaskHead
from eventful_transformer_tpu.detection.roi_heads import CascadeROIHeads as JaxCascadeROIHeads
from eventful_transformer_tpu.models.vitdet import ViTDet as JaxViTDet
from eventful_transformer_tpu.utils.misc import set_policies as jax_set_policies
from eventful_transformer_tpu.utils.params import fill_like
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
from eventful_transformer_tpu_torch.detection.mask_head import MaskHead
from eventful_transformer_tpu_torch.detection.roi_heads import CascadeROIHeads, roi_heads
from eventful_transformer_tpu_torch.models import ViTDet
from eventful_transformer_tpu_torch.utils.config import load_config
from eventful_transformer_tpu_torch.utils.misc import set_policies
from eventful_transformer_tpu_torch.utils.params import flatten_tree, params_from_jax, params_to_numpy

TOL = 1e-5


@pytest.fixture(autouse=True)
def _setup():
    torch.set_num_threads(2)
    jax.config.update("jax_default_matmul_precision", "highest")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, dtype=np.float32),
                               rtol=tol, atol=tol)


def _bumped(like, seed, scale=0.05):
    """The JAX params plus scale * N(0, 1), as ``TestCascadeROIHeads._build``
    of tests/test_detection.py bumps them (the box predictors start near
    0): (flat numpy dict, the JAX tree)."""
    flat = flatten_tree(jax.tree_util.tree_map(np.asarray, like))
    rng = np.random.default_rng(seed)
    flat = {k: (v + scale * rng.standard_normal(v.shape)).astype(np.float32) for k, v in flat.items()}
    return flat, fill_like(like, flat)


def _features(rng, channels, size=16):
    return [rng.standard_normal((1, size // s, size // s, channels)).astype(np.float32)
            for s in (1, 2, 4, 8)]


def _boxes(rng, n, extent=40.0, size=16.0):
    corner = np.abs(rng.standard_normal((n, 2)) * extent / 2)
    wh = 2 + np.abs(rng.standard_normal((n, 2)) * size)
    return np.concatenate([corner, corner + wh], 1).astype(np.float32)


# -- the mask head ------------------------------------------------------------------


def test_mask_head_matches_jax():
    """Seeded p2-p5 features, 12 boxes and their labels: (12, 28, 28)
    probabilities."""
    rng = np.random.default_rng(21)
    kw = dict(num_classes=4, in_channels=8, conv_dims=(8, 8))
    jax_head, head = JaxMaskHead(**kw), MaskHead(**kw)
    flat, params = _bumped(jax_head.init(jax.random.PRNGKey(4)), seed=22, scale=0.3)
    params_from_jax(head, flat)
    feats = _features(rng, 8, size=64)
    boxes = _boxes(rng, 12)
    labels = rng.integers(0, 4, 12).astype(np.int32)
    want = jax_head.inference(params, [jnp.asarray(f) for f in feats], jnp.asarray(boxes),
                              jnp.asarray(labels))
    with torch.no_grad():
        got = head.inference([_t(f) for f in feats], _t(boxes), _t(labels))
    assert got.shape == (12, 28, 28)
    assert float(got.std()) > 0.05  # not all 1/2
    _close(got, want)


def test_mask_head_picks_the_label_channel():
    """JAX ``TestMaskHead.test_predictor_picks_label_channel`` on both
    packages: a predictor whose channels are told apart by their bias
    alone."""
    rng = np.random.default_rng(23)
    jax_head = JaxMaskHead(num_classes=4, in_channels=8, conv_dims=(8,))
    head = MaskHead(num_classes=4, in_channels=8, conv_dims=(8,))
    params = jax_head.init(jax.random.PRNGKey(1))
    params["predictor"] = {"kernel": jnp.zeros((1, 1, 8, 4)),
                           "bias": jnp.asarray([10.0, -10.0, 20.0, -20.0])}
    params_from_jax(head, params)
    feats = _features(rng, 8)
    boxes = np.asarray([[1.0, 1.0, 30.0, 30.0], [2.0, 2.0, 40.0, 40.0]], np.float32)
    labels = np.asarray([0, 3], np.int32)
    want = np.asarray(jax_head.inference(params, [jnp.asarray(f) for f in feats],
                                         jnp.asarray(boxes), jnp.asarray(labels)))
    with torch.no_grad():
        got = head.inference([_t(f) for f in feats], _t(boxes), _t(labels)).numpy()
    assert (got[0] > 0.99).all() and (got[1] < 0.01).all()
    _close(torch.from_numpy(got), want)


# -- the cascade -----------------------------------------------------------------------


@pytest.mark.parametrize("with_mask", [False, True], ids=["boxes", "masks"])
def test_cascade_inference_matches_jax(with_mask):
    """30 seeded proposals (some masked) over p2-p5 of a 64 x 64 image
    through three stages, the averaged scores, NMS and, with the mask head,
    the masks of the kept detections."""
    rng = np.random.default_rng(24)
    kw = dict(num_classes=4, in_channels=8, conv_dims=(8,), fc_dims=(16,), test_topk_per_image=10,
              test_score_thresh=0.0, with_mask=with_mask)
    jax_heads, heads = JaxCascadeROIHeads(**kw), CascadeROIHeads(**kw)
    flat, params = _bumped(jax_heads.init(jax.random.PRNGKey(3)), seed=25)
    params_from_jax(heads, flat)
    feats = _features(rng, 8)
    props = _boxes(rng, 30)
    mask = rng.random(30) < 0.8
    want = jax_heads.inference(params, [jnp.asarray(f) for f in feats], jnp.asarray(props),
                               jnp.asarray(mask), (64, 64))
    with torch.no_grad():
        got = heads.inference([_t(f) for f in feats], _t(props), _t(mask), (64, 64))
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    assert got["mask"].sum() > 5
    _close(got["boxes"], want["boxes"], 1e-4)
    _close(got["scores"], want["scores"])
    if with_mask:
        assert got["masks"].shape == (10, 28, 28)
        _close(got["masks"], want["masks"])


def test_cascade_stage_weights_and_class_agnostic_regression():
    """Three stages, each with 4 box outputs (class-agnostic) and its own
    Box2BoxTransform weights; roi_heads() builds the cascade for cascade:
    true, the mask head only with with_mask."""
    heads = roi_heads(5, 8, cascade=True, with_mask=True, conv_dims=(8,), fc_dims=(16,))
    assert isinstance(heads, CascadeROIHeads) and heads.mask_head is not None
    assert heads.stage_box_weights == ((10.0, 10.0, 5.0, 5.0), (20.0, 20.0, 10.0, 10.0),
                                       (30.0, 30.0, 15.0, 15.0))
    assert [s.bbox_pred.kernel.shape[-1] for s in heads.stages] == [4, 4, 4]
    assert [s.cls_score.kernel.shape[-1] for s in heads.stages] == [6, 6, 6]
    assert roi_heads(5, 8, cascade=True, conv_dims=(8,), fc_dims=(16,)).mask_head is None
    assert not hasattr(heads, "convs")  # the box layers live in the stages


# -- a tiny COCO ViTDet end to end ----------------------------------------------------


def _tiny_config(eventful):
    """tests/test_torch_detection.py's tiny ViTDet with the COCO heads."""
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
        rpn_config=dict(pre_nms_topk=200, post_nms_topk=50),
        roi_config=dict(test_topk_per_image=20, cascade=True, with_mask=True),
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
    flat, params = _bumped(jax_model.init(jax.random.PRNGKey(0)), seed=26)
    params_from_jax(model, flat)
    return jax_model, model, params, flat


@pytest.mark.parametrize("eventful", [False, True], ids=["dense", "eventful"])
def test_tiny_coco_vitdet_apply_matches_jax(eventful, monkeypatch):
    """Three frames through ``ViTDet.apply``: boxes, scores, labels, the
    valid mask and the 28 x 28 masks of each frame."""
    monkeypatch.setenv("EVT_UNROLL_BLOCKS", "1")
    jax_model, model, params, _ = _tiny_pair(eventful)
    frames = np.random.default_rng(27).integers(0, 255, (3, 1, 3, 56, 60), dtype=np.uint8)
    jax_state, state = jax_model.init_state(1), model.init_state(1)
    aux, port_aux = jax_model.precompute(params), model.precompute()
    kept = 0
    for t in range(3):
        mode = ("flush" if t == 0 else "incremental") if eventful else None
        want, jax_state = jax_model.apply(JaxCtx(), params, jax_state, jnp.asarray(frames[t]), aux,
                                          mode=mode)
        got, state = model.apply(Ctx(), state, _t(frames[t]), port_aux, mode=mode)
        assert set(got) == set(want) == {"boxes", "scores", "labels", "mask", "masks"}
        assert got["masks"].shape == (20, 28, 28)
        np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
        np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
        _close(got["scores"], want["scores"], 1e-4)
        _close(got["boxes"], want["boxes"], 1e-3)
        _close(got["masks"], want["masks"], 1e-3)
        kept += int(got["mask"].sum())
    assert kept > 0


def test_coco_bridge_round_trip():
    """The JAX keys roi_heads/stages/<i>/... and roi_heads/mask_head/...
    load into the port (every key, strictly) and come back unchanged,
    conv and deconv kernels in the JAX layouts."""
    _, model, _, flat = _tiny_pair(False)
    back = params_to_numpy(model)
    assert set(back) == set(flat)
    for key in ("roi_heads/stages/2/convs/0/kernel", "roi_heads/stages/1/fcs/0/kernel",
                "roi_heads/stages/0/bbox_pred/kernel", "roi_heads/mask_head/convs/3/ln/scale",
                "roi_heads/mask_head/convs/0/kernel", "roi_heads/mask_head/deconv/kernel",
                "roi_heads/mask_head/deconv/bias", "roi_heads/mask_head/predictor/kernel"):
        assert key in back, key
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    # the conv kernels are stored in torch's layout and permuted on the way
    jax_kernel = flat["roi_heads/mask_head/convs/0/kernel"]  # HWIO
    assert model.roi_heads.mask_head.convs[0].kernel.shape == (jax_kernel.shape[3], jax_kernel.shape[2], 3, 3)
    deconv = flat["roi_heads/mask_head/deconv/kernel"]  # (kh, kw, Cout, Cin)
    assert model.roi_heads.mask_head.deconv.kernel.shape == (deconv.shape[3], deconv.shape[2], 2, 2)


def test_coco_config_builds_the_cascade():
    """``ViTDet(**vitdet_b_coco.yml["model"])`` of the port: the cascade
    with its mask head over 80 classes."""
    config = load_config("configs/models/vitdet_b_coco.yml")["model"]
    model = ViTDet(**config, device="cpu")
    heads = model.roi_heads
    assert isinstance(heads, CascadeROIHeads) and len(heads.stages) == 3
    assert heads.mask_head is not None and heads.mask_head.predictor.kernel.shape[0] == 80
    assert heads.stages[0].cls_score.kernel.shape[-1] == 81
    assert model.backbone_input_size == (64, 64)
