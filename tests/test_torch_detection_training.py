"""The port's detector training side (``detection/training.py``) and the RPN's
training pair (``RPN.propose(training=True)``) against the JAX package on the
CPU, every case of tests/test_detection_training.py and more:

- the Matcher's buckets, its low-quality matches and the gt mask, the
  matches and labels equal to JAX's; ties in the IoU go to the first gt;
- the subsampling: JAX's quotas, and the masks equal to JAX's given JAX's
  own uniforms (``jax.random.split`` of the key, one uniform array each),
  ties among the uniforms included;
- the delta round trip, GIoU, and ``get_deltas`` against JAX's;
- ``rpn_losses``, ``sample_proposals`` and ``fast_rcnn_losses`` on generated
  boxes with JAX's uniforms: values within 1e-6 relative, the sampled
  masks and classes equal, and the gradients with respect to the logits,
  the deltas, the class scores and the predicted boxes against
  ``jax.grad`` (NaN where JAX has NaN: a degenerate box pair's GIoU);
- the RPN's (train, test) pairs and ``propose(training=...)`` against the
  JAX ``propose``, and a frame with fewer candidates than the training
  pair's ``post_nms_topk``, where the JAX ``nms_padded`` returns fewer
  indices than its mask and the JAX ``propose`` fails; the port's pads."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.detection import training as jt
from eventful_transformer_tpu.detection.boxes import iou_matrix as jax_iou_matrix
from eventful_transformer_tpu.detection.rpn import RPN as JaxRPN
from eventful_transformer_tpu.utils.params import _flatten
from eventful_transformer_tpu_torch.detection import training as pt
from eventful_transformer_tpu_torch.detection.boxes import apply_deltas
from eventful_transformer_tpu_torch.detection.rpn import RPN
from eventful_transformer_tpu_torch.utils.params import params_from_jax

LOSS_RTOL = 1e-6
GRAD_TOL = dict(rtol=1e-5, atol=1e-7)


def _t(x):
    return torch.from_numpy(np.array(x))


def _uniforms(key, shape):
    """The uniforms JAX ``subsample_labels`` draws from ``key``."""
    k1, k2 = jax.random.split(key)
    return (_t(jax.random.uniform(k1, shape)), _t(jax.random.uniform(k2, shape)))


def _boxes(rng, n, lo=0.0, hi=50.0, size=(4.0, 16.0)):
    xy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(*size, (n, 2))
    return np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)


QUALITY = np.asarray([[0.1, 0.5, 0.8, 0.0], [0.2, 0.4, 0.1, 0.0]], np.float32)


class TestMatcher:
    @pytest.mark.parametrize("low_quality, want", [(False, [0, -1, 1, 0]), (True, [0, 1, 1, 0])])
    def test_buckets_and_low_quality(self, low_quality, want):
        args = ([0.3, 0.7], [0, -1, 1], low_quality)
        matches, labels = pt.Matcher(*args)(_t(QUALITY))
        jm, jl = jt.Matcher(*args)(jnp.asarray(QUALITY))
        np.testing.assert_array_equal(labels.numpy(), want)
        np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(matches.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(matches.numpy(), [1, 0, 0, 0])
        assert matches.dtype == torch.int32 and labels.dtype == torch.int8

    def test_gt_mask_excludes_padding(self):
        quality = np.asarray([[0.9, 0.0], [0.0, 0.95]], np.float32)
        mask = np.asarray([True, False])
        _, labels = pt.Matcher([0.5], [0, 1], True)(_t(quality), _t(mask))
        np.testing.assert_array_equal(labels.numpy(), [1, 0])

    def test_ties_go_to_the_first_gt(self, rng):
        quality = np.round(rng.uniform(0, 1, (4, 64)), 1).astype(np.float32)
        mask = np.asarray([True, True, False, True])
        for args in (([0.3, 0.7], [0, -1, 1], True), ([0.5], [0, 1], False)):
            matches, labels = pt.Matcher(*args)(_t(quality), _t(mask))
            jm, jl = jt.Matcher(*args)(jnp.asarray(quality), jnp.asarray(mask))
            np.testing.assert_array_equal(matches.numpy(), np.asarray(jm))
            np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))

    def test_refuses_bad_settings(self):
        with pytest.raises(ValueError):
            pt.Matcher([0.7, 0.3], [0, -1, 1])
        with pytest.raises(ValueError):
            pt.Matcher([0.5], [0, 2])


class TestSampling:
    @pytest.mark.parametrize("labels, num, fraction, want", [
        ([1] * 10 + [0] * 100 + [-1] * 20, 32, 0.25, (8, 24)),
        ([1] * 2 + [0] * 100, 32, 0.5, (2, 30)),
        ([0] * 5 + [1] * 3, 32, 0.5, (3, 5)),
    ])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_quotas_and_masks_from_jax_uniforms(self, labels, num, fraction, want, seed):
        labels = np.asarray(labels, np.int8)
        key = jax.random.PRNGKey(seed)
        pos, neg = pt.subsample_labels(_uniforms(key, labels.shape), _t(labels), num, fraction)
        jpos, jneg = jt.subsample_labels(key, jnp.asarray(labels), num, fraction)
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(neg.numpy(), np.asarray(jneg))
        assert (int(pos.sum()), int(neg.sum())) == want
        assert not (pos & neg).any()
        assert not pos[_t(labels) != 1].any() and not neg[_t(labels) != 0].any()

    def test_tied_uniforms_go_to_the_smaller_index(self):
        """Equal priorities rank by index (a stable sort, as jnp.argsort)."""
        labels = torch.zeros(10, dtype=torch.int8)
        flat = torch.full((10,), 0.5)
        _, neg = pt.subsample_labels((flat, flat), labels, 4, 0.5)
        np.testing.assert_array_equal(neg.numpy(), [True] * 4 + [False] * 6)

    def test_generator_draws(self):
        labels = torch.tensor([1] * 10 + [0] * 100, dtype=torch.int8)
        first = pt.subsample_labels(torch.Generator().manual_seed(3), labels, 32, 0.25)
        again = pt.subsample_labels(torch.Generator().manual_seed(3), labels, 32, 0.25)
        for a, b in zip(first, again):
            assert torch.equal(a, b)
        assert (int(first[0].sum()), int(first[1].sum())) == (8, 24)


class TestBoxLosses:
    def test_delta_roundtrip(self):
        src = np.asarray([[0.0, 0.0, 10.0, 20.0], [5.0, 5.0, 9.0, 30.0]], np.float32)
        tgt = np.asarray([[1.0, 2.0, 12.0, 21.0], [4.0, 3.0, 11.0, 28.0]], np.float32)
        weights = (10.0, 10.0, 5.0, 5.0)
        deltas = pt.get_deltas(_t(src), _t(tgt), weights)
        np.testing.assert_allclose(deltas.numpy(), np.asarray(jt.get_deltas(src, tgt, weights)),
                                   rtol=1e-6, atol=1e-7)
        back = apply_deltas(deltas, _t(src), weights)
        np.testing.assert_allclose(back.numpy(), tgt, rtol=1e-5, atol=1e-4)

    def test_giou(self, rng):
        a = _t(np.asarray([[0.0, 0.0, 2.0, 2.0]], np.float32))
        assert float(pt.giou_loss(a, a)[0]) < 1e-6
        b = _t(np.asarray([[4.0, 0.0, 6.0, 2.0]], np.float32))
        np.testing.assert_allclose(float(pt.giou_loss(a, b)[0]), 1 + 1 / 3, rtol=1e-5)
        p, q = _boxes(rng, 32), _boxes(rng, 32)
        np.testing.assert_allclose(pt.giou_loss(_t(p), _t(q)).numpy(),
                                   np.asarray(jt.giou_loss(p, q)), rtol=1e-6, atol=1e-7)


def _rpn_case(rng, perfect=False):
    anchors = _boxes(rng, 96, size=(6.0, 14.0))
    gt = np.concatenate([anchors[:3] + np.asarray([1.0, 1.0, 2.0, -1.0], np.float32),
                         np.zeros((2, 4), np.float32)])
    gt_mask = np.asarray([True, True, True, False, False])
    if perfect:
        q = np.asarray(jax_iou_matrix(gt[:3], anchors))
        deltas = np.asarray(jt.get_deltas(anchors, gt[:3][np.argmax(q, axis=0)]))
        logits = np.where(q.max(axis=0) > 0.3, 20.0, -20.0).astype(np.float32)
    else:
        deltas = rng.standard_normal((96, 4)).astype(np.float32)
        logits = rng.standard_normal(96).astype(np.float32)
    return anchors, logits, deltas, gt, gt_mask


class TestRPNLosses:
    def test_perfect_predictions_near_zero(self, rng):
        anchors, logits, deltas, gt, gt_mask = _rpn_case(rng, perfect=True)
        key = jax.random.PRNGKey(0)
        losses = pt.rpn_losses(_uniforms(key, (96,)), _t(anchors), _t(logits), _t(deltas),
                               _t(gt), _t(gt_mask))
        assert float(losses["loss_rpn_loc"]) < 1e-5
        assert float(losses["loss_rpn_cls"]) < 0.01

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_values_and_gradients_match_jax(self, seed):
        rng = np.random.default_rng(seed)
        anchors, logits, deltas, gt, gt_mask = _rpn_case(rng)
        key = jax.random.PRNGKey(seed)
        kwargs = dict(batch_size_per_image=32, smooth_l1_beta=0.1 * seed)
        lg, dl = _t(logits).requires_grad_(), _t(deltas).requires_grad_()
        got = pt.rpn_losses(_uniforms(key, (96,)), _t(anchors), lg, dl, _t(gt), _t(gt_mask),
                            **kwargs)
        want = jt.rpn_losses(key, anchors, logits, deltas, gt, gt_mask, **kwargs)
        for name in ("loss_rpn_cls", "loss_rpn_loc"):
            assert float(want[name]) > 0
            np.testing.assert_allclose(float(got[name].detach()), float(want[name]),
                                       rtol=LOSS_RTOL)
        (got["loss_rpn_cls"] + got["loss_rpn_loc"]).backward()

        def total(lg_, dl_):
            out = jt.rpn_losses(key, anchors, lg_, dl_, gt, gt_mask, **kwargs)
            return out["loss_rpn_cls"] + out["loss_rpn_loc"]

        g_logits, g_deltas = jax.grad(total, argnums=(0, 1))(jnp.asarray(logits),
                                                              jnp.asarray(deltas))
        np.testing.assert_allclose(lg.grad.numpy(), np.asarray(g_logits), equal_nan=True,
                                   **GRAD_TOL)
        np.testing.assert_allclose(dl.grad.numpy(), np.asarray(g_deltas), equal_nan=True,
                                   **GRAD_TOL)
        assert np.abs(np.asarray(g_deltas)).max() > 0


def _proposal_case(rng, n=40):
    proposals = _boxes(rng, n, size=(8.0, 16.0))
    gt = np.concatenate([proposals[:3] + 1.0, np.zeros((1, 4), np.float32)])
    gt_classes = np.asarray([3, 1, 4, 0], np.int32)
    gt_mask = np.asarray([True, True, True, False])
    mask = np.ones(n, bool)
    mask[-5:] = False  # padded proposals
    return proposals, mask, gt, gt_classes, gt_mask


class TestFastRCNNLosses:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_sampling_and_losses_match_jax(self, seed):
        rng = np.random.default_rng(seed)
        proposals, mask, gt, gt_classes, gt_mask = _proposal_case(rng)
        key = jax.random.PRNGKey(seed)
        n = proposals.shape[0] + gt.shape[0]
        kwargs = dict(num_classes=5, batch_size_per_image=16)
        got = pt.sample_proposals(_uniforms(key, (n,)), _t(proposals), _t(mask), _t(gt),
                                  _t(gt_classes), _t(gt_mask), **kwargs)
        want = jt.sample_proposals(key, proposals, mask, gt, gt_classes, gt_mask, **kwargs)
        assert got[0].shape == (n, 4)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        boxes, classes, sampled, matched = got
        assert 0 < int(sampled.sum()) <= 16 and int((classes < 5).sum()) > 0
        np.testing.assert_array_equal(classes[40:43].numpy(), [3, 1, 4])
        # the box head's outputs for the sampled proposals; one degenerate
        # foreground pair (zero-area prediction on a zero-area target)
        scores = rng.standard_normal((n, 6)).astype(np.float32)
        pred = (boxes.numpy() + rng.normal(0, 2, (n, 4))).astype(np.float32)
        matched_np = matched.numpy().copy()
        fg = np.flatnonzero(sampled.numpy() & (classes.numpy() < 5))
        pred[fg[0]] = matched_np[fg[0]] = [5.0, 5.0, 5.0, 5.0]
        sc, pb = _t(scores).requires_grad_(), _t(pred).requires_grad_()
        losses = pt.fast_rcnn_losses(sc, pb, classes, sampled, _t(matched_np), 5)
        jax_losses = jt.fast_rcnn_losses(scores, pred, np.asarray(want[1]), np.asarray(want[2]),
                                         matched_np, 5)
        for name in ("loss_cls", "loss_box_reg"):
            np.testing.assert_allclose(float(losses[name].detach()), float(jax_losses[name]),
                                       rtol=LOSS_RTOL, equal_nan=True)
        (losses["loss_cls"] + losses["loss_box_reg"]).backward()

        def total(s, p):
            out = jt.fast_rcnn_losses(s, p, np.asarray(want[1]), np.asarray(want[2]),
                                      matched_np, 5)
            return out["loss_cls"] + out["loss_box_reg"]

        g_scores, g_pred = jax.grad(total, argnums=(0, 1))(jnp.asarray(scores), jnp.asarray(pred))
        np.testing.assert_allclose(sc.grad.numpy(), np.asarray(g_scores), equal_nan=True,
                                   **GRAD_TOL)
        np.testing.assert_allclose(pb.grad.numpy(), np.asarray(g_pred), equal_nan=True,
                                   **GRAD_TOL)
        assert np.isnan(pb.grad.numpy()[fg[0]]).all()  # as JAX's: the division in where
        assert np.isfinite(pb.grad.numpy()[fg[1:]]).all()

    def test_perfect_heads(self, rng):
        proposals, mask, gt, gt_classes, gt_mask = _proposal_case(rng)
        n = proposals.shape[0] + gt.shape[0]
        boxes, classes, sampled, matched = pt.sample_proposals(
            _uniforms(jax.random.PRNGKey(0), (n,)), _t(proposals), _t(mask), _t(gt),
            _t(gt_classes), _t(gt_mask), num_classes=5)
        scores = 20.0 * torch.nn.functional.one_hot(classes.long(), 6).float()
        losses = pt.fast_rcnn_losses(scores, matched, classes, sampled, matched, 5)
        assert float(losses["loss_cls"]) < 1e-3
        assert float(losses["loss_box_reg"]) < 1e-5


# a frame of 32 x 32 at strides 4 ... 64: 86 positions x 3 anchors
FEATURES = [(8, 8), (4, 4), (2, 2), (1, 1), (1, 1)]
IN_CHANNELS = 8


def _jax_propose(rpn, params, features, training):
    run = jax.jit(lambda p, f: rpn.propose(p, f, (32, 32), training=training))
    return run(params, [jnp.asarray(f) for f in features])


def _rpn_pair(pre=(2000, 1000), post=(1000, 300)):
    jax_rpn = JaxRPN(in_channels=IN_CHANNELS, pre_nms_topk=pre, post_nms_topk=post)
    params = jax_rpn.init(jax.random.PRNGKey(0))
    port = params_from_jax(RPN(in_channels=IN_CHANNELS, pre_nms_topk=pre, post_nms_topk=post),
                           _flatten(params))
    rng = np.random.default_rng(4)
    features = [rng.standard_normal((1, h, w, IN_CHANNELS)).astype(np.float32)
                for h, w in FEATURES]
    return jax_rpn, params, port, features


class TestRPNTrainingPair:
    def test_pairs(self):
        rpn = RPN(pre_nms_topk=(2000, 1000), post_nms_topk=(1000, 300))
        assert rpn.pre_nms_topk == (2000, 1000) and rpn.post_nms_topk == (1000, 300)
        assert RPN(pre_nms_topk=200).pre_nms_topk == (200, 200)

    @pytest.mark.parametrize("training", [False, True])
    def test_propose_matches_jax(self, training):
        jax_rpn, params, port, features = _rpn_pair(pre=(200, 100), post=(60, 30))
        want = _jax_propose(jax_rpn, params, features, training)
        with torch.no_grad():
            got = port.propose([_t(f) for f in features], (32, 32), training=training)
        assert got[0].shape == (60 if training else 30, 4)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-6)

    def test_fewer_candidates_than_the_training_capacity(self):
        """258 candidates for the default training pair's 1000 slots: the
        JAX nms_padded returns 258 indices for a mask of 1000, which its
        propose cannot take; the port's propose pads the masked slots with
        the first kept box, and its first 258 equal the JAX propose's at a
        capacity of 258."""
        jax_rpn, params, port, features = _rpn_pair()
        n = 3 * sum(h * w for h, w in FEATURES)
        assert n == 258 < port.post_nms_topk[0]
        with pytest.raises(Exception):
            _jax_propose(jax_rpn, params, features, True)
        fit = JaxRPN(in_channels=IN_CHANNELS, pre_nms_topk=(2000, 1000), post_nms_topk=(n, 300))
        want = _jax_propose(fit, params, features, True)
        with torch.no_grad():
            boxes, scores, mask = port.propose([_t(f) for f in features], (32, 32),
                                               training=True)
        assert boxes.shape == (1000, 4) and scores.shape == mask.shape == (1000,)
        np.testing.assert_array_equal(mask[:n].numpy(), np.asarray(want[2]))
        assert not mask[n:].any() and int(mask.sum()) > 0
        np.testing.assert_allclose(boxes[:n].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(scores[:n].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-6)
        assert torch.isinf(scores[n:]).all()
        assert (boxes[n:] == boxes[0]).all()
