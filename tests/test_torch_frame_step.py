"""The whole ViTDet frame as one step on the CPU, where no graph is
captured: ``ViTDet.frame_step``'s body (``frame_run``: the preprocessing,
the backbone and the detection head) through ``GraphStep(...,
capture=False)``, the static input buffers, the static state and the
write-back plan a graph replays, run eagerly; the bucketed ViTDet ladder
on that static state; the COCO cascade with its mask head in the step; and
the cached ROIAlign tables.

Each is held against the JAX package: ``jax.jit`` of the JAX
``ViTDet.apply`` per mode (the frame functions of
``scripts/evaluate/vitdet_vid.py``), the JAX ``BucketedThresholdStep`` over
those jitted programs, and the JAX ``multilevel_roi_align``. The JAX side
runs the configuration the port implements, as
``tests/test_torch_graph_step.py`` sets it. Tolerances, float32 at
"highest" matmul precision: scores and state 1e-4, boxes 1e-3 (pixels of a
64 x 64 image), masks 1e-3, ROIAlign 1e-5 (sums in other orders); labels,
the valid mask, escalations and frames per level exactly; counts at rtol
1e-6. The static step against the eager step of ``make_vitdet_step``: bit
for bit. The graphs themselves are held on the card
(``tests/test_torch_cuda.py -k frame_graph``, ``chip_smoke.py`` phase
``graph_paths``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.core.blocks import EventfulBlock as JaxAVBlock
from eventful_transformer_tpu.core.counting import Counts as JaxCounts, Ctx as JaxCtx
from eventful_transformer_tpu.core.policies import TokenNormThreshold as JaxThreshold
from eventful_transformer_tpu.core.policies import TokenNormTopK as JaxTopK
from eventful_transformer_tpu.detection import roi_align as jax_roi_align
from eventful_transformer_tpu.models.vitdet import ViTDet as JaxViTDet
from eventful_transformer_tpu.utils import bucketing as jax_bucketing
from eventful_transformer_tpu.utils.misc import set_policies as jax_set_policies
from eventful_transformer_tpu.utils.params import fill_like
from eventful_transformer_tpu_torch.core.policies import TokenNormThreshold, TokenNormTopK
from eventful_transformer_tpu_torch.detection import roi_align
from eventful_transformer_tpu_torch.models import ViTDet
from eventful_transformer_tpu_torch.utils import bucketing, graphs
from eventful_transformer_tpu_torch.utils.evaluate import make_vitdet_eval_step, make_vitdet_step
from eventful_transformer_tpu_torch.utils.misc import set_policies
from eventful_transformer_tpu_torch.utils.params import flatten_tree, params_from_jax

TOL, TOL_BOXES, COUNTS_RTOL = 1e-4, 1e-3, 1e-6
CONTENT_HW = (56, 60)


@pytest.fixture(autouse=True)
def _threads(monkeypatch):
    torch.set_num_threads(2)
    monkeypatch.setenv("EVT_UNROLL_BLOCKS", "1")


def _perturbed(like, seed, scale=0.05):
    flat = flatten_tree(jax.tree_util.tree_map(np.asarray, like))
    rng = np.random.default_rng(seed)
    flat = {k: (v + scale * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in flat.items()}
    return flat, fill_like(like, flat)


def _config(cascade=False):
    block = dict(dim=48, heads=6, mlp_ratio=2, window_size=[2, 2], relative_embedding_size=[4, 4],
                 pool_size=2)
    backbone = dict(depth=3, position_encoding_size=[4, 4], window_indices=[0, 2],
                    block_config=block, block_class="EventfulBlock",
                    windowed_class="EventfulTokenwiseBlock", windowed_overrides=dict(pool_size=None))
    roi = dict(test_topk_per_image=20)
    if cascade:
        roi.update(cascade=True, with_mask=True)
    return dict(
        classes=5, input_shape=[3, 64, 64], normalize_mean=[123.675, 116.28, 103.53],
        normalize_std=[58.395, 57.12, 57.375], output_channels=32, patch_size=[16, 16],
        scale_factors=[4.0, 2.0, 1.0, 0.5], backbone_config=backbone,
        rpn_config=dict(pre_nms_topk=200, post_nms_topk=50), roi_config=roi,
    )


def _pair(regime, cascade=False, policy=(JaxTopK, TokenNormTopK, dict(k=10))):
    """The JAX and the port's ViTDet on the same weights, both in
    ``regime``."""
    jax_model = JaxViTDet(**_config(cascade))
    model = ViTDet(**_config(cascade), device="cpu")
    for blk in jax_model.backbone.blocks:
        blk.fused_window_attention = blk.fused_dense_mlp = True
    jax_policy, port_policy, kwargs = policy
    jax_set_policies(jax_model, jax_policy, **kwargs)
    set_policies(model, port_policy, **kwargs)
    for jax_blk, blk in zip(jax_model.backbone.blocks, model.backbone.blocks):
        jax_blk.fused_gates = blk.fused_gates = regime
        if isinstance(jax_blk, JaxAVBlock):
            jax_blk.av_kernel = jax_blk.fuse_matmul_1 = True  # the port's batch-1 rule
    flat, params = _perturbed(jax_model.init(jax.random.PRNGKey(0)), seed=13)
    params_from_jax(model, flat)
    return jax_model, model, params


def _frames(seed, n=4, noise=0.03):
    """A [0, 1] frame of 56 x 60 padded to 64 x 64, and ``n - 1`` noisy
    copies, each (1, 3, 64, 64)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(size=(3,) + CONTENT_HW).astype(np.float32)
    out = []
    for _ in range(n):
        padded = np.zeros((1, 3, 64, 64), np.float32)
        padded[0, :, :56, :60] = np.clip(base + rng.normal(0, noise, base.shape), 0, 1)
        out.append(padded)
    return out


def _jax_steps(jax_model):
    """``jax.jit`` of ``ViTDet.apply``, one program per mode, as the JAX
    script's ``build_step``: (state, frame, content_hw, first) -> (out,
    state, counts)."""

    def jitted(mode):
        @jax.jit
        def step(p, state, frame, content_hw):
            ctx = JaxCtx(count_mode=True)
            out, state = jax_model.apply(ctx, p, state, frame, content_hw=content_hw, mode=mode)
            return out, state, ctx.counts

        return step

    return {True: jitted("flush"), False: jitted("incremental")}


def _static_step(model):
    """The frame step's body through the static-buffer step, eagerly."""
    return graphs.GraphStep(model, model.frame_run(model.precompute()), stateful=True,
                            capture=False, name="vitdet frame step")


def _close_counts(port, ref):
    ref = JaxCounts.from_device(ref)
    assert set(port) == set(ref)
    for key in ref:
        np.testing.assert_allclose(port[key], ref[key], rtol=COUNTS_RTOL, err_msg=key)


def _close_detections(got, want):
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=TOL_BOXES,
                               atol=TOL_BOXES)
    if "masks" in want:
        np.testing.assert_allclose(got["masks"].numpy(), np.asarray(want["masks"]),
                                   rtol=TOL_BOXES, atol=TOL_BOXES)


def _close_state(state, jax_state):
    for jax_s, s in zip(jax_state["blocks"], state["blocks"]):
        for group, leaves in jax_s.items():
            if group == "first":
                continue
            for name, ref in leaves.items():
                np.testing.assert_allclose(s[group][name].numpy(), np.asarray(ref), rtol=TOL,
                                           atol=TOL, err_msg=f"{group}/{name}")


def _tree_equal(a, b):
    la, lb = list(graphs.leaves(a)), list(graphs.leaves(b))
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))


@pytest.mark.parametrize("regime", ["v2", "blocked"])
def test_frame_step_matches_jax_jitted_step(regime):
    """A flush and 3 incremental frames through the static-buffer frame
    step (``content_hw`` an int32 tensor) and through ``make_vitdet_step``'s
    eager step (``content_hw`` a tuple), each against ``jax.jit`` of the
    JAX ``ViTDet.apply`` per mode: every frame's detections and counts, and
    the final state; the two port steps equal bit for bit, and the state
    each static call returns is the step's static state."""
    jax_model, model, params = _pair(regime)
    jax_steps = _jax_steps(jax_model)
    static, eager = _static_step(model), make_vitdet_step(model)
    assert eager.graph is None
    jax_state = jax_model.init_state()
    states = {"static": model.init_state(1), "eager": model.init_state(1)}
    hw = torch.tensor(CONTENT_HW, dtype=torch.int32)
    kept, addresses = 0, []
    for t, frame in enumerate(_frames(14)):
        want, jax_state, want_counts = jax_steps[t == 0](params, jax_state, jnp.asarray(frame),
                                                         jnp.asarray(CONTENT_HW))
        with torch.no_grad():
            got, states["static"], counts = static(
                states["static"], torch.from_numpy(frame), hw,
                mode="flush" if t == 0 else "incremental")
        other, states["eager"], other_counts = eager(states["eager"], torch.from_numpy(frame),
                                                     CONTENT_HW, t == 0)
        _close_detections(got, want)
        _close_counts(counts, want_counts)
        assert _tree_equal(got, other) and counts == other_counts
        addresses.append([leaf.data_ptr() for _, leaf in graphs.leaves(states["static"])])
        kept += int(got["mask"].sum())
    assert kept > 0
    assert all(a == addresses[0] for a in addresses)
    _close_state(states["static"], jax_state)
    assert _tree_equal(states["static"], states["eager"])


def _ladder_frames():
    """Seven frames whose later ones change more and more, so that the
    threshold policy saturates the small capacities in some frames."""
    rng = np.random.default_rng(31)
    base = rng.uniform(size=(3,) + CONTENT_HW).astype(np.float32)
    out = []
    for t, noise in enumerate((0.0, 0.01, 0.3, 0.02, 0.5, 0.01, 0.2)):
        padded = np.zeros((1, 3, 64, 64), np.float32)
        padded[0, :, :56, :60] = np.clip(base + rng.normal(0, noise, base.shape), 0, 1)
        out.append(padded)
    return out


LADDER_THRESHOLD, LADDER = 2.0, [4, 8, 16]


def test_bucketed_ladder_on_the_static_state_matches_jax(monkeypatch):
    """The bucketed ViTDet ladder, one static-buffer frame step for every
    capacity (all sharing its static state, as the captured ladder does),
    against the JAX ``BucketedThresholdStep`` over jitted programs: each
    frame's detections and counts, the escalations and the frames per
    level, with frames that escalate (a run whose state were not restored
    before its rerun would fail), and the final state; the eager ladder of
    ``make_vitdet_eval_step`` gives the same bit for bit."""
    made = []

    class Recording(jax_bucketing.BucketedThresholdStep):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(jax_bucketing, "BucketedThresholdStep", Recording)
    policy = (JaxThreshold, TokenNormThreshold, dict(threshold=LADDER_THRESHOLD))
    jax_model, model, params = _pair("v2", policy=policy)
    jax_steps = _jax_steps(jax_model)

    def jax_build(_capacity=None):
        # rebuilt per capacity: a jitted program bakes in the policies
        steps = _jax_steps(jax_model)
        return lambda state, frame, hw, first: steps[first](params, state, frame, hw)

    del jax_steps
    jax_ladder = jax_bucketing.BucketedThresholdStep(jax_model, jax_build, LADDER_THRESHOLD,
                                                     LADDER)
    static = _static_step(model)

    def step(state, frame, content_hw, first):
        with torch.no_grad():
            return static(state, frame, content_hw, mode="flush" if first else "incremental")

    ladder = bucketing.BucketedThresholdStep(model, lambda _capacity=None: step,
                                             LADDER_THRESHOLD, LADDER)
    eager = make_vitdet_eval_step(model, {"bucket_capacities": LADDER})
    jax_state, state, eager_state = jax_model.init_state(), model.init_state(1), \
        model.init_state(1)
    hw = torch.tensor(CONTENT_HW, dtype=torch.int32)
    eager.reset()
    for t, frame in enumerate(_ladder_frames()):
        want, jax_state, want_counts = jax_ladder(jax_state, jnp.asarray(frame),
                                                  jnp.asarray(CONTENT_HW), t == 0)
        got, state, counts = ladder(state, torch.from_numpy(frame), hw, t == 0)
        other, eager_state, other_counts = eager(eager_state, torch.from_numpy(frame), hw,
                                                 t == 0)
        _close_detections(got, want)
        _close_counts(counts, want_counts)
        assert _tree_equal(got, other) and counts == other_counts
    assert ladder.escalations == jax_ladder.escalations > 0
    assert ladder.frames_per_level == jax_ladder.frames_per_level
    assert eager.escalations == ladder.escalations
    assert eager.frames_per_level == ladder.frames_per_level
    assert sum(ladder.frames_per_level[:-1]) > 0  # some frames stayed below the top
    assert len(static._states) == 1  # one static state for every capacity
    _close_state(state, jax_state)
    assert _tree_equal(state, eager_state)


def test_cascade_frame_with_mask_head_matches_jax():
    """The COCO heads (the 3-stage cascade and the mask head) inside the
    static-buffer frame step, a flush and 2 incremental frames, against
    ``jax.jit`` of the JAX ``ViTDet.apply``: detections with their 28 x 28
    masks, and counts."""
    jax_model, model, params = _pair("v2", cascade=True)
    jax_steps = _jax_steps(jax_model)
    static = _static_step(model)
    jax_state, state = jax_model.init_state(), model.init_state(1)
    hw = torch.tensor(CONTENT_HW, dtype=torch.int32)
    kept = 0
    for t, frame in enumerate(_frames(21, n=3)):
        want, jax_state, want_counts = jax_steps[t == 0](params, jax_state, jnp.asarray(frame),
                                                         jnp.asarray(CONTENT_HW))
        with torch.no_grad():
            got, state, counts = static(state, torch.from_numpy(frame), hw,
                                        mode="flush" if t == 0 else "incremental")
        assert set(got) == {"boxes", "scores", "labels", "mask", "masks"}
        assert got["masks"].shape == (20, 28, 28)
        _close_detections(got, want)
        _close_counts(counts, want_counts)
        kept += int(got["mask"].sum())
    assert kept > 0


def test_cached_roi_align_tables_match_jax(monkeypatch):
    """``multilevel_roi_align`` on the cached per-level tables against the
    JAX function at 1e-5, on two pyramids: each set of shapes makes its
    tables once (a second call reuses the same tensors), with the numpy
    values the tables were built from."""
    monkeypatch.setattr(roi_align, "_LEVEL_TABLES", {})
    rng = np.random.default_rng(5)
    scales = (1 / 4, 1 / 8, 1 / 16, 1 / 32)
    for made, size in enumerate((64, 96), start=1):
        features = [rng.standard_normal((size // s, size // s, 8)).astype(np.float32)
                    for s in (4, 8, 16, 32)]
        xy = rng.uniform(0, size * 0.8, (40, 2))
        wh = rng.uniform(2, size, (40, 2))
        boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        want = jax_roi_align.multilevel_roi_align(
            [jnp.asarray(f) for f in features], jnp.asarray(boxes), scales, 2, 5)
        tensors = [torch.from_numpy(f) for f in features]
        got = roi_align.multilevel_roi_align(tensors, torch.from_numpy(boxes), scales, 2, 5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        assert len(roi_align._LEVEL_TABLES) == made
        shapes = [tuple(f.shape[:2]) for f in features]
        tables = dict(roi_align.level_tables(shapes, scales, "cpu"))
        again = roi_align.multilevel_roi_align(tensors, torch.from_numpy(boxes), scales, 2, 5)
        assert torch.equal(again, got) and len(roi_align._LEVEL_TABLES) == made
        assert all(a is tables[k] for k, a in roi_align.level_tables(shapes, scales, "cpu").items())
        heights = [h for h, _ in shapes]
        assert tables["height"].tolist() == heights and tables["width_i"].tolist() == heights
        assert tables["offset"].tolist() == [0] + np.cumsum([h * h for h in heights])[:-1].tolist()
        assert tables["scale"].tolist() == [float(np.float32(s)) for s in scales]
        assert tables["scale"].dtype == torch.float32 and tables["offset"].dtype == torch.int64


def test_content_hw_as_tensor_or_tuple_and_constants_on_the_model():
    """``pre_backbone`` gives the same tokens for ``content_hw`` as an int32
    tensor and as a tuple; the normalisation constants stay float32 and
    move with the model."""
    model = ViTDet(**_config(), device="cpu")
    frame = torch.from_numpy(_frames(3, n=1)[0])
    with torch.no_grad():
        a = model.pre_backbone(None, frame, torch.tensor(CONTENT_HW, dtype=torch.int32))
        b = model.pre_backbone(None, frame, CONTENT_HW)
        c = model.pre_backbone(None, frame)
    assert torch.equal(a, b) and not torch.equal(a, c)
    model.to(torch.bfloat16)
    assert model.preprocessing.mean.dtype == model.preprocessing.std.dtype == torch.float32
    assert model.preprocessing.mean.device == model.embedding.kernel.device
