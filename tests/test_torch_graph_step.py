"""The captured steps (``utils/graphs.py``) on the CPU, where no graph is
captured: the step builders against the JAX package's jitted steps, the
counts' split into host floats and tensor counts, the static-state step
with its write-back plan run eagerly, the keys, the launch tallies, and
the refusals.

The port's ``make_vivit_step`` (top-k, and the bucketed threshold step
of ``make_bucketed_vivit_step``) and ``make_vitdet_step`` (a flush and 3
incremental frames, the "v2" and "blocked" regimes) are held against the
JAX package's jitted ``make_vivit_step``/``make_bucketed_vivit_step`` and
against ``jax.jit`` of ``ViTDet.apply`` per mode, the frame functions of
``scripts/evaluate/vitdet_vid.py``. The JAX side runs the configuration the
port implements, as ``tests/test_torch_vivit.py`` and
``tests/test_torch_detection.py`` set it. Outputs at 1e-4 (boxes 1e-3:
pixels), counts at rtol 1e-6. The graphs themselves are held on the card
(``tests/test_torch_cuda.py -k graph``, ``chip_smoke.py`` phase
``graph_paths``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.core.blocks import Block as JaxBlock
from eventful_transformer_tpu.core.blocks import EventfulBlock as JaxAVBlock
from eventful_transformer_tpu.core.blocks import EventfulTokenwiseBlock as JaxEventfulBlock
from eventful_transformer_tpu.core.counting import Counts as JaxCounts, Ctx as JaxCtx
from eventful_transformer_tpu.core.policies import TokenNormThreshold as JaxThreshold
from eventful_transformer_tpu.core.policies import TokenNormTopK as JaxTopK
from eventful_transformer_tpu.models import FactorizedViViT as JaxViViT
from eventful_transformer_tpu.models.vitdet import ViTDet as JaxViTDet
from eventful_transformer_tpu.utils import bucketing as jax_bucketing
from eventful_transformer_tpu.utils.evaluate import (
    make_bucketed_vivit_step as jax_make_bucketed_vivit_step,
    make_vivit_step as jax_make_vivit_step,
)
from eventful_transformer_tpu.utils.misc import set_policies as jax_set_policies
from eventful_transformer_tpu.utils.params import fill_like
from eventful_transformer_tpu_torch.core import indexing
from eventful_transformer_tpu_torch.core.blocks import EventfulTokenwiseBlock
from eventful_transformer_tpu_torch.core.counting import Counts, Ctx, add_counts
from eventful_transformer_tpu_torch.core.policies import TokenNormThreshold, TokenNormTopK
from eventful_transformer_tpu_torch.models import FactorizedViViT, ViTDet
from eventful_transformer_tpu_torch.ops import gate_group, gate_fused
from eventful_transformer_tpu_torch.utils import graphs
from eventful_transformer_tpu_torch.utils.evaluate import (
    make_bucketed_vivit_step,
    make_vitdet_step,
    make_vivit_step,
)
from eventful_transformer_tpu_torch.utils.misc import set_policies
from eventful_transformer_tpu_torch.utils.params import flatten_tree, params_from_jax

TOL, TOL_BOXES, COUNTS_RTOL = 1e-4, 1e-3, 1e-6


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


def _close_counts(port, ref):
    ref = JaxCounts.from_device(ref)
    assert set(port) == set(ref)
    for key in ref:
        np.testing.assert_allclose(port[key], ref[key], rtol=COUNTS_RTOL, err_msg=key)


# -- ViViT ---------------------------------------------------------------------------------


def _vivit_config(block_class="EventfulTokenwiseBlock"):
    return dict(
        classes=10, input_shape=[8, 3, 32, 32], normalize_mean=0.45, normalize_std=0.225,
        spatial_views=1, temporal_stride=2, temporal_views=2, tubelet_shape=[2, 8, 8],
        spatial_config=dict(depth=2, position_encoding_size=[4, 4], block_class=block_class,
                            block_config=dict(dim=64, heads=4, mlp_ratio=4)),
        temporal_config=dict(depth=1, position_encoding_size=[4],
                             block_config=dict(dim=64, heads=4, mlp_ratio=4)),
    )


def _vivit_pair(block_class, seed=5):
    """The JAX and the port's ViViT on the same weights, the JAX model
    forced to the port's regime."""
    jax_model = JaxViViT(**_vivit_config(block_class))
    jax_model.split_flush = True
    for blk in jax_model.modules_of_type(JaxBlock):
        blk.fused_dense_mlp = blk.fused_global_attention = True
    model = FactorizedViViT(**_vivit_config(block_class), device="cpu")
    flat, params = _perturbed(jax_model.init(jax.random.PRNGKey(0)), seed)
    params_from_jax(model, flat)
    return jax_model, model, params


def _views(seed, shape=(1, 2, 8, 3, 32, 32)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("eventful", [True, False], ids=["eventful", "dense"])
def test_vivit_step_matches_jax_jitted_step(eventful):
    """``make_vivit_step`` (the eager step on the CPU) against the JAX
    package's jitted step: "v4" at k = 8 of 17 tokens, or the dense twin."""
    jax_model, model, params = _vivit_pair("EventfulTokenwiseBlock" if eventful else "Block")
    if eventful:
        jax_set_policies(jax_model, JaxTopK, k=8)
        set_policies(model, TokenNormTopK, k=8)
        for blk in jax_model.modules_of_type(JaxEventfulBlock):
            blk.fused_gates = "v4"
    views = _views(6)
    step = make_vivit_step(model)
    assert step.graph is None  # the CPU model's step is eager
    jax_step = jax_make_vivit_step(jax_model, params)
    for _ in range(2):  # a second call of each step gives the same
        got, counts = step(torch.from_numpy(views))
        want, want_counts = jax_step(jnp.asarray(views))
        assert got.shape == (1, 10)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
        _close_counts(counts, want_counts)


def test_bucketed_vivit_step_matches_jax_jitted_step(monkeypatch):
    """``make_bucketed_vivit_step`` against the JAX package's: the paper's
    block (EventfulBlock, "v2mlp" on both), TokenNormThreshold over the
    capacities 4, 8, 17, two clips; each clip's probabilities and counts,
    and the dispatchers' escalations and frames per level."""
    made = []

    class Recording(jax_bucketing.BucketedThresholdStep):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(jax_bucketing, "BucketedThresholdStep", Recording)
    jax_model, model, params = _vivit_pair("EventfulBlock", seed=8)
    for blk in jax_model.modules_of_type(JaxAVBlock):
        blk.fused_gates = "v2mlp"
    jax_set_policies(jax_model, JaxThreshold, threshold=0.5)
    set_policies(model, TokenNormThreshold, threshold=0.5)
    config = {"bucket_capacities": [4, 8, 17]}
    step = make_bucketed_vivit_step(model, config)
    jax_step = jax_make_bucketed_vivit_step(jax_model, params, config)
    for seed in (9, 10):
        views = _views(seed)
        got, counts = step(torch.from_numpy(views))
        want, want_counts = jax_step(jnp.asarray(views))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
        _close_counts(counts, want_counts)
    (jax_dispatcher,) = made
    assert step.dispatcher.escalations == jax_dispatcher.escalations > 0
    assert step.dispatcher.frames_per_level == jax_dispatcher.frames_per_level
    assert all(s.graph is None for s in step.dispatcher._steps.values())


def test_counts_split_gives_the_eager_counts():
    """A threshold forward's counts split as a captured step keeps them,
    the host floats and the tensor counts (the saturations, the valid
    shares) stacked, give ``Ctx.counts`` exactly."""
    model = FactorizedViViT(**_vivit_config("EventfulBlock"), device="cpu")
    set_policies(model, TokenNormThreshold, threshold=0.5, capacity=8)
    ctx = Ctx(count_mode=True)
    with torch.no_grad():
        model.apply_views(ctx, torch.from_numpy(_views(11)))
    host = ctx.host_counts()
    keys, values = ctx.tensor_counts()
    assert "policy_saturated" in keys and values.shape == (len(keys),)
    assert values.dtype == torch.float32
    merged = add_counts(Counts(host), keys, values.tolist())
    assert merged == ctx.counts
    assert merged != host  # the tensor counts are not all 0
    assert Ctx(count_mode=True).tensor_counts() == ((), None)


def test_counts_are_not_read_inside_a_capture():
    ctx = Ctx(count_mode=True)
    ctx.add("policy_saturated", torch.ones(()))
    ctx.capturing = True
    with pytest.raises(RuntimeError, match="inside a capture"):
        ctx.counts
    ctx.capturing = False
    assert ctx.counts["policy_saturated"] == 1.0


# -- ViTDet --------------------------------------------------------------------------------


def _vitdet_config():
    block = dict(dim=48, heads=6, mlp_ratio=2, window_size=[2, 2], relative_embedding_size=[4, 4],
                 pool_size=2)
    backbone = dict(depth=3, position_encoding_size=[4, 4], window_indices=[0, 2],
                    block_config=block, block_class="EventfulBlock",
                    windowed_class="EventfulTokenwiseBlock", windowed_overrides=dict(pool_size=None))
    return dict(
        classes=5, input_shape=[3, 64, 64], normalize_mean=[123.675, 116.28, 103.53],
        normalize_std=[58.395, 57.12, 57.375], output_channels=32, patch_size=[16, 16],
        scale_factors=[4.0, 2.0, 1.0, 0.5], backbone_config=backbone,
        rpn_config=dict(pre_nms_topk=200, post_nms_topk=50), roi_config=dict(test_topk_per_image=20),
    )


def _vitdet_pair(regime):
    jax_model = JaxViTDet(**_vitdet_config())
    model = ViTDet(**_vitdet_config(), device="cpu")
    for blk in jax_model.backbone.blocks:
        blk.fused_window_attention = blk.fused_dense_mlp = True
    jax_set_policies(jax_model, JaxTopK, k=10)
    set_policies(model, TokenNormTopK, k=10)
    for jax_blk, blk in zip(jax_model.backbone.blocks, model.backbone.blocks):
        jax_blk.fused_gates = blk.fused_gates = regime
        if isinstance(jax_blk, JaxAVBlock):
            jax_blk.av_kernel = jax_blk.fuse_matmul_1 = True  # the port's batch-1 rule
    flat, params = _perturbed(jax_model.init(jax.random.PRNGKey(0)), seed=13)
    params_from_jax(model, flat)
    return jax_model, model, params


def _frames(seed, n=4):
    """A [0, 1] frame of 56 x 60 (padded to 64 x 64) and ``n - 1`` noisy
    copies, each (1, 3, 64, 64)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(size=(3, 56, 60)).astype(np.float32)
    out = []
    for _ in range(n):
        padded = np.zeros((1, 3, 64, 64), np.float32)
        padded[0, :, :56, :60] = np.clip(base + rng.normal(0, 0.03, base.shape), 0, 1)
        out.append(padded)
    return out


@pytest.mark.parametrize("regime", ["v2", "blocked"])
def test_vitdet_step_matches_jax_jitted_step(regime):
    """``make_vitdet_step`` over a flush and 3 incremental frames against
    ``jax.jit`` of the JAX ``ViTDet.apply``, one program per mode (the JAX
    script's ``build_step``): each frame's detections and counts, and the
    final state."""
    jax_model, model, params = _vitdet_pair(regime)

    def jitted(mode):
        @jax.jit
        def step(p, state, frame, content_hw):
            ctx = JaxCtx(count_mode=True)
            out, state = jax_model.apply(ctx, p, state, frame, content_hw=content_hw, mode=mode)
            return out, state, ctx.counts

        return step

    jax_steps = {True: jitted("flush"), False: jitted("incremental")}
    step = make_vitdet_step(model)
    assert step.graph is None
    jax_state, state = jax_model.init_state(), model.init_state(1)
    kept = 0
    for t, frame in enumerate(_frames(14)):
        want, jax_state, want_counts = jax_steps[t == 0](params, jax_state, jnp.asarray(frame),
                                                         jnp.asarray((56, 60)))
        got, state, counts = step(state, torch.from_numpy(frame), (56, 60), t == 0)
        np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
        np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
        np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]),
                                   rtol=TOL_BOXES, atol=TOL_BOXES)
        _close_counts(counts, want_counts)
        kept += int(got["mask"].sum())
    assert kept > 0
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


def _eager_loop(model, frames, aux):
    """The backbone over ``frames`` eagerly: each frame's tokens, the final
    state and the counts of the loop."""
    ctx = Ctx(count_mode=True)
    state = model.init_state(1)
    tokens = []
    with torch.no_grad():
        for t, frame in enumerate(frames):
            x = model.pre_backbone(Ctx(), torch.from_numpy(frame))
            y, state = model.apply_backbone(ctx, state, x, aux,
                                            mode="flush" if t == 0 else "incremental")
            tokens.append(y)
    return tokens, state, ctx.counts


@pytest.mark.parametrize("regime", ["v2", "blocked"])
def test_static_state_step_matches_the_eager_loop(regime):
    """The backbone's static-state step run eagerly (``capture=False``: the
    static input and state buffers and the write-back plan a graph
    replays) over a flush and 3 incremental frames, equal bit for bit to
    the eager loop, its counts summed equal to the loop's; the state each
    call returns is the step's static state, and a second video's fresh
    state is copied into it."""
    _, model, _ = _vitdet_pair(regime)
    aux = model.precompute()
    frames = _frames(15)
    tokens, state, counts = _eager_loop(model, frames, aux)
    step = graphs.GraphStep(
        model.backbone, lambda ctx, s, x, mode=None: model.apply_backbone(ctx, s, x, aux, mode=mode),
        stateful=True, capture=False)
    for video in range(2):
        s = model.init_state(1)
        total, statics, plans = Counts(), [], []
        with torch.no_grad():
            for t, frame in enumerate(frames):
                x = model.pre_backbone(Ctx(), torch.from_numpy(frame))
                y, s, c = step(s, x, mode="flush" if t == 0 else "incremental")
                assert torch.equal(y, tokens[t]), (video, t)
                total = total + c
                statics.append([leaf.data_ptr() for _, leaf in graphs.leaves(s)])
                plans.append(step.last_write_back)
        assert all(ptrs == statics[0] for ptrs in statics)
        assert _tree_equal(s, state)
        assert set(total) == set(counts)
        for key, value in counts.items():  # per-frame sums added: another association
            np.testing.assert_allclose(total[key], value, rtol=1e-12, err_msg=key)
        assert plans[0]  # the flush replaces the state's leaves
        assert all(b > 0 for plan in plans for _, b in plan)


def test_write_back_plan_copies_only_the_replaced_leaves():
    """An output leaf that is its input leaf updated in place needs no
    copy; a new tensor is copied into the input leaf; one that aliases
    another input leaf is cloned first (here the two swap)."""
    a, b, c = torch.zeros(3), torch.ones(3), torch.full((3,), 2.0)
    state = {"a": a, "b": b, "c": c}
    a.add_(1.0)
    out = {"a": a, "b": c, "c": b * 5}
    new, plan = graphs.write_back(state, out)
    assert [p for p, _ in plan] == [("b",), ("c",)] and all(n == 12 for _, n in plan)
    assert new["a"] is a and new["b"] is b and new["c"] is c
    assert b.tolist() == [2.0] * 3 and c.tolist() == [5.0] * 3
    swap = {"a": b, "b": a, "c": c}
    new, plan = graphs.write_back(state, swap)
    assert a.tolist() == [2.0] * 3 and b.tolist() == [1.0] * 3
    with pytest.raises(ValueError, match="changed its leaves"):
        graphs.write_back(state, {"a": a})
    with pytest.raises(ValueError, match="state leaf"):
        graphs.write_back(state, dict(state, c=torch.zeros(4)))


# -- keys, launches and refusals -------------------------------------------------------------


def test_the_key_follows_what_the_python_path_branches_on(monkeypatch):
    """A policy's k, a block switch, the class switch ``in_kernel_topk``,
    the module switch ``USE_PALLAS_BLEND`` and a replaced weight each
    change the key; a call with the same settings keeps it."""
    model = FactorizedViViT(**_vivit_config(), device="cpu")
    set_policies(model, TokenNormTopK, k=8)
    step = graphs.GraphStep(model, model.apply_views, capture=False)
    key = step.model_key()
    set_policies(model, TokenNormTopK, k=8)  # new policy objects, the same settings
    assert step.model_key() == key
    changes = [
        lambda: set_policies(model, TokenNormTopK, k=4),
        lambda: set_policies(model, TokenNormThreshold, threshold=0.5, capacity=8),
        lambda: setattr(model.spatial_model.backbone.blocks[0], "fused_gates", "v2mlp"),
        lambda: setattr(model.spatial_model.backbone.blocks[1], "in_kernel_topk", True),
        lambda: monkeypatch.setattr(EventfulTokenwiseBlock, "in_kernel_topk", "auto"),
        lambda: monkeypatch.setattr(indexing, "USE_PALLAS_BLEND", True),
        lambda: setattr(model, "spatial_only", True),
        lambda: setattr(model.classifier.kernel, "data", model.classifier.kernel.data.clone()),
    ]
    seen = {key}
    for change in changes:
        change()
        key = step.model_key()
        assert key not in seen
        seen.add(key)


def test_graph_launch_tallies_move_the_wrappers_counts():
    """The wrappers that count launches are found in ops/, and a tally
    taken around counted calls adds back with its sign."""
    wrappers = graphs.counting_wrappers()
    assert gate_group.gate_group_mlp in wrappers and gate_fused.ln_norms in wrappers
    before = graphs._launch_counts()
    gate_group.gate_group_mlp.launches += 3
    gate_group.gate_group_mlp.core_launches["tc"] += 3
    gate_fused.ln_norms.row_body_launches["warp"] += 2
    delta = graphs._launch_delta(before, graphs._launch_counts())
    graphs.add_launches(delta, -1)
    assert graphs._launch_counts() == before
    graphs.add_launches(delta)
    graphs.add_launches(delta, -1)
    assert graphs._launch_counts() == before


def test_capture_failure_names_the_line_of_the_port():
    """A capture's failure is reported at the deepest line of the port in
    the exception it arose from (through an exception raised while the
    capture ended)."""
    def inner():
        return indexing.coverage_from_norms(torch.zeros(2, 4), "k")

    try:
        try:
            inner()
        except TypeError:
            raise RuntimeError("capture invalidated")
    except RuntimeError as exc:
        cause, site = graphs._failure_site(exc)
    assert isinstance(cause, TypeError)
    assert site.startswith("eventful_transformer_tpu_torch/core/indexing.py:")
    assert "coverage_from_norms" in site


def test_refusals():
    """A CPU model's step builders refuse ``graph=True``; a captured step
    refuses grad mode, training, a collective in the forward (a context's
    groups, a block's ``tp_group`` or ``sequence_parallel``, a gate's
    ``norm_group``) and CPU tensors; none runs eagerly instead."""
    model = FactorizedViViT(**_vivit_config(), device="cpu")
    set_policies(model, TokenNormTopK, k=8)
    with pytest.raises(ValueError, match="needs the model on the card"):
        make_vivit_step(model, graph=True)
    det = ViTDet(**_vitdet_config(), device="cpu")
    with pytest.raises(ValueError, match="needs the model on the card"):
        make_vitdet_step(det, graph=True)
    set_policies(model, TokenNormThreshold, threshold=0.5)
    with pytest.raises(ValueError, match="needs the model on the card"):
        make_bucketed_vivit_step(model, {"bucket_capacities": [4]}, graph=True)
    set_policies(model, TokenNormTopK, k=8)
    step = graphs.GraphStep(model, model.apply_views)
    views = torch.from_numpy(_views(1))
    with pytest.raises(RuntimeError, match="grad mode"):
        step(views)
    with torch.no_grad(), pytest.raises(ValueError, match="takes CUDA tensors"):
        step(views)
    with pytest.raises(ValueError, match="Ctx.training"):
        graphs.GraphStep(model, model.apply_views, training=True)
    with pytest.raises(ValueError, match=r"ctx.groups \['seq'\]"):
        graphs.GraphStep(model, model.apply_views, groups={"seq": object()})
    block = model.spatial_model.backbone.blocks[0]
    for owner, attr in ((block, "tp_group"), (block, "sequence_parallel"),
                        (block.qkv_gate, "norm_group")):
        setattr(owner, attr, "model")
        with pytest.raises(ValueError, match=f"{attr}.*collective|collective.*{attr}"):
            graphs.GraphStep(model, model.apply_views)
        setattr(owner, attr, None)
    assert graphs.use_graph(model) is False and graphs.use_graph(model, False) is False
