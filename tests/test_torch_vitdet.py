"""The ViTDet slice of the port against the JAX package on the same weights
and inputs: the resize matrices and embeddings, one windowed
EventfulTokenwiseBlock with its window-major qkv buffer, one global
EventfulBlock with k/v pooling, the dense windowed and global blocks, and
a small ViTDet backbone through ``pre_backbone`` and ``apply_backbone``.

The JAX side runs the configuration the port implements, the TPU's "v2"
regime: ``fused_gates = "v2"`` on every eventful block, the fused window
attention and dense-MLP kernels (Pallas in interpret mode), the block
stack unrolled (``EVT_UNROLL_BLOCKS=1``) so that the norms handoff runs,
at "highest" matmul precision (tests/conftest.py). Tolerances: 2e-5 for a
block and 1e-4 for the backbone over several frames (float32 on both
sides, sums in other orders); 1e-2 where the matmul-2 cast runs the A.V
product in bfloat16 (one bfloat16 ulp is 4e-3 relative, and the two
frameworks may round a different element); counts equal at rtol 1e-6.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.core import backbones as jax_backbones
from eventful_transformer_tpu.core import blocks as jax_blocks
from eventful_transformer_tpu.core import embeddings as jax_embeddings
from eventful_transformer_tpu.core.counting import Counts, Ctx as JaxCtx
from eventful_transformer_tpu.core.policies import TokenNormTopK as JaxTopK
from eventful_transformer_tpu.models.vitdet import ViTDet as JaxViTDet
from eventful_transformer_tpu.ops import resize as jax_resize
from eventful_transformer_tpu.utils.misc import set_policies as jax_set_policies
from eventful_transformer_tpu.utils.params import fill_like
from eventful_transformer_tpu_torch.core import backbones, blocks, embeddings
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
from eventful_transformer_tpu_torch.models import ViTDet
from eventful_transformer_tpu_torch.ops import resize
from eventful_transformer_tpu_torch.utils.misc import set_policies
from eventful_transformer_tpu_torch.utils.params import flatten_tree, params_from_jax

TOL, TOL_MODEL, TOL_CAST = 2e-5, 1e-4, 1e-2


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _perturbed(like, seed, scale=0.1):
    """A JAX param tree's leaves plus noise, as a flat numpy dict and the
    JAX tree, so that LN, biases and rel-pos tables are not trivial."""
    flat = flatten_tree(jax.tree_util.tree_map(np.asarray, like))
    rng = np.random.default_rng(seed)
    flat = {k: (v + scale * rng.standard_normal(v.shape)).astype(np.float32) for k, v in flat.items()}
    return flat, fill_like(like, flat)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(
        port.detach().float().numpy(), np.asarray(ref, dtype=np.float32), rtol=tol, atol=tol
    )


def _close_counts(port_counts, jax_ctx):
    ref = Counts.from_device(jax_ctx.counts)
    assert set(port_counts) == set(ref)
    for key in ref:
        np.testing.assert_allclose(port_counts[key], ref[key], rtol=1e-6, err_msg=key)


# -- resize and embeddings -----------------------------------------------------


@pytest.mark.parametrize("sizes", [(14, 42), (64, 42), (4, 6), (7, 5)])
def test_resize_matches_jax(sizes):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, sizes[0], sizes[0] + 1)).astype(np.float32)
    out = (sizes[1], sizes[1] + 2)
    np.testing.assert_allclose(
        resize.resize_matrix_bicubic(*sizes), jax_resize._resize_matrix_bicubic(*sizes)
    )
    _close(resize.resize_bicubic(torch.from_numpy(x), out), jax_resize.resize_bicubic(jnp.asarray(x), out))
    _close(
        resize.resize_bicubic_1d(torch.from_numpy(x), sizes[1]),
        jax_resize.resize_bicubic_1d(jnp.asarray(x), sizes[1]),
    )
    y = x[..., :4, :4]
    _close(resize.avg_pool_2d(torch.from_numpy(y), (2, 2)), jax_resize.avg_pool_2d(jnp.asarray(y), (2, 2)))
    _close(resize.avg_pool_1d(torch.from_numpy(y), 2), jax_resize.avg_pool_1d(jnp.asarray(y), 2))


@pytest.mark.parametrize(
    "encoding,inputs,cls", [([4, 4], [6, 6], False), ([4, 4], [6, 5], True), ([4], [7], True)]
)
def test_position_encoding_resize_matches_jax(encoding, inputs, cls):
    jax_pe = jax_embeddings.PositionEncoding(8, encoding, inputs, cls)
    flat, params = _perturbed(jax_pe.init(jax.random.PRNGKey(0)), seed=1)
    pe = embeddings.PositionEncoding(8, encoding, inputs, cls)
    params_from_jax(pe, flat)
    _close(pe.precompute(), jax_pe.precompute(params))


@pytest.mark.parametrize(
    "attention,embedding,pool",
    [((3, 3), (3, 3), None), ((6, 6), (8, 8), (2, 2)), ((6, 4), (6, 4), None)],
    ids=["window", "resized_pooled", "rect"],
)
def test_relative_position_matches_jax(attention, embedding, pool):
    hd, heads = 8, 2
    jax_rp = jax_embeddings.RelativePositionEmbedding(attention, embedding, hd, pool)
    flat, params = _perturbed(jax_rp.init(jax.random.PRNGKey(0)), seed=2, scale=1.0)
    rp = embeddings.RelativePositionEmbedding(attention, embedding, hd, pool)
    params_from_jax(rp, flat)
    ref, derived = jax_rp.precompute(params), rp.precompute()
    for key in ("y_relative", "x_relative"):
        _close(derived[key], ref[key])
    if "window_tab" in ref:
        _close(rp.window_tab(derived, torch.float32), ref["window_tab"])
    n = attention[0] * attention[1]
    rng = np.random.default_rng(3)
    p = rp.pooled_size()
    logits = rng.standard_normal((2, heads, n, p[0] * p[1])).astype(np.float32)
    q = rng.standard_normal((2, heads, n, hd)).astype(np.float32)
    jax_ctx, ctx = JaxCtx(count_mode=True), Ctx(count_mode=True)
    want = jax_rp.apply(jax_ctx, params, jnp.asarray(logits), jnp.asarray(q), ref)
    got = rp(ctx, torch.from_numpy(logits), torch.from_numpy(q), derived)
    _close(got, want)
    _close_counts(ctx.counts, jax_ctx)
    _close(rp.bias_terms(Ctx(), torch.from_numpy(q), derived),
           jax_rp.bias_terms(JaxCtx(), jnp.asarray(q), ref))


# -- blocks ------------------------------------------------------------------------


def _block_pair(cls_name, seed, policy_k=None, **kwargs):
    jax_blk = getattr(jax_blocks, cls_name)(**kwargs)
    blk = getattr(blocks, cls_name)(**kwargs)
    if policy_k is not None:
        jax_blk.fused_gates, blk.fused_gates = "v2", "v2"
        for gate in jax_blk.modules_of_type(jax_blocks.TokenGate):
            gate.policy = copy.deepcopy(JaxTopK(k=policy_k))
        set_policies(blk, TokenNormTopK, k=policy_k)
    jax_blk.fused_window_attention = jax_blk.fused_dense_mlp = True
    flat, params = _perturbed(jax_blk.init(jax.random.PRNGKey(0)), seed)
    params_from_jax(blk, flat)
    return jax_blk, blk, params


def _run_pair(jax_blk, blk, params, xs, tol):
    """Flush then incremental steps in both packages; outputs compared each
    step. Returns the final JAX state, the port state and both contexts."""
    b, n, _ = xs[0].shape
    jax_ctx, ctx = JaxCtx(count_mode=True), Ctx(count_mode=True)
    jax_state = jax_blk.init_state(b, n)
    state = blk.init_state(b, n, torch.float32, "cpu")
    aux = jax_blk.precompute(params)
    with torch.no_grad():
        for t, x in enumerate(xs):
            mode = "flush" if t == 0 else "incremental"
            y_ref, jax_state = jax_blk.apply(jax_ctx, params, jax_state, jnp.asarray(x), aux, mode=mode)
            y, state, _ = blk(ctx, state, torch.from_numpy(x), mode=mode)
            _close(y, y_ref, tol)
    jax_state.pop("first", None)
    return jax_state, state, jax_ctx, ctx


def _frames(shape, seed, steps=4):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(shape).astype(np.float32)
    return [base + 0.3 * rng.standard_normal(shape).astype(np.float32) for _ in range(steps)]


@pytest.mark.parametrize("input_size", [(6, 6), (4, 5)], ids=["6x6", "padded_4x5"])
def test_windowed_block_resident_v2_matches_jax(input_size):
    """A windowed EventfulTokenwiseBlock in the "v2" regime over a flush
    and 3 incremental steps: outputs, the gate states, the window-major
    qkv buffer (pad rows holding the qkv bias row) and the counts."""
    window = (3, 3) if input_size == (6, 6) else (2, 3)
    kwargs = dict(dim=32, heads=4, mlp_ratio=2, input_size=input_size, window_size=window,
                  relative_embedding_size=[8, 8])
    jax_blk, blk, params = _block_pair("EventfulTokenwiseBlock", 4, policy_k=7, **kwargs)
    n = input_size[0] * input_size[1]
    assert jax_blk._resident_qkv(n) and blk._resident_qkv(n)
    jax_state, state, jax_ctx, ctx = _run_pair(jax_blk, blk, params, _frames((2, n, 32), 5), TOL)
    assert set(state) == set(jax_state)
    for group, leaves in jax_state.items():
        assert set(state[group]) == set(leaves)
        for name, ref in leaves.items():
            _close(state[group][name], ref)
    assert state["qkv_accumulator"]["b"].shape[1] == blk._resident_rows()
    _close_counts(ctx.counts, jax_ctx)


@pytest.mark.parametrize("cast", [None, "bfloat16"], ids=["f32", "cast_bf16"])
def test_global_eventful_block_pooled_matches_jax(cast):
    """A global EventfulBlock with k/v pool 2 and rel-pos in the "v2"
    regime (gate_group_linear for the qkv and projection groups, the index
    path for the pooled A.V recompute) over a flush and 3 incremental
    steps."""
    kwargs = dict(dim=32, heads=4, mlp_ratio=2, input_size=(6, 6), pool_size=2,
                  relative_embedding_size=[8, 8], matmul_2_cast=cast)
    jax_blk, blk, params = _block_pair("EventfulBlock", 6, policy_k=8, **kwargs)
    tol = TOL if cast is None else TOL_CAST
    jax_state, state, jax_ctx, ctx = _run_pair(jax_blk, blk, params, _frames((2, 36, 32), 7), tol)
    assert set(state) == set(jax_state)
    for group, leaves in jax_state.items():
        for name, ref in leaves.items():
            assert state[group][name].dtype == torch.float32 or cast is not None
            _close(state[group][name], ref, tol)
    _close_counts(ctx.counts, jax_ctx)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(window_size=[3, 3], relative_embedding_size=[8, 8]),
        dict(window_size=[2, 3], relative_embedding_size=[8, 8], input_size=(4, 5)),
        dict(relative_embedding_size=[8, 8]),
        dict(relative_embedding_size=[8, 8], pool_size=2, matmul_2_cast="bfloat16"),
    ],
    ids=["windowed", "windowed_padded", "global_relpos", "global_pooled_cast"],
)
def test_dense_vitdet_blocks_match_jax(kwargs):
    kwargs = dict(dict(dim=32, heads=4, mlp_ratio=2, input_size=(6, 6)), **kwargs)
    jax_blk, blk, params = _block_pair("Block", 8, **kwargs)
    n = kwargs["input_size"][0] * kwargs["input_size"][1]
    x = np.random.default_rng(9).standard_normal((2, n, 32)).astype(np.float32)
    jax_ctx, ctx = JaxCtx(count_mode=True), Ctx(count_mode=True)
    y_ref, _ = jax_blk.apply(jax_ctx, params, {}, jnp.asarray(x), jax_blk.precompute(params))
    with torch.no_grad():
        y, _, _ = blk(ctx, {}, torch.from_numpy(x))
    _close(y, y_ref, TOL_CAST if kwargs.get("matmul_2_cast") else TOL)
    _close_counts(ctx.counts, jax_ctx)


# -- the norms handoff rule ---------------------------------------------------------


def _handoff_case(case):
    """(block, next block) pairs in both packages, and the token count."""
    kw = dict(dim=32, heads=4, mlp_ratio=2, input_size=(6, 6))
    win = dict(kw, window_size=[3, 3])
    pairs = []
    for pkg in (jax_blocks, blocks):
        if case == "v2_windowed_to_global":
            a, b = pkg.EventfulTokenwiseBlock(**win), pkg.EventfulBlock(**kw, pool_size=2)
        elif case in ("v4_windowed_is_v2mlp", "order_1_next"):
            a, b = pkg.EventfulTokenwiseBlock(**win), pkg.EventfulTokenwiseBlock(**win)
        else:  # "dense_next"
            a, b = pkg.EventfulTokenwiseBlock(**win), pkg.Block(**win)
        for blk in (a, b):
            if hasattr(blk, "qkv_gate"):
                blk.fused_gates = "v4" if case == "v4_windowed_is_v2mlp" else "v2"
                gate_cls = JaxTopK if pkg is jax_blocks else TokenNormTopK
                for gate in blk.gates:
                    gate.policy = gate_cls(k=8, order=1 if case == "order_1_next" and blk is b else 2)
        pairs.append((a, b))
    return pairs, 36


@pytest.mark.parametrize(
    "case,passes",
    [("v2_windowed_to_global", True), ("v4_windowed_is_v2mlp", False),
     ("order_1_next", False), ("dense_next", False)],
)
def test_next_gate_rule_matches_jax(case, passes):
    """The port hands the next block's qkv-gate state to a block's last
    kernel exactly where the JAX rule does: not for a block in the
    "v2mlp" regime, nor for a next gate whose policy is not order 2."""
    pairs, n = _handoff_case(case)
    (jax_a, jax_b), (a, b) = pairs
    jax_next_state = jax_b.init_state(2, n)
    next_state = b.init_state(2, n, torch.float32, "cpu")
    x = np.zeros((2, n, 32), np.float32)
    jax_params = jax_b.init(jax.random.PRNGKey(0))
    ref = jax_backbones.ViTBackbone._next_gate_info(jax_a, jax_b, jnp.asarray(x), jax_next_state, jax_params)
    got = backbones._next_gate(a, b, torch.from_numpy(x), next_state)
    assert (ref is not None) == passes
    assert (got is not None) == passes
    if passes:
        assert got[0] is next_state["qkv_gate"]["p"] and got[1] is b.input_layer_norm.scale


# -- a small ViTDet backbone ------------------------------------------------------------


def _vitdet_config(eventful):
    block = dict(dim=32, heads=4, mlp_ratio=2, window_size=[3, 3], relative_embedding_size=[8, 8])
    backbone = dict(depth=4, position_encoding_size=[4, 4], window_indices=[0, 2], block_config=block)
    if eventful:
        block.update(pool_size=2)
        backbone.update(block_class="EventfulBlock", windowed_class="EventfulTokenwiseBlock",
                        windowed_overrides=dict(pool_size=None, matmul_2_cast=None))
    return dict(
        backbone_config=backbone, classes=5, input_shape=[3, 96, 96],
        normalize_mean=[123.675, 116.28, 103.53], normalize_std=[58.395, 57.12, 57.375],
        output_channels=16, patch_size=[16, 16], scale_factors=[4.0, 2.0, 1.0, 0.5],
        rpn_config=dict(pre_nms_topk=50, post_nms_topk=20), roi_config=dict(test_topk_per_image=10),
    )


@pytest.mark.parametrize("eventful", [True, False], ids=["eventful", "dense"])
def test_vitdet_backbone_matches_jax(eventful, monkeypatch):
    """A 6 x 6 token grid (96 x 96 frames, patch 16) with 3 x 3 windows:
    blocks 0 and 2 windowed, 1 and 3 global (EventfulBlock with pool 2 when
    eventful), 2 streams over a flush and 3 incremental frames, from
    ``pre_backbone`` through ``apply_backbone``, on the same weights."""
    monkeypatch.setenv("EVT_UNROLL_BLOCKS", "1")
    jax_model = JaxViTDet(**_vitdet_config(eventful))
    model = ViTDet(**_vitdet_config(eventful), device="cpu")
    for blk in jax_model.backbone.blocks:
        blk.fused_window_attention = blk.fused_dense_mlp = True
    if eventful:
        jax_set_policies(jax_model, JaxTopK, k=12)
        set_policies(model, TokenNormTopK, k=12)
        for jax_blk, blk in zip(jax_model.backbone.blocks, model.backbone.blocks):
            jax_blk.fused_gates = blk.fused_gates = "v2"
    flat, params = _perturbed(jax_model.init(jax.random.PRNGKey(0)), seed=10, scale=0.05)
    params_from_jax(model, flat)
    rng = np.random.default_rng(11)
    base = rng.uniform(size=(2, 3, 90, 96)).astype(np.float32)  # padded to 96 x 96
    frames = [np.clip(base + 0.1 * rng.standard_normal(base.shape), 0, 1).astype(np.float32)
              for _ in range(4)]
    jax_ctx, ctx = JaxCtx(count_mode=True), Ctx(count_mode=True)
    jax_state, state = jax_model.init_state(2), model.init_state(2)
    aux, port_aux = jax_model.precompute(params), model.precompute()
    for t, frame in enumerate(frames):
        mode = ("flush" if t == 0 else "incremental") if eventful else None
        tokens_ref = jax_model.pre_backbone(jax_ctx, params, jnp.asarray(frame))
        out_ref, jax_state = jax_model.apply_backbone(jax_ctx, params, jax_state, tokens_ref, aux, mode=mode)
        tokens = model.pre_backbone(ctx, torch.from_numpy(frame))
        _close(tokens, tokens_ref, TOL)
        out, state = model.apply_backbone(ctx, state, tokens, port_aux, mode=mode)
        assert out.shape == (2, 36, 32)
        _close(out, out_ref, TOL_MODEL)
    _close_counts(ctx.counts, jax_ctx)
    if eventful:
        assert ctx.counts["accumulator_flops"] > 0
        for jax_s, s in zip(jax_state["blocks"], state["blocks"]):
            for group, leaves in jax_s.items():
                if group != "first":
                    for name, ref in leaves.items():
                        _close(s[group][name], ref, TOL_MODEL)


def test_vitdet_head_not_ported():
    """Every ROI head configuration is ported: the standard heads
    (tests/test_torch_detection.py) and the COCO cascade with its mask head
    (tests/test_torch_coco_heads.py), which no longer raises."""
    from eventful_transformer_tpu_torch.detection.roi_heads import CascadeROIHeads

    config = _vitdet_config(False)
    config["roi_config"] = dict(config["roi_config"], cascade=True, with_mask=True)
    heads = ViTDet(**config, device="cpu").roi_heads
    assert isinstance(heads, CascadeROIHeads) and heads.mask_head is not None
