"""Adaptive token sampling (ATS) in the port against the JAX package, on the
same weights and inputs, in float32 with the JAX matmuls at "highest":

- each block class with ``ats_fraction`` over a flush and 3 incremental
  steps (the dense ``Block`` over 4 frames, its ATS state carried), with
  and without the bfloat16 A.V cast: outputs, every state leaf (the
  sampled indices ``ats_last`` exactly) and every count;
- the sampling itself on planted ties at the k-th score, and the index
  stabilisation on random and unchanged sets;
- the JAX package's own ATS ViViT (``tests/test_backbone.py::TestATS``),
  dense and eventful under ``TokenNormTopFraction(0.5)``: probabilities
  and counts.

The JAX side runs its unfused CPU path (its "auto" on the CPU), the port
its plain versions; an ATS block runs unfused in the port in every mode.
Outputs and state at 1e-5 scaled, with the cast too (its A.V product
rounds to the same bfloat16 values on both sides here). Counts at rtol
1e-6.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.core import blocks as jax_blocks
from eventful_transformer_tpu.core.counting import Counts, Ctx as JaxCtx
from eventful_transformer_tpu.core.policies import TokenNormTopFraction as JaxTopFraction
from eventful_transformer_tpu.core.policies import TokenNormTopK as JaxTopK
from eventful_transformer_tpu.models import FactorizedViViT as JaxViViT
from eventful_transformer_tpu.utils.misc import set_policies as jax_set_policies
from eventful_transformer_tpu.utils.params import fill_like
from eventful_transformer_tpu_torch.core import blocks
from eventful_transformer_tpu_torch.core.backbones import ViTBackbone
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.core.policies import TokenNormTopFraction, TokenNormTopK
from eventful_transformer_tpu_torch.models import FactorizedViViT
from eventful_transformer_tpu_torch.utils.misc import set_policies
from eventful_transformer_tpu_torch.utils.params import flatten_tree, params_from_jax

B, C, HEADS, K, FRACTION = 2, 64, 4, 9, 0.7
GRID = (4, 6)
N = GRID[0] * GRID[1] + 1  # a class token, as ViViT's spatial blocks
TOL = 1e-5
CLASSES = ("Block", "EventfulTokenwiseBlock", "EventfulMatmul1Block", "EventfulBlock")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _scaled_close(port, ref, tol):
    port = port.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(port, ref, rtol=0, atol=tol * scale)


def _close_counts(port_counts, jax_ctx):
    ref = Counts.from_device(jax_ctx.counts)
    assert set(port_counts) == set(ref)
    for key in ref:
        np.testing.assert_allclose(port_counts[key], ref[key], rtol=1e-6, err_msg=key)


def _perturbed(jax_module, seed, scale=0.1):
    """The JAX module's params with every leaf perturbed (flat, numpy), so
    that LN scales and biases are not the identities they start as."""
    like = jax_module.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    flat = {
        k: (v + scale * rng.standard_normal(v.shape)).astype(np.float32)
        for k, v in flatten_tree(jax.tree_util.tree_map(np.asarray, like)).items()
    }
    return fill_like(like, flat), flat


def _block_pair(cls, cast, seed):
    kwargs = dict(dim=C, heads=HEADS, mlp_ratio=2, input_size=GRID, ats_fraction=FRACTION,
                  matmul_2_cast=cast)
    jax_blk = getattr(jax_blocks, cls)(**kwargs)
    blk = blocks.BLOCK_CLASSES[cls](**kwargs)
    if cls != "Block":
        for gate in jax_blk.gates:
            gate.policy = copy.deepcopy(JaxTopK(k=K))
        for gate in blk.gates:
            gate.policy = TokenNormTopK(k=K)
        assert blk._fused_mode(N) is False
    jax_params, flat = _perturbed(jax_blk, seed)
    params_from_jax(blk, flat)
    return jax_blk, jax_params, blk


def _frames(seed, n=N):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((B, n, C)).astype(np.float32)
    return [base + 0.3 * rng.standard_normal((B, n, C)).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("cast", [None, "bfloat16"], ids=["f32", "cast"])
@pytest.mark.parametrize("cls", CLASSES)
def test_ats_block_matches_jax_over_flush_and_steps(cls, cast):
    jax_blk, jax_params, blk = _block_pair(cls, cast, seed=1)
    n_out = blk.n_select(N)
    assert blk.out_tokens(N) == jax_blk.out_tokens(N) == n_out < N
    jax_ctx, ctx = JaxCtx(count_mode=True), Ctx(count_mode=True)
    jax_state = jax_blk.init_state(B, N)
    state = blk.init_state(B, N, torch.float32, "cpu")
    indices = []
    with torch.no_grad():
        for t, x in enumerate(_frames(2)):
            mode = "flush" if t == 0 else "incremental"
            y_ref, jax_state = jax_blk.apply(jax_ctx, jax_params, jax_state, jnp.asarray(x),
                                             mode=mode)
            y, state, _ = blk(ctx, state, torch.from_numpy(x), mode=mode)
            assert y.shape == (B, n_out, C)
            _scaled_close(y, y_ref, TOL)
            np.testing.assert_array_equal(state["ats_last"].numpy(),
                                          np.asarray(jax_state["ats_last"]))
            indices.append(state["ats_last"].clone())
    jax_state.pop("first", None)
    assert set(state) == set(jax_state)
    for group, leaves in jax_state.items():
        if group == "ats_has_last":  # a host bool in the port
            assert state[group] is True and bool(leaves)
            continue
        if not isinstance(leaves, dict):
            assert state[group].dtype == torch.int32
            np.testing.assert_array_equal(state[group].numpy(), np.asarray(leaves))
            continue
        assert set(state[group]) == set(leaves)
        for name, ref in leaves.items():
            assert tuple(state[group][name].shape) == ref.shape
            _scaled_close(state[group][name], ref, TOL)
    _close_counts(ctx.counts, jax_ctx)
    # the class token is always kept, and every frame samples n_out tokens
    for index in indices:
        assert (index == 0).any(-1).all()
        assert all(len(set(row.tolist())) == n_out for row in index)


def _planted(seed, dtype):
    """a (B, H, N, N) and v (B, H, N, d) whose scores tie exactly at the
    k-th of ``n_select`` for ATS_FRACTION 0.5 of 17 tokens (9 kept): v rows
    of norm 1, one v row for all 4 tied tokens of a head (so that their
    norms are equal bit for bit); the class column the same in every head,
    the class token, 6 distinct high values, then 4 equal ones
    straddling the cut, then low ones."""
    rng = np.random.default_rng(seed)
    n, d = 17, 16
    column = np.concatenate([[0.5], 0.9 - 0.05 * np.arange(6), [0.25] * 4, 0.1 - 0.01 * np.arange(6)])
    column = column[np.concatenate([[0], 1 + rng.permutation(n - 1)])]
    a = rng.random((2, HEADS, n, n)).astype(np.float32)
    a[..., 0] = column
    v = rng.standard_normal((2, HEADS, n, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True).astype(np.float32)
    tied = np.nonzero(column == 0.25)[0]
    v[..., tied, :] = v[..., tied[:1], :]
    if dtype == "bfloat16":
        # the values each side takes, exact in bfloat16
        a = np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
        v = np.array(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
    return a, v, column


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ats_sampling_breaks_planted_ties_as_lax_top_k(dtype):
    a, v, column = _planted(3, dtype)
    kwargs = dict(dim=C, heads=HEADS, mlp_ratio=2, input_size=(4, 4), ats_fraction=0.5)
    jax_blk, blk = jax_blocks.Block(**kwargs), blocks.Block(**kwargs)
    k = blk.n_select(17)
    tied = np.nonzero(column == 0.25)[0]
    assert k == 9 and len(tied) == 4  # 1 + 6 above, 2 of the 4 tied kept
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jax_state = jax_blk.init_state(2, 17)
    state = blk.init_state(2, 17, None, "cpu")
    ref_a, ref_index, jax_state = jax_blk._adaptive_token_sampling(
        jax_state, jnp.asarray(a, jdt), jnp.asarray(v, jdt))
    got_a, index, state = blk._adaptive_token_sampling(
        state, torch.from_numpy(a).to(tdt), torch.from_numpy(v).to(tdt))
    np.testing.assert_array_equal(index.numpy(), np.asarray(ref_index))
    kept = set(index[0].tolist())
    assert set(tied[:2]) <= kept and not set(tied[2:]) & kept  # the smallest tied indices
    np.testing.assert_array_equal(got_a.float().numpy(), np.asarray(ref_a.astype(jnp.float32)))
    np.testing.assert_array_equal(state["ats_last"].numpy(), np.asarray(jax_state["ats_last"]))
    assert state["ats_has_last"] is True and bool(jax_state["ats_has_last"])


@pytest.mark.parametrize("case", ["random", "unchanged", "disjoint"])
def test_stabilize_ats_indices_matches_jax(case):
    rng = np.random.default_rng(5)
    n, k = 40, 13
    last = np.stack([rng.permutation(n)[:k] for _ in range(6)]).astype(np.int32)
    if case == "random":
        new = np.stack([np.sort(rng.permutation(n)[:k]) for _ in range(6)]).astype(np.int32)
    elif case == "unchanged":
        new = np.sort(last, axis=-1)
    else:  # no old index survives
        new = np.stack([np.sort(np.setdiff1d(np.arange(n), row)[:k]) for row in last])
        new = new.astype(np.int32)
    ref = np.asarray(jax_blocks._stabilize_ats_indices(jnp.asarray(last), jnp.asarray(new)))
    got = blocks.stabilize_ats_indices(torch.from_numpy(last), torch.from_numpy(new))
    np.testing.assert_array_equal(got.numpy(), ref)
    if case == "unchanged":
        np.testing.assert_array_equal(got.numpy(), last)
    for row, want in zip(got.numpy(), new):
        assert sorted(row.tolist()) == want.tolist()


def _ats_vivit_config(eventful):
    """tests/test_backbone.py::TestATS's ViViT (the JAX package's own ATS
    model test), with the eventful twin's EventfulBlocks."""
    spatial = dict(depth=2, position_encoding_size=[4, 4],
                   block_config=dict(dim=32, heads=4, mlp_ratio=2, ats_fraction=0.9))
    if eventful:
        spatial["block_class"] = "EventfulBlock"
    return dict(
        classes=10, input_shape=[8, 3, 32, 32], normalize_mean=0.45, normalize_std=0.225,
        spatial_views=1, temporal_stride=2, temporal_views=2, tubelet_shape=[2, 8, 8],
        spatial_config=spatial,
        temporal_config=dict(depth=1, position_encoding_size=[4],
                             block_config=dict(dim=32, heads=4, mlp_ratio=2)),
    )


@pytest.mark.parametrize("eventful", [False, True], ids=["dense", "eventful"])
def test_ats_vivit_matches_jax(eventful, monkeypatch):
    monkeypatch.setenv("EVT_UNROLL_BLOCKS", "1")
    jax_model = JaxViViT(**_ats_vivit_config(eventful))
    jax_model.split_flush = True
    model = FactorizedViViT(**_ats_vivit_config(eventful), device="cpu")
    if eventful:
        jax_set_policies(jax_model, JaxTopFraction, fraction=0.5)
        set_policies(model, TokenNormTopFraction, fraction=0.5)
    jax_params, flat = _perturbed(jax_model, seed=7, scale=0.05)
    params_from_jax(model, flat)
    # the spatial stack shrinks 17 -> 15 -> 13 tokens
    spatial = model.spatial_model.backbone
    state = spatial.init_state(1, torch.float32, "cpu")["blocks"]
    assert [s["ats_last"].shape[-1] for s in state] == [15, 13]
    views = np.random.default_rng(8).standard_normal((1, 2, 8, 3, 32, 32)).astype(np.float32)
    jax_ctx, ctx = JaxCtx(count_mode=True), Ctx(count_mode=True)
    ref = jax_model.apply_views(jax_ctx, jax_params, jnp.asarray(views))
    with torch.no_grad():
        got = model.apply_views(ctx, torch.from_numpy(views))
    assert got.shape == (1, 10)
    _scaled_close(got, ref, TOL)
    assert float(got.sum()) == pytest.approx(1.0, abs=1e-5)
    _close_counts(ctx.counts, jax_ctx)


def test_ats_backbone_hands_no_norms_across_ats_blocks():
    """The norms handoff needs the token count to stay: no ATS block gives
    or takes the next block's qkv norms, whatever its regime."""
    from eventful_transformer_tpu_torch.core.backbones import _next_gate

    backbone = ViTBackbone(
        block_config=dict(dim=C, heads=HEADS, mlp_ratio=2), depth=2,
        position_encoding_size=list(GRID), input_size=GRID, block_class="EventfulTokenwiseBlock",
        has_class_token=True,
    )
    for blk in backbone.blocks:
        blk.fused_gates = "v2"
        for gate in blk.gates:
            gate.policy = TokenNormTopK(k=K)
    state = backbone.init_state(B, torch.float32, "cpu")["blocks"]
    x = torch.zeros(B, N, C)
    assert _next_gate(backbone.blocks[0], backbone.blocks[1], x, state[1]) is not None
    backbone.blocks[1].ats_fraction = 0.5
    assert _next_gate(backbone.blocks[0], backbone.blocks[1], x, state[1]) is None
    backbone.blocks[1].ats_fraction, backbone.blocks[0].ats_fraction = None, 0.5
    assert _next_gate(backbone.blocks[0], backbone.blocks[1], x, state[1]) is None


@pytest.mark.parametrize("options", [dict(window_size=(2, 2)), dict(pool_size=2),
                                     dict(ats_fraction=1.5)], ids=["window", "pool", "range"])
def test_ats_refuses_what_the_jax_package_asserts(options):
    kwargs = dict(dim=C, heads=HEADS, mlp_ratio=2, input_size=(4, 4), ats_fraction=0.5)
    with pytest.raises(ValueError, match="ATS"):
        blocks.Block(**{**kwargs, **options})
