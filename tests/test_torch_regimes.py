"""One eventful block over a flush and three incremental steps in every
incremental regime the port runs at N <= 512, in the port against the JAX
package on the same weights and inputs: {EventfulTokenwiseBlock,
EventfulBlock, EventfulBlock with the bfloat16 matmul-2 cast} x {"v2mlp",
"v1", "v1v2", "v3", False}, and EventfulBlock with the reference's cached
q.kT product through the A.V kernel's logits form (``recompute_product =
False``, ``av_kernel = True``) and with the delta-accumulated A.V product
(``recompute_av = False``); and ``EventfulMatmul1Block`` (the A.V ablation,
configs/evaluate/vitdet_vid/_ablate_av.yml) with rel-pos in {"v2mlp", "v2",
"blocked", False} x {k/v pool 2, none} x {the bfloat16 cast, none} x
{``recompute_product`` True, False}.

The JAX block runs the same regime forced (``fused_gates``), its Pallas
kernels in interpret mode, at "highest" matmul precision
(tests/conftest.py); the port runs the kernels' plain versions. Outputs
and every state leaf at 2e-5 (float32 on both sides, sums in other
orders), 1e-2 with the cast (the A.V product in bfloat16: one ulp is
4e-3 relative, and the two frameworks may round a different element);
every count key at rtol 1e-6.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.core import blocks as jax_blocks
from eventful_transformer_tpu.core.counting import Counts, Ctx as JaxCtx
from eventful_transformer_tpu.core.policies import TokenNormTopK as JaxTopK
from eventful_transformer_tpu.utils.params import fill_like
from eventful_transformer_tpu_torch.core import blocks
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
from eventful_transformer_tpu_torch.utils.params import flatten_tree, params_from_jax

B, N, C, HEADS, K = 2, 24, 64, 4, 9
KWARGS = dict(dim=C, heads=HEADS, mlp_ratio=2, input_size=(4, 6))
TOL, TOL_CAST = 2e-5, 1e-2

REGIMES = ["v2mlp", "v1", "v1v2", "v3", False]
BLOCKS = {
    "tokenwise": ("EventfulTokenwiseBlock", {}),
    "eventful": ("EventfulBlock", {}),
    "eventful_cast": ("EventfulBlock", dict(matmul_2_cast="bfloat16")),
}
# the reference's A.V formulations, in the "v2mlp" regime
VARIANTS = {
    "cached_product_logits_kernel": dict(recompute_product=False, av_kernel=True),
    "delta_accumulator": dict(recompute_av=False),
}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _pair(cls_name, block_kwargs, regime, attrs=None):
    """The JAX block and the port's, the regime forced on both, policies
    TokenNormTopK(k=K), perturbed weights shared."""
    kwargs = dict(KWARGS, **block_kwargs)
    jax_blk = getattr(jax_blocks, cls_name)(**kwargs)
    blk = getattr(blocks, cls_name)(**kwargs)
    jax_blk.fused_gates = blk.fused_gates = regime
    for name, value in (attrs or {}).items():
        setattr(jax_blk, name, value)
        setattr(blk, name, value)
    for gate in jax_blk.modules_of_type(jax_blocks.TokenGate):
        gate.policy = copy.deepcopy(JaxTopK(k=K))
    for gate in (blk.qkv_gate, blk.projection_gate, blk.mlp_gate):
        gate.policy = TokenNormTopK(k=K)
    assert jax_blk._fused_mode(N) == blk._fused_mode(N) == regime
    like = jax_blk.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    flat = {
        k: (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        for k, v in flatten_tree(jax.tree_util.tree_map(np.asarray, like)).items()
    }
    params_from_jax(blk, flat)
    return jax_blk, blk, fill_like(like, flat)


def _close(port, ref, tol):
    np.testing.assert_allclose(
        port.detach().float().numpy(), np.asarray(ref, dtype=np.float32), rtol=tol, atol=tol
    )


def _run_and_compare(jax_blk, blk, params, tol, xs=None):
    """A flush and 3 incremental steps on ``xs`` (by default (B, N, C)
    frames from seed 2): outputs each step, then every state leaf and
    count key."""
    if xs is None:
        rng = np.random.default_rng(2)
        base = rng.standard_normal((B, N, C)).astype(np.float32)
        xs = [base + 0.3 * rng.standard_normal((B, N, C)).astype(np.float32) for _ in range(4)]
    n = xs[0].shape[1]
    jax_ctx, ctx = JaxCtx(count_mode=True), Ctx(count_mode=True)
    jax_state = jax_blk.init_state(B, n)
    state = blk.init_state(B, n, torch.float32, "cpu")
    aux = jax_blk.precompute(params)
    with torch.no_grad():
        for t, x in enumerate(xs):
            mode = "flush" if t == 0 else "incremental"
            y_ref, jax_state = jax_blk.apply(jax_ctx, params, jax_state, jnp.asarray(x), aux, mode=mode)
            y, state, next_norms = blk(ctx, state, torch.from_numpy(x), mode=mode)
            assert next_norms is None
            _close(y, y_ref, tol)
    jax_state.pop("first")
    assert set(state) == set(jax_state)
    for group, leaves in jax_state.items():
        assert set(state[group]) == set(leaves), group
        for name, ref in leaves.items():
            assert state[group][name].dtype == getattr(torch, str(ref.dtype)), (group, name)
            _close(state[group][name], ref, tol)
    ref_counts = Counts.from_device(jax_ctx.counts)
    assert set(ctx.counts) == set(ref_counts)
    for key in ref_counts:
        np.testing.assert_allclose(ctx.counts[key], ref_counts[key], rtol=1e-6, err_msg=key)


@pytest.mark.parametrize("regime", REGIMES, ids=[str(r) for r in REGIMES])
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_regime_matches_jax(kind, regime):
    cls_name, block_kwargs = BLOCKS[kind]
    jax_blk, blk, params = _pair(cls_name, block_kwargs, regime)
    _run_and_compare(jax_blk, blk, params, TOL_CAST if "matmul_2_cast" in block_kwargs else TOL)


@pytest.mark.parametrize("cast", [None, "bfloat16"], ids=["f32", "cast_bf16"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_eventful_block_av_variant_matches_jax(variant, cast):
    jax_blk, blk, params = _pair(
        "EventfulBlock", dict(matmul_2_cast=cast), "v2mlp", VARIANTS[variant]
    )
    _run_and_compare(jax_blk, blk, params, TOL if cast is None else TOL_CAST)


def test_auto_gives_v2mlp_for_eventful_block():
    """At N <= 512 the JAX TPU dispatch gives an EventfulBlock "v2mlp" (its
    attention consumes the qkv gate's index, so "v4" does not take it);
    the port's "auto" does the same at any batch."""
    blk = blocks.EventfulBlock(**KWARGS, matmul_2_cast="bfloat16")
    for gate in blk.gates:
        gate.policy = TokenNormTopK(k=K)
    assert blk.fused_gates == "auto" and blk._fused_mode(197) == "v2mlp"
    state = blk.init_state(B, N, torch.float32, "cpu")
    assert "qkv_accumulator" not in state and "projection_accumulator" not in state


M1_REGIMES = ["v2mlp", "v2", "blocked", False]


@pytest.mark.parametrize("recompute_product", [True, False], ids=["recompute", "cached"])
@pytest.mark.parametrize("cast", [None, "bfloat16"], ids=["f32", "cast_bf16"])
@pytest.mark.parametrize("pool", [None, 2], ids=["no_pool", "pool2"])
@pytest.mark.parametrize("regime", M1_REGIMES, ids=[str(r) for r in M1_REGIMES])
def test_matmul1_block_matches_jax(regime, pool, cast, recompute_product):
    """EventfulMatmul1Block on a 6 x 6 grid with rel-pos: its q.kT product
    recomputed (counted as the reference's row and column updates) or
    cached, its plain A.V product, in every regime the global blocks of the
    ablation run."""
    kwargs = dict(dim=32, heads=4, mlp_ratio=2, input_size=(6, 6), pool_size=pool,
                  relative_embedding_size=[8, 8], matmul_2_cast=cast)
    jax_blk = jax_blocks.EventfulMatmul1Block(**kwargs)
    blk = blocks.EventfulMatmul1Block(**kwargs)
    jax_blk.fused_gates = blk.fused_gates = regime
    jax_blk.recompute_product = blk.recompute_product = recompute_product
    for gate in jax_blk.modules_of_type(jax_blocks.TokenGate):
        gate.policy = copy.deepcopy(JaxTopK(k=8))
    for gate in blk.gates:
        gate.policy = TokenNormTopK(k=8)
    assert jax_blk._fused_mode(36) == blk._fused_mode(36) == regime
    like = jax_blk.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    flat = {
        k: (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        for k, v in flatten_tree(jax.tree_util.tree_map(np.asarray, like)).items()
    }
    params_from_jax(blk, flat)
    rng = np.random.default_rng(4)
    base = rng.standard_normal((B, 36, 32)).astype(np.float32)
    xs = [base + 0.3 * rng.standard_normal(base.shape).astype(np.float32) for _ in range(4)]
    _run_and_compare(jax_blk, blk, fill_like(like, flat), TOL if cast is None else TOL_CAST, xs)
