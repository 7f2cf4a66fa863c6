"""The threshold policy and ``save_status`` in the port against the JAX
package: ``TokenNormThreshold``'s candidates, mask and ``policy_saturated``
count (with ties at the capacity and at the threshold); a policy that saves
its status (the same ``last_input``/``last_output``, and no select-only,
in-kernel or "v4" shortcut); and both through every incremental regime of
the eventful blocks, forced alike on both sides: {EventfulTokenwiseBlock,
EventfulBlock} x {"v2mlp", "v1", "v1v2", "v3", "v2", "blocked", False}, a
windowed EventfulTokenwiseBlock in "v2" and "blocked" (the window-major qkv
buffer: rows 10 and 11) and a pooled rel-pos EventfulBlock with the A.V
kernel (row 8 on a masked pooled index, a batch row with nothing
selected). Masked-off slots reach the blocked kernels keyed to the marker
N, and every count is scaled by the valid share.

The JAX side runs its Pallas kernels in interpret mode at "highest" matmul
precision (tests/conftest.py); the port its plain versions. Outputs and
every state leaf at 2e-5 (float32 on both sides, sums in other orders);
every count key at rtol 1e-6, ``policy_saturated`` equal.

The JAX package's blocked groups gather the k rows with the masked-off
slots keyed to N (``_blocked_select``), and ``jnp.take_along_axis`` fills
an out-of-range row with NaN, which its kernels' one-hot scatter (a
product with 0) spreads into the token buffer. The tests clamp that
gather's index on the JAX side (``_jax_take_rows_in_range``): a
masked-off slot's row is then never scattered, as the JAX kernels intend
and the port does (ROADMAP.md §3).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.core import blocks as jax_blocks
from eventful_transformer_tpu.core import indexing as jax_indexing
from eventful_transformer_tpu.core.counting import Counts, Ctx as JaxCtx
from eventful_transformer_tpu.core.policies import TokenNormThreshold as JaxThreshold
from eventful_transformer_tpu.core.policies import TokenNormTopK as JaxTopK
from eventful_transformer_tpu.utils.params import fill_like
from eventful_transformer_tpu_torch.core import blocks
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.core.gating import TokenGate
from eventful_transformer_tpu_torch.core.policies import (
    TokenNormThreshold,
    TokenNormTopFraction,
    TokenNormTopK,
    check_kernel_policy,
    in_kernel_topk_eligible,
)
from eventful_transformer_tpu_torch.utils.misc import token_gates
from eventful_transformer_tpu_torch.utils.params import flatten_tree, params_from_jax

TOL = 2e-5


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _jax_take_rows_in_range(monkeypatch):
    def take_rows(x, index):
        return jax_indexing.take_rows(x, jnp.clip(index, 0, x.shape[-2] - 1))

    monkeypatch.setattr(jax_blocks, "take_rows", take_rows)


def _selections(index, mask):
    """Per batch row, the set of (index, valid) pairs."""
    index = np.asarray(index).reshape(-1, np.asarray(index).shape[-1])
    mask = np.ones(index.shape, bool) if mask is None else np.asarray(mask).reshape(index.shape)
    return [sorted(zip(i.tolist(), m.tolist())) for i, m in zip(index, mask)]


def _tied_norms(seed, bsz=4, n=20):
    """Norms (bsz, 2, n) with ties: repeated values around the 6th and 12th
    largest, and exact copies of the thresholds used below."""
    rng = np.random.default_rng(seed)
    norms = rng.uniform(0.0, 3.0, (bsz, 2, n)).astype(np.float32)
    norms[..., 3:7] = norms[..., 3:4]
    norms[..., 10:13] = 1.5
    norms[0, 0, :] = 2.0  # every candidate over 1.0: a saturated row
    norms[1, 1, :] = 0.25  # nothing over the threshold
    return norms


@pytest.mark.parametrize("threshold", [0.25, 1.0, 1.5])
@pytest.mark.parametrize("capacity", [None, 4, 6, 12, 20, 25])
def test_threshold_selection_matches_jax(capacity, threshold):
    norms = _tied_norms(capacity or 0)
    ours = TokenNormThreshold(threshold, capacity=capacity)
    ref = JaxThreshold(threshold, capacity=capacity)
    ctx, jax_ctx = Ctx(count_mode=True), JaxCtx(count_mode=True)
    index, mask = ours.select_from_norms(torch.from_numpy(norms), ctx)
    ref_index, ref_mask = ref.select_from_norms(jnp.asarray(norms), jax_ctx)
    k = ours.capacity(norms.shape[-1])
    assert index.shape == mask.shape == norms.shape[:-1] + (k,) == ref_index.shape
    assert _selections(index, mask) == _selections(ref_index, ref_mask)
    assert mask.dtype == torch.bool
    saturated = Counts.from_device(jax_ctx.counts)["policy_saturated"]
    assert ctx.counts["policy_saturated"] == saturated
    if k < norms.shape[-1] and threshold == 1.0:
        assert saturated >= 1  # row (0, 0)


def test_threshold_select_takes_the_norm_order():
    rng = np.random.default_rng(3)
    e = rng.standard_normal((2, 12, 8)).astype(np.float32)
    for order in (1, 2, 3):
        for axis in (-1, -2):
            ours = TokenNormThreshold(2.0, order=order, capacity=5)
            ref = JaxThreshold(2.0, order=order, capacity=5)
            got = ours.select(torch.from_numpy(e), axis, Ctx(count_mode=True))
            want = ref.select(jnp.asarray(e), axis, JaxCtx(count_mode=True))
            assert _selections(*got) == _selections(*want)


def test_save_status_matches_jax():
    rng = np.random.default_rng(4)
    e = rng.standard_normal((2, 10, 6)).astype(np.float32)
    ours, ref = TokenNormTopK(4, save_status=True), JaxTopK(4, save_status=True)
    index, mask = ours.select(torch.from_numpy(e), -1)
    ref_index, _ = ref.select(jnp.asarray(e), -1)
    assert mask is None
    np.testing.assert_array_equal(ours.last_input.numpy(), np.asarray(ref.last_input))
    assert _selections(ours.last_output, None) == _selections(ref.last_output, None)
    assert ours.last_output is index
    quiet = TokenNormTopK(4)
    quiet.select(torch.from_numpy(e), -1)
    assert quiet.last_input is None and quiet.last_output is None


def test_shortcuts_refuse_threshold_and_save_status():
    blk = blocks.EventfulTokenwiseBlock(dim=32, heads=4, mlp_ratio=2, input_size=(4, 6))
    for policy, eligible in [
        (TokenNormTopK(4), True), (TokenNormTopK(4, order=1), False),
        (TokenNormTopK(4, save_status=True), False), (TokenNormTopFraction(0.5), False),
        (TokenNormThreshold(1.0), False), (TokenNormThreshold(1.0, capacity=4), False),
    ]:
        for gate in blk.gates:
            gate.policy = copy.deepcopy(policy)
        assert in_kernel_topk_eligible(policy) is eligible
        assert blk._v4_eligible() is eligible
        assert blk._fused_mode(24) == ("v4" if eligible else "v2mlp")
        blk.in_kernel_topk = True
        assert blk._use_in_kernel_topk(policy, torch.zeros(1, 24, 32)) is eligible
        blk.in_kernel_topk = False
        select_only = isinstance(policy, TokenNormTopK) and not policy.save_status
        assert blk.qkv_gate.select_only_ok() is select_only
        check_kernel_policy(policy)


# -- blocks ------------------------------------------------------------------------

KIND = {
    "tokenwise": ("EventfulTokenwiseBlock", dict(input_size=(4, 6))),
    "eventful": ("EventfulBlock", dict(input_size=(4, 6))),
    "windowed": ("EventfulTokenwiseBlock", dict(input_size=(4, 5), window_size=[2, 3],
                                                relative_embedding_size=[8, 8])),
    "pooled_av": ("EventfulBlock", dict(input_size=(6, 6), pool_size=2,
                                        relative_embedding_size=[8, 8])),
}
REGIMES = ["v2mlp", "v1", "v1v2", "v3", "v2", "blocked", False]
CASES = (
    [(kind, regime) for kind in ("tokenwise", "eventful") for regime in REGIMES]
    + [("windowed", "v2"), ("windowed", "blocked"), ("pooled_av", "v2"),
       ("pooled_av", "blocked"), ("pooled_av", "v2mlp")]
)
POLICIES = {
    "threshold": (TokenNormThreshold, JaxThreshold, dict(threshold=0.8)),
    "threshold_capacity": (TokenNormThreshold, JaxThreshold, dict(threshold=0.8, capacity=9)),
    "topk_save_status": (TokenNormTopK, JaxTopK, dict(k=7, save_status=True)),
}


def _pair(kind, regime, policy):
    cls_name, kwargs = KIND[kind]
    kwargs = dict(dim=32, heads=4, mlp_ratio=2, **kwargs)
    jax_blk = getattr(jax_blocks, cls_name)(**kwargs)
    blk = getattr(blocks, cls_name)(**kwargs)
    jax_blk.fused_gates = blk.fused_gates = regime
    jax_blk.fused_window_attention = jax_blk.fused_dense_mlp = True
    if kind == "pooled_av":
        jax_blk.av_kernel = jax_blk.fuse_matmul_1 = True
        blk.av_kernel = blk.fuse_matmul_1 = True
    cls, jax_cls, policy_kwargs = POLICIES[policy]
    for gate in jax_blk.modules_of_type(jax_blocks.TokenGate):
        gate.policy = jax_cls(**policy_kwargs)
    for gate in token_gates(blk):
        gate.policy = cls(**policy_kwargs)
    like = jax_blk.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    flat = {
        k: (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        for k, v in flatten_tree(jax.tree_util.tree_map(np.asarray, like)).items()
    }
    params_from_jax(blk, flat)
    return jax_blk, blk, fill_like(like, flat)


def _frames(n, c, seed):
    """A flush frame and 4 more: each token moves by its own scale in
    [0, 0.6] (a quarter not at all); at frame 3 batch row 1 repeats frame
    2, so that its gates find little or nothing over the threshold."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((2, n, c)).astype(np.float32)]
    for t in range(4):
        scale = rng.uniform(0.0, 0.6, (2, n, 1)) * (rng.uniform(size=(2, n, 1)) > 0.25)
        x = (xs[-1] + scale * rng.standard_normal((2, n, c))).astype(np.float32)
        if t == 2:
            x[1] = xs[-1][1]
        xs.append(x)
    return xs


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(
        port.detach().float().numpy(), np.asarray(ref, dtype=np.float32), rtol=tol, atol=tol
    )


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("kind,regime", CASES, ids=[f"{k}-{r}" for k, r in CASES])
def test_masked_policy_regime_matches_jax(kind, regime, policy):
    jax_blk, blk, params = _pair(kind, regime, policy)
    n = blk.input_size[0] * blk.input_size[1]
    assert jax_blk._fused_mode(n) == blk._fused_mode(n) == regime
    if kind == "windowed":
        assert blk._resident_qkv(n)
    xs = _frames(n, blk.dim, 6)
    jax_ctx, ctx = JaxCtx(count_mode=True), Ctx(count_mode=True)
    jax_state = jax_blk.init_state(2, n)
    state = blk.init_state(2, n, torch.float32, "cpu")
    aux = jax_blk.precompute(params)
    with torch.no_grad():
        for t, x in enumerate(xs):
            mode = "flush" if t == 0 else "incremental"
            y_ref, jax_state = jax_blk.apply(jax_ctx, params, jax_state, jnp.asarray(x), aux,
                                             mode=mode)
            y, state, _ = blk(ctx, state, torch.from_numpy(x), mode=mode)
            _close(y, y_ref)
    jax_state.pop("first", None)
    assert set(state) == set(jax_state)
    for group, leaves in jax_state.items():
        assert set(state[group]) == set(leaves), group
        for name, ref in leaves.items():
            _close(state[group][name], np.asarray(ref.astype(jnp.float32)))
    ref_counts = Counts.from_device(jax_ctx.counts)
    counts = ctx.counts
    assert set(counts) == set(ref_counts)
    for key in ref_counts:
        np.testing.assert_allclose(counts[key], ref_counts[key], rtol=1e-6, err_msg=key)
    if policy == "threshold_capacity":
        assert counts["policy_saturated"] == ref_counts["policy_saturated"]


def test_block_threshold_keys_invalid_slots(monkeypatch):
    """The blocked kernels see the masked-off slots keyed to the marker N,
    and the k-row linear gathers an in-range row for every slot."""
    _, blk, _ = _pair("tokenwise", "blocked", "threshold_capacity")
    seen = []
    real = blocks.block_select_scatter

    def spy(x, p, b, cov, index, h, *args, **kwargs):
        seen.append((index.clone(), cov.clone()))
        return real(x, p, b, cov, index, h, *args, **kwargs)

    monkeypatch.setattr(blocks, "block_select_scatter", spy)
    xs = _frames(24, 32, 6)
    state = blk.init_state(2, 24, torch.float32, "cpu")
    with torch.no_grad():
        for t, x in enumerate(xs):
            _, state, _ = blk(Ctx(), state, torch.from_numpy(x),
                              mode="flush" if t == 0 else "incremental")
    assert len(seen) == 3 * 4
    keyed = 0
    for index, cov in seen:
        assert index.shape[-1] == 9
        valid = index < 24
        keyed += int((~valid).sum())
        assert ((index == 24) | valid).all()
        for b in range(2):
            assert cov[b].sum() == valid[b].sum()
            assert (cov[b, index[b][valid[b]].long()] == 1).all()
    assert keyed > 0


def test_unfused_gate_passes_ctx_to_threshold():
    gate = TokenGate()
    gate.policy = TokenNormThreshold(0.1, capacity=3)
    ctx = Ctx(count_mode=True)
    c = torch.ones(2, 6, 4)
    _, index, mask, _ = gate.incremental(ctx, {"p": torch.zeros(2, 6, 4)}, c)
    assert mask.all() and ctx.counts["policy_saturated"] == 2.0
