"""Top-k selection coverage and the select-only gate update of the port
against the JAX package, on norms with ties at the k-th value.

Exact equality: the selection is a set, and both sides derive it from the
same values with the same smallest-index tie rule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.core import indexing as jax_indexing
from eventful_transformer_tpu.core.counting import Counts, Ctx as JaxCtx
from eventful_transformer_tpu.core.gating import TokenGate as JaxTokenGate
from eventful_transformer_tpu.core.policies import TokenNormTopK as JaxTopK
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.core.gating import TokenGate
from eventful_transformer_tpu_torch.core.indexing import coverage_from_norms, valid_fraction
from eventful_transformer_tpu_torch.core.policies import TokenNormTopFraction, TokenNormTopK


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _tied_norms(seed=0, shape=(4, 20)):
    # four distinct values over 20 tokens: every k lands on a tie
    return np.random.default_rng(seed).integers(0, 4, shape).astype(np.float32)


@pytest.mark.parametrize("k", [1, 5, 9, 13, 19, 20, 25])
def test_coverage_from_norms_matches_jax_with_ties(k):
    norms = _tied_norms()
    ref = np.asarray(jax_indexing.coverage_from_norms(jnp.asarray(norms), k))
    got = coverage_from_norms(torch.from_numpy(norms), k)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.sum(-1).numpy(), min(k, norms.shape[-1]))


def test_coverage_keeps_smallest_tied_indices():
    norms = torch.tensor([[1.0, 2.0, 2.0, 0.0, 2.0, 3.0]])
    cov = coverage_from_norms(norms, 3)  # 3.0, then the first two 2.0s
    assert cov.tolist() == [[0.0, 1.0, 1.0, 0.0, 0.0, 1.0]]


@pytest.mark.parametrize("k", [3, 7, 12])
def test_incremental_select_matches_jax(k):
    rng = np.random.default_rng(1)
    c = np.round(rng.standard_normal((2, 12, 8)), 1).astype(np.float32)
    p = c.copy()
    p[:, ::3] += 1.0  # a tied error norm on every third token
    jax_gate, gate = JaxTokenGate(), TokenGate()
    jax_gate.policy, gate.policy = JaxTopK(k=k), TokenNormTopK(k=k)
    jax_ctx, ctx = JaxCtx(count_mode=True), Ctx(count_mode=True)
    kref, sref = jax_gate.incremental_select(jax_ctx, {"p": jnp.asarray(p)}, jnp.asarray(c))
    kgot, sgot = gate.incremental_select(ctx, {"p": torch.from_numpy(p)}, torch.from_numpy(c))
    assert kgot == kref
    np.testing.assert_array_equal(sgot["p"].numpy(), np.asarray(sref["p"]))
    assert ctx.counts["gate_flops"] == Counts.from_device(jax_ctx.counts)["gate_flops"]


def test_policy_capacities():
    assert TokenNormTopK(k=98).capacity(197) == 98
    assert TokenNormTopK(k=98).capacity(50) == 50
    assert TokenNormTopFraction(0.5).capacity(197) == 98
    with pytest.raises(ValueError):
        TokenNormTopFraction(1.5)


def test_valid_fraction():
    assert valid_fraction(None) == 1
    assert valid_fraction(torch.tensor([True, False, True, True])) == 0.75


# -- the gathered paths: scatters, gathers and the incremental gates ---------------

from eventful_transformer_tpu.core.gating import TokenDeltaGate as JaxTokenDeltaGate  # noqa: E402
from eventful_transformer_tpu_torch.core import indexing  # noqa: E402
from eventful_transformer_tpu_torch.core.gating import TokenDeltaGate  # noqa: E402


def _slots(with_mask):
    """Distinct indices per row, in no order; with a mask, one masked-off
    slot names a row that a valid slot also names (it must write nothing)."""
    index = np.array([[7, 2, 9, 0], [3, 8, 1, 5]], np.int32)
    if not with_mask:
        return index, None
    mask = np.array([[True, True, False, True], [True, False, True, True]])
    index[0, 2] = 2  # duplicates the valid slot 1
    return index, mask


@pytest.mark.parametrize("with_mask", [False, True], ids=["all_valid", "masked"])
@pytest.mark.parametrize("structure", ["row", "col"])
def test_put_matches_jax_one_hot_blend(structure, with_mask):
    """Index copies equal the JAX package's one-hot blend bit for bit on
    distinct valid indices; masked-off slots are no-ops."""
    rng = np.random.default_rng(3)
    index, mask = _slots(with_mask)
    x = rng.standard_normal((2, 3, 10, 5) if structure == "row" else (2, 3, 5, 10)).astype(np.float32)
    values = rng.standard_normal((2, 3, 4, 5) if structure == "row" else (2, 3, 5, 4)).astype(np.float32)
    jax_put = jax_indexing.put_rows if structure == "row" else jax_indexing.put_cols
    put = indexing.put_rows if structure == "row" else indexing.put_cols
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    ref = jax_put(jnp.asarray(x), jnp.asarray(index), jnp.asarray(values), jm)
    got = put(torch.from_numpy(x), torch.from_numpy(index), torch.from_numpy(values), tm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    take = indexing.take_rows if structure == "row" else indexing.take_cols
    jax_take = jax_indexing.take_rows if structure == "row" else jax_indexing.take_cols
    np.testing.assert_array_equal(
        take(torch.from_numpy(x), torch.from_numpy(index)).numpy(),
        np.asarray(jax_take(jnp.asarray(x), jnp.asarray(index))),
    )
    if mask is not None:
        jax_mask = jax_indexing.mask_rows if structure == "row" else jax_indexing.mask_cols
        own = indexing.mask_rows if structure == "row" else indexing.mask_cols
        np.testing.assert_array_equal(
            own(torch.from_numpy(values), tm).numpy(), np.asarray(jax_mask(jnp.asarray(values), jm))
        )


def _tied_gate_inputs(structure, seed=5):
    """c and p whose error norms tie: rounded values, every third token
    offset by the same amount."""
    rng = np.random.default_rng(seed)
    shape = (2, 12, 8) if structure == "row" else (2, 3, 8, 12)
    c = np.round(rng.standard_normal(shape), 1).astype(np.float32)
    p = c.copy()
    if structure == "row":
        p[:, ::3] += 1.0
    else:
        p[..., ::3] += 1.0
    return c, p


def _by_index(index, gathered, axis):
    """Gathered rows (cols) reordered by ascending index, for comparing the
    JAX package's top-k order with the port's ascending lists."""
    order = np.argsort(index, axis=-1)
    index = np.take_along_axis(index, order, -1)
    shape = order.shape[:-1] + (1,) * (gathered.ndim - order.ndim) + order.shape[-1:]
    if axis == -2:
        shape = order.shape[:-1] + (1,) * (gathered.ndim - order.ndim - 1) + order.shape[-1:] + (1,)
    return index, np.take_along_axis(gathered, order.reshape(shape), axis)


@pytest.mark.parametrize("k", [3, 7])
@pytest.mark.parametrize("structure", ["row", "col"])
def test_token_gate_incremental_matches_jax(structure, k):
    c, p = _tied_gate_inputs(structure)
    jax_gate, gate = JaxTokenGate(structure), TokenGate(structure)
    jax_gate.policy, gate.policy = JaxTopK(k=k), TokenNormTopK(k=k)
    jax_ctx, ctx = JaxCtx(count_mode=True), Ctx(count_mode=True)
    c_ref, i_ref, m_ref, s_ref = jax_gate.incremental(jax_ctx, {"p": jnp.asarray(p)}, jnp.asarray(c))
    c_got, i_got, m_got, s_got = gate.incremental(ctx, {"p": torch.from_numpy(p)}, torch.from_numpy(c))
    assert m_ref is None and m_got is None
    axis = -2 if structure == "row" else -1
    i_ref, c_ref = _by_index(np.asarray(i_ref), np.asarray(c_ref), axis)
    np.testing.assert_array_equal(i_got.numpy(), i_ref)  # the port lists ascending
    np.testing.assert_array_equal(c_got.numpy(), c_ref)
    np.testing.assert_array_equal(s_got["p"].numpy(), np.asarray(s_ref["p"]))
    assert ctx.counts["gate_flops"] == Counts.from_device(jax_ctx.counts)["gate_flops"]


@pytest.mark.parametrize("forced", [False, True], ids=["selected", "forced_masked"])
@pytest.mark.parametrize("structure", ["row", "col"])
def test_token_delta_gate_incremental_matches_jax(structure, forced):
    """The deltas of the selected tokens, zeroed in masked-off slots; the
    state updated by select (row) or by scatter (col)."""
    rng = np.random.default_rng(6)
    shape = (2, 3, 10, 4) if structure == "row" else (2, 3, 6, 10)
    c = rng.standard_normal(shape).astype(np.float32)
    p = rng.standard_normal(shape).astype(np.float32)
    jax_gate, gate = JaxTokenDeltaGate(structure), TokenDeltaGate(structure)
    jax_gate.policy, gate.policy = JaxTopK(k=4), TokenNormTopK(k=4)
    jkw, kw = {}, {}
    if forced:
        index, mask = _slots(True)
        jkw = dict(forced_index=jnp.asarray(index), forced_mask=jnp.asarray(mask))
        kw = dict(forced_index=torch.from_numpy(index), forced_mask=torch.from_numpy(mask))
    elif structure == "row":
        # the unforced row gate selects per (batch, head): 3-d tokens
        c, p = c[:, 0], p[:, 0]
    jax_ctx, ctx = JaxCtx(count_mode=True), Ctx(count_mode=True)
    ref = jax_gate.incremental(jax_ctx, {"p": jnp.asarray(p)}, jnp.asarray(c), **jkw)
    got = gate.incremental(ctx, {"p": torch.from_numpy(p)}, torch.from_numpy(c), **kw)
    axis = -2 if structure == "row" else -1
    c_ref, e_ref = np.asarray(ref[0]), np.asarray(ref[1])
    if not forced:
        _, c_ref = _by_index(np.asarray(ref[2]), c_ref, axis)
        _, e_ref = _by_index(np.asarray(ref[2]), e_ref, axis)
    np.testing.assert_array_equal(got[0].numpy(), c_ref)
    np.testing.assert_array_equal(got[1].numpy(), e_ref)
    np.testing.assert_array_equal(got[4]["p"].numpy(), np.asarray(ref[4]["p"]))
    assert ctx.counts["gate_flops"] == Counts.from_device(jax_ctx.counts)["gate_flops"]
