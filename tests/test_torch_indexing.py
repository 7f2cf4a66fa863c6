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
