"""The plain versions of the gate-fusion kernels (``ln_select_matmul`` in its
"post" and "none" forms, ``select_linear_skip_norms``, ``ln_select``) and
of the A.V kernel's logits form (with and without rel-pos terms) against
the JAX package's Pallas kernels in interpret mode, on the same numpy
inputs.

float32 at rtol/atol 2e-5, the tolerance the JAX package's own kernel tests
use: both sides compute in float32 and differ only in summation order. The
gate state each kernel updates is checked to be updated in place.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.ops.pallas import av_softmax as jax_av_softmax
from eventful_transformer_tpu.ops.pallas import gate_fused as jax_gate_fused
from eventful_transformer_tpu_torch.ops.av_softmax import softmax_select_matmul_logits_plain
from eventful_transformer_tpu_torch.ops.gate_fused import (
    ln_select_matmul_plain,
    ln_select_plain,
    select_linear_skip_norms_plain,
)

TOL = 2e-5
SHAPES = [(2, 24, 64, 9), (2, 37, 256, 11)]  # (B, N, C, k)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _inputs(b, n, c, k, seed=0):
    """Activations, gate states, LN and linear params and a coverage with
    exactly k ones per row, as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    cov = np.zeros((b, n), np.float32)
    for i in range(b):
        cov[i, rng.permutation(n)[:k]] = 1.0
    return dict(
        x=f(b, n, c), p=f(b, n, c), skip=f(b, n, c), p_next=f(b, n, c), cov=cov,
        s=1.0 + f(c, scale=0.1), bias=f(c, scale=0.1), w=f(c, 3 * c, scale=c**-0.5),
        wb=f(3 * c, scale=0.1), w_proj=f(c, c, scale=c**-0.5), wb_proj=f(c, scale=0.1),
    )


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(port, ref):
    np.testing.assert_allclose(
        np.asarray(port, dtype=np.float32), np.asarray(ref, dtype=np.float32), rtol=TOL, atol=TOL
    )


@pytest.mark.parametrize("ln_mode", ["post", "none"])
@pytest.mark.parametrize("b,n,c,k", SHAPES)
def test_ln_select_matmul_matches_jax(b, n, c, k, ln_mode):
    """"post": the qkv group (LN-domain gate, W C x 3C); "none": the
    projection group (input-domain gate, W C x C)."""
    d = _inputs(b, n, c, k)
    w, wb = (d["w"], d["wb"]) if ln_mode == "post" else (d["w_proj"], d["wb_proj"])
    scale, bias = (d["s"], d["bias"]) if ln_mode == "post" else (np.ones(c), np.zeros(c))
    ref = jax_gate_fused.ln_select_matmul(
        *(jnp.asarray(a, jnp.float32) for a in (d["x"], d["p"], d["cov"], scale, bias, w, wb)),
        ln_mode=ln_mode, block_n=16, interpret=True,
    )
    p = _t(d["p"])
    port = ln_select_matmul_plain(
        _t(d["x"]), p, _t(d["cov"]), _t(d["s"]) if ln_mode == "post" else None,
        _t(d["bias"]) if ln_mode == "post" else None, _t(w), _t(wb), ln_mode=ln_mode,
    )
    assert port[0] is p
    for got, want in zip(port, ref):
        _close(got, want)


@pytest.mark.parametrize("b,n,c,k", SHAPES)
def test_select_linear_skip_norms_matches_jax(b, n, c, k):
    """The projection group of "v3": select, recompute, skip add and the
    MLP gate's norms (next_ln=True)."""
    d = _inputs(b, n, c, k)
    args = ("x", "p", "cov", "w_proj", "wb_proj", "skip", "p_next", "s", "bias")
    ref = jax_gate_fused.select_linear_skip_norms(
        *(jnp.asarray(d[key]) for key in args), next_ln=True, block_n=16, interpret=True
    )
    p = _t(d["p"])
    port = select_linear_skip_norms_plain(_t(d["x"]), p, *(_t(d[key]) for key in args[2:]))
    assert port[0] is p and len(ref) == 3
    for got, want in zip(port, ref):
        _close(got, want)


@pytest.mark.parametrize("b,n,c,k", SHAPES)
def test_ln_select_matches_jax(b, n, c, k):
    """The MLP gate of "v1": p' = where(cov, ln(x), p) (apply_ln=True)."""
    d = _inputs(b, n, c, k)
    args = ("x", "p", "cov", "s", "bias")
    ref = jax_gate_fused.ln_select(
        *(jnp.asarray(d[key]) for key in args), apply_ln=True, block_n=16, interpret=True
    )
    p = _t(d["p"])
    port = ln_select_plain(_t(d["x"]), p, *(_t(d[key]) for key in args[2:]))
    assert port is p
    _close(port, ref)


@pytest.mark.parametrize(
    "grid,with_terms", [((4, 6), False), ((4, 6), True), ((3, 7), True)],
    ids=["noterms", "terms", "terms_3x7"],
)
def test_softmax_select_matmul_logits_matches_jax(grid, with_terms):
    """The A.V kernel reading a logits tensor (B, H, N, Np): the rel-pos
    terms expanded onto the keys, the softmax, the column select into the
    state in place and A.V."""
    b, heads, n, hd = 2, 3, 30, 16
    np_ = grid[0] * grid[1]
    rng = np.random.default_rng(4)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    logits, p_v = f(b, heads, n, np_), f(b, heads, np_, hd)
    p_a = (rng.random((b, heads, n, np_)) * 2.0 / np_).astype(np.float32)
    cov = (rng.random((b, np_)) < 0.3).astype(np.float32)
    terms = f(b, heads, n, grid[0] + grid[1], scale=0.3) if with_terms else None
    kw = dict(terms=jnp.asarray(terms), p=grid) if with_terms else {}
    ref = jax_av_softmax.softmax_select_matmul(
        jnp.asarray(logits), jnp.asarray(p_a), jnp.asarray(cov), jnp.asarray(p_v),
        block_n=16, interpret=True, **kw,
    )
    state = _t(p_a)
    port = softmax_select_matmul_logits_plain(
        _t(logits), state, _t(cov), _t(p_v), None if terms is None else _t(terms),
        p=grid if with_terms else None,
    )
    assert port[0] is state
    for got, want in zip(port, ref):
        _close(got, want)
