"""The plain PyTorch versions of the six ported kernels against the JAX
package's Pallas kernels in interpret mode, on the same numpy inputs.

f32 at rtol/atol 2e-5, the tolerance the JAX package's own kernel tests
use: both sides compute in float32 and differ only in summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.ops.pallas import block_fused as jax_block_fused
from eventful_transformer_tpu.ops.pallas import dense_mlp as jax_dense_mlp
from eventful_transformer_tpu.ops.pallas import gate_fused as jax_gate_fused
from eventful_transformer_tpu.ops.pallas import gate_group as jax_gate_group
from eventful_transformer_tpu.ops.pallas import window_attention as jax_window_attention
from eventful_transformer_tpu_torch.ops.block_fused import (
    proj_group_plain,
    qkv_attention_group_plain,
)
from eventful_transformer_tpu_torch.ops.dense_mlp import dense_mlp_residual_plain
from eventful_transformer_tpu_torch.ops.gate_fused import ln_norms_plain
from eventful_transformer_tpu_torch.ops.gate_group import gate_group_mlp_plain
from eventful_transformer_tpu_torch.ops.window_attention import window_attention_plain

TOL = 2e-5
SHAPES = [(2, 24, 64, 4, 9), (2, 24, 256, 4, 9)]  # (B, N, C, heads, k)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _inputs(b, n, c, k, hidden=None, seed=0):
    """Activations, gate states, LN and linear params, and a coverage with
    exactly k ones per row, as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    cov = np.zeros((b, n), np.float32)
    for i in range(b):
        cov[i, rng.permutation(n)[:k]] = 1.0
    out = dict(
        x=f(b, n, c), p1=f(b, n, c), p2=f(b, n, c), p3=f(b, n, c), buf=f(b, n, c),
        cov=cov, s=1.0 + f(c, scale=0.1), bias=f(c, scale=0.1),
        w=f(c, 3 * c, scale=c**-0.5), wb=f(3 * c, scale=0.1),
    )
    if hidden:
        out.update(
            w1=f(c, hidden, scale=c**-0.5), b1=f(hidden, scale=0.1),
            w2=f(hidden, c, scale=hidden**-0.5), b2=f(c, scale=0.1),
        )
    return out


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(port, ref):
    np.testing.assert_allclose(
        np.asarray(port, dtype=np.float32), np.asarray(ref, dtype=np.float32),
        rtol=TOL, atol=TOL,
    )


# ln_norms also at 2304, ViT-B's F = 3C (9 vectors a lane of the
# warp-per-row body in bfloat16), over 13 rows a batch row (no multiple of 8)
@pytest.mark.parametrize("b,n,c,heads,k", SHAPES + [(2, 13, 2304, 4, 9)])
def test_ln_norms_matches_jax(b, n, c, heads, k):
    d = _inputs(b, n, c, k)
    ref = jax_gate_fused.ln_norms(
        jnp.asarray(d["x"]), jnp.asarray(d["p1"]), jnp.asarray(d["s"]),
        jnp.asarray(d["bias"]), interpret=True,
    )
    port = ln_norms_plain(_t(d["x"]), _t(d["p1"]), _t(d["s"]), _t(d["bias"]))
    _close(port, ref)


@pytest.mark.parametrize("b,n,c,heads,k", SHAPES)
def test_qkv_attention_group_matches_jax(b, n, c, heads, k):
    d = _inputs(b, n, c, k)
    inv_scale = (c // heads) ** -0.5
    ref = jax_block_fused.qkv_attention_group(
        *(jnp.asarray(d[key]) for key in ("x", "p1", "cov", "p2", "s", "bias", "w", "wb")),
        heads=heads, inv_scale=inv_scale, interpret=True,
    )
    p_qkv = _t(d["p1"])
    port = qkv_attention_group_plain(
        *(_t(d[key]) for key in ("x",)), p_qkv,
        *(_t(d[key]) for key in ("cov", "p2", "s", "bias", "w", "wb")),
        heads=heads, inv_scale=inv_scale,
    )
    assert port[0] is p_qkv  # the gate state is updated in place
    for got, want in zip(port, ref):
        _close(got, want)


@pytest.mark.parametrize("b,n,c,heads,k", SHAPES)
def test_proj_group_matches_jax(b, n, c, heads, k):
    d = _inputs(b, n, c, k)
    d["w"], d["wb"] = d["w"][:, :c], d["wb"][:c]
    args = ("x", "p1", "cov", "buf", "p2", "w", "wb", "s", "bias")
    ref = jax_block_fused.proj_group(*(jnp.asarray(d[key]) for key in args), interpret=True)
    port = proj_group_plain(*(_t(d[key]) for key in args))
    for got, want in zip(port, ref):
        _close(got, want)


@pytest.mark.parametrize("emit_norms", [False, True])
@pytest.mark.parametrize("b,n,c,heads,k", SHAPES)
def test_gate_group_mlp_matches_jax(b, n, c, heads, k, emit_norms):
    d = _inputs(b, n, c, k, hidden=2 * c)
    args = ["x", "p1", "buf", "cov", "s", "bias", "w1", "b1", "w2", "b2"]
    if emit_norms:
        d["ns"], d["nb"] = d["s"][::-1].copy(), d["bias"][::-1].copy()
        args += ["p2", "ns", "nb"]
    ref = jax_gate_group.gate_group_mlp(
        *(jnp.asarray(d[key]) for key in args), ln_mode="post", kcap=k, interpret=True
    )
    port = gate_group_mlp_plain(*(_t(d[key]) for key in args), kcap=k)
    assert (port[3] is not None) == emit_norms
    for got, want in zip(port, ref):
        _close(got, want)


@pytest.mark.parametrize("b,n,c,heads,k", SHAPES)
def test_dense_mlp_residual_matches_jax(b, n, c, heads, k):
    d = _inputs(b, n, c, k, hidden=4 * c)
    args = ("x", "s", "bias", "w1", "b1", "w2", "b2")
    ref = jax_dense_mlp.dense_mlp_residual(
        *(jnp.asarray(d[key]) for key in args), block_n=16, interpret=True
    )
    port = dense_mlp_residual_plain(*(_t(d[key]) for key in args))
    _close(port, ref)


@pytest.mark.parametrize("b,n,c,heads,k", SHAPES)
def test_window_attention_global_matches_jax(b, n, c, heads, k):
    del k
    qkv = np.random.default_rng(1).standard_normal((b, n, 3 * c)).astype(np.float32)
    scale = (c // heads) ** 0.5
    ref = jax_window_attention.window_attention(
        jnp.asarray(qkv), heads=heads, scale=scale, interpret=True
    )
    port = window_attention_plain(_t(qkv), heads=heads, scale=scale)
    _close(port, ref)


# -- the kernels of ViTDet's "v2" regime ---------------------------------------

from eventful_transformer_tpu.ops.pallas import gate_block as jax_gate_block  # noqa: E402
from eventful_transformer_tpu_torch.ops.gate_block import (  # noqa: E402
    block_scatter_rows_plain,
    block_select_p_plain,
)
from eventful_transformer_tpu_torch.ops.gate_group import gate_group_linear_plain  # noqa: E402
from eventful_transformer_tpu_torch.ops.window_attention import window_bias_terms  # noqa: E402


@pytest.mark.parametrize("b,n,c,heads,k", SHAPES)
def test_gate_group_linear_post_matches_jax(b, n, c, heads, k):
    """The qkv group form: LN-domain gate, F = 3C, no skip."""
    d = _inputs(b, n, c, k)
    d["bufq"] = np.random.default_rng(3).standard_normal((b, n, 3 * c)).astype(np.float32)
    args = ("x", "p1", "bufq", "cov", "s", "bias", "w", "wb")
    ref = jax_gate_group.gate_group_linear(
        *(jnp.asarray(d[key]) for key in args), ln_mode="post", kcap=k, interpret=True
    )
    p, buf = _t(d["p1"]), _t(d["bufq"])
    port = gate_group_linear_plain(
        _t(d["x"]), p, buf, *(_t(d[key]) for key in args[3:]), ln_mode="post", kcap=k
    )
    assert port[0] is p and port[1] is buf and port[2] is None and port[3] is None
    for got, want in zip(port[:2], ref):
        _close(got, want)


@pytest.mark.parametrize("b,n,c,heads,k", SHAPES)
def test_gate_group_linear_skip_norms_matches_jax(b, n, c, heads, k):
    """The projection group form: input-domain gate, F = C, the skip add
    and the next gate's norms from the rounded output."""
    d = _inputs(b, n, c, k)
    d["w"], d["wb"] = d["w"][:, :c], d["wb"][:c]
    d["ns"], d["nb"] = d["s"][::-1].copy(), d["bias"][::-1].copy()
    ones, zeros = np.ones(c, np.float32), np.zeros(c, np.float32)
    ref = jax_gate_group.gate_group_linear(
        *(jnp.asarray(d[key]) for key in ("x", "p1", "buf", "cov")), jnp.asarray(ones),
        jnp.asarray(zeros), *(jnp.asarray(d[key]) for key in ("w", "wb", "p2", "p3", "ns", "nb")),
        ln_mode="none", kcap=k, interpret=True,
    )
    port = gate_group_linear_plain(
        *(_t(d[key]) for key in ("x", "p1", "buf", "cov")), None, None,
        *(_t(d[key]) for key in ("w", "wb", "p2", "p3", "ns", "nb")), ln_mode="none", kcap=k,
    )
    assert len(ref) == 4
    for got, want in zip(port, ref):
        _close(got, want)


@pytest.mark.parametrize("apply_ln", [True, False], ids=["ln", "no_ln"])
@pytest.mark.parametrize("b,n,c,heads,k", SHAPES)
def test_block_select_p_matches_jax(b, n, c, heads, k, apply_ln):
    d = _inputs(b, n, c, k)
    args = ("x", "p1", "cov", "s", "bias")
    ref = jax_gate_block.block_select_p(
        *(jnp.asarray(d[key]) for key in args), apply_ln=apply_ln, block_n=16, interpret=True
    )
    p = _t(d["p1"])
    port = block_select_p_plain(_t(d["x"]), p, *(_t(d[key]) for key in args[2:]), apply_ln=apply_ln)
    assert port is p
    _close(port, ref)


@pytest.mark.parametrize("b,n,c,heads,k", SHAPES)
def test_block_scatter_rows_matches_jax(b, n, c, heads, k):
    """Target rows in random (unsorted) order, with invalid (-1) slots."""
    rng = np.random.default_rng(4)
    buf = rng.standard_normal((b, n, 3 * c)).astype(np.float32)
    h = rng.standard_normal((b, k, 3 * c)).astype(np.float32)
    index = np.stack([rng.permutation(n)[:k] for _ in range(b)]).astype(np.int32)
    index[:, ::4] = -1
    assert not np.all(np.diff(index[index >= 0]) > 0)  # not sorted
    ref = jax_gate_block.block_scatter_rows(
        jnp.asarray(buf), jnp.asarray(index), jnp.asarray(h), block_n=16, interpret=True
    )
    port = block_scatter_rows_plain(_t(buf), torch.from_numpy(index), _t(h))
    _close(port, ref)


@pytest.mark.parametrize("window", [(4, 6), (3, 3)], ids=["4x6", "3x3"])
@pytest.mark.parametrize("c,heads", [(64, 4), (256, 4)])
def test_window_attention_windowed_matches_jax(window, c, heads):
    """The windowed form with rel-pos terms contracted from the unscaled q
    lanes against the per-token table."""
    rng = np.random.default_rng(5)
    t = window[0] * window[1]
    hd = c // heads
    qkv = rng.standard_normal((3, t, 3 * c)).astype(np.float32)
    y_rel = (0.3 * rng.standard_normal((window[0], window[0], hd))).astype(np.float32)
    x_rel = (0.3 * rng.standard_normal((window[1], window[1], hd))).astype(np.float32)
    terms = jax_window_attention.window_bias_terms(
        jnp.asarray(qkv), jnp.asarray(y_rel), jnp.asarray(x_rel), heads
    )
    scale = hd**0.5
    ref = jax_window_attention.window_attention(
        jnp.asarray(qkv), terms, heads=heads, scale=scale, a=window, p=window, interpret=True
    )
    tab = torch.cat(
        [_t(y_rel).repeat_interleave(window[1], dim=0), _t(x_rel).repeat(window[0], 1, 1)], dim=1
    )
    port_terms = window_bias_terms(_t(qkv), tab, heads)
    _close(port_terms, terms)
    port = window_attention_plain(_t(qkv), port_terms, heads=heads, scale=scale, p=window)
    _close(port, ref)
