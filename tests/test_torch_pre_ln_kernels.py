"""The plain versions of the kernel forms a gate before its LayerNorm runs
(``gate_before_ln``) against the JAX package's Pallas kernels in interpret
mode, on the same numpy inputs: ``gate_group_mlp`` and ``gate_group_linear``
with ``ln_mode="pre"``, ``ln_select_matmul`` "pre",
``select_linear_skip_norms`` with ``next_ln=False``, ``ln_select``,
``block_select_p`` and ``block_select_scatter`` (qkv and MLP forms) with
``apply_ln=False``.

float32 at rtol/atol 2e-5, the tolerance the JAX package's own kernel tests
use: both sides compute in float32 and differ only in summation order.
bfloat16 within the bounds ``ops/kernel_check.py`` holds the CUDA kernels
to against the same plain versions (scaled error <= 2e-2, <= 5 % of the
elements differing, <= 1 % by more than one ulp), float32 outputs (norms)
at 1e-4 scaled: both sides round at the same points, so an element differs
only where a float32 sum lies within its summation error of a rounding
boundary. The norms of a bfloat16 run are taken of the rounded output y,
where XLA on the CPU, keeping excess precision, may take them of y before
its rounding: they are held within the norm of the two sides' y difference
plus that of y's rounding error (2**-8 of |y|; the triangle inequality),
plus 1e-4 scaled.
The gate state each kernel updates is checked to be updated in place.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.ops.pallas import gate_block as jax_gate_block
from eventful_transformer_tpu.ops.pallas import gate_fused as jax_gate_fused
from eventful_transformer_tpu.ops.pallas import gate_group as jax_gate_group
from eventful_transformer_tpu_torch.ops import kernel_check
from eventful_transformer_tpu_torch.ops.gate_block import (
    block_select_p_plain,
    block_select_scatter_plain,
)
from eventful_transformer_tpu_torch.ops.gate_fused import (
    ln_select_matmul_plain,
    ln_select_plain,
    select_linear_skip_norms_plain,
)
from eventful_transformer_tpu_torch.ops.gate_group import (
    gate_group_linear_plain,
    gate_group_mlp_plain,
)

TOL = 2e-5
SHAPES = [(2, 24, 64, 9), (2, 37, 256, 11)]  # (B, N, C, k)
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _inputs(b, n, c, k, seed=0):
    """Activations, input-domain gate states, buffers, LN and linear params
    and a coverage with exactly k ones per row, as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    cov = np.zeros((b, n), np.float32)
    for i in range(b):
        cov[i, rng.permutation(n)[:k]] = 1.0
    return dict(
        x=f(b, n, c), p=f(b, n, c), buf=f(b, n, c), bufq=f(b, n, 3 * c), skip=f(b, n, c),
        p_next=f(b, n, c), cov=cov, s=1.0 + f(c, scale=0.1), bias=f(c, scale=0.1),
        w=f(c, 3 * c, scale=c**-0.5), wb=f(3 * c, scale=0.1), w_proj=f(c, c, scale=c**-0.5),
        wb_proj=f(c, scale=0.1), w1=f(c, 2 * c, scale=c**-0.5), b1=f(2 * c, scale=0.1),
        w2=f(2 * c, c, scale=(2 * c) ** -0.5), b2=f(c, scale=0.1),
    )


def _pair(d, dtype):
    """The inputs as JAX arrays and torch tensors of one dtype (cov
    float32)."""
    tdt, jdt = DTYPES[dtype]
    jx = {k: jnp.asarray(v, jnp.float32 if k == "cov" else jdt) for k, v in d.items()}
    tx = {k: torch.from_numpy(v).to(torch.float32 if k == "cov" else tdt) for k, v in d.items()}
    return jx, tx


def _close(port, ref):
    """Port output against the JAX one: 2e-5 in float32, kernel_check's
    bounds in bfloat16."""
    ref = torch.from_numpy(np.array(jnp.asarray(ref, jnp.float32)))
    if port.dtype == torch.bfloat16:
        row = kernel_check.compare(port, ref.to(torch.bfloat16))
        assert row["ok"], row
    else:
        np.testing.assert_allclose(port.numpy(), ref.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,n,c,k", SHAPES)
def test_gate_group_mlp_pre_matches_jax(b, n, c, k, dtype):
    """The MLP group of a gate before its LN: x into p, the compacted rows
    normalised, the MLP, the scatter-blend and the residual."""
    jx, tx = _pair(_inputs(b, n, c, k), dtype)
    args = ("x", "p", "buf", "cov", "s", "bias", "w1", "b1", "w2", "b2")
    ref = jax_gate_group.gate_group_mlp(
        *(jx[key] for key in args), ln_mode="pre", kcap=k, interpret=True
    )
    p, buf = tx["p"], tx["buf"]
    port = gate_group_mlp_plain(*(tx[key] for key in args), ln_mode="pre", kcap=k)
    assert port[0] is p and port[1] is buf and port[3] is None
    assert len(ref) == 3
    for got, want in zip(port, ref):
        _close(got, want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,n,c,k", SHAPES)
def test_gate_group_linear_pre_matches_jax(b, n, c, k, dtype):
    """The qkv group of a gate before its LN ("v2", global blocks): F = 3C,
    no skip."""
    jx, tx = _pair(_inputs(b, n, c, k), dtype)
    args = ("x", "p", "bufq", "cov", "s", "bias", "w", "wb")
    ref = jax_gate_group.gate_group_linear(
        *(jx[key] for key in args), ln_mode="pre", kcap=k, interpret=True
    )
    port = gate_group_linear_plain(*(tx[key] for key in args), ln_mode="pre", kcap=k)
    assert port[0] is tx["p"] and port[1] is tx["bufq"] and port[2] is None
    assert len(ref) == 2
    for got, want in zip(port[:2], ref):
        _close(got, want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,n,c,k", SHAPES)
def test_ln_select_matmul_pre_matches_jax(b, n, c, k, dtype):
    """The qkv group of "v1"/"v1v2"/"v3" before the LN: p' = where(cov, x,
    p), y = ln(p') W + b over every row."""
    jx, tx = _pair(_inputs(b, n, c, k), dtype)
    args = ("x", "p", "cov", "s", "bias", "w", "wb")
    ref = jax_gate_fused.ln_select_matmul(
        *(jx[key] for key in args), ln_mode="pre", block_n=16, interpret=True
    )
    port = ln_select_matmul_plain(*(tx[key] for key in args), ln_mode="pre")
    assert port[0] is tx["p"]
    for got, want in zip(port, ref):
        _close(got, want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,n,c,k", SHAPES)
def test_select_linear_skip_norms_no_ln_matches_jax(b, n, c, k, dtype):
    """The projection group of "v3" ahead of an MLP gate before its LN: the
    norms ||y - p_next|| with no LN."""
    jx, tx = _pair(_inputs(b, n, c, k), dtype)
    args = ("x", "p", "cov", "w_proj", "wb_proj", "skip", "p_next", "s", "bias")
    ref = jax_gate_fused.select_linear_skip_norms(
        *(jx[key] for key in args), next_ln=False, block_n=16, interpret=True
    )
    port = select_linear_skip_norms_plain(
        *(tx[key] for key in args[:7]), None, None, next_ln=False
    )
    assert port[0] is tx["p"] and port[2].dtype == torch.float32
    for got, want in zip(port[:2], ref[:2]):
        _close(got, want)
    norms, want = port[2], torch.from_numpy(np.array(ref[2]))
    if dtype == "f32":
        _close(norms, want)
    else:
        y = port[1].float()
        y_gap = y - torch.from_numpy(np.array(ref[1].astype(jnp.float32)))
        rounding = (y.abs() * 2.0**-8).square().sum(-1).sqrt()
        slack = y_gap.square().sum(-1).sqrt() + rounding + 1e-4 * want.abs().clamp(min=1.0)
        assert ((norms - want).abs() <= slack).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,n,c,k", SHAPES)
def test_ln_select_no_ln_matches_jax(b, n, c, k, dtype):
    """The MLP gate of "v1" before the LN: p' = where(cov, x, p)."""
    jx, tx = _pair(_inputs(b, n, c, k), dtype)
    args = ("x", "p", "cov", "s", "bias")
    ref = jax_gate_fused.ln_select(
        *(jx[key] for key in args), apply_ln=False, block_n=16, interpret=True
    )
    port = ln_select_plain(tx["x"], tx["p"], tx["cov"], None, None, apply_ln=False)
    assert port is tx["p"]
    _close(port, ref)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,n,c,k", SHAPES)
def test_block_select_p_no_ln_matches_jax(b, n, c, k, dtype):
    """The windowed qkv group's gate-state select before the LN."""
    jx, tx = _pair(_inputs(b, n, c, k), dtype)
    args = ("x", "p", "cov", "s", "bias")
    ref = jax_gate_block.block_select_p(
        *(jx[key] for key in args), apply_ln=False, block_n=16, interpret=True
    )
    port = block_select_p_plain(tx["x"], tx["p"], tx["cov"], None, None, apply_ln=False)
    assert port is tx["p"]
    _close(port, ref)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("form", ["qkv", "mlp"])
def test_block_select_scatter_no_ln_matches_jax(form, dtype):
    """The blocked qkv (F = 3C) and MLP (residual x) groups of a gate before
    its LN, at N = 600 (two of the JAX kernel's 512-row blocks), the
    selected rows in no order with invalid slots (-1 in the port, N in the
    JAX package)."""
    b, n, c, k = 2, 600, 64, 40
    f = 3 * c if form == "qkv" else c
    rng = np.random.default_rng(20)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    d = dict(x=r(b, n, c), p=r(b, n, c), buf=r(b, n, f), h=r(b, k, f),
             s=np.ones(c, np.float32), bias=np.zeros(c, np.float32))
    index = np.stack([rng.permutation(n)[:k] for _ in range(b)]).astype(np.int32)
    valid = np.ones((b, k), bool)
    valid[:, ::7] = False
    cov = np.zeros((b, n), np.float32)
    for i in range(b):
        cov[i, index[i][valid[i]]] = 1.0
    jx, tx = _pair(dict(d, cov=cov), dtype)
    residual_x = form == "mlp"
    ref = jax_gate_block.block_select_scatter(
        jx["x"], jx["p"], jx["buf"], jx["cov"], jnp.asarray(np.where(valid, index, n)), jx["h"],
        jx["s"], jx["bias"], apply_ln=False, residual_x=residual_x, interpret=True,
    )
    port = block_select_scatter_plain(
        tx["x"], tx["p"], tx["buf"], tx["cov"], torch.from_numpy(np.where(valid, index, -1)),
        tx["h"], None, None, apply_ln=False, residual_x=residual_x,
    )
    assert port[0] is tx["p"] and port[1] is tx["buf"]
    assert len(port) == len(ref) == (3 if residual_x else 2)
    for got, want in zip(port, ref):
        _close(got, want)
