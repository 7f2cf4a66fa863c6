"""The rule that picks the body of rows 1 and 9 (``ops/row_pass.py``), and
the warp-per-row body's float32 arithmetic (``csrc/row_pass.cuh``) emulated
in numpy against the JAX kernel ``ln_norms`` in interpret mode.

The emulation keeps the kernel's order of float32 sums: each lane sums its
16-byte vectors (lane + 32 j, in j and then element order), then the warp
adds the 32 partial sums by the xor butterfly of ``warp_sum`` (offsets 16,
8, 4, 2, 1); the mean, then the sum of squared deviations, then the
squared errors of ``(x - mean) * rstd * scale + bias - p``. Against the
JAX kernel at TOL = 2e-5, the tolerance of the JAX package's own kernel
tests: both sides sum in float32, in other orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.ops.pallas import gate_fused as jax_gate_fused
from eventful_transformer_tpu_torch.ops import row_pass

TOL = 2e-5
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("widths", [(768,), (768, 768), (768, 2304), (64,), (192,), (64, 192)],
                         ids=lambda w: "x".join(map(str, w)))
def test_path_shapes_take_the_warp_body(widths, dtype):
    """ViT-B's C = 768 and F = 768 or 2304 (rows 1 and 9 on every model
    path) and the tests' slim widths take the warp-per-row body in both
    dtypes."""
    assert row_pass.row_body(DTYPES[dtype], widths) == "warp"


@pytest.mark.parametrize("dtype,widths", [
    ("bf16", (100,)), ("f32", (98,)), ("bf16", (768, 100)), ("f32", (2308,)),
    ("f32", (768, 2320)), ("bf16", (4616,)), ("bf16", (0,)),
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_off_rule_widths_take_the_block_body(dtype, widths):
    """A width of no whole 16-byte vectors, or beyond the 18 vectors a lane
    the template holds (2304 float32, 4608 bfloat16 values), takes the
    block-per-row body."""
    assert row_pass.row_body(DTYPES[dtype], widths) == "block"


def test_widest_rows_the_warp_body_holds():
    """32 lanes x 18 vectors: 2304 float32 or 4608 bfloat16 values (one
    vector more: test_off_rule_widths_take_the_block_body)."""
    assert row_pass.row_body(torch.float32, (2304,)) == "warp"
    assert row_pass.row_body(torch.bfloat16, (4608,)) == "warp"


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_misaligned_operands_take_the_block_body(dtype):
    assert row_pass.row_body(DTYPES[dtype], (768,), aligned=False) == "block"


def _warp_sum(lanes):
    """``warp_sum``'s xor butterfly over the last axis (32 lanes), float32."""
    for offset in (16, 8, 4, 2, 1):
        lanes = (lanes + lanes[..., np.arange(32) ^ offset]).astype(np.float32)
    return lanes[..., 0]


def _lane_sums(terms, elems):
    """Each lane's float32 sum of its vectors' terms (R, C): vector lane +
    32 j, in j and then element order."""
    rows, c = terms.shape
    nv = c // elems
    lanes = np.zeros((rows, 32), np.float32)
    for j in range(-(-nv // 32)):
        vec = np.arange(32) + 32 * j
        for e in range(elems):
            col = np.minimum(vec * elems + e, c - 1)
            lanes = (lanes + np.where(vec < nv, terms[:, col], 0)).astype(np.float32)
    return lanes


def _warp_ln_norms(x, p, scale, bias, elems):
    """ln_norms_kernel's arithmetic in float32 on (R, C) rows."""
    c = x.shape[-1]
    mean = (_warp_sum(_lane_sums(x, elems)) / np.float32(c)).astype(np.float32)[:, None]
    dev = (x - mean).astype(np.float32)
    var = _warp_sum(_lane_sums(dev * dev, elems)) / np.float32(c)
    rstd = (1 / np.sqrt(var + np.float32(1e-6))).astype(np.float32)[:, None]
    err = (dev * rstd * scale + bias - p).astype(np.float32)
    return np.sqrt(_warp_sum(_lane_sums(err * err, elems)))


@pytest.mark.parametrize("elems", [4, 8], ids=["f32_vectors", "bf16_vectors"])
@pytest.mark.parametrize("c", [64, 192, 768, 2304])
def test_warp_ln_norms_arithmetic_matches_jax(c, elems):
    """The warp body's sums, at the vector width of each dtype, against the
    JAX kernel in interpret mode on the same float32 rows (2 x 13 rows, no
    multiple of a block's 8)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 13, c)).astype(np.float32)
    p = rng.standard_normal((2, 13, c)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    ref = jax_gate_fused.ln_norms(jnp.asarray(x), jnp.asarray(p), jnp.asarray(scale),
                                  jnp.asarray(bias), interpret=True)
    got = _warp_ln_norms(x.reshape(-1, c), p.reshape(-1, c), scale, bias, elems)
    np.testing.assert_allclose(got.reshape(2, 13), np.asarray(ref), rtol=TOL, atol=TOL)
