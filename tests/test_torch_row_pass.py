"""The rule that picks the body of the row passes (``ops/row_pass.py``), and
the warp-per-row body's float32 arithmetic (``csrc/row_pass.cuh``) emulated
in numpy: row 1's norms against the JAX kernel ``ln_norms``, rows 10 and
14's select against ``gate_block.block_select_p`` and ``gate_fused.ln_select``
(all in interpret mode), and the difference norm against the JAX package's
error norm (``policies._vector_norm``); then which wrappers count their
row bodies, and rows 10 and 14's bytes in ``kernel_check.io_bytes``.

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

from eventful_transformer_tpu.core import policies as jax_policies
from eventful_transformer_tpu.ops.pallas import gate_block as jax_gate_block
from eventful_transformer_tpu.ops.pallas import gate_fused as jax_gate_fused
from eventful_transformer_tpu_torch.ops import kernel_check, row_pass

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


def _warp_ln_stats(x, elems):
    """warp_ln_stats' float32 mean and rstd of (R, C) rows, each (R, 1)."""
    c = x.shape[-1]
    mean = (_warp_sum(_lane_sums(x, elems)) / np.float32(c)).astype(np.float32)[:, None]
    dev = (x - mean).astype(np.float32)
    var = _warp_sum(_lane_sums(dev * dev, elems)) / np.float32(c)
    rstd = (1 / np.sqrt(var + np.float32(1e-6))).astype(np.float32)[:, None]
    return mean, rstd


def _warp_select(x, p, cov, scale, bias, elems, apply_ln):
    """select_warp_kernel's arithmetic in float32 on (R, C) rows: a row
    with cov > 0 takes (x - mean) * rstd * scale + bias from
    warp_store_select (x itself without the LN), the others keep p."""
    new = x
    if apply_ln:
        mean, rstd = _warp_ln_stats(x, elems)
        new = ((x - mean).astype(np.float32) * rstd * scale + bias).astype(np.float32)
    return np.where(cov[:, None] > 0, new, p)


def _warp_diff_norms(a, p, elems):
    """diff_norms_warp_kernel's float32 ||a - p|| of (R, C) rows."""
    d = (a - p).astype(np.float32)
    return np.sqrt(_warp_sum(_lane_sums(d * d, elems)))


def _select_rows(c, seed):
    """2 x 13 float32 rows (13 a batch row: no multiple of a block's 8) of
    x and p, scale and bias, and three coverages: mixed, none and all."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 13, c)).astype(np.float32)
    p = rng.standard_normal((2, 13, c)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    covs = {"mixed": (rng.random((2, 13)) < 0.4).astype(np.float32),
            "none": np.zeros((2, 13), np.float32), "all": np.ones((2, 13), np.float32)}
    return x, p, scale, bias, covs


JAX_SELECTS = {
    "block_select_p": lambda x, p, cov, s, b, ln: jax_gate_block.block_select_p(
        x, p, cov, s, b, apply_ln=ln, interpret=True),
    "ln_select": lambda x, p, cov, s, b, ln: jax_gate_fused.ln_select(
        x, p, cov, s, b, apply_ln=ln, interpret=True),
}


@pytest.mark.parametrize("cov_form", ["mixed", "none", "all"])
@pytest.mark.parametrize("apply_ln", [True, False], ids=["ln", "no_ln"])
@pytest.mark.parametrize("elems", [4, 8], ids=["f32_vectors", "bf16_vectors"])
@pytest.mark.parametrize("c", [64, 192, 768])
@pytest.mark.parametrize("name", sorted(JAX_SELECTS))
def test_warp_select_arithmetic_matches_jax(name, c, elems, apply_ln, cov_form):
    """Rows 10 and 14's warp select (the lane sums and the xor butterfly of
    its LN statistics), at the vector width of each dtype, against the JAX
    kernel in interpret mode on the same float32 rows: within TOL with the
    LN, equal without it and on every unselected row."""
    x, p, scale, bias, covs = _select_rows(c, seed=5)
    cov = covs[cov_form]
    ref = np.asarray(JAX_SELECTS[name](jnp.asarray(x), jnp.asarray(p), jnp.asarray(cov),
                                       jnp.asarray(scale), jnp.asarray(bias), apply_ln))
    got = _warp_select(x.reshape(-1, c), p.reshape(-1, c), cov.reshape(-1), scale, bias, elems,
                       apply_ln).reshape(x.shape)
    kept = cov <= 0
    np.testing.assert_array_equal(got[kept], p[kept])
    np.testing.assert_array_equal(ref[kept], p[kept])
    if apply_ln:
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("elems", [4, 8], ids=["f32_vectors", "bf16_vectors"])
@pytest.mark.parametrize("c", [64, 192, 768])
def test_warp_diff_norms_arithmetic_matches_jax(c, elems):
    """The warp difference norm's sums, at the vector width of each dtype,
    against the JAX package's error norm (``policies._vector_norm`` of a -
    p, order 2) on the same float32 rows."""
    a, p, _, _, _ = _select_rows(c, seed=6)
    ref = jax_policies._vector_norm(jnp.asarray(a) - jnp.asarray(p), -1, 2)
    got = _warp_diff_norms(a.reshape(-1, c), p.reshape(-1, c), elems)
    np.testing.assert_allclose(got.reshape(2, 13), np.asarray(ref), rtol=TOL, atol=TOL)


def test_warp_select_emulation_fails_without_the_ln():
    """The emulation's LN is what the JAX kernel checks: a select that
    copies x where the LN is asked for fails it."""
    x, p, scale, bias, covs = _select_rows(192, seed=7)
    ref = np.asarray(jax_gate_fused.ln_select(jnp.asarray(x), jnp.asarray(p),
                                              jnp.asarray(covs["all"]), jnp.asarray(scale),
                                              jnp.asarray(bias), apply_ln=True, interpret=True))
    copied = _warp_select(x.reshape(-1, 192), p.reshape(-1, 192), covs["all"].reshape(-1), scale,
                          bias, 8, apply_ln=False).reshape(x.shape)
    assert not np.allclose(copied, ref, rtol=TOL, atol=TOL)


# every wrapper that launches a row pass of csrc/row_pass.cuh, by its module
ROW_PASS_WRAPPERS = {
    "ln_norms": "gate_fused", "block_select_scatter": "gate_block",
    "block_select_p": "gate_block", "ln_select": "gate_fused",
    "qkv_attention_group": "block_fused", "proj_group": "block_fused",
    "dense_mlp_residual": "dense_mlp", "gate_group_mlp": "gate_group",
    "gate_group_linear": "gate_group", "ln_select_matmul": "gate_fused",
    "select_linear_skip_norms": "gate_fused",
}


def test_row_pass_wrappers_count_their_bodies():
    """Every wrapper with a row pass (rows 1, 9, 10, 14 and the stages of
    rows 2-5, 7, 12 and 13) counts its launches by row body, which
    ``kernel_check.row_body_launches`` reads and ``reset_launches`` zeroes,
    and ``chip_smoke.py`` checks in phase row_bodies; the plain versions the
    CPU tensors take count nothing."""
    import importlib

    import chip_smoke

    assert set(chip_smoke.ROW_PASS_WRAPPERS) == set(ROW_PASS_WRAPPERS)
    for name, module in ROW_PASS_WRAPPERS.items():
        fn = getattr(importlib.import_module(f"eventful_transformer_tpu_torch.ops.{module}"), name)
        fn.row_body_launches["warp"] += 3
    counts = kernel_check.row_body_launches()
    assert set(counts) == set(ROW_PASS_WRAPPERS)
    assert all(c == {"block": 0, "warp": 3} for c in counts.values()), counts
    kernel_check.reset_launches()
    assert all(c == {"block": 0, "warp": 0} for c in kernel_check.row_body_launches().values())
    d = kernel_check.make_inputs(2, 37, 64, 4, 11, torch.float32, "cpu", seed=1)
    for name in ("block_select_p", "block_select_p_noln", "ln_select", "ln_select_noln"):
        kernel_check.call(name, d)
    assert all(c == {"block": 0, "warp": 0} for c in kernel_check.row_body_launches().values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_select_bytes_count_the_selected_rows(dtype):
    """Rows 10 and 14 move cov, scale and bias (with the LN) whole, and x
    and p' at the selected rows only, as row 9's qkv form counts them."""
    d = kernel_check.make_inputs(2, 37, 64, 4, 11, dtype, "cpu", seed=1)
    size = torch.finfo(dtype).bits // 8
    row = 64 * size
    for name, cov in (("block_select_p", "cov1"), ("ln_select", "cov3")):
        selected = float(d[cov].sum())
        assert 0 < selected < 2 * 37
        base = 2 * 37 * 4 + 2 * selected * row  # cov, x's rows read, p's written
        assert kernel_check.io_bytes(name, d) == base + 2 * row  # scale and bias
        assert kernel_check.io_bytes(f"{name}_noln", d) == base
