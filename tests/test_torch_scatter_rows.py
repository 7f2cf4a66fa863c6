"""Rows 19 and 20, ``scatter_rows_inplace`` and ``gather_rows``: the port's
plain versions against the JAX package's Pallas kernels in interpret mode,
on the same numpy inputs, bit for bit in float32 and bfloat16 (pure row
copies), at the shapes of ``tests/test_pallas.py``'s tests of the same
kernels and at a ragged one; the float32-values-into-bfloat16 cast, the
in-place return and the out-of-range slots against a numpy loop."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.ops.pallas import scatter as jax_scatter
from eventful_transformer_tpu_torch.ops import scatter

SHAPES = [(2, 16, 256, 5), (3, 37, 128, 11)]  # (B, N, C, K)
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _inputs(b, n, c, k, seed=0):
    rng = np.random.default_rng(seed)
    buf = rng.standard_normal((b, n, c)).astype(np.float32)
    vals = rng.standard_normal((b, k, c)).astype(np.float32)
    idx = np.stack([rng.choice(n, k, replace=False) for _ in range(b)]).astype(np.int32)
    mask = rng.integers(0, 2, (b, k)).astype(bool)
    return buf, vals, idx, mask


def _same(port, ref):
    np.testing.assert_array_equal(port.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "all_valid"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_scatter_rows_matches_jax(shape, dtype, masked):
    tdt, jdt = DTYPES[dtype]
    buf, vals, idx, mask = _inputs(*shape)
    mask = mask if masked else None
    ref = jax_scatter.scatter_rows_inplace(
        jnp.asarray(buf, jdt), jnp.asarray(vals, jdt), jnp.asarray(idx),
        None if mask is None else jnp.asarray(mask), interpret=True,
    )
    got = scatter.scatter_rows_inplace(
        torch.from_numpy(buf).to(tdt), torch.from_numpy(vals).to(tdt), torch.from_numpy(idx),
        None if mask is None else torch.from_numpy(mask),
    )
    _same(got, ref)


def test_scatter_rows_casts_float32_values_into_bfloat16():
    """float32 values into a bfloat16 buffer: each rounded to nearest even,
    as the JAX wrapper's astype rounds them."""
    buf, vals, idx, mask = _inputs(2, 16, 256, 5, seed=1)
    ref = jax_scatter.scatter_rows_inplace(
        jnp.asarray(buf, jnp.bfloat16), jnp.asarray(vals), jnp.asarray(idx), jnp.asarray(mask),
        interpret=True,
    )
    got = scatter.scatter_rows_inplace(
        torch.from_numpy(buf).to(torch.bfloat16), torch.from_numpy(vals), torch.from_numpy(idx),
        torch.from_numpy(mask),
    )
    assert got.dtype == torch.bfloat16
    _same(got, ref)
    values = torch.from_numpy(vals)
    assert not torch.equal(values.to(torch.bfloat16).float(), values)  # the cast rounds


def test_scatter_rows_writes_in_place_and_skips_out_of_range():
    """The caller's buffer is written and returned; a slot naming a row
    outside [0, N), or masked off, writes nothing."""
    b, n, c, k = 2, 16, 128, 6
    buf, vals, idx, mask = _inputs(b, n, c, k, seed=2)
    idx[0, 1], idx[1, 4] = -1, n
    want = buf.copy()
    for i in range(b):
        for j in range(k):
            if mask[i, j] and 0 <= idx[i, j] < n:
                want[i, idx[i, j]] = vals[i, j]
    buffer = torch.from_numpy(buf.copy())
    got = scatter.scatter_rows_inplace(
        buffer, torch.from_numpy(vals), torch.from_numpy(idx).long(), torch.from_numpy(mask)
    )
    assert got is buffer
    np.testing.assert_array_equal(buffer.numpy(), want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(2, 16, 256, 7), (3, 37, 128, 11)],
                         ids=lambda s: "x".join(map(str, s)))
def test_gather_rows_matches_jax(shape, dtype):
    tdt, jdt = DTYPES[dtype]
    buf, _, idx, _ = _inputs(*shape)
    ref = jax_scatter.gather_rows(jnp.asarray(buf, jdt), jnp.asarray(idx), interpret=True)
    got = scatter.gather_rows(torch.from_numpy(buf).to(tdt), torch.from_numpy(idx))
    assert got.shape == shape[:1] + shape[3:] + shape[2:3]
    _same(got, ref)


def test_gather_rows_zeroes_out_of_range_slots():
    buf, _, idx, _ = _inputs(2, 16, 128, 5, seed=3)
    idx[1, 2] = -3
    got = scatter.gather_rows(torch.from_numpy(buf), torch.from_numpy(idx)).numpy()
    assert not got[1, 2].any()
    np.testing.assert_array_equal(got[0], buf[0][idx[0]])


def test_row_width_must_be_whole_lanes():
    """The JAX kernels' rule (C % 128 == 0) holds in the port too, so that
    the same calls are valid in both packages."""
    buf = torch.zeros((2, 16, 64))
    idx = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="C % 128"):
        scatter.gather_rows(buf, idx)
    with pytest.raises(ValueError, match="C % 128"):
        scatter.scatter_rows_inplace(buf, torch.zeros((2, 3, 64)), idx)
