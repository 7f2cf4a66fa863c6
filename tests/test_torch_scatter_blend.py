"""``put_rows`` as one kernel (``ops/scatter_blend.py``, the JAX package's
``scatter_blend``) and the ``USE_PALLAS_BLEND`` switch that routes to it.

- ``scatter_blend_plain`` against the JAX Pallas kernel in interpret mode,
  on the same numpy inputs: N = 197 (not a multiple of the kernel's
  block_n = 64), a mask, float32 and bfloat16, distinct indices and a
  duplicated one (the one-hot blend's -x + v1 + v2). Bit for bit: both sides
  compute x * (1 - cov) + the matched values in float32 and round once.
- ``put_rows`` with the switch on and CPU tensors: the calls the JAX rule
  takes (3-D x, 2-D index, C % 128 == 0) run the blend (bit for bit the
  index copy on distinct indices; -x + v1 + v2 at a duplicate), the others
  the index copy.
- An unfused STGT block (C = 128, so every buffer's scatter is eligible)
  with the switch on, a flush and 3 steps against the JAX package: outputs,
  state and counts at 2e-5 / rtol 1e-6 (tests/test_torch_gate_before_ln.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.ops.pallas.scatter_blend import scatter_blend as jax_scatter_blend
from eventful_transformer_tpu_torch.core import indexing
from eventful_transformer_tpu_torch.ops.scatter_blend import scatter_blend_plain
from tests.test_torch_gate_before_ln import _pair, _run_and_compare

B, N, C, K = 2, 197, 256, 98
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _count_blends(monkeypatch):
    """The x shape of every call put_rows routes to the blend."""
    calls = []

    def counted(x, values, index, mask):
        calls.append(x.shape)
        return scatter_blend_plain(x, values, index, mask)

    monkeypatch.setattr(indexing, "scatter_blend", counted)
    return calls


def _inputs(seed, duplicate=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    values = rng.standard_normal((B, K, C)).astype(np.float32)
    index = np.stack([rng.permutation(N)[:K] for _ in range(B)]).astype(np.int32)
    mask = rng.random((B, K)) < 0.8
    if duplicate:  # slot 7 names slot 3's row, both valid
        index[0, 7] = index[0, 3]
        mask[0, [3, 7]] = True
    return x, values, index, mask


@pytest.mark.parametrize("duplicate", [False, True], ids=["distinct", "duplicate"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_scatter_blend_plain_matches_jax(dtype, duplicate):
    tdt, jdt = DTYPES[dtype]
    x, values, index, mask = _inputs(3, duplicate)
    ref = jax_scatter_blend(
        jnp.asarray(x, jdt), jnp.asarray(values), jnp.asarray(index), jnp.asarray(mask),
        interpret=True,
    )
    got = scatter_blend_plain(
        torch.from_numpy(x).to(tdt), torch.from_numpy(values), torch.from_numpy(index),
        torch.from_numpy(mask),
    )
    assert got.dtype == tdt and got.shape == (B, N, C)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    if duplicate:
        row = index[0, 3]
        want = -x[0, row] + (values[0, 3] + values[0, 7])
        if dtype == "f32":
            np.testing.assert_array_equal(got[0, row].numpy(), want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_put_rows_routes_eligible_calls_to_the_blend(dtype, monkeypatch):
    tdt = DTYPES[dtype][0]
    x, values, index, mask = (torch.from_numpy(a) for a in _inputs(4))
    x = x.to(tdt)
    off = indexing.put_rows(x, index, values, mask)
    monkeypatch.setattr(indexing, "USE_PALLAS_BLEND", True)
    calls = _count_blends(monkeypatch)
    on = indexing.put_rows(x, index, values, mask)
    assert len(calls) == 1 and torch.equal(on, off)
    # a duplicated valid index: the blend's -x + v1 + v2, not the copy's one write
    dup = index.clone()
    dup[0, 7] = dup[0, 3]
    full = torch.ones_like(mask)
    row = int(dup[0, 3])
    blended = indexing.put_rows(x, dup, values, full)
    want = -x[0, row].float() + (values[0, 3].to(tdt).float() + values[0, 7].to(tdt).float())
    assert torch.equal(blended[0, row], want.to(tdt))
    # not eligible: a row width that is no multiple of 128, a 4-D x
    for xx, idx, vals in ((x[..., :100], index, values[..., :100]),
                          (x[None], index[None], values[None])):
        assert torch.equal(indexing.put_rows(xx, idx, vals, None),
                           _index_copy(xx, idx, vals))
    assert len(calls) == 2


def _index_copy(x, index, values):
    out = x.clone()
    out.scatter_(-2, index.long()[..., None].expand(values.shape), values.to(x.dtype))
    return out


def test_stgt_block_with_the_blend_matches_jax(monkeypatch):
    """Every buffer scatter of an unfused STGT block (qkv 3C = 384,
    projection and MLP C = 128) through the blend: 3 a step."""
    monkeypatch.setattr(indexing, "USE_PALLAS_BLEND", True)
    calls = _count_blends(monkeypatch)
    kwargs = dict(dim=128, heads=4, mlp_ratio=2, input_size=(4, 6), stgt=True)
    jax_blk, blk, params = _pair("EventfulTokenwiseBlock", kwargs, False)
    assert blk._fused_mode(24) is False and not blk.recompute_buffers
    _run_and_compare(jax_blk, blk, params)
    assert sorted(set(s[-1] for s in calls)) == [128, 384] and len(calls) == 3 * 3
