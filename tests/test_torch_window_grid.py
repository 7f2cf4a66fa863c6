"""Row 15, ``window_attention_grid``: the port's plain version against the
JAX package's Pallas kernel in interpret mode, on the same numpy map, with
and without the rel-pos tables, on a map whose extents are the window
grid's and on a padded one (the image's tokens, then pad positions that
hold the qkv-bias row, as the padded windowed form's inputs do); and
against the port's partitioned ``window_attention`` plain version over the
partition of the same map.

float32 at rtol/atol 1e-5, as ``tests/test_pallas.py`` holds the JAX grid
kernel to its partitioned one: the sides differ in summation order only.
bfloat16 within ``ops/kernel_check.py``'s bounds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.ops.pallas import window_attention as jax_wa
from eventful_transformer_tpu_torch.ops import kernel_check
from eventful_transformer_tpu_torch.ops import window_attention as wa

C, HEADS = 32, 4
HD = C // HEADS
SCALE = float(np.sqrt(HD))
# (B, Hp, Wp, window, image (h, w)): the window grid exactly, and a padded map
MAPS = {"exact": (2, 4, 6, (2, 3), (4, 6)), "padded": (2, 6, 9, (3, 3), (5, 7))}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _inputs(key, seed=0):
    """The map (pad positions hold the bias row) and tables (a, a, hd), as
    float32 numpy arrays, with the image extents and the bias row."""
    b, hp, wp, window, (h, w) = MAPS[key]
    rng = np.random.default_rng(seed)
    bias = rng.standard_normal(3 * C).astype(np.float32)
    x = np.broadcast_to(bias, (b, hp, wp, 3 * C)).copy()
    x[:, :h, :w] = rng.standard_normal((b, h, w, 3 * C))
    yr = (0.3 * rng.standard_normal((window[0], window[0], HD))).astype(np.float32)
    xr = (0.3 * rng.standard_normal((window[1], window[1], HD))).astype(np.float32)
    return x, yr, xr, window, (h, w), bias


def _jax(x, yr, xr, window, dtype, tables):
    rel = (jnp.asarray(yr), jnp.asarray(xr)) if tables else ()
    out = jax_wa.window_attention_grid(
        jnp.asarray(x, dtype), *rel, heads=HEADS, scale=SCALE, window=window,
        a=window if tables else None, p=window if tables else None, interpret=True,
    )
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


@pytest.mark.parametrize("tables", [True, False], ids=["terms", "no_terms"])
@pytest.mark.parametrize("key", sorted(MAPS))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_window_attention_grid_matches_jax(dtype, key, tables):
    x, yr, xr, window, _, _ = _inputs(key)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    ref = _jax(x, yr, xr, window, jdt, tables)
    rel = (torch.from_numpy(yr), torch.from_numpy(xr)) if tables else ()
    got = wa.window_attention_grid(
        torch.from_numpy(x).to(tdt), *rel, heads=HEADS, scale=SCALE, window=window,
        a=window if tables else None,
    )
    assert got.shape == x.shape[:3] + (C,) and got.dtype == tdt
    if tdt == torch.float32:
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    else:
        row = kernel_check.compare(got, ref.to(tdt))
        assert row["ok"], row


def _partition(m, window):
    b, hp, wp, ch = m.shape
    a0, a1 = window
    m = m.reshape(b, hp // a0, a0, wp // a1, a1, ch).permute(0, 1, 3, 2, 4, 5)
    return m.reshape(-1, a0 * a1, ch)


@pytest.mark.parametrize("key", sorted(MAPS))
def test_grid_plain_matches_the_partitioned_form(key):
    """The grid over the map against ``window_attention_plain`` over its
    partition, with the terms of ``window_bias_terms``: the windowed form
    on the exact map; on the padded one the padded form, fed the partition
    of the zero-padded map with the bias row and its terms substituted at
    pad rows. Compared at the image's rows, in float32."""
    x, yr, xr, window, (h, w), bias = _inputs(key, seed=1)
    a0, a1 = window
    tab = torch.cat([
        torch.from_numpy(yr).repeat_interleave(a1, dim=0), torch.from_numpy(xr).repeat(a0, 1, 1)
    ], dim=1)
    xt = torch.from_numpy(x)
    got = wa.window_attention_grid_plain(
        xt, torch.from_numpy(yr), torch.from_numpy(xr), heads=HEADS, scale=SCALE, window=window,
        a=window,
    )
    b, hp, wp, _ = x.shape
    zero = torch.zeros_like(xt)
    zero[:, :h, :w] = xt[:, :h, :w]
    win = _partition(zero, window)
    terms = wa.window_bias_terms(win, tab, HEADS)
    pad = {}
    if (h, w) != (hp, wp):
        bias_t = torch.from_numpy(bias)
        pad = dict(pad_bias=bias_t, pad_terms=wa.window_bias_pad_terms(bias_t, tab, HEADS),
                   a=window, geom=(hp // a0, wp // a1, h, w))
    out = wa.window_attention_plain(win, terms, heads=HEADS, scale=SCALE, p=window, **pad)
    out = out.reshape(b, hp // a0, wp // a1, a0, a1, C).permute(0, 1, 3, 2, 4, 5)
    want = out.reshape(b, hp, wp, C)
    np.testing.assert_allclose(got[:, :h, :w].numpy(), want[:, :h, :w].numpy(), rtol=1e-5,
                               atol=1e-5)


def test_grid_rejects_a_map_off_the_window_grid():
    x = torch.zeros((1, 5, 6, 3 * C))
    with pytest.raises(ValueError, match="multiple"):
        wa.window_attention_grid(x, heads=HEADS, scale=SCALE, window=(2, 3))
