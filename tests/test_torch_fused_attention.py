"""Row 21, ``fused_attention``: the port's plain version against the JAX
package's Pallas kernel in interpret mode, on the same numpy inputs, in
float32 and bfloat16, without and with the matmul-2 cast, at ViViT's
temporal length (17) and a ragged one (37).

float32 at rtol/atol 1e-5: both sides compute in float32 and differ in
summation order only; with the cast, the probabilities rounded to
bfloat16 on both sides. bfloat16 within ``ops/kernel_check.py``'s bounds,
which a dropped rounding point fails: the two frameworks sum in other
orders, so an output near a bfloat16 rounding boundary may land one ulp
apart."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.ops.pallas import attention as jax_attention
from eventful_transformer_tpu_torch.ops import kernel_check
from eventful_transformer_tpu_torch.ops.attention import fused_attention, fused_attention_plain

B, C, HEADS = 2, 64, 4
SCALE = float(np.sqrt(C // HEADS))
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
CASTS = {"no_cast": (None, None), "cast_bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _qkv(n, seed=0):
    return np.random.default_rng(seed).standard_normal((B, n, 3 * C)).astype(np.float32)


@pytest.mark.parametrize("n", [17, 37])
@pytest.mark.parametrize("cast", sorted(CASTS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_attention_matches_jax(dtype, cast, n):
    (tdt, jdt), (tcast, jcast) = DTYPES[dtype], CASTS[cast]
    qkv = _qkv(n)
    ref = jax_attention.fused_attention(
        jnp.asarray(qkv, jdt), heads=HEADS, scale=SCALE, cast=jcast, interpret=True
    )
    got = fused_attention(torch.from_numpy(qkv).to(tdt), heads=HEADS, scale=SCALE, cast=tcast)
    assert got.shape == (B, n, C) and got.dtype == tdt
    want = torch.from_numpy(np.array(ref.astype(jnp.float32))).to(tdt)
    if tdt == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    else:
        row = kernel_check.compare(got, want)
        assert row["ok"], row


def test_cast_rounds_the_probabilities():
    """The cast is a rounding point of its own: in float32 it moves the
    output by far more than the summation order does."""
    qkv = torch.from_numpy(_qkv(37, seed=1))
    plain = fused_attention_plain(qkv, heads=HEADS, scale=SCALE)
    cast = fused_attention_plain(qkv, heads=HEADS, scale=SCALE, cast=torch.bfloat16)
    assert float((plain - cast).abs().max()) > 1e-3
    same = fused_attention_plain(qkv, heads=HEADS, scale=SCALE, cast=torch.float32)
    assert torch.equal(same, plain)


def test_rejects_other_casts_and_widths():
    qkv = torch.zeros((B, 5, 3 * C))
    with pytest.raises(ValueError, match="cast"):
        fused_attention(qkv, heads=HEADS, scale=SCALE, cast=torch.float16)
    with pytest.raises(ValueError, match="heads wide"):
        fused_attention(qkv, heads=5, scale=SCALE)
