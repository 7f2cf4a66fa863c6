"""The port's decomposed rel-pos bias add against the JAX package: the plain
versions of ``relpos_bias_add`` (row 16) and ``relpos_bias_add_v2`` (row
17) against the Pallas kernels in interpret mode, and
``RelativePositionEmbedding.forward`` with each ``use_kernel`` value
against the JAX ``apply`` with the matching ``use_pallas_kernel``, counts
included.

Tolerances. float32: 1e-5 max abs error (both sides sum the c-long dot
products in float32, in other orders). bfloat16: the two sides make the
same roundings, so an element differs only where a float32 dot product
lies within its summation error of a bfloat16 rounding boundary of a term,
the bias or the sum: at most one ulp of the output, on at most 2 % of the
elements (measured: none differ at these shapes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.core import embeddings as jax_embeddings
from eventful_transformer_tpu.core.counting import Counts, Ctx as JaxCtx
from eventful_transformer_tpu.ops.pallas import relpos as jax_relpos
from eventful_transformer_tpu.utils.params import fill_like
from eventful_transformer_tpu_torch.core import embeddings
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.ops import kernel_check, relpos
from eventful_transformer_tpu_torch.utils.params import flatten_tree, params_from_jax

F32_TOL = 1e-5
BF16_DIFFER_SHARE = 2e-2

# (a, p): a pooled non-square grid, a square unpooled one
# and a pooled one with a1 > 16 (two token blocks of the kernel per row)
GRIDS = [((6, 5), (3, 5)), ((4, 4), (4, 4)), ((2, 18), (1, 9))]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _inputs(a, p, c=8, bsz=2, heads=3, seed=0):
    rng = np.random.default_rng(seed)
    n, np_ = a[0] * a[1], p[0] * p[1]
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(bsz, heads, n, np_), f(bsz, heads, n, c), f(a[0], p[0], c), f(a[1], p[1], c)


@pytest.mark.parametrize("grid", GRIDS, ids=["pooled_6x5", "square_4x4", "wide_2x18"])
@pytest.mark.parametrize("form", ["relpos_bias_add", "relpos_bias_add_v2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel(form, grid, dtype):
    a, p = grid
    arrays = _inputs(a, p)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = getattr(jax_relpos, form)(*(jnp.asarray(v, jdt) for v in arrays), a=a, p=p,
                                      interpret=True)
    got = getattr(relpos, form + "_plain")(*(torch.from_numpy(v).to(tdt) for v in arrays), a=a, p=p)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_TOL)
        return
    ref = torch.from_numpy(np.array(want.astype(jnp.float32))).to(torch.bfloat16)
    gap = (kernel_check._ulp_order(got) - kernel_check._ulp_order(ref)).abs()
    assert int(gap.max()) <= 1
    assert float((gap > 0).float().mean()) <= BF16_DIFFER_SHARE


def test_forms_differ_where_they_round():
    """In bfloat16 the two forms round at other points: some elements
    differ between them (each matching its own JAX kernel above); in
    float32 they agree to summation order."""
    a, p = GRIDS[0]
    arrays = [torch.from_numpy(v) for v in _inputs(a, p, seed=1)]
    bf = [v.to(torch.bfloat16) for v in arrays]
    v1 = relpos.relpos_bias_add_plain(*bf, a=a, p=p)
    v2 = relpos.relpos_bias_add_v2_plain(*bf, a=a, p=p)
    assert bool((v1 != v2).any())
    torch.testing.assert_close(relpos.relpos_bias_add_plain(*arrays, a=a, p=p),
                               relpos.relpos_bias_add_v2_plain(*arrays, a=a, p=p),
                               rtol=0, atol=F32_TOL)


@pytest.mark.parametrize(
    "use_kernel,jax_value",
    [(False, False), ("auto", False), (True, True), ("v2", "v2")],
    ids=["einsum", "auto_cpu", "row16", "row17"],
)
@pytest.mark.parametrize(
    "attention,embedding,pool",
    [((6, 6), (8, 8), (2, 2)), ((4, 6), (4, 6), None)],
    ids=["resized_pooled", "rect"],
)
def test_relative_position_forward_matches_jax(use_kernel, jax_value, attention, embedding, pool):
    """The logits path of a global block: each ``use_kernel`` value
    against the JAX apply with the same kernel choice, float32, counts
    equal (the kernel forms count the two term einsums and two adds)."""
    hd, heads = 8, 2
    jax_rp = jax_embeddings.RelativePositionEmbedding(attention, embedding, hd, pool)
    jax_rp.use_pallas_kernel = jax_value
    rng = np.random.default_rng(4)
    init = jax_rp.init(None)
    flat = {k: rng.standard_normal(np.shape(v)).astype(np.float32)
            for k, v in flatten_tree(init).items()}
    params = fill_like(init, flat)
    rp = embeddings.RelativePositionEmbedding(attention, embedding, hd, pool)
    rp.use_kernel = use_kernel
    params_from_jax(rp, flat)
    n = attention[0] * attention[1]
    p = rp.pooled_size()
    logits = rng.standard_normal((2, heads, n, p[0] * p[1])).astype(np.float32)
    q = rng.standard_normal((2, heads, n, hd)).astype(np.float32)
    jax_ctx, ctx = JaxCtx(count_mode=True), Ctx(count_mode=True)
    want = jax_rp.apply(jax_ctx, params, jnp.asarray(logits), jnp.asarray(q))
    with torch.no_grad():
        got = rp(ctx, torch.from_numpy(logits), torch.from_numpy(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_TOL)
    ref = Counts.from_device(jax_ctx.counts)
    assert set(ctx.counts) == set(ref)
    for key in ref:
        np.testing.assert_allclose(ctx.counts[key], ref[key], rtol=1e-6, err_msg=key)


def test_use_kernel_rejects_unknown_values():
    rp = embeddings.RelativePositionEmbedding((2, 2), (2, 2), 8)
    rp.use_kernel = "v3"
    with pytest.raises(ValueError, match="use_kernel"):
        rp(Ctx(), torch.zeros(1, 1, 4, 4), torch.zeros(1, 1, 4, 8))


def test_kernel_bounds_fail_the_other_rounding():
    """``ops/kernel_check.py``'s bfloat16 bounds, which hold the card's
    kernel to its plain version, fail a kernel that rounds by the other
    form's rule or adds the bias unrounded (planted here in the plain
    versions, at the terms' scale of the card check)."""
    d = kernel_check.make_inputs(1, 144, 128, 2, 16, torch.bfloat16, "cpu", relpos_keys=(6, 6))
    args, kw = (d["rp_x"], d["rp_q"], d["rp_y"], d["rp_xr"]), dict(a=d["rp_a"], p=d["rp_p"])
    v1 = relpos.relpos_bias_add_plain(*args, **kw)
    v2 = relpos.relpos_bias_add_v2_plain(*args, **kw)
    ty, tx = relpos.relpos_terms(*args[1:], d["rp_a"], torch.bfloat16)
    bias = relpos.expand_bias(ty.to(torch.bfloat16).float(), tx.to(torch.bfloat16).float(), d["rp_p"])
    unrounded = (args[0].float() + bias).to(torch.bfloat16)
    assert kernel_check.compare(v2, v2.clone())["ok"]
    assert not kernel_check.compare(v1, v2)["ok"]
    assert not kernel_check.compare(unrounded, v2)["ok"]
