"""The port's decomposed rel-pos bias add against the JAX package: the plain
versions of ``relpos_bias_add`` (row 16) and ``relpos_bias_add_v2`` (row
17) against the Pallas kernels in interpret mode, the tiled body's rule,
tile plan, division and arithmetic, and
``RelativePositionEmbedding.forward`` with each ``use_kernel`` value
against the JAX ``apply`` with the matching ``use_pallas_kernel``, counts
included.

Tolerances. float32: 1e-5 max abs error (both sides sum the c-long dot
products in float32, in other orders; at ViTDet-672's grids 1e-5 scaled
by max(1, |value|)). bfloat16: the two sides make the
same roundings, so an element differs only where a float32 dot product
lies within its summation error of a bfloat16 rounding boundary of a term,
the bias or the sum: at most one ulp of the output, on at most 2 % of the
elements (measured: none differ at these shapes). At ViTDet-672's grids (c
= 64) a flipped term or bias moves an output that cancels by many of its
own ulps, so the tests there bound each element by two ulps of the largest
of |out|, |bias|, |ty| and |tx| instead (``_assert_bf16_close``), on the
same 2 %. The tiled body's tests hold a numpy emulation of its arithmetic
and element mapping (``emulate_tile``) to those bounds."""

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


# -- the tiled body (csrc/relpos_tile.cuh): its rule, its tile plan and its
# arithmetic, emulated in numpy ------------------------------------------------------

# (bh, query grid, key grid) of the paths: 672 dense and pooled at 2 streams
# and at the e2e path's one, 1024 dense and its flush keys
PATH_GRIDS = [(24, (42, 42), (42, 42)), (24, (42, 42), (21, 21)), (12, (42, 42), (42, 42)),
              (12, (42, 42), (21, 21)), (24, (64, 64), (64, 64)), (24, (64, 64), (32, 32))]


@pytest.mark.parametrize("dtype,aligned,body", [
    (torch.bfloat16, True, "tile"), (torch.float32, True, "simt"),
    (torch.bfloat16, False, "simt"), (torch.float32, False, "simt"),
], ids=["bf16", "f32", "bf16_misaligned", "f32_misaligned"])
def test_relpos_body_rule(dtype, aligned, body):
    assert relpos.relpos_body(dtype, aligned) == body


def _plan_tiles(a, plan):
    """The query tokens (flat indices over the (a0, a1) grid) of each tile of
    ``plan``, in csrc/relpos_tile.cuh's block order: tile rows of a1 // s
    tiles, each tile's r segments of s tokens."""
    r, s = plan
    return [[(ti * r + i) * a[1] + tj * s + j for i in range(r) for j in range(s)]
            for ti in range(a[0] // r) for tj in range(a[1] // s)]


@pytest.mark.parametrize("c", [64, 16, 40])
@pytest.mark.parametrize("bh,a,p", PATH_GRIDS + [(6, g[0], g[1]) for g in GRIDS]
                         + [(24, (21, 21), (21, 21)), (24, (32, 32), (32, 32))])
def test_relpos_plan_covers_every_token_once(bh, a, p, c):
    """The tile plan at every path grid, the query sides 21 and 32, and the
    tests' grids, at head widths 64, 16 and 40: r divides a0 and s divides
    a1 (no ragged tile), each at most 16, the tile within the body's shared
    memory, and the tiles cover every token of the grid exactly once."""
    plan = relpos.relpos_plan(bh, a, p, c)
    r, s = plan
    assert a[0] % r == 0 and a[1] % s == 0 and max(r, s) <= relpos.TILE_MAX_SIDE
    assert relpos._tile_smem(r, s, p, c) <= relpos.TILE_SHAPES[p[1] % 8 == 0][0]
    tokens = sorted(t for tile in _plan_tiles(a, plan) for t in tile)
    assert tokens == list(range(a[0] * a[1]))


def test_relpos_plan_at_the_paths():
    """The tiles the path grids get at c = 64, each within PLAN_TILE_BYTES
    of logits."""
    want = [(3, 6), (6, 6), (3, 6), (2, 14), (4, 4), (8, 8)]
    for (bh, a, p), tile in zip(PATH_GRIDS, want):
        r, s = relpos.relpos_plan(bh, a, p, 64)
        assert 2 * r * s * p[0] * p[1] * 2 <= relpos.PLAN_TILE_BYTES[p[1] % 8 == 0]
        assert (r, s) == tile, (a, p, (r, s))


def _fast_div(d):
    """csrc/relpos_tile.cuh fast_div: (m, shift), m = 0 for d = 1."""
    if d == 1:
        return 0, 0
    l = (d - 1).bit_length()
    return ((1 << (31 + l)) + d - 1) // d, l - 1


def _div_of(fd, n):
    m, shift = fd
    n = np.asarray(n, dtype=np.int64)
    return n if m == 0 else ((n.astype(np.uint64) * np.uint64(m)) >> np.uint64(32 + shift)).astype(
        np.int64)


def test_fast_division_is_exact():
    """The multiply-high division of csrc/relpos_tile.cuh against integer
    division, for every dividend the path grids give it (offsets within a
    tile's segment, key offsets within a token, slots within a tile) and at
    the ends of its range."""
    for bh, a, p in PATH_GRIDS:
        r, s = relpos.relpos_plan(bh, a, p, 64)
        np_ = p[0] * p[1]
        seg_vecs = (s * np_ + 14) // 8
        for d, top in ((np_, s * np_ + 8), (p[1], np_), (seg_vecs, r * seg_vecs)):
            n = np.arange(top)
            assert np.array_equal(_div_of(_fast_div(d), n), n // d), (d, top)
    for d in (1, 2, 3, 5, 7, 9, 21, 441, 1764, 4096, 65521, 2**30 + 3):
        n = np.array([0, 1, d - 1, d, d + 1, 2**31 - 1, 2**31 - 2, 12345678])
        assert np.array_equal(_div_of(_fast_div(d), n), n // d), d


def _rnd_bf16(v):
    """float32 values rounded to bfloat16 (to nearest, ties to even), as
    float32."""
    f = np.asarray(v, dtype=np.float32)
    u = np.ascontiguousarray(f).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32).reshape(f.shape)


def emulate_tile(x, q, y_rel, x_rel, a, p, round_each):
    """csrc/relpos_tile.cuh in numpy, on bfloat16 values held as float32:
    the tile plan, the terms summed k by k in float32 (the product of two
    bfloat16 values is exact, so each step is the kernel's fmaf), rounded by
    the form's rule, and the stream over each tile's 16-byte vector slots:
    with p1 a multiple of 8 each vector adds one ty' and 8 consecutive tx'
    of its key row; otherwise each segment's bias row is built key row by
    key row at the phase of its logits and added a vector at a time, the
    ragged head and tail element by element. Returns the output and how
    often each element was written."""
    bsz, heads, n, np_ = x.shape
    c = q.shape[-1]
    bh = bsz * heads
    r, s = relpos.relpos_plan(bh, tuple(a), tuple(p), c)
    p0, p1 = p
    xf, qf = x.reshape(-1), q.reshape(bh, n, c)
    out = np.zeros_like(xf)
    writes = np.zeros(xf.shape, dtype=np.int64)
    seg_len, row_elems = s * np_, a[1] * np_
    whole_rows = p1 % 8 == 0
    seg_vecs = seg_len // 8 if whole_rows else (seg_len + 14) // 8
    bstride = (seg_len + 15) & ~7
    by_np, by_p1, by_vecs = _fast_div(np_), _fast_div(p1), _fast_div(seg_vecs)

    def product(qrows, tab):  # (m, c) . (c, P), k ascending
        acc = np.zeros((qrows.shape[0], tab.shape[0]), dtype=np.float32)
        for k in range(c):
            acc = acc + qrows[:, k:k + 1] * tab[None, :, k]
        return _rnd_bf16(acc) if round_each else acc

    for b in range(bh):
        for ti in range(a[0] // r):
            for tj in range(a[1] // s):
                i0, j0, tokens = ti * r, tj * s, r * s
                ty = np.zeros((tokens, p0), dtype=np.float32)
                tx = np.zeros((tokens, p1), dtype=np.float32)
                for i in range(r):
                    rows = qf[b, (i0 + i) * a[1] + j0:(i0 + i) * a[1] + j0 + s]
                    ty[i * s:(i + 1) * s] = product(rows, y_rel[i0 + i])
                for j in range(s):
                    rows = qf[b, [(i0 + m) * a[1] + j0 + j for m in range(r)]]
                    tx[j::s] = product(rows, x_rel[j0 + j])
                g0 = (b * n + i0 * a[1] + j0) * np_
                gbase, head = g0 - g0 % 8, g0 % 8
                f = np.arange(r * seg_vecs)
                i = _div_of(by_vecs, f)
                vs = f - i * seg_vecs
                rel = head + i * row_elems
                e = 8 * vs - (rel & 7)
                if whole_rows:  # every segment on 16 bytes, a vector in one key row
                    assert head == 0 and (e == 8 * vs).all()
                    t = _div_of(by_np, e)
                    k = e - t * np_
                    ky = _div_of(by_p1, k)
                    kx = k - ky * p1
                    tt = i * s + t
                    for w in range(8):
                        at = gbase + rel + e + w
                        out[at] = _rnd_bf16(xf[at] + _rnd_bf16(ty[tt, ky] + tx[tt, kx + w]))
                        writes[at] += 1
                    continue
                bias = np.zeros((r, bstride), dtype=np.float32)
                for tt in range(tokens):
                    seg = tt // s
                    start = (int(rel[seg * seg_vecs]) & 7) + (tt - seg * s) * np_
                    bias[seg, start:start + np_] = _rnd_bf16(ty[tt][:, None] + tx[tt][None, :]).reshape(-1)
                whole = (e >= 0) & (e + 8 <= seg_len)
                for w in range(8):
                    at = gbase + rel[whole] + e[whole] + w
                    out[at] = _rnd_bf16(xf[at] + bias[i[whole], 8 * vs[whole] + w])
                    writes[at] += 1
                for fi, fe, frel in zip(i[~whole], e[~whole], rel[~whole]):
                    for w in range(8):
                        pos = int(fe) + w
                        if not 0 <= pos < seg_len:
                            continue
                        at = gbase + int(frel) + pos
                        out[at] = _rnd_bf16(xf[at] + bias[fi, (int(frel) & 7) + pos])
                        writes[at] += 1
    return out.reshape(x.shape), writes.reshape(x.shape)


def _bf16_inputs(a, p, c, bsz, heads, seed):
    """The file's inputs rounded to bfloat16 (as float32), tables at the
    card check's scale."""
    x, q, y, xr = _inputs(a, p, c=c, bsz=bsz, heads=heads, seed=seed)
    return _rnd_bf16(x), _rnd_bf16(q), _rnd_bf16(0.3 * y), _rnd_bf16(0.3 * xr)


def _bf16_ulp(v):
    """One bfloat16 ulp of |v| (float32 array), 2^-133 below the normals."""
    _, e = np.frexp(np.maximum(np.abs(v), np.float32(2.0**-126)))
    return np.ldexp(np.float32(1.0), e - 8)


def _assert_bf16_close(got, want, arrays, a, p):
    """The bfloat16 tolerance of the tests at path-like grids. Both sides
    make the same roundings; an element differs where a float32 sum lies
    within its summation error of a rounding boundary of a term, the bias
    or the sum. Such a flip moves the value by one ulp of the quantity
    rounded there, and the later roundings by at most one ulp more: many
    ulps of an output that cancels (x near -bias, or terms of opposite
    sign). So: at most two bfloat16 ulps of the largest of |out|, |bias| =
    |out - x|, |ty| and |tx| (measured: at most 2, at 2 in one case), on at
    most BF16_DIFFER_SHARE of the elements (measured: below 0.003 %)."""
    got, want = (np.asarray(v, dtype=np.float32) for v in (got, want))
    x, q, y_rel, x_rel = (torch.from_numpy(np.asarray(v, dtype=np.float32)) for v in arrays)
    ty, tx = relpos.relpos_terms(q.to(torch.bfloat16), y_rel, x_rel, a, torch.bfloat16)
    k = np.arange(p[0] * p[1])
    terms = np.maximum(np.abs(ty.numpy())[..., k // p[1]], np.abs(tx.numpy())[..., k % p[1]])
    scale = np.maximum.reduce([np.abs(want), np.abs(want - x.numpy()), terms])
    assert float(np.max(np.abs(got - want) - 2 * _bf16_ulp(scale))) <= 0
    assert float(np.mean(got != want)) <= BF16_DIFFER_SHARE


# path-like grids at c = 64 and a small B H (672's, and 1024's query grid
# over 32 x 32 keys: whole key rows), and the file's grids at c = 16 and 40
EMULATED = [((42, 42), (21, 21), 64, 1, 2), ((42, 42), (42, 42), 64, 1, 1),
            ((64, 64), (32, 32), 64, 1, 1), ((6, 5), (3, 5), 16, 2, 3),
            ((2, 18), (1, 9), 40, 2, 3), ((4, 4), (4, 4), 16, 2, 3)]


@pytest.mark.parametrize("grid", EMULATED, ids=["672_pooled", "672_dense", "1024_flush",
                                                "pooled_6x5", "wide_2x18", "square_4x4"])
@pytest.mark.parametrize("form", ["relpos_bias_add", "relpos_bias_add_v2"])
def test_tile_emulation_matches_jax_kernel(form, grid):
    """The tiled body's arithmetic and element mapping (numpy,
    ``emulate_tile``) against the JAX kernel in interpret mode and against
    the port's plain version: every element written exactly once, within
    the file's bfloat16 tolerance of the JAX kernel and within
    ``kernel_check``'s bounds of the plain version."""
    a, p, c, bsz, heads = grid
    arrays = _bf16_inputs(a, p, c, bsz, heads, seed=5)
    got, writes = emulate_tile(*arrays, a, p, round_each=form.endswith("_v2"))
    assert int(writes.min()) == 1 and int(writes.max()) == 1
    want = getattr(jax_relpos, form)(*(jnp.asarray(v, jnp.bfloat16) for v in arrays), a=a, p=p,
                                      interpret=True)
    _assert_bf16_close(got, np.asarray(want.astype(jnp.float32)), arrays, a, p)
    plain = getattr(relpos, form + "_plain")(*(torch.from_numpy(v).to(torch.bfloat16)
                                               for v in arrays), a=a, p=p)
    assert kernel_check.compare(torch.from_numpy(got).to(torch.bfloat16), plain)["ok"]


@pytest.mark.parametrize("keys", [(21, 21), (42, 42)], ids=["pooled", "dense"])
@pytest.mark.parametrize("form", ["relpos_bias_add", "relpos_bias_add_v2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel_at_path_grids(form, keys, dtype):
    """The plain versions against the JAX kernels at ViTDet-672's query
    grid over its pooled and dense key grids, c = 64, one (batch, head)
    pair, tables at the card check's scale (0.3): float32 within 1e-5
    scaled by max(1, |value|) (64-long sums, terms of a few units, in other
    orders), bfloat16 as ``_assert_bf16_close``."""
    a = (42, 42)
    x, q, y, xr = _inputs(a, keys, c=64, bsz=1, heads=1, seed=6)
    arrays = (x, q, 0.3 * y, 0.3 * xr)
    if dtype == "bfloat16":
        arrays = tuple(_rnd_bf16(v) for v in arrays)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = getattr(jax_relpos, form)(*(jnp.asarray(v, jdt) for v in arrays), a=a, p=keys,
                                      interpret=True)
    got = getattr(relpos, form + "_plain")(*(torch.from_numpy(v).to(tdt) for v in arrays),
                                           a=a, p=keys)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    else:
        _assert_bf16_close(got.float().numpy(), want, arrays, a, keys)
