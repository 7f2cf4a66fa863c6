"""The tensor-core attention body (``csrc/attention_tc.cuh``) on the CPU,
where no card runs it: the rule that picks the body, and the body's
arithmetic emulated in PyTorch.

(a) ``window_attention.attention_body``, the one rule the four wrappers
that reach the attention kernel share, at every shape the paths give it:
bfloat16 takes the tensor-core body in the rounded form (rows 2 and 6), in
row 21's two forms and in the grid form (row 15); float32 the CUDA-core
body in every form; so do a head width that is not a multiple of 16 or
beyond 128, more than 512 tokens and an operand off a 16-byte boundary.

(b) The body's arithmetic: bfloat16 operands into float32 sums, as
``mma.sync.m16n8k16`` takes them. Row 21's q is scaled in float32 and goes
in as two bfloat16 parts, hi = bf16(q) and lo = bf16(q - hi); without the
cast its float32 probabilities go in the same way; with it they are rounded
to bfloat16 and one product runs. The rounded form's q and probabilities
are exact bfloat16 values, so one product each. The grid form (row 15)
splits its float32 q as row 21 does, rounds its probabilities as the
rounded form does, and computes its rel-pos terms on the tensor cores from
the UNSCALED q, an exact bfloat16 value, against the tables rounded to
bfloat16, adding them to the logits one after the other, (s + term_y) +
term_x. Made from a numpy seed at a small size, the emulation is held
against the JAX kernels in interpret mode
(``jax_default_matmul_precision="highest"``, tests/conftest.py) and against
the port's plain versions, within ``kernel_check.BF16_BOUNDS`` and, for the
cast form, ``BF16_ROUNDED``'s comparison: the bounds the card holds the
body to. A split dropped from the emulation fails them, and so do the grid
form's terms taken from the scaled q."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.ops.pallas import attention as jax_attention
from eventful_transformer_tpu.ops.pallas import window_attention as jax_window_attention
from eventful_transformer_tpu_torch.ops import kernel_check
from eventful_transformer_tpu_torch.ops.attention import fused_attention_plain
from eventful_transformer_tpu_torch.ops.window_attention import (
    ATTENTION_FORMS,
    aligned16,
    attention_body,
    expand_terms,
    window_attention_grid_plain,
    window_attention_plain,
)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


# -- (a) the rule ------------------------------------------------------------------

# (n, d) of every call the paths make: ViViT's spatial stack and its temporal
# model, ViTDet's 14 x 14 windows (672, 1024, e2e) and 1024's padded ones,
# the EPIC-Kitchens shape (tests/test_torch_epic.py), the small tests' sizes
PATH_SHAPES = {
    "vivit_spatial": (197, 64), "vivit_temporal": (17, 64), "vitdet_window": (196, 64),
    "vitdet_padded_window": (196, 64), "epic": (401, 64), "small_d16": (9, 16),
    "small_window": (24, 16), "small_d32": (197, 32),
}
RULE_FORMS = ("rounded", "f32_probs", "bf16_probs")


@pytest.mark.parametrize("form", RULE_FORMS)
@pytest.mark.parametrize("shape", sorted(PATH_SHAPES))
def test_rule_takes_the_tensor_cores_in_bfloat16(shape, form):
    n, d = PATH_SHAPES[shape]
    assert attention_body(torch.bfloat16, n, d, form) == "tc"
    assert attention_body(torch.float32, n, d, form) == "simt"


@pytest.mark.parametrize("shape", sorted(PATH_SHAPES))
def test_rule_keeps_the_grid_form_on_the_cuda_cores(shape):
    """The grid form stays on the CUDA cores in float32 only: in bfloat16
    it takes the tensor-core body, as every other form does. (The name is
    the one the test had when bfloat16 grid calls stayed there too; it is
    kept with its cases.)"""
    n, d = PATH_SHAPES[shape]
    assert attention_body(torch.bfloat16, n, d, "grid") == "tc"
    assert attention_body(torch.float32, n, d, "grid") == "simt"


@pytest.mark.parametrize(
    "n,d,aligned",
    [(513, 64, True), (4096, 64, True), (197, 8, True), (197, 24, True), (197, 144, True),
     (197, 64, False)],
    ids=["n513", "n4096", "d8", "d24", "d144", "unaligned"],
)
def test_rule_sends_the_rest_to_the_cuda_cores(n, d, aligned):
    assert attention_body(torch.bfloat16, n, d, aligned=aligned) == "simt"


def test_rule_edges_and_forms():
    assert attention_body(torch.bfloat16, 512, 128) == "tc"
    assert attention_body(torch.bfloat16, 1, 16) == "tc"
    assert set(ATTENTION_FORMS) == set(RULE_FORMS) | {"grid"}
    with pytest.raises(ValueError, match="form"):
        attention_body(torch.bfloat16, 197, 64, "cast")


def test_alignment_reads_the_data_pointer():
    t = torch.zeros(64, dtype=torch.bfloat16)
    assert aligned16(t, None) and aligned16(t[8:])
    assert not aligned16(t[1:])


# -- (b) the arithmetic ----------------------------------------------------------------


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _split(x):
    """float32 x as hi + lo, both bfloat16 values."""
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def tc_emulation(qkv, heads, scale, form, terms=None, p=None, split=True):
    """The tensor-core body's arithmetic on bfloat16 qkv (B, N, 3C): every
    product of bfloat16 operands summed in float32. ``form`` "rounded"
    (rows 2 and 6, with the windowed form's ``terms``), "f32_probs" or
    "bf16_probs" (row 21); ``split`` False drops the lo parts, a planted
    fault."""
    bsz, n, c3 = qkv.shape
    c = c3 // 3
    q, k, v = qkv.reshape(bsz, n, 3, heads, c // heads).float().permute(2, 0, 3, 1, 4)
    if form == "rounded":
        s = _bf16(q * _bf16(torch.tensor(1.0 / scale))) @ k.transpose(-1, -2)
    else:
        hi, lo = _split(q * torch.tensor(1.0 / scale, dtype=torch.float32))
        s = hi @ k.transpose(-1, -2)
        if split:
            s = s + lo @ k.transpose(-1, -2)
    if terms is not None:
        s = s + expand_terms(terms, p)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    if form == "f32_probs":
        hi, lo = _split(probs)
        out = hi @ v + (lo @ v if split else 0.0)
    else:
        out = _bf16(probs) @ v
    return out.to(torch.bfloat16).transpose(1, 2).reshape(bsz, n, c)


B = 2
# (n, C, heads): at d = 16 and 64 the scale 1/sqrt(d) is a power of two and
# q's lo part is 0; d = 48 gives it bits
SIZES = {"n17_d16": (17, 64, 4), "n37_d48": (37, 192, 4), "n197_d64": (197, 256, 4)}
FUSED_FORMS = {"f32_probs": None, "bf16_probs": torch.bfloat16}


def _qkv(n, c, seed):
    return np.random.default_rng(seed).standard_normal((B, n, 3 * c)).astype(np.float32)


def _jax_out(ref):
    return torch.from_numpy(np.array(ref.astype(jnp.float32))).to(torch.bfloat16)


def _check(got, want, rounded=False):
    row = (kernel_check.compare_rounded if rounded else kernel_check.compare)(got, want)
    assert row["ok"], row
    return row


@pytest.mark.parametrize("form", sorted(FUSED_FORMS))
@pytest.mark.parametrize("size", sorted(SIZES))
def test_row21_split_arithmetic_matches_jax_and_plain(size, form):
    n, c, heads = SIZES[size]
    scale = float(np.sqrt(c // heads))
    qkv = _qkv(n, c, seed=11)
    cast = FUSED_FORMS[form]
    ref = jax_attention.fused_attention(
        jnp.asarray(qkv, jnp.bfloat16), heads=heads, scale=scale,
        cast=None if cast is None else jnp.bfloat16, interpret=True,
    )
    x = torch.from_numpy(qkv).to(torch.bfloat16)
    got = tc_emulation(x, heads, scale, form)
    rounded = form == "bf16_probs"
    _check(got, _jax_out(ref), rounded)
    _check(got, fused_attention_plain(x, heads=heads, scale=scale, cast=cast), rounded)


@pytest.mark.parametrize("size", sorted(SIZES))
def test_rounded_form_arithmetic_matches_jax_and_plain(size):
    n, c, heads = SIZES[size]
    scale = float(np.sqrt(c // heads))
    qkv = _qkv(n, c, seed=12)
    ref = jax_window_attention.window_attention(
        jnp.asarray(qkv, jnp.bfloat16), heads=heads, scale=scale, interpret=True
    )
    x = torch.from_numpy(qkv).to(torch.bfloat16)
    got = tc_emulation(x, heads, scale, "rounded")
    _check(got, _jax_out(ref))
    _check(got, window_attention_plain(x, heads=heads, scale=scale))


@pytest.mark.parametrize("window", [(4, 6), (3, 3)], ids=["4x6", "3x3"])
def test_rounded_form_with_terms_matches_plain(window):
    """The windowed form: the float32 sum of the two terms added to the
    tensor-core logits."""
    n, c, heads = window[0] * window[1], 64, 4
    scale = float(np.sqrt(c // heads))
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((3, n, 3 * c)).astype(np.float32)).to(torch.bfloat16)
    terms = torch.from_numpy(
        (0.5 * rng.standard_normal((3, heads, n, sum(window)))).astype(np.float32)
    ).to(torch.bfloat16)
    got = tc_emulation(x, heads, scale, "rounded", terms, window)
    _check(got, window_attention_plain(x, terms, heads=heads, scale=scale, p=window))


@pytest.mark.parametrize("form", sorted(FUSED_FORMS))
def test_dropped_split_fails_the_bounds(form):
    """Without the lo parts row 21's q (and, without the cast, its
    probabilities) lose float32's precision, and the bounds see it. At d =
    48, where q's lo part is not 0."""
    n, c, heads = 197, 192, 4
    scale = float(np.sqrt(c // heads))
    x = torch.from_numpy(_qkv(n, c, seed=14)).to(torch.bfloat16)
    cast = FUSED_FORMS[form]
    want = fused_attention_plain(x, heads=heads, scale=scale, cast=cast)
    rounded = form == "bf16_probs"
    _check(tc_emulation(x, heads, scale, form), want, rounded)
    row = (kernel_check.compare_rounded if rounded else kernel_check.compare)(
        tc_emulation(x, heads, scale, form, split=False), want
    )
    assert not row["ok"], row


def grid_tc_emulation(x, heads, scale, window, y_rel=None, x_rel=None, p=None, split=True,
                      scaled_terms=False):
    """The tensor-core body's arithmetic for the grid form (row 15) on a
    bfloat16 map x (B, Hp, Wp, 3C): the windows partitioned, q scaled in
    float32 and split into hi + lo; with the tables (rounded to bfloat16)
    the terms of the unscaled q, q . y[i // a1] and q . x[i % a1], added to
    the logits one after the other; probabilities and output rounded to
    bfloat16. ``split`` False drops q's lo part and ``scaled_terms`` takes
    the terms from the scaled q: planted faults."""
    b, hp, wp, c3 = x.shape
    c, (a0, a1) = c3 // 3, window
    t = a0 * a1
    win = x.reshape(b, hp // a0, a0, wp // a1, a1, c3).permute(0, 1, 3, 2, 4, 5)
    q, k, v = win.reshape(-1, t, 3, heads, c // heads).float().permute(2, 0, 3, 1, 4)
    scaled = q * torch.tensor(1.0 / scale, dtype=torch.float32)
    hi, lo = _split(scaled)
    s = hi @ k.transpose(-1, -2)
    if split:
        s = s + lo @ k.transpose(-1, -2)
    if y_rel is not None:
        p0, p1 = p or window
        idx = torch.arange(t)
        q_terms = scaled if scaled_terms else q
        term_y = torch.einsum("bhtd,tpd->bhtp", q_terms, _bf16(y_rel)[idx // a1])
        term_x = torch.einsum("bhtd,tpd->bhtp", q_terms, _bf16(x_rel)[idx % a1])
        s = (s + term_y[..., idx // p1]) + term_x[..., idx % p1]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = (_bf16(e / e.sum(dim=-1, keepdim=True)) @ v).to(torch.bfloat16)
    out = out.transpose(1, 2).reshape(b, hp // a0, wp // a1, a0, a1, c)
    return out.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)


# (C, heads): d = 64 (1/scale a power of two, q's lo part 0) and d = 48
GRID_SIZES = {"d64": (256, 4), "d48": (192, 4)}
# the rel-pos tables and the key grid p: with the tables over the window's
# own grid, over a p != a grid (p0 * p1 == a0 * a1), and without tables
GRID_FORMS = {"terms": (True, None), "terms_p6x4": (True, (6, 4)), "no_terms": (False, None)}
GRID_MAP, GRID_WINDOW = (2, 8, 12), (4, 6)


def _grid_case(size, form, seed):
    """The bfloat16 map, the tables (or none), scale and key grid of a grid
    case, and the JAX kernel's output in interpret mode."""
    c, heads = GRID_SIZES[size]
    tables, p = GRID_FORMS[form]
    a0, a1 = GRID_WINDOW
    p0, p1 = p or GRID_WINDOW
    hd = c // heads
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(GRID_MAP + (3 * c,)).astype(np.float32)
    yr = (0.3 * rng.standard_normal((a0, p0, hd))).astype(np.float32)
    xr = (0.3 * rng.standard_normal((a1, p1, hd))).astype(np.float32)
    scale = float(np.sqrt(hd))
    keys = dict(a=GRID_WINDOW, p=p) if tables else {}
    ref = jax_window_attention.window_attention_grid(
        jnp.asarray(x, jnp.bfloat16), *((jnp.asarray(yr), jnp.asarray(xr)) if tables else ()),
        heads=heads, scale=scale, window=GRID_WINDOW, interpret=True, **keys,
    )
    rel = (torch.from_numpy(yr), torch.from_numpy(xr)) if tables else ()
    return torch.from_numpy(x).to(torch.bfloat16), rel, heads, scale, keys, _jax_out(ref)


@pytest.mark.parametrize("form", sorted(GRID_FORMS))
@pytest.mark.parametrize("size", sorted(GRID_SIZES))
def test_grid_arithmetic_matches_jax_and_plain(size, form):
    x, rel, heads, scale, keys, want_jax = _grid_case(size, form, seed=15)
    got = grid_tc_emulation(x, heads, scale, GRID_WINDOW, *rel, p=keys.get("p"))
    _check(got, want_jax)
    _check(got, window_attention_grid_plain(x, *rel, heads=heads, scale=scale,
                                            window=GRID_WINDOW, **keys))


GRID_FAULTS = {"terms_of_the_scaled_q": ("d64", dict(scaled_terms=True)),
               "dropped_q_split": ("d48", dict(split=False))}


@pytest.mark.parametrize("fault", sorted(GRID_FAULTS))
def test_grid_planted_faults_fail_the_bounds(fault):
    """The terms taken from the scaled q (at d = 64, a factor of 8 on them),
    or q's lo part dropped (at d = 48, where it is not 0): both fail the
    bounds against the JAX kernel and the plain version, which the faultless
    emulation of the same case passes."""
    size, planted = GRID_FAULTS[fault]
    x, rel, heads, scale, keys, want_jax = _grid_case(size, "terms", seed=16)
    want = window_attention_grid_plain(x, *rel, heads=heads, scale=scale, window=GRID_WINDOW,
                                       **keys)
    for ref in (want_jax, want):
        _check(grid_tc_emulation(x, heads, scale, GRID_WINDOW, *rel), ref)
        row = kernel_check.compare(grid_tc_emulation(x, heads, scale, GRID_WINDOW, *rel,
                                                     **planted), ref)
        assert not row["ok"], row
