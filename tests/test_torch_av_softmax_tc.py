"""The tensor-core body of the A.V kernel (row 8, ``csrc/av_softmax_tc.cuh``)
on the CPU, where no card runs it: the rule that picks the body, and the
body's arithmetic emulated in PyTorch.

(a) ``av_softmax.av_softmax_body`` at every shape the paths give the two
wrappers: bfloat16 takes the tensor-core body in both forms, with and
without terms; float32 and the matmul-2 cast (float32 q, k and terms with
bfloat16 state) the CUDA-core body; so do a head width that is not a
multiple of 16 or beyond 64 and k or p_v off a 16-byte boundary.

(b) The body's arithmetic: q scaled as rnd(q * rnd(inv_scale)), bfloat16
operands into float32 sums (mma.sync.m16n8k16), the keys in chunks of 64;
the two rel-pos terms summed in float32, then added to the float32 logit;
the exact softmax: the row max over all keys, the float32 sum of exp(l -
max), then a = e / sum by the kernel's division (q = e r with r = RN(1 /
sum), corrected once by the remainder, Markstein's), rounded to bfloat16;
the select into the state; P.V chunk by chunk in float32, rounded once.
Made from a numpy seed at small, awkward sizes (N = 37 over a 3 x 7 key
grid, Np = 21 not a multiple of 8; N = 70 over 10 x 13 = 130 keys, three
chunks with a ragged last one), the emulation is held against the JAX
kernel in interpret mode (``jax_default_matmul_precision="highest"``,
tests/conftest.py) and against the port's plain versions, within
``kernel_check.BF16_BOUNDS``: the bounds the card holds the body to.
Planted faults fail them: inv_scale not rounded (at d = 48, where its
rounding moves it), the terms added one after the other ((l + ty) + tx,
on logits near 2^16 whose float32 ulp is 2^-7), and an online, rescaled
sum with P.V accumulated as it goes (FlashAttention's order: the
unnormalised exp rounded to bfloat16 under a running max, rescaled, and
divided by the sum at the end)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.ops.pallas import av_softmax as jax_av_softmax
from eventful_transformer_tpu_torch.ops import _build, kernel_check
from eventful_transformer_tpu_torch.ops.av_softmax import (
    TC_MAX_HEAD_DIM,
    av_softmax_body,
    softmax_select_matmul_logits_plain,
    softmax_select_matmul_plain,
)

BF16, F32 = torch.bfloat16, torch.float32


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


# -- (a) the rule ------------------------------------------------------------------

# (N queries, Np keys, d) of every call the paths make, and the form: the
# fused form with terms at ViTDet-1024's global blocks and on the e2e path,
# the logits form without terms in the paper's ViViT's cached product, the
# logits form with terms at 1024's pooled shape (chip_smoke.py's check),
# and the small tests' sizes (tests/test_torch_cuda.py SHAPES)
PATH_SHAPES = {
    "vitdet1024_fused": (4096, 1024, 64), "e2e_fused": (1764, 441, 64),
    "vivit_evblock_logits": (197, 197, 64), "vitdet1024_logits": (4096, 1024, 64),
    "small_d16": (24, 21, 16), "small_d64": (37, 21, 64), "small_d32": (197, 21, 32),
}


@pytest.mark.parametrize("shape", sorted(PATH_SHAPES))
def test_rule_takes_the_tensor_cores_in_bfloat16(shape):
    _, _, d = PATH_SHAPES[shape]
    assert av_softmax_body(BF16, BF16, d) == "tc"
    assert av_softmax_body(F32, F32, d) == "simt"


@pytest.mark.parametrize("shape", sorted(PATH_SHAPES))
def test_rule_keeps_the_cast_on_the_cuda_cores(shape):
    """The matmul-2 cast of a float32 model (float32 q and k, or float32
    terms beside bfloat16 logits, over bfloat16 state)."""
    _, _, d = PATH_SHAPES[shape]
    assert av_softmax_body(F32, BF16, d) == "simt"


@pytest.mark.parametrize(
    "d,aligned", [(8, True), (24, True), (80, True), (128, True), (64, False)],
    ids=["d8", "d24", "d80", "d128", "unaligned"],
)
def test_rule_sends_the_rest_to_the_cuda_cores(d, aligned):
    assert av_softmax_body(BF16, BF16, d, aligned) == "simt"


def test_rule_edges():
    assert TC_MAX_HEAD_DIM == 64
    assert av_softmax_body(BF16, BF16, 16) == "tc"
    assert av_softmax_body(BF16, BF16, 64) == "tc"
    assert av_softmax_body(BF16, BF16, 48) == "tc"


def test_alignment_reads_k_and_p_v():
    t = torch.zeros(64, dtype=BF16)
    assert _build.aligned16(t, t[8:])
    assert not _build.aligned16(t, t[1:])


# -- (b) the arithmetic ----------------------------------------------------------------

CHUNK = 64  # keys a step of the body


def _bf16(x):
    return x.to(BF16).float()


def _fma(a, b, c):
    """a * b + c rounded once to float32 (float64 holds the product of two
    float32 values exactly)."""
    return (a.double() * b.double() + c.double()).float()


def _chunks(np_):
    return [(j, min(j + CHUNK, np_)) for j in range(0, np_, CHUNK)]


def tc_emulation(p_a, cov, p_v, q=None, k=None, terms=None, *, inv_scale=None, logits=None,
                 p=None, round_scale=True, terms_in_turn=False, online=False):
    """The tensor-core body's arithmetic on bfloat16 operands; returns
    (p_a', out) in bfloat16 without touching ``p_a``. ``round_scale``
    False, ``terms_in_turn`` True and ``online`` True are the planted
    faults of the module docstring."""
    np_ = p_a.shape[-1]
    if logits is None:
        scale = _bf16(torch.tensor(inv_scale)) if round_scale else torch.tensor(inv_scale)
        qs = _bf16(q.float() * scale)
        l = torch.cat([qs @ k.float()[..., j0:j1, :].transpose(-1, -2)
                       for j0, j1 in _chunks(np_)], dim=-1)
    else:
        l = logits.float()
    if terms is not None:
        p0, p1 = p
        j = torch.arange(np_)
        ty, tx = terms.float()[..., j // p1], terms.float()[..., p0 + j % p1]
        l = (l + ty) + tx if terms_in_turn else l + (ty + tx)
    m = l.amax(dim=-1, keepdim=True)
    v = p_v.float()
    keep = cov[:, None, None, :] > 0
    if online:
        # running max and sum; the covered keys' P.V from the unnormalised
        # exp rounded to bfloat16, rescaled as the max moves and divided by
        # the sum at the end, the uncovered keys' from the old state
        run_m = torch.full_like(m, -torch.inf)
        run_s = torch.zeros_like(m)
        fresh = torch.zeros(l.shape[:-1] + (v.shape[-1],))
        for j0, j1 in _chunks(np_):
            lc = l[..., j0:j1]
            new_m = torch.maximum(run_m, lc.amax(dim=-1, keepdim=True))
            factor = torch.exp(run_m - new_m)
            ec = torch.exp(lc - new_m)
            run_s = run_s * factor + ec.sum(dim=-1, keepdim=True)
            fresh = fresh * factor + torch.where(keep[..., j0:j1], _bf16(ec), 0.0) @ v[..., j0:j1, :]
            run_m = new_m
        old = torch.where(keep, 0.0, p_a.float()) @ v
        a = (torch.exp(l - m) / run_s).to(BF16)
        return torch.where(keep, a, p_a), (fresh / run_s + old).to(BF16)
    e = torch.exp(l - m)
    total = torch.zeros_like(m)
    for j0, j1 in _chunks(np_):
        total = total + e[..., j0:j1].sum(dim=-1, keepdim=True)
    r = (1.0 / total.double()).float()  # RN(1 / sum)
    quotient = e * r
    a = _fma(_fma(-quotient, total, e), r, quotient).to(BF16)
    merged = torch.where(keep, a, p_a)
    out = torch.zeros(l.shape[:-1] + (v.shape[-1],))
    for j0, j1 in _chunks(np_):
        out = out + merged.float()[..., j0:j1] @ v[..., j0:j1, :]
    return merged, out.to(BF16)


B, H = 2, 2
# (N, key grid, d): d = 48 gives rnd(inv_scale) a rounding, d = 64 none
SIZES = {"n37_p3x7_d48": (37, (3, 7), 48), "n70_p10x13_d64": (70, (10, 13), 64),
         "n37_p3x7_d16": (37, (3, 7), 16)}
FORMS = {"fused_terms": (False, True), "fused_noterms": (False, False),
         "logits_terms": (True, True), "logits_noterms": (True, False)}


def _case(size, form, seed):
    """bfloat16 inputs of one case, made from a numpy seed, as numpy
    arrays rounded to bfloat16 and as torch tensors."""
    n, grid, d = SIZES[size]
    np_ = grid[0] * grid[1]
    rng = np.random.default_rng(seed)
    r = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    arrays = dict(
        q=r(B, H, n, d, scale=1.5), k=r(B, H, np_, d, scale=1.5),
        logits=r(B, H, n, np_, scale=2.0), terms=r(B, H, n, sum(grid), scale=0.3),
        p_a=rng.uniform(0, 2 / np_, (B, H, n, np_)).astype(np.float32), p_v=r(B, H, np_, d),
    )
    cov = (rng.uniform(size=(B, np_)) < 0.25).astype(np.float32)
    t = {key: torch.from_numpy(a).to(BF16) for key, a in arrays.items()}
    t["cov"] = torch.from_numpy(cov)
    return t, grid, d**-0.5


def _jax(t, grid, inv_scale, logits_form, with_terms):
    j = {key: jnp.asarray(v.float().numpy(), jnp.bfloat16) for key, v in t.items() if key != "cov"}
    kw = dict(terms=j["terms"], p=grid) if with_terms else {}
    if logits_form:
        ref = jax_av_softmax.softmax_select_matmul(
            j["logits"], j["p_a"], jnp.asarray(t["cov"].numpy()), j["p_v"], interpret=True, **kw)
    else:
        ref = jax_av_softmax.softmax_select_matmul(
            None, j["p_a"], jnp.asarray(t["cov"].numpy()), j["p_v"], q=j["q"], k=j["k"],
            inv_scale=inv_scale, interpret=True, **kw)
    return [torch.from_numpy(np.array(x.astype(jnp.float32))).to(BF16) for x in ref]


def _plain(t, grid, inv_scale, logits_form, with_terms):
    terms = t["terms"] if with_terms else None
    p_a = t["p_a"].clone()
    if logits_form:
        return softmax_select_matmul_logits_plain(t["logits"], p_a, t["cov"], t["p_v"], terms,
                                                  p=grid)
    return softmax_select_matmul_plain(p_a, t["cov"], t["p_v"], t["q"], t["k"], terms,
                                       inv_scale=inv_scale, p=grid)


def _emulate(t, grid, inv_scale, logits_form, with_terms, **faults):
    terms = t["terms"] if with_terms else None
    if logits_form:
        return tc_emulation(t["p_a"], t["cov"], t["p_v"], terms=terms, logits=t["logits"],
                            p=grid, **faults)
    return tc_emulation(t["p_a"], t["cov"], t["p_v"], t["q"], t["k"], terms,
                        inv_scale=inv_scale, p=grid, **faults)


def _rows(got, want):
    return [kernel_check.compare(a, b) for a, b in zip(got, want)]


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("size", sorted(SIZES))
def test_arithmetic_matches_jax_and_plain(size, form):
    t, grid, inv_scale = _case(size, form, seed=31)
    logits_form, with_terms = FORMS[form]
    got = _emulate(t, grid, inv_scale, logits_form, with_terms)
    for want in (_jax(t, grid, inv_scale, logits_form, with_terms),
                 _plain(t, grid, inv_scale, logits_form, with_terms)):
        rows = _rows(got, want)
        assert all(row["ok"] for row in rows), rows


def test_uncovered_columns_keep_their_bits():
    """p_a' equals p_a bit for bit where the coverage is 0, and pad-free:
    the select is a where() on the old values."""
    t, grid, inv_scale = _case("n70_p10x13_d64", "fused_terms", seed=32)
    merged, _ = _emulate(t, grid, inv_scale, False, True)
    keep = (t["cov"] <= 0)[:, None, None, :].expand_as(merged)
    assert torch.equal(merged[keep], t["p_a"][keep])
    assert not torch.equal(merged, t["p_a"])


def test_division_is_the_correctly_rounded_quotient():
    """The kernel's division, q = e r corrected once by the remainder, is
    float32's e / sum wherever the quotient is a normal float."""
    g = torch.Generator().manual_seed(33)
    e = torch.rand(4096, generator=g)
    total = e.sum() + torch.rand(4096, generator=g) * 100.0
    r = (1.0 / total.double()).float()
    quotient = e * r
    got = _fma(_fma(-quotient, total, e), r, quotient)
    assert torch.equal(got, e / total)


def _large_logits_case(seed):
    """The fused form on logits near 2^16, exact in float32 in any
    summation order: q's first lane 2048 (256 once scaled by 1/8 at d =
    64) against k's 256, the other lanes on grids (q multiples of 1/2 in
    [-2, 2], k of 1/8 in [-1, 1]) whose products are multiples of 2^-7,
    the float32 ulp there; terms ~ 0.3 N(0, 1) with finer bits, so that
    each addition to the logit rounds."""
    n, grid, d = 37, (3, 7), 64
    np_ = grid[0] * grid[1]
    rng = np.random.default_rng(seed)
    q = rng.integers(-4, 5, (B, H, n, d)).astype(np.float32) / 2
    k = rng.integers(-8, 9, (B, H, np_, d)).astype(np.float32) / 8
    q[..., 0], k[..., 0] = 2048.0, 256.0
    t, _, _ = _case("n37_p3x7_d16", "fused_terms", seed)  # its terms, coverage and p_a
    t.update(q=torch.from_numpy(q).to(BF16), k=torch.from_numpy(k).to(BF16),
             p_v=torch.from_numpy(rng.standard_normal((B, H, np_, d)).astype(np.float32)).to(BF16))
    return t, grid, d**-0.5


# planted fault -> (the case it shows on, the emulation's switch)
FAULTS = {
    "inv_scale_not_rounded": (lambda: _case("n37_p3x7_d48", "fused_terms", seed=34),
                              dict(round_scale=False)),
    "terms_one_after_the_other": (lambda: _large_logits_case(35), dict(terms_in_turn=True)),
    "online_rescaled_sum": (lambda: _case("n70_p10x13_d64", "fused_terms", seed=36),
                            dict(online=True)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_faults_fail_the_bounds(fault):
    """Each planted fault fails the bounds against the JAX kernel and the
    plain version, which the faultless emulation of the same case passes."""
    make, planted = FAULTS[fault]
    t, grid, inv_scale = make()
    for want in (_jax(t, grid, inv_scale, False, True), _plain(t, grid, inv_scale, False, True)):
        rows = _rows(_emulate(t, grid, inv_scale, False, True), want)
        assert all(row["ok"] for row in rows), rows
        rows = _rows(_emulate(t, grid, inv_scale, False, True, **planted), want)
        assert not all(row["ok"] for row in rows), rows
