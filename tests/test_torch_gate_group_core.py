"""Row 7 (``gate_group_linear``) on the wgmma GEMM core
(``csrc/gemm_tc.cuh``), its GEMM writing the token buffer itself
(``BiasScatterEpilogue`` in ``csrc/gemm.cuh``), on the CPU, where no card
runs it: what surrounds the kernels, in Python, and the arithmetic they
must keep.

(a) bfloat16 parity with the JAX package: the plain version, which the
card holds the kernels against, against the JAX Pallas kernel in
interpret mode on the same numpy inputs rounded to bfloat16 (B = 2, N =
24, C = 128, F = 3C = 384 for the qkv forms "post" and "pre", F = C = 128
for the projection form "none", so that every form takes "tc"; k = 9):
each LN mode without a skip, with the skip, and with the skip and the next
gate's norms, with the coverage given (exactly k rows, and more than k,
whose rows beyond kcap the one-hot scatter zeroes) and selected by the
group (``cov=None``). The bfloat16 outputs within
``kernel_check.BF16_BOUNDS`` (the bounds the card holds the kernels to),
the updated gate state exactly; the float32 norms within the norm of the
two sides' difference in the vectors they are taken of, plus one ulp of
each element of the rounded y they are taken from, carried through the
next LN's gain (XLA on the CPU may keep the excess precision of y across
the kernel's bfloat16 rounding of it), plus 1e-4 scaled
(``kernel_check.F32_SCALED``).

(b) The scatter epilogue's contract, emulated: the compaction (slots in
index order, a selected row beyond kcap zeroed in b), the gathered rows
(or "pre"'s normalised scratch, a zero row in an empty slot), the GEMM
summed as a split of 1, 2 or 3 of C = 768's 12 K steps sums it
(``gemm_core.gemm_split_plain``: float32 partials in split order), then
rnd(acc + wb) written into b at the row each slot names, nothing for an
empty slot; then, with the skip, y = rnd(b' + skip) and the next gate's
norms. Equal to the plain version within ``BF16_BOUNDS`` in bfloat16 and
1e-4 scaled in float32, and exactly unsplit, with exactly k rows
selected, more than kcap and fewer (empty slots).

(c) The core rule and plan at the paths' shapes (ViTDet-672's 2 streams x
k = 256 and the e2e path's one stream, C = 768): "tc" in bfloat16, "simt"
in float32, "wmma" off a 16-byte boundary; the qkv GEMM unsplit at 672,
the others split 3 ways.

(d) The wrapper counts its launches by core, and the harness lists and
resets those counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.ops.pallas import gate_group as jax_gate_group
from eventful_transformer_tpu_torch.ops import gate_group, gemm_core, kernel_check
from eventful_transformer_tpu_torch.ops.common import ln_f32, row_norms
from eventful_transformer_tpu_torch.ops.gate_group import gate_group_linear_plain

B, N, C, K = 2, 24, 128, 9
LN_MODES = ("post", "pre", "none")
VARIANTS = ("plain", "skip", "skip_norms")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _coverage(rng, rows):
    """(B, N) float32 numpy coverage of ``rows`` random rows a batch row."""
    cov = np.zeros((B, N), np.float32)
    for i in range(B):
        cov[i, rng.permutation(N)[:rows]] = 1.0
    return cov


def _inputs(c, ln_mode, seed=0, selected=K):
    """float32 numpy activations, a gate state, the token buffer, a skip,
    the next gate's state and LN, a coverage of ``selected`` rows a batch
    row, the LN params and the linear: qkv (c x 3c) for "post" and "pre",
    the projection (c x c) for "none"."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    width = c if ln_mode == "none" else 3 * c
    return dict(
        x=f(B, N, c), p=f(B, N, c), b=f(B, N, width), skip=f(B, N, width),
        p_next=f(B, N, width), cov=_coverage(rng, selected), s=1.0 + f(c, scale=0.1),
        bias=f(c, scale=0.1), w=f(c, width, scale=c**-0.5), wb=f(width, scale=0.1),
        ns=1.0 + f(width, scale=0.1), nb=f(width, scale=0.1),
    )


def _bf16(d):
    """The same inputs for both packages: bfloat16 tensors (the coverage in
    float32), rounded once."""
    jx = {k: jnp.asarray(v, jnp.float32 if k == "cov" else jnp.bfloat16) for k, v in d.items()}
    tx = {k: torch.from_numpy(v.copy()).to(torch.float32 if k == "cov" else torch.bfloat16)
          for k, v in d.items()}
    return jx, tx


def _torch(ref):
    return torch.from_numpy(np.array(jnp.asarray(ref, jnp.float32)))


def _close(port, ref):
    row = kernel_check.compare(port, ref.to(port.dtype))
    assert row["ok"], row


def _extra(variant):
    """The optional operands' keys of a variant, in the wrappers' order."""
    return {"plain": (), "skip": ("skip",), "skip_norms": ("skip", "p_next", "ns", "nb")}[variant]


def _close_norms(norms, want, y, y_ref, scale, bias):
    """The next gate's float32 norms of the bfloat16 y (the module's
    docstring)."""
    y, y_ref = y.float(), _torch(y_ref)
    ln = lambda t: ln_f32(t, scale, bias)  # noqa: E731
    moved = row_norms(ln(y) - ln(y_ref.to(torch.bfloat16)))
    gain = scale.float().abs().max() * torch.rsqrt(y.var(-1, unbiased=False) + 1e-6)
    ulps = (y.abs() * 2.0**-7).square().sum(-1).sqrt() * gain
    want = _torch(want)
    slack = moved + ulps + kernel_check.F32_SCALED * want.abs().clamp(min=1.0)
    assert norms.dtype == torch.float32
    assert ((norms - want).abs() <= slack).all()


# -- (a) bfloat16 parity with the JAX kernel -----------------------------------------

PARITY = [(m, v, cov) for m in LN_MODES for v in VARIANTS for cov in ("given", "topk")]
PARITY += [(m, "skip_norms" if m == "none" else "plain", "over") for m in LN_MODES]


@pytest.mark.parametrize("ln_mode,variant,cov", PARITY)
def test_gate_group_linear_bf16_matches_jax(ln_mode, variant, cov):
    """"over": 13 rows selected against kcap = 9 (a coverage given from
    elsewhere can hold more than kcap rows)."""
    jx, tx = _bf16(_inputs(C, ln_mode, seed=1, selected=13 if cov == "over" else K))
    extra = _extra(variant)
    j_scale = (jnp.ones(C), jnp.zeros(C)) if ln_mode == "none" else (jx["s"], jx["bias"])
    ref = jax_gate_group.gate_group_linear(
        jx["x"], jx["p"], jx["b"], None if cov == "topk" else jx["cov"], *j_scale, jx["w"],
        jx["wb"], *(jx[k] for k in extra), ln_mode=ln_mode, kcap=K, interpret=True,
    )
    t_scale = (None, None) if ln_mode == "none" else (tx["s"], tx["bias"])
    p, b = tx["p"], tx["b"]
    port = gate_group_linear_plain(
        tx["x"], p, b, None if cov == "topk" else tx["cov"], *t_scale, tx["w"], tx["wb"],
        *(tx[k] for k in extra), ln_mode=ln_mode, kcap=K,
    )
    skip, emit = variant != "plain", variant == "skip_norms"
    assert port[0] is p and port[1] is b  # both states are updated in place
    assert len(ref) == 2 + skip + emit
    assert torch.equal(p.float(), _torch(ref[0]))
    assert b.dtype == torch.bfloat16 and b.shape == (B, N, tx["w"].shape[1])
    _close(b, _torch(ref[1]))
    if cov == "over":  # the rows beyond kcap hold zeros in both packages
        beyond = (torch.cumsum(tx["cov"], -1) > K) & (tx["cov"] > 0)
        assert int(beyond.sum()) == B * 4
        assert not b[beyond].any() and not _torch(ref[1])[beyond].any()
    if skip:
        _close(port[2], _torch(ref[2]))
    else:
        assert port[2] is None
    if emit:
        _close_norms(port[3], ref[3], port[2], ref[2], tx["ns"], tx["nb"])
    else:
        assert port[3] is None


# -- (b) the scatter epilogue, emulated ----------------------------------------------


def _scatter_kernel(d, ln_mode, variant, split):
    """Row 7 as the kernels compute it, the GEMM summed as a plan of
    ``split`` sums it and written into b through the slots; returns (p, b,
    y, next_norms) as the plain version does."""
    x, p, b, cov, w, wb = (d[k] for k in ("x", "p", "b", "cov", "w", "wb"))
    scale, bias = (None, None) if ln_mode == "none" else (d["s"], d["bias"])
    new = ln_f32(x, scale, bias) if ln_mode == "post" else x.float()
    sel = cov > 0
    p1 = torch.where(sel[..., None], new, p.float()).to(p.dtype)
    b1 = b.clone()
    idx = torch.full((B, K), -1, dtype=torch.int64)
    for i in range(B):  # the compaction: slots in index order
        rows = torch.nonzero(sel[i]).flatten()
        idx[i, : min(K, len(rows))] = rows[:K]
        b1[i, rows[K:]] = 0  # a selected row beyond kcap, zeroed
    a = torch.where((idx >= 0)[..., None], p1[torch.arange(B)[:, None], idx.clamp(min=0)], 0)
    if ln_mode == "pre":  # the normalised scratch, a zero row in an empty slot
        a = torch.where((idx >= 0)[..., None], ln_f32(a, scale, bias), 0.0).to(x.dtype)
    acc = gemm_core.gemm_split_plain(a.to(w.dtype), w, split)
    for i in range(B):
        for j in range(K):
            if idx[i, j] >= 0:  # BiasScatterEpilogue
                b1[i, idx[i, j]] = (acc[i, j] + wb.float()).to(b.dtype)
    y = norms = None
    if variant != "plain":
        y = (b1.float() + d["skip"].float()).to(x.dtype)
        if variant == "skip_norms":
            norms = row_norms(ln_f32(y, d["ns"], d["nb"]) - d["p_next"].float())
    return p1, b1, y, norms


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("selected", [K, 13, 5], ids=["k_rows", "over_kcap", "empty_slots"])
@pytest.mark.parametrize("split", [1, 2, 3])
@pytest.mark.parametrize("ln_mode,variant", [("post", "plain"), ("pre", "plain"),
                                             ("none", "plain"), ("none", "skip_norms")])
def test_scatter_epilogue_matches_the_plain_version(ln_mode, variant, split, selected, dtype):
    c = 768
    assert (c // gemm_core.TILE_K) % split == 0  # whole K steps in each split
    d = {k: torch.from_numpy(v).to(torch.float32 if k == "cov" else dtype)
         for k, v in _inputs(c, ln_mode, seed=2, selected=selected).items()}
    got = _scatter_kernel(d, ln_mode, variant, split)
    scale, bias = (None, None) if ln_mode == "none" else (d["s"], d["bias"])
    want = gate_group_linear_plain(
        d["x"], d["p"].clone(), d["b"].clone(), d["cov"], scale, bias, d["w"], d["wb"],
        *(d[k] for k in _extra(variant)), ln_mode=ln_mode, kcap=K,
    )
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        row = kernel_check.compare(g, w)
        assert row["ok"], row
        if split == 1:
            assert torch.equal(g, w)


# -- (c) the core rule and plan at the paths' shapes ---------------------------------


@pytest.mark.parametrize("m,n,tiles,split", [
    (2 * 256, 3 * 768, (4, 18), 1),  # qkv "post"/"pre", ViTDet-672 (2 streams)
    (2 * 256, 768, (4, 6), 3),  # projection "none", ViTDet-672
    (256, 3 * 768, (2, 18), 3),  # qkv, the e2e path (one stream)
    (256, 768, (2, 6), 3),  # projection, the e2e path
], ids=["672_qkv", "672_proj", "e2e_qkv", "e2e_proj"])
def test_rule_and_plan_at_the_paths(m, n, tiles, split):
    """72 tiles unsplit (a split of 2 would exceed the SMs); 24, 36 and 12
    tiles split 3 ways (4 K steps each), with a float32 workspace of split
    x M x N; "simt" in float32; "wmma" where an operand is off a 16-byte
    boundary."""
    assert gemm_core.gemm_core(torch.bfloat16, m, 768, n) == "tc"
    core, plan = gemm_core.gemm_launch(torch.bfloat16, m, 768, n, True)
    assert core == "tc"
    assert (plan.tiles_m, plan.tiles_n) == tiles
    assert (plan.split, plan.steps) == (split, 12 // split)
    assert plan.blocks == tiles[0] * tiles[1] * split <= gemm_core.SMS
    assert plan.workspace == (split * m * n if split > 1 else 0)
    assert gemm_core.split_args([plan], None)[0] == split
    assert gemm_core.gemm_launch(torch.float32, m, 768, n, True) == ("simt", None)
    assert gemm_core.gemm_launch(torch.bfloat16, m, 768, n, False) == ("wmma", None)


@pytest.mark.parametrize("c,want", [(64, "wmma"), (128, "tc"), (768, "tc")])
@pytest.mark.parametrize("ln_mode", LN_MODES)
def test_rule_at_the_test_widths(ln_mode, c, want):
    """The card tests' widths: at C = 64 no form takes "tc" (3C = 192 and C
    = 64 are off the 128-column tile), at C = 128 and up every form does,
    at any row count (k rows of B batch rows); float32 always "simt"."""
    f = c if ln_mode == "none" else 3 * c
    for m in (1, B * K, 2 * 256):
        assert gemm_core.gemm_launch(torch.bfloat16, m, c, f, True)[0] == want
        assert gemm_core.gemm_launch(torch.float32, m, c, f, True)[0] == "simt"


# -- (d) the launch counts by core ---------------------------------------------------


def test_core_counts_are_listed_and_reset():
    """The wrapper keeps a count per core, which ``kernel_check`` lists
    beside the other GEMM rows' and sets to 0; CPU tensors take the plain
    version and count nothing."""
    wrapper = gate_group.gate_group_linear
    assert set(wrapper.core_launches) == set(gemm_core.CORES)
    assert wrapper.__name__ in kernel_check.core_launches()
    wrapper.core_launches["tc"] += 1
    kernel_check.reset_launches()
    assert wrapper.core_launches == gemm_core.new_core_counts()
    d = kernel_check.make_inputs(B, N, C, 4, K, torch.float32, "cpu", seed=3)
    for name in ("gate_group_linear", "gate_group_linear_post", "gate_group_linear_pre",
                 "gate_group_linear_topk"):
        kernel_check.call(name, d)
    assert wrapper.core_launches == gemm_core.new_core_counts()
    assert kernel_check.core_launches()["gate_group_linear"] == gemm_core.new_core_counts()
