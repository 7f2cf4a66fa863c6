"""Rows 12 (``ln_select_matmul``) and 13 (``select_linear_skip_norms``) on
the wgmma GEMM core (``csrc/gemm_tc.cuh``), on the CPU, where no card runs
it: what surrounds the kernels, in Python, and the arithmetic they must
keep.

(a) bfloat16 parity with the JAX package: the plain versions, which the
card holds the kernels against, against the JAX Pallas kernels in
interpret mode on the same numpy inputs rounded to bfloat16 (B = 2, N =
24, C = 128, so that row 12's F = 3C = 384 "post" and "pre" and F = C =
128 "none", and row 13's F = C, all take "tc"; k = 9). The bfloat16
outputs within ``kernel_check.BF16_BOUNDS`` (the bounds the card holds the
kernels to), the updated gate state exactly; row 13's float32 norms within
the norm of the two sides' difference in the vectors they are taken of,
plus one ulp of each element of the rounded y they are taken from (carried
through the LN with ``next_ln``: XLA on the CPU may keep the excess
precision of y across the kernel's bfloat16 rounding of it), plus 1e-4
scaled (``kernel_check.F32_SCALED``).

(b) Split-K, emulated (``gemm_core.gemm_split_plain``): float32 partials
added in split order, the epilogue after the full sum, at a split of 1, 2
and 3 of C = 768's 12 K steps. Every form built on it, with the plain
versions' rounding points (row 12 rnd(acc + b), row 13 rnd(rnd(acc + b) +
skip), not kernel B's rnd(rnd(rnd(acc) + b) + skip)), equals the plain
version within ``BF16_BOUNDS`` in bfloat16 and within 1e-4 scaled in
float32; unsplit, exactly.

(c) The core rule and plan at the paths' five shapes (the paper's ViViT at
12 views and ViViT with gates before LN at 8, N = 197, C = 768): "tc" in
bfloat16, "simt" in float32, one unsplit wave each; at C = 64 the forms
take "wmma", at C = 128 "tc".

(d) The wrappers count their launches by core, and the harness lists and
resets those counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.ops.pallas import gate_fused as jax_gate_fused
from eventful_transformer_tpu_torch.ops import gate_fused, gemm_core, kernel_check
from eventful_transformer_tpu_torch.ops.common import ln_f32, row_norms
from eventful_transformer_tpu_torch.ops.gate_fused import (
    ln_select_matmul_plain,
    select_linear_skip_norms_plain,
)

B, N, C, K = 2, 24, 128, 9
LN_MODES = ("post", "none", "pre")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _inputs(c, seed=0):
    """float32 numpy activations, a gate state, a skip, the next gate's
    state, a coverage of exactly K rows per batch row, LN params and the
    qkv (C x 3C) and projection (C x C) linears."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    cov = np.zeros((B, N), np.float32)
    for i in range(B):
        cov[i, rng.permutation(N)[:K]] = 1.0
    return dict(
        x=f(B, N, c), p=f(B, N, c), skip=f(B, N, c), p_next=f(B, N, c), cov=cov,
        s=1.0 + f(c, scale=0.1), bias=f(c, scale=0.1), w=f(c, 3 * c, scale=c**-0.5),
        wb=f(3 * c, scale=0.1), w_proj=f(c, c, scale=c**-0.5), wb_proj=f(c, scale=0.1),
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


def _row12_operands(d, ln_mode):
    """Row 12's operands in the wrapper's order: the qkv linear for "post"
    and "pre", the projection for "none" (scale and bias unused)."""
    w, wb = ("w", "wb") if ln_mode != "none" else ("w_proj", "wb_proj")
    return [d["x"], d["p"], d["cov"], d["s"], d["bias"], d[w], d[wb]]


def _row13_operands(d):
    return [d["x"], d["p"], d["cov"], d["w_proj"], d["wb_proj"], d["skip"], d["p_next"], d["s"],
            d["bias"]]


# -- (a) bfloat16 parity with the JAX kernels ----------------------------------------


@pytest.mark.parametrize("ln_mode", LN_MODES)
def test_ln_select_matmul_bf16_matches_jax(ln_mode):
    jx, tx = _bf16(_inputs(C))
    ref = jax_gate_fused.ln_select_matmul(*_row12_operands(jx, ln_mode), ln_mode=ln_mode,
                                          block_n=16, interpret=True)
    args = _row12_operands(tx, ln_mode)
    if ln_mode == "none":
        args[3] = args[4] = None
    port = ln_select_matmul_plain(*args, ln_mode=ln_mode)
    assert port[0] is tx["p"]  # the gate state is updated in place
    assert torch.equal(port[0].float(), _torch(ref[0]))
    assert port[1].dtype == torch.bfloat16
    assert port[1].shape == (B, N, 3 * C if ln_mode != "none" else C)
    _close(port[1], _torch(ref[1]))


@pytest.mark.parametrize("next_ln", [True, False], ids=["next_ln", "no_ln"])
def test_select_linear_skip_norms_bf16_matches_jax(next_ln):
    jx, tx = _bf16(_inputs(C, seed=1))
    ref = jax_gate_fused.select_linear_skip_norms(*_row13_operands(jx), next_ln=next_ln,
                                                  block_n=16, interpret=True)
    args = _row13_operands(tx)
    if not next_ln:
        args[7] = args[8] = None
    port = select_linear_skip_norms_plain(*args, next_ln=next_ln)
    assert port[0] is tx["p"]
    assert torch.equal(port[0].float(), _torch(ref[0]))
    assert port[1].dtype == torch.bfloat16
    _close(port[1], _torch(ref[1]))
    y, y_ref = port[1].float(), _torch(ref[1])
    # one bfloat16 ulp of each element of y, through the LN's gain with next_ln
    ulps = (y.abs() * 2.0**-7).square().sum(-1).sqrt()
    if next_ln:
        ln = lambda t: ln_f32(t, tx["s"], tx["bias"])  # noqa: E731
        moved = row_norms(ln(y) - ln(y_ref.to(torch.bfloat16)))
        gain = tx["s"].float().abs().max() * torch.rsqrt(y.var(-1, unbiased=False) + 1e-6)
        ulps = ulps * gain
    else:
        moved = row_norms(y - y_ref)
    want = _torch(ref[2])
    slack = moved + ulps + kernel_check.F32_SCALED * want.abs().clamp(min=1.0)
    assert port[2].dtype == torch.float32
    assert ((port[2] - want).abs() <= slack).all()


# -- (b) split-K, emulated -----------------------------------------------------------


def _split_row12(d, ln_mode, split):
    """Row 12 with its GEMM summed as a plan of ``split`` sums it, the
    epilogue rnd(acc + b) after the full sum."""
    x, p, cov, scale, bias, w, wb = _row12_operands(d, ln_mode)
    new = ln_f32(x, scale, bias) if ln_mode == "post" else x.float()
    p1 = torch.where(cov[..., None] > 0, new, p.float()).to(p.dtype)
    mm_in = ln_f32(p1, scale, bias).to(x.dtype) if ln_mode == "pre" else p1
    acc = gemm_core.gemm_split_plain(mm_in.reshape(-1, mm_in.shape[-1]), w, split)
    return p1, (acc + wb.float()).to(x.dtype).reshape(*x.shape[:-1], -1)


def _split_row13(d, next_ln, split):
    """Row 13 with its GEMM summed as a plan of ``split`` sums it, the
    epilogue rnd(rnd(acc + b) + skip) after the full sum, the norms of the
    rounded y."""
    x, p, cov, w, wb, skip, p_next, scale, bias = _row13_operands(d)
    p1 = torch.where(cov[..., None] > 0, x.float(), p.float()).to(p.dtype)
    acc = gemm_core.gemm_split_plain(p1.reshape(-1, p1.shape[-1]), w, split)
    y = (acc + wb.float()).to(x.dtype).reshape(x.shape)
    y = (y.float() + skip.float()).to(x.dtype)
    yn = ln_f32(y, scale, bias) if next_ln else y.float()
    return p1, y, row_norms(yn - p_next.float())


FORMS = ["post", "none", "pre", "next_ln", "no_ln"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("split", [1, 2, 3])
@pytest.mark.parametrize("form", FORMS)
def test_split_kernel_matches_the_plain_version(form, split, dtype):
    c = 768
    assert (c // gemm_core.TILE_K) % split == 0  # whole K steps in each split
    d = {k: torch.from_numpy(v).to(torch.float32 if k == "cov" else dtype)
         for k, v in _inputs(c, seed=2).items()}
    if form in LN_MODES:
        got = _split_row12(d, form, split)
        args = _row12_operands(d, form)
        args[1] = args[1].clone()
        want = ln_select_matmul_plain(*args, ln_mode=form)
    else:
        next_ln = form == "next_ln"
        got = _split_row13(d, next_ln, split)
        args = _row13_operands(d)
        args[1] = args[1].clone()
        want = select_linear_skip_norms_plain(*args, next_ln=next_ln)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        row = kernel_check.compare(g, w)
        assert row["ok"], row
        if split == 1:
            assert torch.equal(g, w)


# -- (c) the core rule and plan at the paths' shapes ---------------------------------

EV_ROWS, PRE_LN_ROWS = 12 * 197, 8 * 197  # B.N of the two paths


@pytest.mark.parametrize("m,n,tiles_m", [
    (EV_ROWS, 3 * 768, 19),  # row 12 "post", the paper's ViViT
    (EV_ROWS, 768, 19),  # row 12 "none" and row 13 next_ln, the paper's ViViT
    (PRE_LN_ROWS, 3 * 768, 13),  # row 12 "pre", ViViT with gates before LN
    (PRE_LN_ROWS, 768, 13),  # row 13 no_ln, ViViT with gates before LN
], ids=["post", "none_next_ln", "pre", "no_ln"])
def test_rule_and_plan_at_the_paths(m, n, tiles_m):
    """342, 114, 234 and 78 tiles: each one unsplit wave (a split of 2 would
    exceed the SMs where the tiles are fewer), no workspace; "simt" in
    float32; "wmma" where an operand is off a 16-byte boundary."""
    assert gemm_core.gemm_core(torch.bfloat16, m, 768, n) == "tc"
    core, plan = gemm_core.gemm_launch(torch.bfloat16, m, 768, n, True)
    assert core == "tc"
    assert (plan.tiles_m, plan.tiles_n, plan.split, plan.steps) == (tiles_m, n // 128, 1, 12)
    assert plan.blocks == tiles_m * n // 128
    assert plan.workspace == 0
    assert gemm_core.workspace([plan], "cpu") is None
    assert gemm_core.plan_args([plan], None) == (1, None)
    assert gemm_core.gemm_launch(torch.float32, m, 768, n, True) == (
        "simt", gemm_core.simt_plan(m, 768, n))
    assert gemm_core.gemm_launch(torch.bfloat16, m, 768, n, False) == ("wmma", None)


def test_the_five_path_shapes_plan_their_tiles():
    """Row 12 "post" 342 tiles, "none" 114, "pre" 234; row 13 next_ln 114,
    no_ln 78."""
    shapes = {"post": (EV_ROWS, 3 * 768), "none": (EV_ROWS, 768), "pre": (PRE_LN_ROWS, 3 * 768),
              "next_ln": (EV_ROWS, 768), "no_ln": (PRE_LN_ROWS, 768)}
    tiles = {form: gemm_core.gemm_plan(m, 768, n).blocks for form, (m, n) in shapes.items()}
    assert tiles == {"post": 342, "none": 114, "pre": 234, "next_ln": 114, "no_ln": 78}


@pytest.mark.parametrize("c,want", [(64, "wmma"), (128, "tc"), (768, "tc")])
@pytest.mark.parametrize("form", FORMS)
def test_rule_at_the_test_widths(form, c, want):
    """The card tests' widths: at C = 64 no form takes "tc" (3C = 192 and C
    = 64 are off the 128-column tile), at C = 128 and up every form does;
    float32 always "simt"."""
    n = 3 * c if form in ("post", "pre") else c
    m = B * N
    assert gemm_core.gemm_launch(torch.bfloat16, m, c, n, True)[0] == want
    assert gemm_core.gemm_launch(torch.float32, m, c, n, True)[0] == "simt"


# -- (d) the launch counts by core ---------------------------------------------------


@pytest.mark.parametrize("wrapper", [gate_fused.ln_select_matmul,
                                     gate_fused.select_linear_skip_norms])
def test_core_counts_are_listed_and_reset(wrapper):
    """Each wrapper keeps a count per core, which ``kernel_check`` lists
    beside rows 2-5's and sets to 0; CPU tensors take the plain version
    and count nothing."""
    assert set(wrapper.core_launches) == set(gemm_core.CORES)
    assert wrapper.__name__ in kernel_check.core_launches()
    wrapper.core_launches["tc"] += 1
    kernel_check.reset_launches()
    assert wrapper.core_launches == gemm_core.new_core_counts()
    d = kernel_check.make_inputs(B, N, C, 4, K, torch.float32, "cpu", seed=3)
    for name in ("ln_select_matmul_post", "select_linear_skip_norms"):
        kernel_check.call(name, d)
    assert wrapper.core_launches == gemm_core.new_core_counts()
    assert kernel_check.core_launches()[wrapper.__name__] == gemm_core.new_core_counts()
