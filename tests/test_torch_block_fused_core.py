"""Kernels A (``qkv_attention_group``) and B (``proj_group``) on the wgmma
GEMM core (``csrc/gemm_tc.cuh``), on the CPU, where no card runs it: what
surrounds the kernels, in Python, and the arithmetic they must keep.

(a) bfloat16 parity with the JAX package: the plain versions, which the
card holds the kernels against, against the JAX Pallas kernels in
interpret mode on the same numpy inputs rounded to bfloat16 (B = 2, N =
24, C = 128, so that 3C = 384 and C both take "tc"; 4 heads, k = 9). The
bfloat16 outputs within ``kernel_check.BF16_BOUNDS`` (the bounds the card
holds the kernels to: <= 5 % of the elements differ, <= 1 % by more than
one ulp, scaled error <= 2e-2), the updated gate state exactly; the float32
norms within the norm of the two sides' difference in the vectors they are
taken of (a norm moves by at most the norm of its vector's move), plus one
ulp of each element of the bfloat16 output they are taken from, carried
through the LN in kernel B (XLA on the CPU may keep the excess precision
of a value across the kernel's bfloat16 rounding of it, so the JAX side
may take the norms of the unrounded output), plus 1e-4 scaled
(``kernel_check.F32_SCALED``).

(b) Split-K, emulated (``gemm_core.gemm_split_plain``): float32 partials
added in split order, the epilogue after the full sum, at a forced split of
2 and 3 of C = 768's 12 K steps. Both kernels built on it, with the plain
versions' rounding points, equal the plain versions within
``BF16_BOUNDS`` in bfloat16 and within 1e-4 scaled in float32; unsplit,
exactly.

(c) The core rule and plan at the main path's shapes: (1576, 768, 2304)
and (1576, 768, 768) take "tc" in bfloat16 and "simt" in float32, with one
unsplit wave each; C = 64 (3C = 192) takes "wmma".

(d) The yardsticks (``kernel_check.library_call``) of rows 2, 3, 7, 12 and
13 compute the products of those kernels on the same operands: in float32
each equals the plain version's product (row 2: its attention output)
within 1e-4 scaled.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.ops.pallas import block_fused as jax_block_fused
from eventful_transformer_tpu_torch.ops import gemm_core, kernel_check
from eventful_transformer_tpu_torch.ops.block_fused import (
    proj_group_plain,
    qkv_attention_group_plain,
)
from eventful_transformer_tpu_torch.ops.common import ln_f32, row_norms
from eventful_transformer_tpu_torch.ops.window_attention import attention_plain

B, N, C, HEADS, K = 2, 24, 128, 4, 9


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _inputs(c, seed=0):
    """float32 numpy activations, gate states, coverages of exactly K rows
    per batch row, LN and linear params of both kernels."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731

    def cov():
        out = np.zeros((B, N), np.float32)
        for i in range(B):
            out[i, rng.permutation(N)[:K]] = 1.0
        return out

    return dict(
        x=f(B, N, c), p_qkv=f(B, N, c), p_proj=f(B, N, c), attn=f(B, N, c), p_mlp=f(B, N, c),
        cov1=cov(), cov2=cov(), ln1_s=1.0 + f(c, scale=0.1), ln1_b=f(c, scale=0.1),
        ln2_s=1.0 + f(c, scale=0.1), ln2_b=f(c, scale=0.1),
        w_qkv=f(c, 3 * c, scale=c**-0.5), b_qkv=f(3 * c, scale=0.1),
        w_proj=f(c, c, scale=c**-0.5), b_proj=f(c, scale=0.1),
    )


def _is_cov(key):
    return key.startswith("cov")


def _bf16(d):
    """The same inputs for both packages: bfloat16 tensors (the coverages in
    float32), rounded once."""
    jx = {k: jnp.asarray(v, jnp.float32 if _is_cov(k) else jnp.bfloat16) for k, v in d.items()}
    tx = {k: torch.from_numpy(v.copy()).to(torch.float32 if _is_cov(k) else torch.bfloat16)
          for k, v in d.items()}
    return jx, tx


def _torch(ref):
    return torch.from_numpy(np.array(jnp.asarray(ref, jnp.float32)))


def _close(port, ref):
    row = kernel_check.compare(port, ref.to(port.dtype))
    assert row["ok"], row


def _ulps(y, gain=1.0):
    """The norm of one bfloat16 ulp of each element of ``y``'s rows, times
    ``gain``."""
    return gain * (y.float().abs() * 2.0**-7).square().sum(-1).sqrt()


def _close_norms(norms, want, moved, rounding):
    """float32 norms within ``moved`` (the norm of the move of the vectors
    they are taken of) plus ``rounding`` plus 1e-4 scaled."""
    slack = moved + rounding + kernel_check.F32_SCALED * want.abs().clamp(min=1.0)
    assert norms.dtype == torch.float32
    assert ((norms - want).abs() <= slack).all()


# -- (a) bfloat16 parity with the JAX kernels ----------------------------------------


def test_qkv_attention_group_bf16_matches_jax():
    jx, tx = _bf16(_inputs(C))
    inv_scale = (C // HEADS) ** -0.5
    keys = ("x", "p_qkv", "cov1", "p_proj", "ln1_s", "ln1_b", "w_qkv", "b_qkv")
    ref = jax_block_fused.qkv_attention_group(*(jx[k] for k in keys), heads=HEADS,
                                              inv_scale=inv_scale, interpret=True)
    p_qkv = tx["p_qkv"]
    port = qkv_attention_group_plain(*(p_qkv if k == "p_qkv" else tx[k] for k in keys),
                                     heads=HEADS, inv_scale=inv_scale)
    assert port[0] is p_qkv  # the gate state is updated in place
    assert torch.equal(port[0].float(), _torch(ref[0]))
    assert port[1].dtype == torch.bfloat16
    _close(port[1], _torch(ref[1]))
    moved = row_norms(port[1].float() - _torch(ref[1]))
    _close_norms(port[2], _torch(ref[2]), moved, _ulps(port[1]))


def test_proj_group_bf16_matches_jax():
    jx, tx = _bf16(_inputs(C, seed=1))
    keys = ("attn", "p_proj", "cov2", "x", "p_mlp", "w_proj", "b_proj", "ln2_s", "ln2_b")
    ref = jax_block_fused.proj_group(*(jx[k] for k in keys), interpret=True)
    p_proj = tx["p_proj"]
    port = proj_group_plain(*(p_proj if k == "p_proj" else tx[k] for k in keys))
    assert port[0] is p_proj
    assert torch.equal(port[0].float(), _torch(ref[0]))
    assert port[1].dtype == torch.bfloat16
    _close(port[1], _torch(ref[1]))
    ln = lambda y: ln_f32(y, tx["ln2_s"], tx["ln2_b"])  # noqa: E731
    moved = row_norms(ln(port[1]) - ln(_torch(ref[1]).to(torch.bfloat16)))
    # the LN scales a move of y by |scale| / std(y) at most
    y = port[1].float()
    gain = tx["ln2_s"].float().abs().max() * torch.rsqrt(y.var(-1, unbiased=False) + 1e-6)
    _close_norms(port[2], _torch(ref[2]), moved, _ulps(y, gain))


# -- (b) split-K, emulated -----------------------------------------------------------


def _split_qkv_attention_group(d, split, heads):
    """Kernel A with its GEMM summed as a plan of ``split`` sums it, the
    epilogue rnd(rnd(acc) + b) after the full sum."""
    wd = d["x"].dtype
    p1 = torch.where(d["cov1"][..., None] > 0, ln_f32(d["x"], d["ln1_s"], d["ln1_b"]),
                     d["p_qkv"].float()).to(wd)
    acc = gemm_core.gemm_split_plain(p1.reshape(-1, p1.shape[-1]), d["w_qkv"], split)
    qkv = acc.to(wd).reshape(*p1.shape[:2], -1) + d["b_qkv"]
    c = p1.shape[-1]
    out = attention_plain(qkv, heads, (c // heads) ** -0.5)
    return p1, out, row_norms(out.float() - d["p_proj"].float())


def _split_proj_group(d, split):
    """Kernel B with its GEMM summed as a plan of ``split`` sums it, the
    epilogue rnd(rnd(rnd(acc) + b) + skip) after the full sum."""
    wd = d["attn"].dtype
    p2 = torch.where(d["cov2"][..., None] > 0, d["attn"].float(), d["p_proj"].float()).to(wd)
    acc = gemm_core.gemm_split_plain(p2.reshape(-1, p2.shape[-1]), d["w_proj"], split)
    y1 = (acc.to(wd).reshape(p2.shape) + d["b_proj"]) + d["x"]
    return p2, y1, row_norms(ln_f32(y1, d["ln2_s"], d["ln2_b"]) - d["p_mlp"].float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("split", [1, 2, 3])
@pytest.mark.parametrize("kernel", ["qkv_attention_group", "proj_group"])
def test_split_kernel_matches_the_plain_version(kernel, split, dtype):
    c, heads = 768, 12
    assert (c // gemm_core.TILE_K) % split == 0  # whole K steps in each split
    d = {k: torch.from_numpy(v).to(torch.float32 if _is_cov(k) else dtype)
         for k, v in _inputs(c, seed=2).items()}
    if kernel == "qkv_attention_group":
        got = _split_qkv_attention_group(d, split, heads)
        want = qkv_attention_group_plain(
            d["x"], d["p_qkv"].clone(), d["cov1"], d["p_proj"], d["ln1_s"], d["ln1_b"],
            d["w_qkv"], d["b_qkv"], heads=heads, inv_scale=(c // heads) ** -0.5)
    else:
        got = _split_proj_group(d, split)
        want = proj_group_plain(d["attn"], d["p_proj"].clone(), d["cov2"], d["x"], d["p_mlp"],
                                d["w_proj"], d["b_proj"], d["ln2_s"], d["ln2_b"])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        row = kernel_check.compare(g, w)
        assert row["ok"], row
        if split == 1:
            assert torch.equal(g, w)


# -- (c) the core rule and plan at the path's shapes ---------------------------------

ROWS = 8 * 197  # ViViT's B.N


@pytest.mark.parametrize("name,n", [("qkv_attention_group", 3 * 768), ("proj_group", 768)])
def test_rule_and_plan_at_the_main_path(name, n):
    """Kernels A and B at ViViT's shape: "tc" in bfloat16, one unsplit wave
    (A 13 x 18 = 234 tiles, B 13 x 6 = 78: a split of 2 would exceed the
    SMs), no workspace; "simt" in float32, on its tile plan."""
    assert gemm_core.gemm_core(torch.bfloat16, ROWS, 768, n) == "tc"
    assert gemm_core.gemm_core(torch.float32, ROWS, 768, n) == "simt"
    core, plan = gemm_core.gemm_launch(torch.bfloat16, ROWS, 768, n, True)
    assert core == "tc"
    assert (plan.tiles_m, plan.tiles_n, plan.split, plan.steps) == (13, n // 128, 1, 12)
    assert plan.workspace == 0
    assert gemm_core.workspace([plan], "cpu") is None
    assert gemm_core.plan_args([plan], None) == (1, None)
    assert gemm_core.gemm_launch(torch.float32, ROWS, 768, n, True) == (
        "simt", gemm_core.simt_plan(ROWS, 768, n))
    assert gemm_core.gemm_launch(torch.bfloat16, ROWS, 768, n, False) == ("wmma", None)


@pytest.mark.parametrize("c,want_a,want_b", [(64, "wmma", "wmma"), (128, "tc", "tc"),
                                             (256, "tc", "tc"), (768, "tc", "tc")])
def test_rule_at_the_test_widths(c, want_a, want_b):
    """The card tests' widths: C = 64 keeps both GEMMs on WMMA (3C = 192
    and C = 64 are off the 128-column tile), C = 128 and up takes "tc"."""
    m = B * N
    assert gemm_core.gemm_launch(torch.bfloat16, m, c, 3 * c, True)[0] == want_a
    assert gemm_core.gemm_launch(torch.bfloat16, m, c, c, True)[0] == want_b
    for n in (3 * c, c):
        assert gemm_core.gemm_launch(torch.float32, m, c, n, True)[0] == "simt"


# -- (d) the yardsticks compute the kernels' products --------------------------------


def _yardstick_inputs():
    return kernel_check.make_inputs(B, N, C, HEADS, K, torch.float32, "cpu", seed=3)


def _scaled(got, want):
    return float(((got - want).abs() / want.abs().clamp(min=1.0)).max())


def test_row2_yardstick_is_the_gemm_and_attention():
    d = _yardstick_inputs()
    want = kernel_check.call("qkv_attention_group", d, plain=True)[1]
    got = kernel_check.library_call("qkv_attention_group", d)()
    assert _scaled(got.transpose(1, 2).reshape(want.shape), want) <= kernel_check.F32_SCALED


@pytest.mark.parametrize("name", ["proj_group", "select_linear_skip_norms",
                                  "select_linear_skip_norms_noln"])
def test_dense_projection_yardsticks_add_up_to_the_output(name):
    """Rows 3 and 13: the product over every row plus the skip is y."""
    d = _yardstick_inputs()
    y = kernel_check.call(name, d, plain=True)[1]
    got = kernel_check.library_call(name, d)().reshape(y.shape) + d["x"]
    assert _scaled(got, y) <= kernel_check.F32_SCALED


@pytest.mark.parametrize("name", ["ln_select_matmul_post", "ln_select_matmul_none"])
def test_dense_recompute_yardsticks_are_the_output(name):
    """Row 12: the product over every row of the selected state is y."""
    d = _yardstick_inputs()
    y = kernel_check.call(name, d, plain=True)[1]
    got = kernel_check.library_call(name, d)().reshape(y.shape)
    assert _scaled(got, y) <= kernel_check.F32_SCALED


@pytest.mark.parametrize("name,cov", [("gate_group_linear", "cov2"),
                                      ("gate_group_linear_post", "cov1"),
                                      ("gate_group_linear_pre", "cov1"),
                                      ("gate_group_linear_topk", "cov2"),
                                      ("gate_group_linear_post_topk", "cov1")])
def test_gathered_yardsticks_are_the_buffer_rows(name, cov):
    """Row 7: the product on the k covered rows is the buffer's new rows
    there (with a coverage given); the forms that select their own rows
    multiply k rows of each batch row too."""
    d = _yardstick_inputs()
    got = kernel_check.library_call(name, d)()
    assert got.shape == (B * K, d["b_qkv" if cov == "cov1" else "b_proj"].shape[0])
    if name.endswith("_topk"):
        return
    buf = kernel_check.call(name, d, plain=True)[1]
    assert _scaled(got, buf[d[cov] > 0]) <= kernel_check.F32_SCALED
