"""The wgmma GEMM core of rows 4 and 5 (``csrc/gemm_tc.cuh``) on the CPU,
where no card runs it: what surrounds the kernel, in Python, and the
arithmetic it must keep.

(a) bfloat16 parity with the JAX package: the plain versions of
``dense_mlp_residual`` (row 5) and ``gate_group_mlp`` (row 4, in its
"post", "pre" and ``cov=None`` forms), which the card holds the core's
launches against, against the JAX Pallas kernels in interpret mode on the
same numpy inputs rounded to bfloat16 (B = 2, N = 24, C = 64 and 128,
hidden 4C, k = 9), within ``kernel_check.BF16_BOUNDS`` (the bounds the card
holds the kernels to); next-gate norms within the slack
tests/test_torch_topk_in_kernel.py states for a bfloat16 run.

(b) The launch plan (``gemm_core.gemm_plan``) at every GEMM shape of the
paths and at ragged row counts: the tiles cover M and N, the split divides
the K steps into whole steps of at least ``MIN_SPLIT_STEPS``, a split
keeps its blocks within the SMs and is the largest that does, and the
workspace is split x M x N floats.

(c) Split-K, emulated (``gemm_core.gemm_split_plain``): float32 partials
added in split order, the epilogue after the full sum. The sum equals the
unsplit one within float32 summation error, and the MLP built on it, with
the plain versions' rounding points, equals the plain versions: exactly
in the bfloat16 elements but for roundings its sums put across a boundary
(``BF16_BOUNDS``), within 1e-5 scaled in float32.

(d) The core rule (``gemm_core.gemm_core``, ``mlp_launch``): bfloat16 at
every path shape takes "tc"; float32 "simt"; a K or N off the tile, or an
operand off a 16-byte boundary, "wmma".
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.ops.pallas import dense_mlp as jax_dense_mlp
from eventful_transformer_tpu.ops.pallas import gate_group as jax_gate_group
from eventful_transformer_tpu_torch.ops import gemm_core, kernel_check
from eventful_transformer_tpu_torch.ops.common import gelu_exact, ln_f32
from eventful_transformer_tpu_torch.ops.dense_mlp import dense_mlp_residual_plain
from eventful_transformer_tpu_torch.ops.gate_group import gate_group_mlp_plain

B, N, K = 2, 24, 9


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _inputs(c, seed=0):
    """float32 numpy activations, gate state, buffer, LN and MLP params, a
    coverage of exactly K rows per batch row, and a next gate's state."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    hidden = 4 * c
    cov = np.zeros((B, N), np.float32)
    for i in range(B):
        cov[i, rng.permutation(N)[:K]] = 1.0
    return dict(
        x=f(B, N, c), p=f(B, N, c), buf=f(B, N, c), cov=cov, p_next=f(B, N, c),
        s=1.0 + f(c, scale=0.1), bias=f(c, scale=0.1), ns=1.0 + f(c, scale=0.1),
        nb=f(c, scale=0.1), w1=f(c, hidden, scale=c**-0.5), b1=f(hidden, scale=0.1),
        w2=f(hidden, c, scale=hidden**-0.5), b2=f(c, scale=0.1),
    )


def _bf16(d):
    """The same inputs for both packages: bfloat16 tensors (the coverage in
    float32), rounded once."""
    jx = {k: jnp.asarray(v, jnp.float32 if k == "cov" else jnp.bfloat16) for k, v in d.items()}
    tx = {k: torch.from_numpy(v.copy()).to(torch.float32 if k == "cov" else torch.bfloat16)
          for k, v in d.items()}
    return jx, tx


def _close(port, ref):
    ref = torch.from_numpy(np.array(jnp.asarray(ref, jnp.float32)))
    row = kernel_check.compare(port, ref.to(port.dtype))
    assert row["ok"], row


def _close_norms(norms, want, y, y_ref):
    """bfloat16 next-gate norms (float32 values of bfloat16 y): within the
    norm of the two sides' y difference plus y's rounding error, plus 1e-4
    scaled (tests/test_torch_topk_in_kernel.py)."""
    want = torch.from_numpy(np.array(want)).reshape(norms.shape)
    yf = y.float()
    gap = yf - torch.from_numpy(np.array(jnp.asarray(y_ref, jnp.float32)))
    rounding = (yf.abs() * 2.0**-8).square().sum(-1).sqrt()
    slack = gap.square().sum(-1).sqrt() + rounding + 1e-4 * want.abs().clamp(min=1.0)
    assert ((norms - want).abs() <= slack).all()


# -- (a) bfloat16 parity with the JAX kernels ----------------------------------------


@pytest.mark.parametrize("c", [64, 128])
def test_dense_mlp_residual_bf16_matches_jax(c):
    jx, tx = _bf16(_inputs(c))
    args = ("x", "s", "bias", "w1", "b1", "w2", "b2")
    ref = jax_dense_mlp.dense_mlp_residual(*(jx[k] for k in args), block_n=16, interpret=True)
    port = dense_mlp_residual_plain(*(tx[k] for k in args))
    assert port.dtype == torch.bfloat16
    _close(port, ref)


MLP_FORMS = [("post", True), ("post", False), ("pre", True), ("post_topk", True),
             ("post_topk", False), ("pre_topk", True)]


@pytest.mark.parametrize("c", [64, 128])
@pytest.mark.parametrize("form,emit", MLP_FORMS, ids=[f"{f}-{'norms' if e else 'plain'}"
                                                      for f, e in MLP_FORMS])
def test_gate_group_mlp_bf16_matches_jax(form, emit, c):
    ln_mode = form.split("_")[0]
    emit = emit and ln_mode == "post"  # no next-gate norms before the LN
    jx, tx = _bf16(_inputs(c, seed=1))
    topk = form.endswith("_topk")
    extra = ("p_next", "ns", "nb") if emit else ()
    ref = jax_gate_group.gate_group_mlp(
        jx["x"], jx["p"], jx["buf"], None if topk else jx["cov"], jx["s"], jx["bias"], jx["w1"],
        jx["b1"], jx["w2"], jx["b2"], *(jx[k] for k in extra), ln_mode=ln_mode, kcap=K,
        interpret=True,
    )
    p, buf = tx["p"], tx["buf"]
    port = gate_group_mlp_plain(
        tx["x"], p, buf, None if topk else tx["cov"], tx["s"], tx["bias"], tx["w1"], tx["b1"],
        tx["w2"], tx["b2"], *(tx[k] for k in extra), ln_mode=ln_mode, kcap=K,
    )
    assert port[0] is p and port[1] is buf
    for got, want in zip(port[:3], ref[:3]):
        assert got.dtype == torch.bfloat16
        _close(got, want)
    assert (port[3] is not None) == emit
    if emit:
        _close_norms(port[3], ref[3], port[2], ref[2])


# -- (b) the launch plan -------------------------------------------------------------

# (M, K, N) of every GEMM of rows 4 and 5 on the paths: the MLP's two GEMMs,
# C = 768 <-> 4C = 3072, at M = the rows a call multiplies
PATH_ROWS = {
    "row5_vivit": 8 * 197, "row5_temporal": 8 * 17, "row5_672": 2 * 1764,
    "row5_e2e": 1764, "row5_1024": 2 * 4096, "row4_vivit_k98": 8 * 98,
    "row4_evblock_k24": 12 * 24, "row4_672_k256": 2 * 256,
}
RAGGED_ROWS = {"m1": 1, "m17": 17, "m136": 136, "m197": 197}
ALL_ROWS = {**PATH_ROWS, **RAGGED_ROWS}
SHAPES = [(name, m, k, n) for name, m in sorted(ALL_ROWS.items())
          for k, n in ((768, 3072), (3072, 768))]


def _plan_ok(m, k, n):
    """The tile count, the K steps and whether a split satisfies the plan's
    constraints at (m, k, n)."""
    steps = k // gemm_core.TILE_K
    tiles = -(-m // gemm_core.TILE_M) * (n // gemm_core.TILE_N)

    def ok(s):
        return (steps % s == 0 and steps // s >= gemm_core.MIN_SPLIT_STEPS
                and tiles * s <= gemm_core.SMS)

    return tiles, steps, ok


@pytest.mark.parametrize("name,m,k,n", SHAPES, ids=[f"{s[0]}-{s[2]}x{s[3]}" for s in SHAPES])
def test_plan_covers_the_gemm(name, m, k, n):
    plan = gemm_core.gemm_plan(m, k, n)
    assert (plan.m, plan.k, plan.n) == (m, k, n)
    assert (plan.tiles_m - 1) * gemm_core.TILE_M < m <= plan.tiles_m * gemm_core.TILE_M
    assert plan.tiles_n * gemm_core.TILE_N == n
    assert plan.split * plan.steps * gemm_core.TILE_K == k
    tiles, steps, ok = _plan_ok(m, k, n)
    if plan.split > 1:
        assert ok(plan.split)
        assert plan.blocks <= gemm_core.SMS
        assert plan.workspace == plan.split * m * n
    else:
        assert plan.workspace == 0
    # the largest split that keeps the constraints, and none where the tiles fill the SMs
    if tiles >= gemm_core.SMS:
        assert plan.split == 1
    else:
        assert not any(ok(s) for s in range(plan.split + 1, steps + 1))


@pytest.mark.parametrize("row,split1,split2", [
    ("row5_vivit", 1, 1), ("row5_1024", 1, 1), ("row5_temporal", 2, 8),
    ("row4_vivit_k98", 1, 3), ("row4_evblock_k24", 1, 6), ("row4_672_k256", 1, 4),
])
def test_plan_at_the_paths(row, split1, split2):
    """The splits the paths take: row 4's second GEMM (18-42 tiles) splits,
    row 5 at ViViT and 1024 (78-1536 tiles a GEMM) does not."""
    m = PATH_ROWS[row]
    core, plan1, plan2 = gemm_core.mlp_launch(torch.bfloat16, m, 768, 3072, True)
    assert core == "tc"
    assert (plan1.split, plan2.split) == (split1, split2)
    ws = [p.workspace for p in (plan1, plan2)]
    assert ws == [s * m * n if s > 1 else 0 for s, n in ((split1, 3072), (split2, 768))]


# -- (c) split-K, emulated -----------------------------------------------------------


@pytest.mark.parametrize("split", [1, 2, 3, 4, 12])
def test_split_sum_matches_the_unsplit_sum(split):
    g = torch.Generator().manual_seed(0)
    a = torch.randn(17, 768, generator=g).to(torch.bfloat16)
    w = (torch.randn(768, 256, generator=g) * 768**-0.5).to(torch.bfloat16)
    got = gemm_core.gemm_split_plain(a, w, split)
    want = torch.matmul(a.double(), w.double())
    # float32 summation error: at most K ulps of the sum of |terms|
    scale = torch.matmul(a.double().abs(), w.double().abs())
    assert ((got.double() - want).abs() <= 768 * 2.0**-24 * scale).all()


def test_split_must_divide_k():
    with pytest.raises(ValueError, match="does not divide"):
        gemm_core.gemm_split_plain(torch.zeros(2, 512), torch.zeros(512, 4), 3)


def _split_mlp(x, s, bias, w1, b1, w2, b2, split1, split2):
    """Row 5 with each GEMM summed as a split plan sums it, the epilogues
    after the full sums at the plain version's rounding points."""
    wd = x.dtype
    xl = ln_f32(x, s, bias).to(w1.dtype).reshape(-1, x.shape[-1])
    h = gelu_exact(gemm_core.gemm_split_plain(xl, w1, split1) + b1.float()).to(wd)
    h2 = (gemm_core.gemm_split_plain(h, w2, split2) + b2.float()).to(wd)
    return (h2.float() + x.reshape(h2.shape).float()).to(wd).reshape(x.shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("splits", [(1, 1), (2, 8), (1, 4), (2, 2)])
def test_split_mlp_matches_the_plain_version(splits, dtype):
    d = {k: torch.from_numpy(v).to(dtype) for k, v in _inputs(128, seed=2).items()}
    args = [d[k] for k in ("x", "s", "bias", "w1", "b1", "w2", "b2")]
    got = _split_mlp(*args, *splits)
    want = dense_mlp_residual_plain(*args)
    row = kernel_check.compare(got, want)
    assert row["ok"], row
    if dtype == torch.bfloat16 and splits == (1, 1):
        assert row["max_abs_err"] == 0.0


def test_gemm_tc_cpu_takes_the_split_sum_of_the_rows():
    """The core's own entry on CPU tensors: a[rows] @ w as the plan splits
    it, a -1 row zero."""
    g = torch.Generator().manual_seed(3)
    a = torch.randn(20, 768, generator=g).to(torch.bfloat16)
    w = torch.randn(768, 3072, generator=g).to(torch.bfloat16)
    rows = torch.tensor([3, -1, 0, 19, 3], dtype=torch.int32)
    got = gemm_core.gemm_tc(a, w, rows)
    plan = gemm_core.gemm_plan(5, 768, 3072)
    assert plan.split == 3
    want = gemm_core.gemm_split_plain(a[[3, 0, 0, 19, 3]], w, plan.split)
    want[1] = 0.0
    assert torch.equal(got, want)


# -- (d) the core rule ---------------------------------------------------------------


@pytest.mark.parametrize("name,m", sorted(ALL_ROWS.items()))
def test_rule_takes_the_wgmma_core_in_bfloat16(name, m):
    assert gemm_core.mlp_launch(torch.bfloat16, m, 768, 3072, True)[0] == "tc"
    for k, n in ((768, 3072), (3072, 768)):
        assert gemm_core.gemm_core(torch.bfloat16, m, k, n) == "tc"
        assert gemm_core.gemm_core(torch.float32, m, k, n) == "simt"
    assert gemm_core.mlp_launch(torch.float32, m, 768, 3072, True) == (
        "simt", gemm_core.simt_plan(m, 768, 3072), gemm_core.simt_plan(m, 3072, 768))


@pytest.mark.parametrize("k,n,aligned", [
    (768, 3000, True), (700, 3072, True), (32, 128, True), (768, 64, True), (768, 3072, False),
])
def test_rule_sends_what_the_core_refuses_to_the_old_tile(k, n, aligned):
    assert gemm_core.gemm_core(torch.bfloat16, 197, k, n, aligned) == "wmma"
    assert gemm_core.gemm_core(torch.float32, 197, k, n, aligned) == "simt"


def test_mlp_takes_one_core_for_both_gemms():
    """C = 64 (hidden 256): GEMM1 (64 -> 256) would take "tc", GEMM2 (256
    -> 64) not, so both stay on the old tile; C = 256 takes "tc"."""
    assert gemm_core.gemm_core(torch.bfloat16, 48, 64, 256) == "tc"
    assert gemm_core.mlp_launch(torch.bfloat16, 48, 64, 256, True) == ("wmma", None, None)
    assert gemm_core.mlp_launch(torch.bfloat16, 48, 256, 1024, True)[0] == "tc"
