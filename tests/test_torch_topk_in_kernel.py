"""The group kernels' own top-k selection (``cov=None``, the JAX package's
``in_kernel_topk``) against the JAX package, on the same numpy inputs.

- The plain versions of ``gate_group_linear`` and ``gate_group_mlp`` with
  ``cov=None`` against the JAX Pallas kernels with ``cov=None`` in interpret
  mode (B = 2, N = 24, C = 64, F = 128, k = 9, the shapes of
  tests/test_pallas.py::test_gate_group_in_kernel_topk): "post", "pre" and
  "none", with and without the skip and the next gate's norms, float32 and
  bfloat16, and rows planted with equal error norms at the k-th value,
  where the selection must take the smallest indices.
- ``EventfulTokenwiseBlock`` in "v2mlp" and "v2" with ``in_kernel_topk =
  True`` and ``share_gate_passes`` on and off: a flush and 3 incremental
  steps against the JAX block forced the same way (interpret mode), every
  state leaf and count.
- A small ``FactorizedViViT`` of such blocks through ``apply_views``.

Tolerances: float32 at 2e-5 (both sides compute in float32, summing in
other orders), the models' outputs at 1e-4 as tests/test_torch_vivit.py
holds them; bfloat16 within ``ops/kernel_check.py``'s bounds, the norms of
a bfloat16 run within the slack tests/test_torch_pre_ln_kernels.py states;
counts at rtol 1e-6; the planted ties' coverages exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.core.blocks import Block as JaxBlock
from eventful_transformer_tpu.core.blocks import EventfulTokenwiseBlock as JaxEventfulBlock
from eventful_transformer_tpu.core.counting import Counts, Ctx as JaxCtx
from eventful_transformer_tpu.core.policies import TokenNormTopK as JaxTopK
from eventful_transformer_tpu.models import FactorizedViViT as JaxViViT
from eventful_transformer_tpu.ops.pallas import gate_group as jax_gate_group
from eventful_transformer_tpu.utils.misc import set_policies as jax_set_policies
from eventful_transformer_tpu.utils.params import fill_like
from eventful_transformer_tpu_torch.core import blocks
from eventful_transformer_tpu_torch.core.backbones import _next_gate
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.core.policies import TokenNormTopFraction, TokenNormTopK
from eventful_transformer_tpu_torch.models import FactorizedViViT
from eventful_transformer_tpu_torch.ops import gate_group, kernel_check
from eventful_transformer_tpu_torch.utils.misc import set_policies
from eventful_transformer_tpu_torch.utils.params import flatten_tree, params_from_jax
from tests.test_torch_gate_before_ln import GLOBAL
from tests.test_torch_gate_before_ln import _pair as block_pair
from tests.test_torch_gate_before_ln import _run_and_compare
from tests.test_torch_vivit import _config as vivit_config

TOL = 2e-5
B, N, C, F, K = 2, 24, 64, 128, 9
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture
def selections(monkeypatch):
    """Every coverage a cov=None group selects, in order."""
    log = []
    monkeypatch.setattr(gate_group, "record_selection", log.append)
    return log


def _inputs(seed=0, ties=None):
    """Activations, gate states, buffers, LN, linear and MLP params as
    float32 numpy arrays. ``ties`` (an LN mode): p set so that the error
    in that mode's domain has norm 5 at rows 1, 3, 6, 11, 15, 18, 23, norm
    2 at rows 4, 9, 13, 20 (which share their x and p rows, so their norms
    are equal in any arithmetic) and 0.1 elsewhere: at k = 9 the 2 slots
    left for the tied rows go to rows 4 and 9."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    d = dict(
        x=f(B, N, C), p=f(B, N, C), buf=f(B, N, F), skip=f(B, N, F), p_next=f(B, N, F),
        s=1.0 + f(C, scale=0.1), bias=f(C, scale=0.1), w=f(C, F, scale=C**-0.5),
        wb=f(F, scale=0.1), ns=1.0 + f(F, scale=0.1), nb=f(F, scale=0.1),
        buf_mlp=f(B, N, C), p_next_mlp=f(B, N, C), w1=f(C, 2 * C, scale=C**-0.5),
        b1=f(2 * C, scale=0.1), w2=f(2 * C, C, scale=(2 * C) ** -0.5), b2=f(C, scale=0.1),
    )
    if ties is not None:
        x, e = d["x"], f(B, N, C)
        for row in (9, 13, 20):
            x[:, row], e[:, row] = x[:, 4], e[:, 4]
        amp = np.full((B, N, 1), 0.1, np.float32)
        amp[:, [1, 3, 6, 11, 15, 18, 23]] = 5.0
        amp[:, [4, 9, 13, 20]] = 2.0
        e *= amp / np.linalg.norm(e, axis=-1, keepdims=True)
        new = x
        if ties == "post":
            mean = x.mean(-1, keepdims=True)
            var = np.square(x - mean).mean(-1, keepdims=True)
            new = (x - mean) / np.sqrt(var + 1e-6) * d["s"] + d["bias"]
        d["p"] = (new - e).astype(np.float32)
    return d


def _as(d, dtype):
    tdt, jdt = DTYPES[dtype]
    jx = {k: jnp.asarray(v, jdt) for k, v in d.items()}
    tx = {k: torch.from_numpy(v.copy()).to(tdt) for k, v in d.items()}
    return jx, tx


def _close(port, ref):
    ref = torch.from_numpy(np.array(jnp.asarray(ref, jnp.float32)))
    if port.dtype == torch.bfloat16:
        row = kernel_check.compare(port, ref.to(torch.bfloat16))
        assert row["ok"], row
    else:
        np.testing.assert_allclose(port.numpy(), ref.numpy(), rtol=TOL, atol=TOL)


def _close_norms(norms, want, y, y_ref):
    """Next-gate norms: 2e-5 in float32; in bfloat16 within the norm of
    the two sides' y difference plus y's rounding error, plus 1e-4 scaled
    (tests/test_torch_pre_ln_kernels.py)."""
    want = torch.from_numpy(np.array(want))
    if y.dtype == torch.float32:
        np.testing.assert_allclose(norms.numpy(), want.numpy(), rtol=TOL, atol=TOL)
        return
    yf = y.float()
    gap = yf - torch.from_numpy(np.array(jnp.asarray(y_ref, jnp.float32)))
    rounding = (yf.abs() * 2.0**-8).square().sum(-1).sqrt()
    slack = gap.square().sum(-1).sqrt() + rounding + 1e-4 * want.abs().clamp(min=1.0)
    assert ((norms - want).abs() <= slack).all()


LINEAR_CASES = [(m, v) for m in ("post", "pre", "none") for v in ("plain", "skip", "skip_norms")]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("ln_mode,variant", LINEAR_CASES)
def test_gate_group_linear_topk_matches_jax(ln_mode, variant, dtype, selections):
    jx, tx = _as(_inputs(), dtype)
    skip = variant != "plain"
    emit = variant == "skip_norms"
    extra = ("skip",) if skip else ()
    extra += ("p_next", "ns", "nb") if emit else ()
    j_scale = (jnp.ones(C), jnp.zeros(C)) if ln_mode == "none" else (jx["s"], jx["bias"])
    ref = jax_gate_group.gate_group_linear(
        jx["x"], jx["p"], jx["buf"], None, *j_scale, jx["w"], jx["wb"], *(jx[k] for k in extra),
        ln_mode=ln_mode, kcap=K, interpret=True,
    )
    t_scale = (None, None) if ln_mode == "none" else (tx["s"], tx["bias"])
    p, buf = tx["p"], tx["buf"]
    port = gate_group.gate_group_linear_plain(
        tx["x"], p, buf, None, *t_scale, tx["w"], tx["wb"], *(tx[k] for k in extra),
        ln_mode=ln_mode, kcap=K,
    )
    assert port[0] is p and port[1] is buf
    assert len(ref) == 2 + skip + emit
    assert len(selections) == 1 and selections[0].shape == (B, N)
    assert (selections[0].sum(-1) == K).all()
    for got, want in zip(port[: 2 + skip], ref[: 2 + skip]):
        _close(got, want)
    if emit:
        _close_norms(port[3], ref[3], port[2], ref[2])
    else:
        assert port[3] is None


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("ln_mode,emit", [(m, e) for m in ("post", "pre") for e in (False, True)])
def test_gate_group_mlp_topk_matches_jax(ln_mode, emit, dtype, selections):
    jx, tx = _as(_inputs(seed=1), dtype)
    args = ("x", "p", "buf_mlp")
    params = ("s", "bias", "w1", "b1", "w2", "b2")
    nxt = ("p_next_mlp", "s", "bias") if emit else ()
    ref = jax_gate_group.gate_group_mlp(
        *(jx[k] for k in args), None, *(jx[k] for k in params + nxt), ln_mode=ln_mode, kcap=K,
        interpret=True,
    )
    port = gate_group.gate_group_mlp_plain(
        *(tx[k] for k in args), None, *(tx[k] for k in params + nxt), ln_mode=ln_mode, kcap=K,
    )
    assert port[0] is tx["p"] and port[1] is tx["buf_mlp"] and len(selections) == 1
    for got, want in zip(port[:3], ref[:3]):
        _close(got, want)
    if emit:
        _close_norms(port[3], ref[3], port[2], ref[2])
    else:
        assert len(ref) == 3 and port[3] is None


@pytest.mark.parametrize("ln_mode", ["post", "none"])
def test_planted_ties_take_the_smallest_indices(ln_mode, selections):
    """Four rows with equal norms at the k-th value, two slots left for
    them: rows 4 and 9 are selected, 13 and 20 not, in both packages (the
    new gate states agree: exactly without the LN, at 2e-5 with it, whose
    float32 sums run in other orders)."""
    jx, tx = _as(_inputs(seed=2, ties=ln_mode), "f32")
    j_scale = (jnp.ones(C), jnp.zeros(C)) if ln_mode == "none" else (jx["s"], jx["bias"])
    t_scale = (None, None) if ln_mode == "none" else (tx["s"], tx["bias"])
    ref = jax_gate_group.gate_group_linear(
        jx["x"], jx["p"], jx["buf"], None, *j_scale, jx["w"], jx["wb"], ln_mode=ln_mode, kcap=K,
        interpret=True,
    )
    port = gate_group.gate_group_linear_plain(
        tx["x"], tx["p"], tx["buf"], None, *t_scale, tx["w"], tx["wb"], ln_mode=ln_mode, kcap=K,
    )
    want = torch.zeros(B, N)
    want[:, [1, 3, 6, 11, 15, 18, 23, 4, 9]] = 1.0
    assert torch.equal(selections[0], want)
    for got, ref_out in zip(port[:2], ref):
        if ln_mode == "none":
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref_out))
        else:
            _close(got, ref_out)


def _forced_pair(regime, share, pre_ln=False):
    kwargs = dict(GLOBAL, gate_before_ln=True) if pre_ln else GLOBAL
    jax_blk, blk, params = block_pair("EventfulTokenwiseBlock", kwargs, regime)
    for b in (jax_blk, blk):
        b.in_kernel_topk = True
        b.share_gate_passes = share
    return jax_blk, blk, params


@pytest.mark.parametrize("pre_ln", [False, True], ids=["post_ln", "pre_ln"])
@pytest.mark.parametrize("share", ["auto", False], ids=["share", "no_share"])
@pytest.mark.parametrize("regime", ["v2mlp", "v2"])
def test_block_in_kernel_topk_matches_jax(regime, share, pre_ln, selections):
    """The groups that select their own rows per step: "v2mlp" the MLP
    group; "v2" the qkv and projection groups, and the MLP group unless the
    projection group hands it its norms (sharing on, gates after LN). With
    the gates before LN the forms are "pre" and nothing is handed over."""
    jax_blk, blk, params = _forced_pair(regime, share, pre_ln)
    n = blk.input_size[0] * blk.input_size[1]
    assert jax_blk._fused_mode(n) == blk._fused_mode(n) == regime
    _run_and_compare(jax_blk, blk, params)
    per_step = {"v2mlp": 1, "v2": 3 if share is False or pre_ln else 2}[regime]
    assert len(selections) == 3 * per_step
    assert all((cov.sum(-1) == K).all() for cov in selections)


def test_in_kernel_topk_rule():
    """The JAX rule: False off; True wherever the policy allows (an order-2
    TokenNormTopK, not a subclass); any other value on the card at N <=
    TOPK_MAX_TOKENS only, so never for CPU tensors."""
    blk = blocks.EventfulTokenwiseBlock(**GLOBAL)
    x = torch.zeros(2, 24, 64)
    assert blk.in_kernel_topk is False and blk.share_gate_passes == "auto"
    assert not blk._use_in_kernel_topk(TokenNormTopK(k=K), x)
    blk.in_kernel_topk = True
    assert blk._use_in_kernel_topk(TokenNormTopK(k=K), x)
    assert not blk._use_in_kernel_topk(TokenNormTopK(k=K, order=1), x)
    assert not blk._use_in_kernel_topk(TokenNormTopFraction(0.5), x)
    blk.in_kernel_topk = "auto"
    assert not blk._use_in_kernel_topk(TokenNormTopK(k=K), x)


def test_no_sharing_hands_no_norms_across_blocks():
    """JAX core/backbones.py:200: no cross-block norms where either block
    has share_gate_passes False."""
    a, b = (blocks.EventfulTokenwiseBlock(**GLOBAL) for _ in range(2))
    for blk in (a, b):
        blk.fused_gates = "v2"
        for gate in blk.gates:
            gate.policy = TokenNormTopK(k=K)
    state = b.init_state(2, 24, torch.float32, "cpu")
    x = torch.zeros(2, 24, 64)
    assert _next_gate(a, b, x, state) is not None
    for blk in (a, b):
        blk.share_gate_passes = False
        assert _next_gate(a, b, x, state) is None
        blk.share_gate_passes = "auto"


def test_vivit_v2mlp_in_kernel_topk_matches_jax(monkeypatch, selections):
    """A small ViViT of EventfulTokenwiseBlocks (N = 17, k = 8) forced to
    "v2mlp" with in_kernel_topk on both sides through apply_views: the MLP
    group of every spatial block and incremental step selects its own
    rows."""
    monkeypatch.setenv("EVT_UNROLL_BLOCKS", "1")
    jax_model = JaxViViT(**vivit_config(True))
    jax_model.split_flush = True
    for blk in jax_model.modules_of_type(JaxBlock):
        blk.fused_dense_mlp = blk.fused_global_attention = True
    for blk in jax_model.modules_of_type(JaxEventfulBlock):
        blk.fused_gates, blk.in_kernel_topk = "v2mlp", True
    model = FactorizedViViT(**vivit_config(True), device="cpu")
    for blk in model.spatial_model.backbone.blocks:
        blk.fused_gates, blk.in_kernel_topk = "v2mlp", True
    jax_set_policies(jax_model, JaxTopK, k=8)
    set_policies(model, TokenNormTopK, k=8)
    like = jax_model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    flat = {
        k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
        for k, v in flatten_tree(jax.tree_util.tree_map(np.asarray, like)).items()
    }
    params_from_jax(model, flat)
    views = rng.standard_normal((2, 2, 8, 3, 32, 32)).astype(np.float32)
    jax_ctx, ctx = JaxCtx(count_mode=True), Ctx(count_mode=True)
    ref = jax_model.apply_views(jax_ctx, fill_like(like, flat), jnp.asarray(views))
    with torch.no_grad():
        got = model.apply_views(ctx, torch.from_numpy(views))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    ref_counts = Counts.from_device(jax_ctx.counts)
    assert set(ctx.counts) == set(ref_counts)
    for key in ref_counts:
        np.testing.assert_allclose(ctx.counts[key], ref_counts[key], rtol=1e-6, err_msg=key)
    # 2 spatial blocks x 3 incremental steps (4 tubelet steps)
    assert len(selections) == 2 * 3
