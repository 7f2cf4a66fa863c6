"""The "blocked" regime of the port (ViTDet-1024's) against the JAX package
on the same weights and inputs: the plain versions of
``block_select_scatter``, ``softmax_select_matmul`` and the padded form of
``window_attention`` against the JAX Pallas kernels in interpret mode, a
windowed padded ``EventfulTokenwiseBlock`` and a pooled rel-pos
``EventfulBlock`` forced to "blocked" on both sides with the A.V kernel on,
and a slim ViTDet backbone at N = 4096, where the port's "auto" dispatch
picks "blocked", against the JAX package's unfused CPU path (whose outputs
and counts ``tests/test_pallas.py`` holds equal to its blocked path's).

Tolerances, as in tests/test_torch_vitdet.py: TOL = 2e-5 for kernels and
blocks (float32 on both sides, sums in other orders), TOL_MODEL = 1e-4 for
the backbone over several frames, TOL_CAST = 1e-2 where the A.V state is
bfloat16 (one bfloat16 ulp is 4e-3 relative, and the two frameworks may
round a different element); counts equal at rtol 1e-6.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.core import blocks as jax_blocks
from eventful_transformer_tpu.core.counting import Counts, Ctx as JaxCtx
from eventful_transformer_tpu.core.policies import TokenNormTopK as JaxTopK
from eventful_transformer_tpu.models.vitdet import ViTDet as JaxViTDet
from eventful_transformer_tpu.ops.pallas import av_softmax as jax_av_softmax
from eventful_transformer_tpu.ops.pallas import gate_block as jax_gate_block
from eventful_transformer_tpu.ops.pallas import window_attention as jax_window_attention
from eventful_transformer_tpu.utils.misc import set_policies as jax_set_policies
from eventful_transformer_tpu.utils.params import fill_like
from eventful_transformer_tpu_torch.core import blocks
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
from eventful_transformer_tpu_torch.models import ViTDet
from eventful_transformer_tpu_torch.ops.av_softmax import softmax_select_matmul_plain
from eventful_transformer_tpu_torch.ops.gate_block import block_select_scatter_plain
from eventful_transformer_tpu_torch.ops.window_attention import (
    window_attention_plain,
    window_bias_pad_terms,
)
from eventful_transformer_tpu_torch.utils.misc import set_policies
from eventful_transformer_tpu_torch.utils.params import flatten_tree, params_from_jax

TOL, TOL_MODEL, TOL_CAST = 2e-5, 1e-4, 1e-2


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(
        port.detach().float().numpy(), np.asarray(ref, dtype=np.float32), rtol=tol, atol=tol
    )


def _close_counts(port_counts, jax_ctx):
    ref = Counts.from_device(jax_ctx.counts)
    assert set(port_counts) == set(ref)
    for key in ref:
        np.testing.assert_allclose(port_counts[key], ref[key], rtol=1e-6, err_msg=key)


def _perturbed(like, seed, scale=0.1):
    flat = flatten_tree(jax.tree_util.tree_map(np.asarray, like))
    rng = np.random.default_rng(seed)
    flat = {k: (v + scale * rng.standard_normal(v.shape)).astype(np.float32) for k, v in flat.items()}
    return flat, fill_like(like, flat)


# -- the kernels' plain versions ----------------------------------------------------


def _select_scatter_against_jax(form, invalid, b, n, c, k, f=None, unnamed=0, seed=20):
    """block_select_scatter_plain against the JAX kernel in interpret mode
    in ``form`` ("qkv": F = 3C by default, LN, no y; "proj": no LN, the skip
    and the next norms; "mlp": LN, x as the residual, the next norms), the
    k selected rows in no order, every 7th slot invalid, marked -1 (the
    port's convention) or N (the JAX package's), and ``unnamed`` more
    selected rows of each batch row that no valid slot names (b' = 0)."""
    f = f or (3 * c if form == "qkv" else c)
    rng = np.random.default_rng(seed)
    r = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    x, p, buf, h = r(b, n, c), r(b, n, c), r(b, n, f), r(b, k, f)
    skip, p_next = r(b, n, f), r(b, n, f)
    scale, bias, ns, nb = 1 + r(c, scale=0.1), r(c, scale=0.1), 1 + r(f, scale=0.1), r(f, scale=0.1)
    order = np.stack([rng.permutation(n) for _ in range(b)])
    index = order[:, :k].astype(np.int32)
    assert not np.all(np.diff(index[0]) > 0)  # not sorted
    valid = np.ones((b, k), bool)
    valid[:, ::7] = False
    cov = np.zeros((b, n), np.float32)
    for i in range(b):
        cov[i, index[i][valid[i]]] = 1.0
        cov[i, order[i, k:k + unnamed]] = 1.0
    jax_index = np.where(valid, index, n)
    port_index = np.where(valid, index, -1 if invalid == "minus_one" else n).astype(np.int32)
    apply_ln = form != "proj"
    kw = dict(skip=skip if form == "proj" else None, residual_x=form == "mlp")
    nxt = (p_next, ns, nb) if form != "qkv" else (None, None, None)
    if apply_ln:
        jax_scale, jax_bias = scale, bias
    else:
        jax_scale, jax_bias = np.ones(c, np.float32), np.zeros(c, np.float32)
    ref = jax_gate_block.block_select_scatter(
        *(jnp.asarray(a) for a in (x, p, buf, cov, jax_index, h, jax_scale, jax_bias)),
        None if kw["skip"] is None else jnp.asarray(skip),
        *(None if a is None else jnp.asarray(a) for a in nxt),
        apply_ln=apply_ln, residual_x=kw["residual_x"], interpret=True,
    )
    p_t, b_t = _t(p), _t(buf)
    port = block_select_scatter_plain(
        _t(x), p_t, b_t, _t(cov), _t(port_index), _t(h), _t(scale) if apply_ln else None,
        _t(bias) if apply_ln else None, None if kw["skip"] is None else _t(skip),
        *(None if a is None else _t(a) for a in nxt), apply_ln=apply_ln,
        residual_x=kw["residual_x"],
    )
    assert port[0] is p_t and port[1] is b_t  # the state is updated in place
    assert len(port) == len(ref) == (2 if form == "qkv" else 4)
    for got, want in zip(port, ref):
        _close(got, want)
    for i in range(b):
        rows = order[i, k:k + unnamed]
        assert not port[1][i, rows].any() and not np.asarray(ref[1])[i, rows].any()


@pytest.mark.parametrize("invalid", ["minus_one", "n"])
@pytest.mark.parametrize("form", ["qkv", "proj", "mlp"])
def test_block_select_scatter_matches_jax(form, invalid):
    """The three forms the path runs, at N = 600 (two of the JAX kernel's
    512-row blocks), with the selected rows in no order and invalid slots,
    marked -1 (the port's convention) or N (the JAX package's)."""
    _select_scatter_against_jax(form, invalid, 2, 600, 64, 40)


@pytest.mark.parametrize("form", ["qkv", "proj", "mlp"])
@pytest.mark.parametrize("case", ["unnamed_row", "kp_not_32", "f_3c_768"])
def test_block_select_scatter_cases_match_jax(case, form):
    """The cases the kernel's warp-per-row body treats apart: selected rows
    that no valid slot names (b' = 0, as the JAX kernel's one-hot leaves
    them), kp = 33 (no multiple of the 32 slots a warp reads a step, over
    N = 77 rows, no multiple of the 8 rows of a block), and C = 768 (F =
    2304 for the qkv form: 9 vectors a lane in bfloat16)."""
    if case == "unnamed_row":
        _select_scatter_against_jax(form, "minus_one", 2, 96, 64, 40, unnamed=3)
    elif case == "kp_not_32":
        _select_scatter_against_jax(form, "n", 2, 77, 64, 33, unnamed=1)
    else:
        _select_scatter_against_jax(form, "minus_one", 2, 40, 768, 16, unnamed=1)


@pytest.mark.parametrize(
    "case", ["f32_terms", "f32_no_terms", "bf16_state_terms"],
)
def test_softmax_select_matmul_matches_jax(case):
    """The fused matmul-1 form at an awkward N (37) and key grid (3 x 7),
    with and without rel-pos terms; float32, and bfloat16 p_a / p_v with
    float32 q and k (the matmul-2 cast)."""
    b, h, n, d, grid = 2, 3, 37, 16, (3, 7)
    np_ = grid[0] * grid[1]
    rng = np.random.default_rng(21)
    r = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    q, k, terms = r(b, h, n, d), r(b, h, np_, d), r(b, h, n, sum(grid), scale=0.3)
    p_a = rng.uniform(0, 2 / np_, (b, h, n, np_)).astype(np.float32)
    p_v = r(b, h, np_, d)
    cov = (rng.uniform(size=(b, np_)) < 0.3).astype(np.float32)
    inv_scale = d**-0.5
    with_terms = case != "f32_no_terms"
    sdtype, tol = (jnp.float32, TOL) if case.startswith("f32") else (jnp.bfloat16, TOL_CAST)
    ref = jax_av_softmax.softmax_select_matmul(
        None, jnp.asarray(p_a, sdtype), jnp.asarray(cov), jnp.asarray(p_v, sdtype),
        q=jnp.asarray(q), k=jnp.asarray(k), terms=jnp.asarray(terms) if with_terms else None,
        p=grid if with_terms else None, inv_scale=inv_scale, interpret=True,
    )
    tdtype = torch.float32 if sdtype == jnp.float32 else torch.bfloat16
    p_a_t = _t(p_a).to(tdtype)
    port = softmax_select_matmul_plain(
        p_a_t, _t(cov), _t(p_v).to(tdtype), _t(q), _t(k), _t(terms) if with_terms else None,
        inv_scale=inv_scale, p=grid,
    )
    assert port[0] is p_a_t and port[1].dtype == tdtype
    for got, want in zip(port, ref):
        _close(got, np.asarray(want.astype(jnp.float32)), tol)


@pytest.mark.parametrize("relpos", [True, False], ids=["relpos", "no_relpos"])
def test_window_attention_padded_matches_jax(relpos):
    """The padded form over the windows of a zero-padded 5 x 7 map with
    2 x 3 windows: the bias row and the pad terms substituted at pad rows."""
    b, (h, w), a, c, heads = 2, (5, 7), (2, 3), 32, 4
    hd = c // heads
    rng = np.random.default_rng(22)
    nh, nw = -(-h // a[0]), -(-w // a[1])
    x = rng.standard_normal((b, h, w, 3 * c)).astype(np.float32)
    grid = np.zeros((b, nh * a[0], nw * a[1], 3 * c), np.float32)
    grid[:, :h, :w] = x
    qkv = grid.reshape(b, nh, a[0], nw, a[1], 3 * c).transpose(0, 1, 3, 2, 4, 5)
    qkv = np.ascontiguousarray(qkv.reshape(-1, a[0] * a[1], 3 * c))
    pad_bias = rng.standard_normal(3 * c).astype(np.float32)
    y_rel = (0.3 * rng.standard_normal((a[0], a[0], hd))).astype(np.float32)
    x_rel = (0.3 * rng.standard_normal((a[1], a[1], hd))).astype(np.float32)
    geom, scale = (nh, nw, h, w), hd**0.5
    terms = pad_terms = port_terms = port_pad_terms = None
    if relpos:
        terms = jax_window_attention.window_bias_terms(jnp.asarray(qkv), y_rel, x_rel, heads)
        pad_terms = jax_window_attention.window_bias_pad_terms(
            jnp.asarray(pad_bias), y_rel, x_rel, heads, jnp.float32
        )
        tab = torch.cat([_t(y_rel).repeat_interleave(a[1], dim=0), _t(x_rel).repeat(a[0], 1, 1)],
                        dim=1)
        port_pad_terms = window_bias_pad_terms(_t(pad_bias), tab, heads)
        _close(port_pad_terms, pad_terms)
        port_terms = _t(np.asarray(terms))
    ref = jax_window_attention.window_attention(
        jnp.asarray(qkv), terms, jnp.asarray(pad_bias), pad_terms, heads=heads, scale=scale,
        a=a, p=a if relpos else None, geom=geom, interpret=True,
    )
    port = window_attention_plain(
        _t(qkv), port_terms, _t(pad_bias), port_pad_terms, heads=heads, scale=scale,
        p=a if relpos else None, a=a, geom=geom,
    )
    _close(port, ref)


# -- blocks in the forced "blocked" regime ------------------------------------------


def _blocked_pair(cls_name, seed, k, **kwargs):
    jax_blk = getattr(jax_blocks, cls_name)(**kwargs)
    blk = getattr(blocks, cls_name)(**kwargs)
    jax_blk.fused_gates = blk.fused_gates = "blocked"
    for gate in jax_blk.modules_of_type(jax_blocks.TokenGate):
        gate.policy = copy.deepcopy(JaxTopK(k=k))
    set_policies(blk, TokenNormTopK, k=k)
    jax_blk.fused_window_attention = jax_blk.fused_dense_mlp = True
    if cls_name == "EventfulBlock":
        jax_blk.av_kernel = jax_blk.fuse_matmul_1 = True
        blk.av_kernel = blk.fuse_matmul_1 = True
    flat, params = _perturbed(jax_blk.init(jax.random.PRNGKey(0)), seed)
    params_from_jax(blk, flat)
    return jax_blk, blk, params


def _run_blocked(jax_blk, blk, params, n, tol, seed):
    """A flush and 3 incremental steps in both packages: outputs each step,
    then every state leaf and the counts."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((2, n, blk.dim)).astype(np.float32)
    xs = [base + 0.3 * rng.standard_normal(base.shape).astype(np.float32) for _ in range(4)]
    jax_ctx, ctx = JaxCtx(count_mode=True), Ctx(count_mode=True)
    jax_state = jax_blk.init_state(2, n)
    state = blk.init_state(2, n, torch.float32, "cpu")
    aux = jax_blk.precompute(params)
    with torch.no_grad():
        for t, x in enumerate(xs):
            mode = "flush" if t == 0 else "incremental"
            y_ref, jax_state = jax_blk.apply(jax_ctx, params, jax_state, jnp.asarray(x), aux, mode=mode)
            y, state, _ = blk(ctx, state, torch.from_numpy(x), mode=mode)
            _close(y, y_ref, tol)
    jax_state.pop("first", None)
    assert set(state) == set(jax_state)
    for group, leaves in jax_state.items():
        assert set(state[group]) == set(leaves)
        for name, ref in leaves.items():
            _close(state[group][name], np.asarray(ref.astype(jnp.float32)), tol)
    _close_counts(ctx.counts, jax_ctx)


def test_blocked_windowed_padded_block_matches_jax():
    """A windowed EventfulTokenwiseBlock on a 4 x 5 grid with 2 x 3 windows
    (pad rows in the window-major qkv buffer), forced "blocked": the qkv
    group's select/scatter pair and block_select_scatter for the
    projection and MLP groups."""
    kwargs = dict(dim=32, heads=4, mlp_ratio=2, input_size=(4, 5), window_size=[2, 3],
                  relative_embedding_size=[8, 8])
    jax_blk, blk, params = _blocked_pair("EventfulTokenwiseBlock", 30, 7, **kwargs)
    assert blk._fused_mode(20) == "blocked" and blk._resident_qkv(20)
    _run_blocked(jax_blk, blk, params, 20, TOL, 31)


@pytest.mark.parametrize("cast", [None, "bfloat16"], ids=["f32", "cast_bf16"])
def test_blocked_eventful_block_av_kernel_matches_jax(cast):
    """A global EventfulBlock with k/v pool 2 and rel-pos, forced "blocked"
    with the A.V kernel and its fused matmul-1 on both sides."""
    kwargs = dict(dim=32, heads=4, mlp_ratio=2, input_size=(6, 6), pool_size=2,
                  relative_embedding_size=[8, 8], matmul_2_cast=cast)
    jax_blk, blk, params = _blocked_pair("EventfulBlock", 32, 8, **kwargs)
    assert blk._use_av_kernel(Ctx(), 9, 2)
    _run_blocked(jax_blk, blk, params, 36, TOL if cast is None else TOL_CAST, 33)


# -- a slim backbone at N = 4096 --------------------------------------------------------


def _slim_config():
    block = dict(dim=64, heads=2, mlp_ratio=2, window_size=[14, 14],
                 relative_embedding_size=[64, 64], pool_size=2)
    backbone = dict(depth=4, position_encoding_size=[14, 14], window_indices=[0, 2],
                    block_class="EventfulBlock", windowed_class="EventfulTokenwiseBlock",
                    windowed_overrides=dict(pool_size=None), block_config=block)
    return dict(
        backbone_config=backbone, classes=5, input_shape=[3, 1024, 1024],
        normalize_mean=[123.675, 116.28, 103.53], normalize_std=[58.395, 57.12, 57.375],
        output_channels=16, patch_size=[16, 16], scale_factors=[1.0],
    )


def test_slim_backbone_n4096_auto_is_blocked_and_matches_jax(monkeypatch):
    """A slim ViTDet backbone on the 64 x 64 grid of 1024 x 1024 frames
    (14 x 14 windows that pad, blocks 0 and 2 windowed, 1 and 3 global
    EventfulBlocks with pool 2, k = 256), 2 streams over a flush and 2
    incremental frames through ``pre_backbone`` and ``apply_backbone``. The
    port runs "auto": "blocked" everywhere, the A.V kernel in the global
    blocks (1024 pooled keys). The JAX package runs its unfused CPU path
    with buffered groups. Outputs, counts and every state leaf (the
    window-major qkv buffers under the window permutation) are compared."""
    monkeypatch.setenv("EVT_UNROLL_BLOCKS", "1")
    jax_model, model = JaxViTDet(**_slim_config()), ViTDet(**_slim_config(), device="cpu")
    jax_set_policies(jax_model, JaxTopK, k=256)
    set_policies(model, TokenNormTopK, k=256)
    for jax_blk, blk in zip(jax_model.backbone.blocks, model.backbone.blocks):
        jax_blk.fused_gates = False
        jax_blk.recompute_buffers = False
        assert blk._fused_mode(4096) == "blocked"
        if isinstance(blk, blocks.EventfulBlock):
            assert blk._use_av_kernel(Ctx(), blk._pooled_tokens(4096), 2)
    flat, params = _perturbed(jax_model.init(jax.random.PRNGKey(0)), seed=34, scale=0.05)
    params_from_jax(model, flat)
    rng = np.random.default_rng(35)
    base = rng.uniform(size=(2, 3, 1024, 1024)).astype(np.float32)
    frames = [np.clip(base + 0.1 * rng.standard_normal(base.shape), 0, 1).astype(np.float32)
              for _ in range(3)]
    jax_ctx, ctx = JaxCtx(count_mode=True), Ctx(count_mode=True)
    jax_state, state = jax_model.init_state(2), model.init_state(2)
    aux, port_aux = jax_model.precompute(params), model.precompute()
    with torch.no_grad():
        for t, frame in enumerate(frames):
            mode = "flush" if t == 0 else "incremental"
            tokens_ref = jax_model.pre_backbone(jax_ctx, params, jnp.asarray(frame))
            out_ref, jax_state = jax_model.apply_backbone(
                jax_ctx, params, jax_state, tokens_ref, aux, mode=mode
            )
            tokens = model.pre_backbone(ctx, torch.from_numpy(frame))
            out, state = model.apply_backbone(ctx, state, tokens, port_aux, mode=mode)
            assert out.shape == (2, 4096, 64)
            _close(out, out_ref, TOL_MODEL)
    _close_counts(ctx.counts, jax_ctx)
    for blk, jax_s, s in zip(model.backbone.blocks, jax_state["blocks"], state["blocks"]):
        for group, leaves in jax_s.items():
            if group == "first":
                continue
            for name, ref in leaves.items():
                ref = np.asarray(ref)
                got = s[group][name]
                if group == "qkv_accumulator" and blk.window_size is not None:
                    perm, _ = blk._window_perm()
                    valid = perm < 4096
                    got, ref = got[:, torch.from_numpy(np.nonzero(valid)[0])], ref[:, perm[valid]]
                _close(got, ref, TOL_MODEL)
