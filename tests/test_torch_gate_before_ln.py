"""Eventful blocks with their gates before the LayerNorm (``gate_before_ln``)
and with STGT gates (``stgt``), over a flush and three incremental steps,
in the port against the JAX package on the same weights and inputs.

``gate_before_ln`` runs in every regime the JAX package gives it, forced on
both sides (``fused_gates``): "v2mlp", "v1", "v1v2", "v3", "v2" and
"blocked" on a global block, "v2" and "blocked" on a windowed block with a
padded window grid (the window-major qkv buffer), and False. STGT gates run
unfused in every mode in both packages (the JAX package's ``_fused_mode``
returns False for them, and ``recompute_buffers`` is False on both sides):
each forced mode and "auto" is checked to fall to the unfused path. The
JAX Pallas kernels run in interpret mode at "highest" matmul precision
(tests/conftest.py); the port runs the kernels' plain versions.

Outputs and every state leaf at 2e-5 (float32 on both sides, sums in other
orders); every count key at rtol 1e-6.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.core import blocks as jax_blocks
from eventful_transformer_tpu.core import gating as jax_gating
from eventful_transformer_tpu.core.counting import Counts, Ctx as JaxCtx
from eventful_transformer_tpu.core.policies import TokenNormTopK as JaxTopK
from eventful_transformer_tpu.utils.params import fill_like
from eventful_transformer_tpu_torch.core import blocks, gating
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
from eventful_transformer_tpu_torch.utils.params import flatten_tree, params_from_jax

TOL = 2e-5
GLOBAL = dict(dim=64, heads=4, mlp_ratio=2, input_size=(4, 6))
WINDOWED = dict(dim=32, heads=4, mlp_ratio=2, input_size=(4, 5), window_size=[2, 3],
                relative_embedding_size=[8, 8])
K = 9


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _pair(cls_name, kwargs, regime, seed=1):
    """The JAX block and the port's, ``regime`` forced on both, policies
    TokenNormTopK(k=K), perturbed weights shared, the JAX kernels of the
    dense attention and MLP on."""
    jax_blk = getattr(jax_blocks, cls_name)(**kwargs)
    blk = getattr(blocks, cls_name)(**kwargs)
    jax_blk.fused_gates = blk.fused_gates = regime
    jax_blk.fused_window_attention = jax_blk.fused_dense_mlp = True
    for gate in jax_blk.modules_of_type(jax_gating.TokenGate):
        gate.policy = copy.deepcopy(JaxTopK(k=K))
    for gate in blk.gates:
        gate.policy = TokenNormTopK(k=K)
    like = jax_blk.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    flat = {
        k: (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        for k, v in flatten_tree(jax.tree_util.tree_map(np.asarray, like)).items()
    }
    params_from_jax(blk, flat)
    return jax_blk, blk, fill_like(like, flat)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(
        port.detach().float().numpy(), np.asarray(ref, dtype=np.float32), rtol=tol, atol=tol
    )


def _run_and_compare(jax_blk, blk, params, seed=2):
    """A flush and 3 incremental steps on both sides: outputs each step,
    then every state leaf (same dtype) and every count key."""
    n = blk.input_size[0] * blk.input_size[1]
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
            y, state, next_norms = blk(ctx, state, torch.from_numpy(x), mode=mode)
            assert next_norms is None
            _close(y, y_ref)
    jax_state.pop("first")
    assert set(state) == set(jax_state)
    for group, leaves in jax_state.items():
        assert set(state[group]) == set(leaves), group
        for name, ref in leaves.items():
            assert state[group][name].dtype == getattr(torch, str(ref.dtype)), (group, name)
            _close(state[group][name], ref)
    ref_counts = Counts.from_device(jax_ctx.counts)
    assert set(ctx.counts) == set(ref_counts)
    for key in ref_counts:
        np.testing.assert_allclose(ctx.counts[key], ref_counts[key], rtol=1e-6, err_msg=key)


PRE_LN_CASES = {
    **{f"global_{r}": (GLOBAL, r) for r in ("v2mlp", "v1", "v1v2", "v3", "v2", "blocked", False)},
    "windowed_v2": (WINDOWED, "v2"),
    "windowed_blocked": (WINDOWED, "blocked"),
}


@pytest.mark.parametrize("case", sorted(PRE_LN_CASES))
def test_gate_before_ln_block_matches_jax(case):
    kwargs, regime = PRE_LN_CASES[case]
    jax_blk, blk, params = _pair(
        "EventfulTokenwiseBlock", dict(kwargs, gate_before_ln=True), regime
    )
    n = blk.input_size[0] * blk.input_size[1]
    assert jax_blk._fused_mode(n) == blk._fused_mode(n) == regime
    if "window_size" in kwargs:
        assert jax_blk._resident_qkv(n) and blk._resident_qkv(n)
    _run_and_compare(jax_blk, blk, params)


def test_gate_before_ln_takes_no_v4_and_hands_no_norms():
    """"v4" falls to "v2mlp" before the LN, as in the JAX package; the
    backbone hands no norms to or from such a block."""
    from eventful_transformer_tpu_torch.core.backbones import _next_gate

    pre = blocks.EventfulTokenwiseBlock(**GLOBAL, gate_before_ln=True)
    post = blocks.EventfulTokenwiseBlock(**GLOBAL)
    for blk in (pre, post):
        blk.fused_gates = "v2"
        for gate in blk.gates:
            gate.policy = TokenNormTopK(k=K)
    state = post.init_state(2, 24, torch.float32, "cpu")
    x = torch.zeros(2, 24, 64)
    assert _next_gate(post, post, x, state) is not None
    assert _next_gate(pre, post, x, state) is None
    assert _next_gate(post, pre, x, pre.init_state(2, 24, torch.float32, "cpu")) is None
    pre.fused_gates = "v4"
    assert pre._fused_mode(24) == "v2mlp" and not pre._v4_eligible()


STGT_MODES = ["auto", "v4", "v2mlp", "v2", "blocked", "v1", "v1v2", "v3", False]


@pytest.mark.parametrize("mode", STGT_MODES, ids=[str(m) for m in STGT_MODES])
def test_stgt_block_is_unfused_and_matches_jax(mode):
    """A global STGT block in every mode: both packages run the unfused path
    with qkv and projection buffers (``recompute_buffers`` False)."""
    jax_blk, blk, params = _pair("EventfulTokenwiseBlock", dict(GLOBAL, stgt=True), mode)
    if mode == "auto":
        jax_blk.fused_gates = False  # the JAX "auto" is the TPU's; STGT is unfused there too
    assert not jax_blk.recompute_buffers and not blk.recompute_buffers
    assert jax_blk._fused_mode(24) is False and blk._fused_mode(24) is False
    assert all(type(g) is gating.SimpleSTGTGate for g in blk.gates)
    _run_and_compare(jax_blk, blk, params)


@pytest.mark.parametrize(
    "cls_name,kwargs",
    [("EventfulTokenwiseBlock", dict(WINDOWED, stgt=True)),
     ("EventfulTokenwiseBlock", dict(GLOBAL, stgt=True, gate_before_ln=True)),
     ("EventfulBlock", dict(dim=32, heads=4, mlp_ratio=2, input_size=(6, 6), pool_size=2,
                            relative_embedding_size=[8, 8], stgt=True))],
    ids=["windowed", "gate_before_ln", "eventful_block_pooled"],
)
def test_stgt_blocks_match_jax(cls_name, kwargs):
    """A windowed STGT block (its qkv buffer row-major: the unfused path
    keeps no window-major buffer), STGT gates before the LN, and an
    EventfulBlock with k/v pooling whose attention takes the STGT qkv
    gate's index."""
    jax_blk, blk, params = _pair(cls_name, kwargs, False)
    n = blk.input_size[0] * blk.input_size[1]
    assert not blk._resident_qkv(n)
    _run_and_compare(jax_blk, blk, params)


def test_stgt_gate_state_is_the_whole_input():
    """SimpleSTGTGate selects on the error against the previous input and
    keeps the whole current one (JAX core/gating.py:152-166)."""
    gate = gating.SimpleSTGTGate()
    gate.policy = TokenNormTopK(k=2)
    p = torch.zeros(1, 4, 3)
    c = torch.tensor([[[0.0] * 3, [3.0] * 3, [1.0] * 3, [2.0] * 3]])
    ctx = Ctx(count_mode=True)
    rows, index, mask, state = gate.incremental(ctx, {"p": p}, c)
    assert index.tolist() == [[1, 3]] and mask is None
    assert torch.equal(rows, c[:, [1, 3]]) and state["p"] is c
    assert ctx.counts["gate_flops"] == 12
    with pytest.raises(ValueError, match="rows only"):
        gating.SimpleSTGTGate(structure="col")
