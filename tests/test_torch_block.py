"""One EventfulTokenwiseBlock over a flush and three incremental steps, and
one dense Block, in the port against the JAX package on the same weights
and inputs. The JAX block runs its "v4" kernel pipeline, its global
attention kernel and (dense block) its dense-MLP kernel, as on the TPU, with
the Pallas kernels in interpret mode; the port runs the kernels' plain
versions. The dense block is also held against the JAX package's XLA path.

Outputs and every state leaf at rtol/atol 2e-5 (float32 on both sides,
summation order differs); every count key at rtol 1e-6 (the JAX counts are
float32 pairs, the port's Python floats).
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
from eventful_transformer_tpu.utils.params import fill_like
from eventful_transformer_tpu_torch.core import blocks
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
from eventful_transformer_tpu_torch.utils.params import flatten_tree, params_from_jax

B, N, C, HEADS, K = 2, 24, 64, 4, 9
KWARGS = dict(dim=C, heads=HEADS, mlp_ratio=2, input_size=(4, 6))
TOL = 2e-5


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _params(jax_block, seed):
    """The JAX block's params with every leaf perturbed, so that LN scales,
    biases and linear biases are not the identities they start as."""
    flat = flatten_tree(jax.tree_util.tree_map(np.asarray, jax_block.init(jax.random.PRNGKey(0))))
    rng = np.random.default_rng(seed)
    flat = {
        k: (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in flat.items()
    }
    return fill_like(jax_block.init(jax.random.PRNGKey(0)), flat), flat


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=tol, atol=tol)


def _close_counts(port_counts, jax_ctx):
    ref = Counts.from_device(jax_ctx.counts)
    assert set(port_counts) == set(ref)
    for key in ref:
        np.testing.assert_allclose(port_counts[key], ref[key], rtol=1e-6, err_msg=key)


def test_eventful_block_matches_jax_over_flush_and_steps():
    jax_blk = jax_blocks.EventfulTokenwiseBlock(**KWARGS)
    jax_blk.fused_gates = "v4"
    jax_blk.fused_global_attention = True
    for gate in jax_blk.gates:
        gate.policy = copy.deepcopy(JaxTopK(k=K))
    assert jax_blk._fused_mode(N) == "v4"
    blk = blocks.EventfulTokenwiseBlock(**KWARGS)
    for gate in blk.gates:
        gate.policy = TokenNormTopK(k=K)
    jax_params, flat = _params(jax_blk, seed=1)
    params_from_jax(blk, flat)

    rng = np.random.default_rng(2)
    base = rng.standard_normal((B, N, C)).astype(np.float32)
    xs = [base + 0.3 * rng.standard_normal((B, N, C)).astype(np.float32) for _ in range(4)]
    jax_ctx, ctx = JaxCtx(count_mode=True), Ctx(count_mode=True)
    jax_state = jax_blk.init_state(B, N)
    state = blk.init_state(B, N, torch.float32, "cpu")
    with torch.no_grad():
        for t, x in enumerate(xs):
            mode = "flush" if t == 0 else "incremental"
            y_ref, jax_state = jax_blk.apply(jax_ctx, jax_params, jax_state, jnp.asarray(x), mode=mode)
            y, state, next_norms = blk(ctx, state, torch.from_numpy(x), mode=mode)
            assert next_norms is None
            _close(y, y_ref)
    jax_state.pop("first")
    assert set(state) == set(jax_state)
    for group, leaves in jax_state.items():
        assert set(state[group]) == set(leaves)
        for name, ref in leaves.items():
            _close(state[group][name], ref)
    _close_counts(ctx.counts, jax_ctx)


@pytest.mark.parametrize("jax_kernels", [True, False], ids=["pallas", "xla"])
def test_dense_block_matches_jax(jax_kernels):
    jax_blk = jax_blocks.Block(**KWARGS)
    jax_blk.fused_dense_mlp = jax_blk.fused_global_attention = jax_kernels
    blk = blocks.Block(**KWARGS)
    jax_params, flat = _params(jax_blk, seed=3)
    params_from_jax(blk, flat)
    x = np.random.default_rng(4).standard_normal((B, N, C)).astype(np.float32)
    jax_ctx, ctx = JaxCtx(count_mode=True), Ctx(count_mode=True)
    y_ref, _ = jax_blk.apply(jax_ctx, jax_params, {}, jnp.asarray(x))
    with torch.no_grad():
        y, state, _ = blk(ctx, {}, torch.from_numpy(x))
    assert state == {}
    _close(y, y_ref)
    _close_counts(ctx.counts, jax_ctx)


# each option's refusal: sequence parallelism is ported for the dense Block
# (tests/test_torch_parallel.py) and refused for the eventful blocks, whose
# top-k gates would select per shard; drop-path is ported
# (tests/test_torch_train.py), and a rate outside [0, 1] is refused
UNSUPPORTED = {
    "drop_path": (lambda: blocks.EventfulTokenwiseBlock(**KWARGS, drop_path_rate=1.5),
                  ValueError, "drop_path_rate"),
    "sequence_parallel": (lambda: blocks.EventfulTokenwiseBlock(**KWARGS, sequence_parallel="sp"),
                          ValueError, "dense Block"),
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unsupported_block_options_raise(case):
    build, error, match = UNSUPPORTED[case]
    with pytest.raises(error, match=match):
        build()


class _ThresholdPolicy:
    """A policy class the kernel paths do not know (the port's own
    TokenNormThreshold is held in tests/test_torch_threshold.py)."""

    order = 2

    def capacity(self, n_tokens):
        return n_tokens


def test_unsupported_policy_raises():
    blk = blocks.EventfulTokenwiseBlock(**KWARGS)
    for gate in blk.gates:
        gate.policy = _ThresholdPolicy()
    state = blk.init_state(B, N, torch.float32, "cpu")
    x = torch.zeros(B, N, C)
    with torch.no_grad():
        _, state, _ = blk(Ctx(), state, x, mode="flush")
        with pytest.raises(NotImplementedError, match="TokenNormThreshold"):
            blk(Ctx(), state, x, mode="incremental")
