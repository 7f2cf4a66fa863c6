"""The port's pipeline parallelism (``parallel/pipeline.py``) on the CPU:
gloo ranks spawned through ``parallel.mesh.spawn``, one a stage, against the
JAX package's ``make_pipelined_backbone`` on as many of the 8 virtual CPU
devices (tests/conftest.py), on JAX ``TestPipeline``'s stacks
(tests/test_pipeline.py: 4 blocks, B = 2, N = 24, C = 32, T = 5 frames),
dense and eventful (``EventfulTokenwiseBlock``, top-k 8, frames that drift),
at P = 2 and 4:

- the outputs and every block's state leaf against the JAX pipeline's, at
  JAX's tolerances (dense rtol = atol = 1e-5; eventful rtol 1e-4, atol
  1e-5);
- the outputs and every state leaf equal, bit for bit, to the port's own
  block loop in one process (``ViTBackbone.run_blocks`` over the stack,
  the qkv-gate norms handed from block to block), and the same on every
  rank;
- the refusals: a depth P does not divide, and stacks that are not
  homogeneous (a windowed block among global ones; ATS).

The rank functions live in tests/torch_parallel_ranks.py; one spawn of each
world size serves every check of it."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_parallel_ranks
from eventful_transformer_tpu.utils.params import _flatten
from eventful_transformer_tpu_torch.core.backbones import ViTBackbone
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.parallel.mesh import spawn

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from tests.test_pipeline import B, C, DEPTH, N, T, _build, _run_pipeline  # noqa: E402

KINDS = ("Block", "EventfulTokenwiseBlock")
K = 8  # JAX TestPipeline's top-k
TOL = {"Block": dict(rtol=1e-5, atol=1e-5), "EventfulTokenwiseBlock": dict(rtol=1e-4, atol=1e-5)}


def _config(block_class, **extra):
    return dict(block_config=dict(dim=C, heads=4, mlp_ratio=2, **extra.pop("block", {})),
                depth=DEPTH, position_encoding_size=[4, 6], input_size=(4, 6),
                block_class=block_class, **extra)


def _frames(block_class):
    rng = np.random.default_rng(0)
    if block_class == "Block":
        return rng.standard_normal((T, B, N, C)).astype(np.float32)
    base = rng.standard_normal((B, N, C)).astype(np.float32)
    return np.stack([base + 0.1 * t * rng.standard_normal((B, N, C)).astype(np.float32)
                     for t in range(T)])


@pytest.fixture(scope="module")
def jax_stacks():
    out = {}
    for kind in KINDS:
        backbone, params = _build(kind)
        out[kind] = (backbone, params, {k: np.array(v) for k, v in _flatten(params).items()})
    return out


def _jobs(jax_stacks):
    return [("pipeline", _config(kind), jax_stacks[kind][2], K if kind != "Block" else None,
             _frames(kind)) for kind in KINDS]


REFUSED = [
    dict(_config("Block"), depth=3),
    _config("Block", window_indices=[0], windowed_overrides=dict(window_size=[2, 3])),
    _config("Block", block=dict(ats_fraction=0.5)),
]


@pytest.fixture(scope="module")
def worlds(jax_stacks, tmp_path_factory):
    """One spawn of 2 ranks (the two stacks, the refusals) and one of 4
    (the two stacks)."""
    out = {}
    for world in (2, 4):
        jobs = _jobs(jax_stacks) + ([("pipeline_refused", REFUSED)] if world == 2 else [])
        store = tmp_path_factory.mktemp(f"store_pipe_{world}")
        out[world] = spawn(torch_parallel_ranks.run_jobs, world, args=(jobs, str(store)),
                           threads=1)
    return out


def _port_loop(kind, flat):
    """The port's block loop in this process: ``run_blocks`` over the whole
    stack, frame 0 a flush."""
    backbone = torch_parallel_ranks._backbone(_config(kind), flat, K if kind != "Block" else None)
    frames = torch.from_numpy(_frames(kind))
    states = backbone.init_state(B, torch.float32, "cpu")["blocks"]
    aux = backbone.precompute()["blocks"]
    outs = []
    with torch.no_grad():
        for t in range(T):
            mode = "flush" if t == 0 else "incremental"
            x, states = backbone.run_blocks(Ctx(), states, frames[t], mode, aux)
            outs.append(x)
    return torch.stack(outs).numpy(), [torch_parallel_ranks._state_numpy(s) for s in states]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return {p: v for key in sorted(tree) for p, v in _leaves(tree[key], path + (key,)).items()}
    return {path: tree}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_pipeline_matches_jax_and_the_block_loop(kind, world, worlds, jax_stacks):
    ranks = [rank[KINDS.index(kind)] for rank in worlds[world]]
    got, got_state = ranks[0]
    for out, state in ranks[1:]:
        np.testing.assert_array_equal(out, got)
        for i, block in enumerate(state["blocks"]):
            for path, leaf in _leaves(block).items():
                np.testing.assert_array_equal(leaf, _leaves(got_state["blocks"][i])[path])
    assert got.shape == (T, B, N, C)
    # the port's block loop, bit for bit
    want, want_state = _port_loop(kind, jax_stacks[kind][2])
    np.testing.assert_array_equal(got, want)
    for i, block in enumerate(want_state):
        leaves = _leaves(got_state["blocks"][i])
        assert leaves.keys() == _leaves(block).keys()
        for path, leaf in _leaves(block).items():
            np.testing.assert_array_equal(leaves[path], leaf, err_msg=f"block {i} {path}")
    # the JAX pipeline on as many virtual devices
    backbone, params, _ = jax_stacks[kind]
    jax_out, jax_state = _run_pipeline(backbone, params, jax.numpy.asarray(_frames(kind)), world)
    np.testing.assert_allclose(got, np.asarray(jax_out), **TOL[kind])
    for i, block in enumerate(jax_state["blocks"]):
        jax_leaves = _leaves(jax.tree_util.tree_map(np.asarray, block))
        leaves = _leaves(got_state["blocks"][i])
        assert set(leaves) <= set(jax_leaves)
        for path, leaf in leaves.items():
            np.testing.assert_allclose(leaf, jax_leaves[path], **TOL[kind],
                                       err_msg=f"block {i} {path}")


def test_pipeline_refusals(worlds):
    """At P = 2: a depth of 3 blocks, a windowed block among global ones,
    ATS."""
    for messages in (rank[2] for rank in worlds[2]):
        depth, windowed, ats = messages
        assert "3 blocks do not divide into 2 stages" in depth
        assert "not homogeneous" in windowed and "not homogeneous" in ats


def test_homogeneous():
    assert ViTBackbone(**_config("EventfulTokenwiseBlock")).homogeneous
    for config in REFUSED[1:]:
        assert not ViTBackbone(**config).homogeneous
