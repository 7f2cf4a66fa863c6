"""Tensor parallelism of the eventful and ATS ViViT blocks
(``parallel/sharding.py``, ``core/blocks.py``, ``core/gating.py``,
``core/policies.py``) on the CPU: gloo ranks spawned through
``parallel.mesh.spawn`` against the JAX package's sharded forward and
``make_sharded_train_step`` on 4 of the 8 virtual CPU devices
(tests/conftest.py), on the JAX package's TINY ViViT (tests/
test_parallel.py) with its spatial blocks swapped, every bias non-zero.

For each case of CASES (EventfulTokenwiseBlock, EventfulMatmul1Block and
EventfulBlock with TokenNormTopK k = 4, the dense Block with ATS 0.5) and
the TokenNormThreshold case:

- ``apply_views`` at dp x tp = 1 x 4 and 2 x 2 against JAX ``jax.jit(
  apply_views)`` on ``shard_params``, at FORWARD_TOL (rtol 2e-5, atol
  1e-6), and against the port's own unsharded forward, in its default
  regime and on the unfused path the sharded blocks take;
- every selection of the sharded run (each gate's top-k or threshold mask,
  each ATS sampling) equal on every rank to the unsharded unfused run's,
  after the test has asserted that at its seed no selection lies within
  MARGIN of a flip: the group sums the projection gate's norms and the
  ATS scores in another order than one process does, and so does the
  residual stream the later gates read, which moves a norm by about the
  float32 rounding of a sum of C terms (C 2^-24 < 2e-6 relative); a
  selection nearer a tie could flip, and then fails with that message;
- the counts: a group's ``linear_flops`` and ``matmul_flops`` sum to the
  unsharded unfused ones (the classifier's linear, replicated, counted on
  every rank), and ``add_flops`` (the residual adds, replicated) equals
  them on every rank;
- 5 train steps at 2 x 2 against JAX ``make_sharded_train_step`` with SGD
  (momentum 0.9) and ``adamw(3e-3)``, under tests/test_torch_tensor_
  parallel.py's rules (its ``_same_params``: AdamW's float32-noise
  elements within 2 lr a step).

One spawn of 4 ranks serves every check; the rank functions are in
tests/torch_parallel_ranks.py."""

import copy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_ranks
from eventful_transformer_tpu.core.counting import Ctx as JaxCtx
from eventful_transformer_tpu.core.policies import (
    TokenNormThreshold as JaxThreshold,
    TokenNormTopK as JaxTopK,
)
from eventful_transformer_tpu.models import FactorizedViViT as JaxViViT
from eventful_transformer_tpu.parallel.mesh import (
    best_dp_tp_mesh as jax_best_dp_tp_mesh,
    make_mesh as jax_make_mesh,
)
from eventful_transformer_tpu.parallel.sharding import shard_params as jax_shard_params
from eventful_transformer_tpu.parallel.train import make_sharded_train_step as jax_train_step
from eventful_transformer_tpu.utils.misc import set_policies as jax_set_policies
from eventful_transformer_tpu_torch.parallel.mesh import BACKEND_ENV, backend_for, spawn

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from tests.test_parallel import TINY  # noqa: E402
from tests.test_torch_tensor_parallel import (  # noqa: E402
    FORWARD_TOL,
    OPTIMIZERS,
    TRAIN_TOL,
    _flat,
    _same_params,
    _unflatten,
    _with_biases,
)

WORLD = 4
BATCH, STEPS, SEED = 8, 5, 0
K = 4
THRESHOLD = 0.5
# the least relative margin of a selection from a flip (module docstring)
MARGIN = 1e-5
# case: (spatial block class, ats_fraction, policy)
CASES = {
    "tokenwise": ("EventfulTokenwiseBlock", None, ("top_k", K)),
    "matmul1": ("EventfulMatmul1Block", None, ("top_k", K)),
    "eventful": ("EventfulBlock", None, ("top_k", K)),
    "ats": ("Block", 0.5, ("top_k", K)),
}
THRESHOLD_CASE = ("EventfulTokenwiseBlock", None, ("threshold", THRESHOLD))
SHAPES = {4: (1, 4), 2: (2, 2)}  # max_tp: (dp, tp) of 4 ranks


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def case_config(case):
    block_class, ats, _ = case
    config = copy.deepcopy(TINY)
    config["spatial_config"]["block_class"] = block_class
    if ats is not None:
        config["spatial_config"]["block_config"]["ats_fraction"] = ats
    return config


def _jax_policy(model, policy):
    name, value = policy
    if name == "top_k":
        jax_set_policies(model, JaxTopK, k=value)
    else:
        jax_set_policies(model, JaxThreshold, threshold=value)
    return model


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    views = rng.standard_normal((4, 2, 8, 3, 32, 32)).astype(np.float32)
    inputs = rng.standard_normal((BATCH, 2, 8, 3, 32, 32)).astype(np.float32)
    labels = rng.integers(0, 16, (BATCH,)).astype(np.int64)
    flats = {}
    for name, case in {**CASES, "threshold": THRESHOLD_CASE}.items():
        params = JaxViViT(**case_config(case)).init(jax.random.PRNGKey(0))
        flats[name] = _with_biases(_flat(params))
    return dict(flats=flats, views=views, inputs=inputs, labels=labels)


@pytest.fixture(scope="module")
def world(setup, tmp_path_factory):
    """One spawn of 4 ranks: each case's forwards at 1 x 4 and 2 x 2, then
    its 5 steps at 2 x 2 with each optimizer; the threshold case's
    forwards."""
    s = setup
    jobs, where = [], {}
    for name, case in CASES.items():
        config, flat = case_config(case), s["flats"][name]
        for max_tp in SHAPES:
            where[name, max_tp] = len(jobs)
            jobs.append(("tp_eventful_forward", config, flat, s["views"], max_tp, case[2]))
        for optimizer in OPTIMIZERS:
            where[name, optimizer] = len(jobs)
            jobs.append(("tp_train", dict(config, dropout_rate=0.0), flat, s["inputs"],
                         s["labels"], OPTIMIZERS[optimizer][0], STEPS, 2, SEED, case[2]))
    for max_tp in SHAPES:
        where["threshold", max_tp] = len(jobs)
        jobs.append(("tp_eventful_forward", case_config(THRESHOLD_CASE), s["flats"]["threshold"],
                     s["views"], max_tp, THRESHOLD_CASE[2]))
    store = tmp_path_factory.mktemp("store_tp_eventful")
    results = spawn(torch_parallel_ranks.run_jobs, WORLD, args=(jobs, str(store)), threads=1)
    return {key: [rank[i] for rank in results] for key, i in where.items()}


def _jax_sharded_forward(case, flat, views, shape):
    model = _jax_policy(JaxViViT(**case_config(case)), case[2])
    mesh = jax_make_mesh(shape, ("data", "model"), devices=jax.devices()[:WORLD])
    sharded = jax_shard_params(mesh, _unflatten(flat))
    views = jax.device_put(jnp.asarray(views), NamedSharding(mesh, P("data")))
    return np.asarray(jax.jit(lambda p, v: model.apply_views(JaxCtx(), p, v))(sharded, views))


FORWARDS = [(name, max_tp) for name in [*CASES, "threshold"] for max_tp in SHAPES]


def _case(name):
    return THRESHOLD_CASE if name == "threshold" else CASES[name]


def _by_data(ranks, key):
    """The data shards' ``key`` in data order, after checking that every
    rank of a TP group holds the same."""
    by_data = {}
    for r in ranks:
        if r["data"] in by_data:
            np.testing.assert_array_equal(r[key], by_data[r["data"]])
        by_data[r["data"]] = r[key]
    return np.concatenate([by_data[d] for d in sorted(by_data)])


@pytest.mark.parametrize("name, max_tp", FORWARDS)
def test_sharded_forward_matches_jax(name, max_tp, world, setup):
    ranks = world[name, max_tp]
    dp, tp = SHAPES[max_tp]
    assert sorted((r["data"], r["model"]) for r in ranks) == [(d, m) for d in range(dp)
                                                              for m in range(tp)]
    want = _jax_sharded_forward(_case(name), setup["flats"][name], setup["views"], (dp, tp))
    np.testing.assert_allclose(_by_data(ranks, "probs"), want, **FORWARD_TOL)


@pytest.mark.parametrize("name, max_tp", FORWARDS)
def test_sharded_forward_matches_unsharded(name, max_tp, world):
    """Against the port's own unsharded forward, in its default regime and
    on the unfused path."""
    ranks = world[name, max_tp]
    got = _by_data(ranks, "probs")
    np.testing.assert_allclose(got, _by_data(ranks, "unfused"), **FORWARD_TOL)
    np.testing.assert_allclose(got, _by_data(ranks, "auto"), **FORWARD_TOL)


@pytest.mark.parametrize("name, max_tp", FORWARDS)
def test_selections_equal_unsharded(name, max_tp, world):
    """Every gate's selection and every ATS sampling of the sharded run,
    on every rank, equal to the unsharded unfused run's; first, that none
    of the latter lies within MARGIN of a flip."""
    ranks = world[name, max_tp]
    for r in ranks:
        assert r["margin"] > MARGIN, (
            f"a selection at this seed lies {r['margin']:.3g} (relative) from a flip, within "
            f"the float32 rounding of the group's sums (MARGIN {MARGIN}): a mismatch below may "
            "be that near tie")
        assert len(r["selections"]) == len(r["want_selections"])
        for i, ((where, got), (want_where, want)) in enumerate(
                zip(r["selections"], r["want_selections"])):
            assert where == want_where, i
            np.testing.assert_array_equal(got, want, err_msg=f"selection {i} ({where})")
    ats = [where for where, _ in ranks[0]["selections"] if where == "blocks"]
    # ATS samples in each of the 2 spatial blocks at each of the 4 tubelet
    # steps, the views on the batch axis
    assert len(ats) == (8 if _case(name)[1] is not None else 0)


@pytest.mark.parametrize("name, max_tp", FORWARDS)
def test_counts_split_over_the_group(name, max_tp, world):
    """Each rank counts its own share: a TP group's linear and matmul
    FLOPs sum to the unsharded unfused counts, the replicated work (the
    classifier's linear, the residual adds) counted on every rank."""
    ranks = world[name, max_tp]
    dp, tp = SHAPES[max_tp]
    views, dim = TINY["temporal_views"], TINY["spatial_config"]["block_config"]["dim"]
    classifier = 4 // dp * views * dim * TINY["classes"]
    for d in range(dp):
        group = [r for r in ranks if r["data"] == d]
        want = group[0]["unfused_counts"]
        np.testing.assert_allclose(sum(r["counts"]["matmul_flops"] for r in group),
                                   want["matmul_flops"], rtol=1e-9)
        np.testing.assert_allclose(sum(r["counts"]["linear_flops"] for r in group),
                                   want["linear_flops"] + (tp - 1) * classifier, rtol=1e-9)
        for r in group:
            np.testing.assert_allclose(r["counts"]["add_flops"], want["add_flops"], rtol=1e-9)


def _jax_training(case, flat, setup, optimizer):
    model = _jax_policy(JaxViViT(**case_config(case), dropout_rate=0.0), case[2])
    mesh = jax_best_dp_tp_mesh(WORLD, max_tp=2)
    init_fn, make_jitted = jax_train_step(model, OPTIMIZERS[optimizer][1](), mesh)
    params, opt_state, shardings = init_fn(_unflatten(flat))
    step = make_jitted(params, opt_state, shardings)
    batch = {"inputs": jnp.asarray(setup["inputs"]),
             "labels": jnp.asarray(setup["labels"].astype(np.int32))}
    losses = []
    for i in range(STEPS):
        params, opt_state, loss = step(params, opt_state, batch, jax.random.PRNGKey(i))
        losses.append(float(loss))
    return losses, _flat(params)


@pytest.mark.parametrize("optimizer", list(OPTIMIZERS))
@pytest.mark.parametrize("name", list(CASES))
def test_training_matches_jax(name, optimizer, world, setup):
    flat = setup["flats"][name]
    want_losses, want_params = _jax_training(CASES[name], flat, setup, optimizer)
    ranks = world[name, optimizer]
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
        for key, value in r["params"].items():
            np.testing.assert_array_equal(value, ranks[0]["params"][key], err_msg=key)
    losses = ranks[0]["losses"]
    assert all(np.isfinite(losses)), losses
    np.testing.assert_allclose(losses, want_losses, rtol=TRAIN_TOL, atol=0)
    assert losses[-1] < losses[0], losses
    lr = OPTIMIZERS[optimizer][0]["optimizer_kwargs"]["lr"] if optimizer == "adamw" else None
    _same_params(ranks[0]["params"], want_params, STEPS, flat, lr)


@pytest.mark.parametrize("name", list(CASES))
def test_replicated_gradients_equal_across_a_tp_group(name, world):
    """The first SGD step's gradient of every replicated parameter (the
    gates' LN, the row-parallel biases, the embeddings) is the same, bit
    for bit, on the two ranks of each "model" group."""
    ranks = world[name, "sgd"]
    for d in (0, 1):
        group = [r for r in ranks if r["data"] == d]
        assert len(group) == 2
        assert "spatial_model.backbone.blocks.0.projection.bias" in group[0]["grads"]
        for key, value in group[0]["grads"].items():
            np.testing.assert_array_equal(value, group[1]["grads"][key], err_msg=key)


def test_backend_for_the_card(monkeypatch):
    """NCCL on the card unless BACKEND_ENV asks for gloo (ranks sharing one
    GPU); gloo on the CPU; any other name refused."""
    monkeypatch.delenv(BACKEND_ENV, raising=False)
    assert (backend_for("cuda"), backend_for("cpu")) == ("nccl", "gloo")
    monkeypatch.setenv(BACKEND_ENV, "gloo")
    assert (backend_for("cuda"), backend_for(torch.device("cpu"))) == ("gloo", "gloo")
    monkeypatch.setenv(BACKEND_ENV, "mpi")
    with pytest.raises(ValueError, match="'nccl' and 'gloo'"):
        backend_for("cuda")
