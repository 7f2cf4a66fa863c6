"""The port's tensor parallelism and dp x tp training (``parallel/mesh.py::
best_dp_tp_mesh``, ``parallel/sharding.py``, ``parallel/train.py``), its dry
run (``parallel/dryrun.py``) and ``initialize_distributed``, on the CPU: gloo
ranks spawned through ``parallel.mesh.spawn`` against the JAX package's
``TestMesh``, ``TestTensorParallel`` and ``TestDryrun`` (tests/
test_parallel.py) on 4 of the 8 virtual CPU devices (tests/conftest.py), on
the JAX package's TINY ViViT.

- ``best_dp_tp_mesh``'s shapes, from the pure rule and against the JAX mesh;
- the spec of every parameter against the JAX ``vit_param_specs``;
- the qkv shard by head, [q_r | k_r | v_r];
- the sharded forward at dp x tp = 1 x 4 and 2 x 2 against the JAX sharded
  forward, at its rtol 2e-5, atol 1e-6, every bias non-zero (so a
  row-parallel bias added on every rank fails);
- 5 train steps at 2 x 2, dropout 0, against JAX ``make_sharded_train_step``
  on ``best_dp_tp_mesh(4, max_tp=2)``, with SGD (momentum 0.9) and with the
  JAX test's ``adamw(3e-3)``: the losses within 1e-5 and falling, the final
  parameters within 1e-5. AdamW divides each gradient element by its own
  running scale, so an element whose gradient is float32 noise takes steps
  of up to lr whatever its value: the key third of each qkv bias (a zero
  gradient, since the softmax ignores a constant added to the keys) is held
  within 2 lr a step, as tests/test_torch_train.py holds it, and of the
  other elements at most 0.1 % may pass 1e-5 (6 of 51,856 do; the JAX
  package's own 1-device and 2 x 2 runs differ by up to 7e-5), none by
  more than 2 lr a step;
- the replicated parameters' gradients equal across each TP group;
- with dropout and drop-path on, the 2 x 2 step against one process's step
  over the two data shards, each drawn from its data rank's generator;
- the refusals (rel-pos, sequence parallelism with TP, a block class the
  port does not know; the eventful classes and ATS taken),
  ``dryrun_multichip(4, device="cpu")``, ``device="cuda"``
  without a GPU, and ``initialize_distributed`` at 2 ranks over tcp.

The rank functions live in tests/torch_parallel_ranks.py; one spawn of 4
ranks serves every check above but the dry run's and the rendezvous'."""

import copy
import socket
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_ranks
from eventful_transformer_tpu.core.counting import Ctx as JaxCtx
from eventful_transformer_tpu.models import FactorizedViViT as JaxViViT
from eventful_transformer_tpu.parallel.mesh import (
    best_dp_tp_mesh as jax_best_dp_tp_mesh,
    make_mesh as jax_make_mesh,
)
from eventful_transformer_tpu.parallel.sharding import (
    shard_params as jax_shard_params,
    vit_param_specs as jax_vit_param_specs,
)
from eventful_transformer_tpu.parallel.train import make_sharded_train_step as jax_train_step
from eventful_transformer_tpu.utils.params import _flatten
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.models import FactorizedViViT
from eventful_transformer_tpu_torch.parallel import dryrun
from eventful_transformer_tpu_torch.parallel.mesh import dp_tp_shape, spawn
from eventful_transformer_tpu_torch.parallel.sharding import vit_param_specs
from eventful_transformer_tpu_torch.parallel.train import (
    cross_entropy_from_probs,
    data_generator,
)
from eventful_transformer_tpu_torch.utils.params import params_from_jax
from eventful_transformer_tpu_torch.utils.train import make_optimizer

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from tests.test_parallel import TINY  # noqa: E402

WORLD = 4
BATCH, STEPS, SEED = 8, 5, 0
# the optimizers of the 5-step runs: (torch config, optax optimizer)
OPTIMIZERS = {
    "sgd": ({"optimizer": "SGD", "optimizer_kwargs": {"lr": 3e-2, "momentum": 0.9}},
            lambda: optax.sgd(3e-2, momentum=0.9)),
    "adamw": ({"optimizer": "AdamW", "optimizer_kwargs": {"lr": 3e-3}},
              lambda: optax.adamw(3e-3)),
}
DROPOUT_LR, DROPOUT_SEED = 1e-4, 7
NOISE_SHARE = 1e-3  # AdamW: the share of elements that may pass TRAIN_TOL
FORWARD_TOL = dict(rtol=2e-5, atol=1e-6)  # JAX TestTensorParallel's
TRAIN_TOL = 1e-5


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _flat(params):
    return {k: np.array(v) for k, v in _flatten(params).items()}


def _with_biases(flat, seed=5):
    """Every bias non-zero (the JAX init zeroes the linears')."""
    rng = np.random.default_rng(seed)
    return {k: (0.1 * rng.standard_normal(v.shape)).astype(v.dtype) if k.endswith("bias") else v
            for k, v in flat.items()}


def _unflatten(flat):
    tree = {}
    for key, value in flat.items():
        *parts, leaf = key.split("/")
        node = tree
        for part in parts:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(value)
    return _lists(tree)


def _lists(tree):
    if not isinstance(tree, dict):
        return tree
    if tree and all(k.isdigit() for k in tree):
        return [_lists(tree[str(i)]) for i in range(len(tree))]
    return {k: _lists(v) for k, v in tree.items()}


def _dropout_config():
    return dict(dryrun.TRAIN_MODEL)


@pytest.fixture(scope="module")
def setup():
    params = JaxViViT(**TINY).init(jax.random.PRNGKey(0))
    flat = _with_biases(_flat(params))
    rng = np.random.default_rng(0)
    views = rng.standard_normal((4, 2, 8, 3, 32, 32)).astype(np.float32)
    inputs = rng.standard_normal((BATCH, 2, 8, 3, 32, 32)).astype(np.float32)
    labels = rng.integers(0, 16, (BATCH,)).astype(np.int64)
    drop_flat = _with_biases(_flat(JaxViViT(**_dropout_config()).init(jax.random.PRNGKey(1))))
    return dict(flat=flat, params=_unflatten(flat), views=views, inputs=inputs, labels=labels,
                drop_flat=drop_flat)


@pytest.fixture(scope="module")
def world(setup, tmp_path_factory):
    """One spawn of 4 ranks: the forwards at 1 x 4 and 2 x 2, the 5 steps
    at 2 x 2, the dropout step at 2 x 2, the refusals."""
    s = setup
    taken = []
    for block_class in ("EventfulTokenwiseBlock", "EventfulMatmul1Block", "EventfulBlock"):
        taken.append(copy.deepcopy(TINY))
        taken[-1]["spatial_config"]["block_class"] = block_class
    taken.append(copy.deepcopy(TINY))
    taken[-1]["spatial_config"]["block_config"]["ats_fraction"] = 0.5
    relpos = copy.deepcopy(TINY)
    relpos["spatial_config"]["block_config"]["relative_embedding_size"] = [4, 4]
    dropout_optimizer = {"optimizer": "AdamW", "optimizer_kwargs": {"lr": DROPOUT_LR}}
    jobs = [
        ("tp_forward", TINY, s["flat"], s["views"], 4),
        ("tp_forward", TINY, s["flat"], s["views"], 2),
        ("tp_train", _dropout_config(), s["drop_flat"], s["inputs"][:4], s["labels"][:4],
         dropout_optimizer, 1, 2, DROPOUT_SEED),
        ("tp_refused", [relpos, (TINY, "sequence"), (TINY, "unknown"), *taken, TINY]),
        *[("tp_train", dict(TINY, dropout_rate=0.0), s["flat"], s["inputs"], s["labels"],
           OPTIMIZERS[name][0], STEPS, 2, SEED) for name in OPTIMIZERS],
    ]
    store = tmp_path_factory.mktemp("store_tp")
    results = spawn(torch_parallel_ranks.run_jobs, WORLD, args=(jobs, str(store)), threads=1)
    return [[rank[i] for rank in results] for i in range(len(jobs))]


@pytest.mark.parametrize("n, max_tp, want", [
    (8, 4, (2, 4)), (8, 3, (4, 2)), (4, 4, (1, 4)), (4, 2, (2, 2)), (6, 4, (2, 3)),
    (7, 4, (7, 1)), (1, 4, (1, 1)),
])
def test_dp_tp_shape_matches_jax(n, max_tp, want):
    assert dp_tp_shape(n, max_tp) == want
    mesh = jax_best_dp_tp_mesh(n, max_tp=max_tp)
    assert (mesh.shape["data"], mesh.shape["model"]) == want


def test_param_specs_match_jax(setup):
    """Every parameter's sharded axis, against the JAX spec of its leaf."""
    want = {k: tuple(v) for k, v in _flatten(jax_vit_param_specs(setup["params"])).items()}
    got = {k.replace(".", "/"): v for k, v in
           vit_param_specs(FactorizedViViT(**TINY, device="cpu")).items()}
    assert got == want
    block = "spatial_model.backbone.blocks.0."
    specs = vit_param_specs(FactorizedViViT(**TINY, device="cpu"))
    assert specs[block + "qkv.kernel"] == (None, "model")
    assert specs[block + "projection.bias"] == ()
    assert specs[block + "mlp_2.kernel"] == ("model", None)
    assert specs["classifier.kernel"] == ()


def _jax_sharded_forward(params, views, shape):
    model = JaxViViT(**TINY)
    mesh = jax_make_mesh(shape, ("data", "model"), devices=jax.devices()[:WORLD])
    sharded = jax_shard_params(mesh, params)
    views = jax.device_put(jnp.asarray(views), NamedSharding(mesh, P("data")))
    return np.asarray(jax.jit(lambda p, v: model.apply_views(JaxCtx(), p, v))(sharded, views))


@pytest.mark.parametrize("job, shape", [(0, (1, 4)), (1, (2, 2))])
def test_sharded_forward_matches_jax(job, shape, world, setup):
    ranks = world[job]
    dp, tp = shape
    assert sorted((r["data"], r["model"]) for r in ranks) == [(d, m) for d in range(dp)
                                                              for m in range(tp)]
    by_data = {}
    for r in ranks:  # every rank of a TP group holds its data shard's output
        if r["data"] in by_data:
            np.testing.assert_array_equal(r["probs"], by_data[r["data"]])
        by_data[r["data"]] = r["probs"]
    got = np.concatenate([by_data[d] for d in range(dp)])
    want = _jax_sharded_forward(setup["params"], setup["views"], shape)
    np.testing.assert_allclose(got, want, **FORWARD_TOL)


@pytest.mark.parametrize("job", [0, 1])
def test_qkv_is_sharded_by_head(job, world, setup):
    """Rank m of tp holds the q, k and v columns of its heads, packed."""
    kernel = setup["flat"]["spatial_model/backbone/blocks/0/qkv/kernel"]
    bias = setup["flat"]["spatial_model/backbone/blocks/0/qkv/bias"]
    heads = TINY["spatial_config"]["block_config"]["heads"]
    c = kernel.shape[0]
    d = c // heads
    for r in world[job]:
        tp = {0: 4, 1: 2}[job]
        h = heads // tp
        cols = [part * c + head * d + i for part in range(3)
                for head in range(r["model"] * h, (r["model"] + 1) * h) for i in range(d)]
        np.testing.assert_array_equal(r["qkv_kernel"], kernel[:, cols])
        np.testing.assert_array_equal(r["qkv_bias"], bias[cols])


def _jax_training(setup, name):
    """JAX TestDryrun::test_training_reduces_loss's step on 4 devices."""
    model = JaxViViT(**TINY, dropout_rate=0.0)
    mesh = jax_best_dp_tp_mesh(WORLD, max_tp=2)
    init_fn, make_jitted = jax_train_step(model, OPTIMIZERS[name][1](), mesh)
    # a copy: the step donates its parameters
    params, opt_state, shardings = init_fn(_unflatten(setup["flat"]))
    step = make_jitted(params, opt_state, shardings)
    batch = {"inputs": jnp.asarray(setup["inputs"]),
             "labels": jnp.asarray(setup["labels"].astype(np.int32))}
    losses = []
    for i in range(STEPS):
        params, opt_state, loss = step(params, opt_state, batch, jax.random.PRNGKey(i))
        losses.append(float(loss))
    return losses, _flat(params)


def _same_params(got, want, steps, start, lr=None):
    """Within TRAIN_TOL; with AdamW's ``lr``, the key third of each qkv
    bias within 2 lr a step, and at most NOISE_SHARE of the other elements
    beyond TRAIN_TOL, none beyond 2 lr a step. Every parameter moved."""
    assert set(got) == {k.replace("/", ".") for k in want}
    beyond = total = 0
    for key, value in want.items():
        name = key.replace("/", ".")
        assert not np.array_equal(value, start[key]), key
        diff = np.abs(got[name] - value)
        if lr is not None:
            if key.endswith("qkv/bias"):
                c = value.shape[0] // 3
                assert diff[c : 2 * c].max() <= 2 * lr * steps, (key, diff.max())
                diff = np.concatenate([diff[:c], diff[2 * c :]])
            assert diff.max() <= 2 * lr * steps, (key, diff.max())
            beyond += int((diff > TRAIN_TOL).sum())
            total += diff.size
        else:
            assert diff.max() <= TRAIN_TOL, (key, diff.max())
    assert beyond <= NOISE_SHARE * total, (beyond, total)


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_training_matches_jax(name, world, setup):
    want_losses, want_params = _jax_training(setup, name)
    ranks = world[4 + list(OPTIMIZERS).index(name)]
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
        for key, value in r["params"].items():
            np.testing.assert_array_equal(value, ranks[0]["params"][key], err_msg=key)
    losses = ranks[0]["losses"]
    np.testing.assert_allclose(losses, want_losses, rtol=TRAIN_TOL, atol=0)
    assert losses[-1] < losses[0], losses
    lr = OPTIMIZERS[name][0]["optimizer_kwargs"]["lr"] if name == "adamw" else None
    _same_params(ranks[0]["params"], want_params, STEPS, setup["flat"], lr)


def test_replicated_gradients_equal_across_a_tp_group(world):
    """The first step's gradient of every replicated parameter is the same,
    bit for bit, on the ranks of a "model" group, and differs between the
    two data shards."""
    ranks = world[4]
    for d in (0, 1):
        group = [r for r in ranks if r["data"] == d]
        assert len(group) == 2
        assert group[0]["grads"].keys() == group[1]["grads"].keys()
        assert "spatial_model.backbone.blocks.0.projection.bias" in group[0]["grads"]
        for name, value in group[0]["grads"].items():
            np.testing.assert_array_equal(value, group[1]["grads"][name], err_msg=name)


def test_dropout_step_matches_one_process(world, setup):
    """Dropout 0.1 and drop-path 0.1 (the dry run's model): the 2 x 2 step
    against one process's, each data shard's loss drawn from its data
    rank's generator and the gradients averaged."""
    ranks = world[2]
    model = params_from_jax(FactorizedViViT(**_dropout_config(), device="cpu"),
                            setup["drop_flat"])
    optimizer = make_optimizer({"optimizer": "AdamW", "optimizer_kwargs": {"lr": DROPOUT_LR}},
                               model, list(model.parameters()))
    for p in model.parameters():
        p.requires_grad_(True)
    inputs = torch.from_numpy(setup["inputs"][:4])
    labels = torch.from_numpy(setup["labels"][:4])
    losses = []
    for d in (0, 1):
        ctx = Ctx(training=True, generator=data_generator(DROPOUT_SEED, d, "cpu"))
        loss = cross_entropy_from_probs(model.apply_views(ctx, inputs[2 * d : 2 * d + 2]),
                                        labels[2 * d : 2 * d + 2]) / 2
        loss.backward()
        losses.append(float(loss.detach()))
    optimizer.step()
    np.testing.assert_allclose(ranks[0]["losses"], [sum(losses)], rtol=TRAIN_TOL, atol=0)
    want = {name.replace(".", "/"): p.detach().numpy() for name, p in model.named_parameters()}
    _same_params(ranks[0]["params"], want, 1, setup["drop_flat"], DROPOUT_LR)


def test_refusals(world):
    """A rel-pos block, a sequence-parallel block and a block class the
    port does not know raise under tp = 2, each saying why; the three
    eventful classes, an ATS block and the dense TINY are taken."""
    for relpos, sequence, unknown, *taken in world[3]:
        assert "rel-pos" in relpos and "no tensor-parallel path" in relpos
        assert "tensor- or sequence-parallel" in sequence
        assert "UnknownBlock" in unknown and "block classes" in unknown
        assert taken == [None] * 5


def test_cross_entropy_from_probs():
    probs = torch.tensor([[0.7, 0.2, 0.1], [0.25, 0.25, 0.5]])
    want = -(np.log(0.7 + 1e-9) + np.log(0.5 + 1e-9)) / 2
    assert abs(float(cross_entropy_from_probs(probs, torch.tensor([0, 2]))) - want) < 1e-7


def test_dryrun_on_four_gloo_ranks():
    result = dryrun.dryrun_multichip(WORLD, device="cpu")
    assert (result["world_size"], result["backend"], result["dp"], result["tp"]) == (
        WORLD, "gloo", 1, 4)
    assert np.isfinite(result["loss"]) and np.isfinite(result["map"])
    assert result["pipeline"] == (3, 2, 16, 32) and result["sequence"] == (2, 32, 32)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal on a host without GPUs")
def test_dryrun_on_the_card_without_gpus_raises():
    with pytest.raises(RuntimeError, match="needs 2 GPUs, this host has 0"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="needs 1 GPUs, this host has 0"):
        dryrun.main(["--devices", "1"])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_initialize_distributed_joins_two_ranks():
    results = spawn(torch_parallel_ranks.joined, 2, args=(f"127.0.0.1:{_free_port()}", 2),
                    threads=1)
    assert results == [(True, 0, 2, "gloo", 3.0), (True, 1, 2, "gloo", 3.0)]
