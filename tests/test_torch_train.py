"""The temporal fine-tune of the port against the JAX package on the CPU,
at the small ``MODEL`` of tests/test_train.py: one step's loss and the
gradients of every trained parameter against ``jax.value_and_grad``; the
optimizers against optax on identical gradients; ``train_vivit_temporal``
of both packages over one synthetic cache; the resume; the ``.npz`` the
port writes, read by the JAX package; dropout and drop-path; and the
training path reaching no kernel wrapper.

Tolerances, float32 on both sides at "highest" matmul precision: the loss
at 1e-6 relative, each gradient within 1e-5 of its largest magnitude (sums
in other orders); optimizer updates at 1e-6 (rtol and atol: the same
arithmetic, other orders), frozen parameters bit for bit. Over two epochs
the history's losses agree within 1e-5 and the top-1/top-5 exactly, and
the trained weights within 1e-6, but for the key third of each qkv bias:
the softmax of a row does not change when q.b_k is added to every logit,
so that bias's gradient is 0 in exact arithmetic and float32 noise of
1e-10 in both packages; AdamW divides each gradient by its running RMS,
which turns that noise into steps of up to lr, of either sign. Those
elements are held within 2 * lr * steps (measured: about 2e-3 at lr 3e-3
and 6 steps; every other weight within 5e-7).
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eventful_transformer_tpu.core.counting import Ctx as JaxCtx
from eventful_transformer_tpu.core.policies import TokenNormTopK as JaxTopK
from eventful_transformer_tpu.data import SyntheticVideoClassification
from eventful_transformer_tpu.models import FactorizedViViT as JaxViViT
from eventful_transformer_tpu.utils.misc import set_policies as jax_set_policies
from eventful_transformer_tpu.utils.params import fill_like
from eventful_transformer_tpu.utils.params import load_params as jax_load_params
from eventful_transformer_tpu.utils.params import save_params as jax_save_params
from eventful_transformer_tpu.utils.spatial import compute_vivit_spatial
from eventful_transformer_tpu.utils.train import make_optimizer as jax_make_optimizer
from eventful_transformer_tpu.utils.train import train_vivit_temporal as jax_train
from eventful_transformer_tpu_torch.core import blocks as port_blocks
from eventful_transformer_tpu_torch.core import embeddings as port_embeddings
from eventful_transformer_tpu_torch.core import indexing as port_indexing
from eventful_transformer_tpu_torch.core.blocks import (
    Block,
    EventfulBlock,
    EventfulMatmul1Block,
    EventfulTokenwiseBlock,
)
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.core.nn import Dropout, DropPath
from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
from eventful_transformer_tpu_torch.data.vivit_spatial import ViViTSpatial
from eventful_transformer_tpu_torch.models import FactorizedViViT
from eventful_transformer_tpu_torch.utils import checkpoint
from eventful_transformer_tpu_torch.utils.misc import set_policies
from eventful_transformer_tpu_torch.utils.params import (
    flatten_tree,
    load_params,
    params_from_jax,
    params_to_numpy,
    save_params,
)
from eventful_transformer_tpu_torch.utils.train import (
    TRAINED_SUBTREES,
    eval_step,
    loss_fn,
    make_optimizer,
    train_vivit_temporal,
)

MODEL = dict(
    classes=4,
    input_shape=[8, 3, 32, 32],
    normalize_mean=0.45,
    normalize_std=0.225,
    spatial_views=1,
    temporal_stride=2,
    temporal_views=2,
    tubelet_shape=[2, 8, 8],
    spatial_config=dict(
        depth=1,
        position_encoding_size=[4, 4],
        block_class="EventfulBlock",
        block_config=dict(dim=32, heads=4, mlp_ratio=2),
    ),
    temporal_config=dict(
        depth=1,
        position_encoding_size=[4],
        block_config=dict(dim=32, heads=4, mlp_ratio=2),
    ),
)
TRAIN_MODEL = dict(MODEL, temporal_only=True, dropout_rate=0.0)


@pytest.fixture(autouse=True)
def _setup():
    torch.set_num_threads(2)
    jax.config.update("jax_default_matmul_precision", "highest")


def _trained(key):
    return key.split("/", 1)[0] in TRAINED_SUBTREES


def _pair(model_config=TRAIN_MODEL, seed=1):
    """The JAX model and the port's on the same weights (the JAX init plus
    seeded noise): (JAX model, its params, port model, the flat weights)."""
    jax_model = JaxViViT(**model_config)
    like = jax_model.init(jax.random.PRNGKey(42))
    rng = np.random.default_rng(seed)
    flat = {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in flatten_tree(jax.tree_util.tree_map(np.asarray, like)).items()}
    model = FactorizedViViT(**model_config, device="cpu")
    params_from_jax(model, flat)
    return jax_model, fill_like(like, flat), model, flat


def _batch(seed=2, batch=3, classes=4):
    rng = np.random.default_rng(seed)
    inputs = rng.standard_normal((batch, 2, 4, 32)).astype(np.float32)
    labels = rng.integers(0, classes, batch).astype(np.int32)
    return inputs, labels


def test_step_loss_and_gradients_match_jax():
    """The loss of one batch and the gradient of every trained parameter
    against ``jax.value_and_grad`` of the JAX ``loss_fn`` (the temporal
    forward under ``Ctx(training=True)``, the cross-entropy of the
    probabilities), dropout 0; frozen parameters get no gradient."""
    jax_model, params, model, flat = _pair()
    inputs, labels = _batch()

    def jax_loss(p):
        ctx = JaxCtx(training=True, rng=jax.random.PRNGKey(0))
        probs = jax_model._forward_temporal(ctx, p, jnp.asarray(inputs), inputs.shape[0])
        return optax.softmax_cross_entropy_with_integer_labels(probs, jnp.asarray(labels)).mean()

    want_loss, want_grads = jax.value_and_grad(jax_loss)(params)
    want_grads = flatten_tree(jax.tree_util.tree_map(np.asarray, want_grads))
    make_optimizer({}, model)  # freezes every parameter outside the trained subtrees
    generator = torch.Generator().manual_seed(0)
    loss, _ = loss_fn(model, torch.from_numpy(inputs), torch.from_numpy(labels).long(),
                      Ctx(training=True, generator=generator))
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-6 * abs(float(want_loss))
    checked = 0
    for name, p in model.named_parameters():
        key = name.replace(".", "/")
        if not _trained(key):
            assert p.grad is None and not p.requires_grad, key
            continue
        got, want = p.grad.numpy(), want_grads[key]
        scale = np.abs(want).max()
        assert scale > 0, key
        assert np.abs(got - want).max() <= 1e-5 * scale, (key, np.abs(got - want).max(), scale)
        checked += 1
    assert checked == sum(_trained(k) for k in flat) > 10


@pytest.mark.parametrize(
    "name,kwargs",
    [
        ("AdamW", {"lr": 1e-2, "weight_decay": 0.05}),
        ("AdamW", {"lr": 1e-2}),
        ("Adam", {"lr": 1e-2, "b1": 0.8, "b2": 0.99}),
        ("SGD", {"lr": 1e-2, "momentum": 0.9}),
        ("SGD", {"lr": 1e-2}),
    ],
    ids=["adamw", "adamw_default_decay", "adam", "sgd_momentum", "sgd"],
)
def test_optimizer_update_matches_optax(name, kwargs):
    """Three steps of both packages' ``make_optimizer`` on identical seeded
    gradients: the trained parameters alike, the frozen ones untouched
    (no update and no decay), optax's defaults where the config gives none
    (AdamW's weight decay 1e-4)."""
    _, params, model, flat = _pair()
    config = {"optimizer": name, "optimizer_kwargs": kwargs}
    jax_opt = jax_make_optimizer(config)
    state = jax_opt.init(params)
    opt = make_optimizer(config, model)
    if name == "AdamW":
        assert opt.param_groups[0]["weight_decay"] == kwargs.get("weight_decay", 1e-4)
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    rng = np.random.default_rng(3)
    for _ in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in flat.items()}
        updates, state = jax_opt.update(fill_like(params, grads), state, params)
        params = optax.apply_updates(params, updates)
        for pname, p in model.named_parameters():
            if p.requires_grad:
                p.grad = torch.from_numpy(grads[pname.replace(".", "/")])
        opt.step()
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, params))
    for pname, p in model.named_parameters():
        key = pname.replace(".", "/")
        if _trained(key):
            np.testing.assert_allclose(p.detach().numpy(), want[key], rtol=1e-6, atol=1e-6,
                                       err_msg=key)
            assert not torch.equal(p.detach(), start[pname]), key
        else:
            assert torch.equal(p.detach(), start[pname]), key
            np.testing.assert_array_equal(want[key], flat[key], err_msg=key)


def test_optimizer_refuses_unknown_keywords():
    """optax.adam takes no weight_decay; the port refuses it the same way."""
    _, _, model, _ = _pair()
    with pytest.raises(TypeError):
        make_optimizer({"optimizer": "Adam", "optimizer_kwargs": {"weight_decay": 0.1}}, model)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """Six clips' spatial features from the JAX ``compute_vivit_spatial``
    (tests/test_train.py's stage 1), and a starting-weights ``.npz`` the
    JAX package wrote."""
    root = tmp_path_factory.mktemp("train")
    data = SyntheticVideoClassification(n_items=6, n_frames=16, size=(32, 32), classes=4)
    compute_vivit_spatial({"model": dict(MODEL, spatial_only=True), "k": 8}, root / "cache", data)
    jax_model, params, _, _ = _pair()
    jax_save_params(root / "start.npz", params)
    return root


def _configs(root, **extra):
    base = dict(epochs=2, optimizer="AdamW", optimizer_kwargs={"lr": 3e-3, "weight_decay": 0.05},
                train_batch_size=2, val_batch_size=2, starting_weights=str(root / "start.npz"),
                **extra)
    return dict(base, model=TRAIN_MODEL), dict(base, model=dict(TRAIN_MODEL, device="cpu"))


def test_train_vivit_temporal_matches_jax(cache, capsys):
    """Two epochs of both packages' ``train_vivit_temporal`` over one
    cache from the same JAX-written starting weights, dropout 0: the same
    history and printed lines, the weights within the bound above, the
    frozen subtrees bit for bit."""
    data = ViViTSpatial(cache / "cache")
    jax_config, config = _configs(cache)
    jax_params, jax_history = jax_train(jax_config, data, data)
    jax_lines = capsys.readouterr().out.splitlines()
    model, history = train_vivit_temporal(config, data, data)
    lines = capsys.readouterr().out.splitlines()
    assert [h["pass"] for h in history] == ["val", "train", "val", "train", "val"]
    assert [(h["pass"], h["step"]) for h in history] == [(h["pass"], h["step"]) for h in jax_history]
    for got, want in zip(history, jax_history):
        assert abs(got["loss"] - want["loss"]) <= 1e-5, (got, want)
        assert (got["top_1"], got["top_5"]) == (want["top_1"], want["top_5"])
    assert [line[:6] for line in lines] == [line[:6] for line in jax_lines]
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, jax_params))
    with np.load(cache / "start.npz") as f:
        start = {k: f[k] for k in f.files}
    got = params_to_numpy(model)
    lr, steps = 3e-3, 2 * 3
    for key, value in got.items():
        if not _trained(key):
            np.testing.assert_array_equal(value, start[key], err_msg=key)
            np.testing.assert_array_equal(want[key], start[key], err_msg=key)
            continue
        assert not np.array_equal(want[key], start[key]), key
        diff = np.abs(value - want[key])
        if key.endswith("qkv/bias"):  # the key third: a zero gradient's noise
            c = diff.shape[-1] // 3
            assert diff[c : 2 * c].max() <= 2 * lr * steps, (key, diff.max())
            diff = np.concatenate([diff[:c], diff[2 * c :]])
        assert diff.max() <= 1e-6, (key, diff.max())


def test_resume_reproduces_an_uninterrupted_run(cache, tmp_path):
    """One epoch checkpointed, then a resume to two, gives bit-equal weights
    to two epochs in one run; the resumed run skips epoch 1's training."""
    data = ViViTSpatial(cache / "cache")
    _, config = _configs(cache)
    straight, _ = train_vivit_temporal(config, data, data)
    ckpt = dict(config, checkpoint_dir=str(tmp_path / "ckpt"))
    train_vivit_temporal(dict(ckpt, epochs=1), data, data)
    assert checkpoint.latest_epoch(tmp_path / "ckpt") == 1
    resumed, history = train_vivit_temporal(ckpt, data, data)
    assert checkpoint.latest_epoch(tmp_path / "ckpt") == 2
    assert [h["step"] for h in history if h["pass"] == "train"] == [2]
    for (name, a), (_, b) in zip(straight.named_parameters(), resumed.named_parameters()):
        assert torch.equal(a, b), name
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["epoch_00001", "epoch_00002"]


def test_output_weights_are_read_by_jax(cache, tmp_path):
    """The port's ``output_weights`` ``.npz``, read by the JAX package's
    ``load_params(like=...)``, gives the port's validation probabilities;
    the port reads it back to the same weights."""
    data = ViViTSpatial(cache / "cache")
    _, config = _configs(cache, output_weights=str(tmp_path / "final.npz"))
    model, _ = train_vivit_temporal(dict(config, epochs=1), data, data)
    jax_model = JaxViViT(**TRAIN_MODEL)
    params = jax_load_params(tmp_path / "final.npz", like=jax_model.init(jax.random.PRNGKey(0)))
    inputs = np.stack([data[i][0] for i in range(len(data))])
    labels = np.asarray([data[i][1] for i in range(len(data))])
    want = jax_model._forward_temporal(JaxCtx(), params, jnp.asarray(inputs), len(data))
    _, got = eval_step(model, torch.from_numpy(inputs), torch.from_numpy(labels).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    again = load_params(tmp_path / "final.npz", FactorizedViViT(**TRAIN_MODEL, device="cpu"))
    for (name, a), (_, b) in zip(model.named_parameters(), again.named_parameters()):
        assert torch.equal(a, b), name


def test_save_params_round_trip(tmp_path):
    """``save_params`` writes every parameter in the JAX layout, which the
    JAX package's ``load_params(like=...)`` takes key for key."""
    jax_model, _, model, flat = _pair()
    save_params(tmp_path / "w.npz", model)
    params = jax_load_params(tmp_path / "w.npz", like=jax_model.init(jax.random.PRNGKey(0)))
    back = flatten_tree(jax.tree_util.tree_map(np.asarray, params))
    assert set(back) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_tensorboard_logs_or_warns(cache, tmp_path, capsys):
    """A ``tensorboard`` entry logs the scalars where ``SummaryWriter``
    imports, and otherwise warns and goes on, as the JAX package does."""
    data = ViViTSpatial(cache / "cache")
    _, config = _configs(cache, tensorboard=str(tmp_path / "tb"))
    _, history = train_vivit_temporal(dict(config, epochs=1), data, data)
    out = capsys.readouterr().out
    written = list(tmp_path.glob("tb_*"))
    assert written or "WARNING: tensorboard disabled" in out
    assert len(history) == 3


# -- dropout and drop-path ------------------------------------------------------------


def test_dropout_keep_share_and_scale():
    """Each element kept with probability 1 - rate (within 5 standard
    deviations of 200000 draws) and scaled by 1 / keep; the identity
    outside training and at rate 0; the draws follow the generator."""
    x = torch.ones(200_000)
    rate = 0.3
    ctx = Ctx(training=True, generator=torch.Generator().manual_seed(0))
    y = Dropout(rate)(ctx, x)
    kept = y != 0
    sigma = math.sqrt(rate * (1 - rate) / x.numel())
    assert abs(float(kept.float().mean()) - (1 - rate)) < 5 * sigma
    assert torch.equal(y[kept], torch.full((int(kept.sum()),), 1 / (1 - rate)))
    again = Dropout(rate)(Ctx(training=True, generator=torch.Generator().manual_seed(0)), x)
    assert torch.equal(y, again)
    assert Dropout(rate)(Ctx(), x) is x
    assert Dropout(0.0)(ctx, x) is x
    with pytest.raises(ValueError, match="generator"):
        Dropout(rate)(Ctx(training=True), x)


def test_drop_path_keeps_whole_rows():
    """One uniform a batch row: a row is kept (scaled by 1 / (1 - rate)) or
    zeroed whole, the keep share within 5 standard deviations of 20000
    rows; the identity outside training."""
    x = torch.ones(20_000, 3, 5)
    rate = 0.2
    y = DropPath(rate)(Ctx(training=True, generator=torch.Generator().manual_seed(1)), x)
    rows = y.reshape(y.shape[0], -1)
    kept = rows[:, 0] != 0
    assert torch.equal(rows[kept], torch.full_like(rows[kept], 1 / (1 - rate)))
    assert torch.equal(rows[~kept], torch.zeros_like(rows[~kept]))
    sigma = math.sqrt(rate * (1 - rate) / x.shape[0])
    assert abs(float(kept.float().mean()) - (1 - rate)) < 5 * sigma
    assert DropPath(rate)(Ctx(), x) is x


def test_drop_path_model_at_inference_matches_jax(monkeypatch):
    """A model with ``drop_path_rate=0.1`` in every block (an EventfulBlock
    spatial model, k = 8, and the dense temporal model) at inference: the
    same probabilities as the JAX model's (its CPU "auto", unfused; the
    port's "auto" unfused too, as the JAX "auto" rule takes a block with
    drop-path) within 1e-5."""
    monkeypatch.setenv("EVT_UNROLL_BLOCKS", "1")
    config = copy.deepcopy(MODEL)
    for sub in ("spatial_config", "temporal_config"):
        config[sub]["block_config"]["drop_path_rate"] = 0.1
    jax_model, params, model, _ = _pair(config, seed=4)
    jax_set_policies(jax_model, JaxTopK, k=8)
    set_policies(model, TokenNormTopK, k=8)
    assert all(blk._fused_mode(17) is False for blk in model.spatial_model.backbone.blocks)
    views = np.random.default_rng(5).standard_normal((1, 2, 8, 3, 32, 32)).astype(np.float32)
    want = jax_model.apply_views(JaxCtx(), params, jnp.asarray(views))
    got = model.apply_views(Ctx(), torch.from_numpy(views))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# -- the training path reaches no kernel ----------------------------------------------

WRAPPERS = {
    port_blocks: ("softmax_select_matmul", "softmax_select_matmul_logits", "proj_group",
                  "qkv_attention_group", "dense_mlp_residual", "block_scatter_rows",
                  "block_select_p", "block_select_scatter", "ln_norms", "ln_select",
                  "ln_select_matmul", "select_linear_skip_norms", "gate_group_linear",
                  "gate_group_mlp", "window_attention"),
    port_embeddings: ("relpos_bias_add", "relpos_bias_add_v2"),
    port_indexing: ("scatter_blend",),
}


@pytest.fixture
def no_kernels(monkeypatch):
    """Every kernel wrapper a block can reach, replaced by one that raises."""
    def refuse(name):
        def call(*args, **kwargs):
            raise AssertionError(f"the training path reached {name}")
        return call

    for module, names in WRAPPERS.items():
        for name in names:
            monkeypatch.setattr(module, name, refuse(name))


def _block_cases():
    windowed = dict(dim=32, heads=4, mlp_ratio=2, input_size=(5, 6), window_size=(2, 2),
                    relative_embedding_size=(2, 2))
    plain = dict(dim=32, heads=4, mlp_ratio=2, input_size=(4, 5))
    return {
        "dense_global": (Block, plain, {}),
        "dense_windowed_padded": (Block, windowed, {}),
        "dense_global_relpos": (Block, dict(plain, relative_embedding_size=(4, 5)), {}),
        "tokenwise_v4": (EventfulTokenwiseBlock, plain, dict(fused_gates="v4")),
        "tokenwise_windowed_resident_v2": (EventfulTokenwiseBlock, windowed, dict(fused_gates="v2")),
        "tokenwise_blocked": (EventfulTokenwiseBlock, plain, dict(fused_gates="blocked")),
        "matmul1_v3": (EventfulMatmul1Block, plain, dict(fused_gates="v3")),
        "eventful_av_kernel": (EventfulBlock, dict(plain, relative_embedding_size=(4, 5),
                                                   pool_size=(2, 1)),
                               dict(fused_gates="v2mlp", av_kernel=True)),
    }


@pytest.mark.parametrize("case", list(_block_cases()))
def test_training_reaches_no_kernel_wrapper(case, no_kernels):
    """Each block class under ``Ctx(training=True)`` (a flush, then two
    incremental steps for the eventful ones, each forced to a kernel regime
    that inference would take) with every wrapper refusing: the plain path
    runs, and the backward reaches every parameter."""
    cls, kw, attrs = _block_cases()[case]
    torch.manual_seed(0)
    block = cls(**kw)
    for module in block.modules():
        if hasattr(module, "reset_parameters"):
            module.reset_parameters(torch.Generator().manual_seed(6))
    for key, value in attrs.items():
        setattr(block, key, value)
    eventful = cls is not Block
    if eventful:
        set_policies(block, TokenNormTopK, k=6)
    n = math.prod(kw["input_size"])
    xs = torch.randn(3, 2, n, 32, generator=torch.Generator().manual_seed(7))
    train_ctx = Ctx(training=True, generator=torch.Generator().manual_seed(8))
    state = block.init_state(2, n, torch.float32, "cpu")
    ys = []
    for t in range(3 if eventful else 1):
        mode = ("flush" if t == 0 else "incremental") if eventful else None
        y, state, _ = block(train_ctx, state, xs[t], mode=mode)
        ys.append(y)
    torch.stack(ys).square().sum().backward()
    missing = [name for name, p in block.named_parameters() if p.grad is None]
    assert not missing, missing
    assert all(torch.isfinite(p.grad).all() for p in block.parameters())


def test_training_block_equals_inference_block():
    """Without drop-path the plain training path computes what inference
    computes: a windowed EventfulTokenwiseBlock forced to "v2" (its qkv
    buffer window-major) over a flush and two incremental steps, training
    against inference, on the CPU (the plain versions), within 1e-5."""
    kw = dict(dim=32, heads=4, mlp_ratio=2, input_size=(5, 6), window_size=(2, 2),
              relative_embedding_size=(2, 2))
    block = EventfulTokenwiseBlock(**kw)
    for module in block.modules():
        if hasattr(module, "reset_parameters"):
            module.reset_parameters(torch.Generator().manual_seed(9))
    block.fused_gates = "v2"
    set_policies(block, TokenNormTopK, k=6)
    xs = torch.randn(3, 2, 30, 32, generator=torch.Generator().manual_seed(10))
    outs = {}
    for training in (False, True):
        ctx = Ctx(training=training, generator=torch.Generator().manual_seed(0))
        state = block.init_state(2, 30, torch.float32, "cpu")
        assert state["qkv_accumulator"]["b"].shape[1] == 36  # window-major, padded
        ys = []
        with torch.no_grad():
            for t in range(3):
                y, state, _ = block(ctx, state, xs[t], mode="flush" if t == 0 else "incremental")
                ys.append(y)
        outs[training] = torch.stack(ys)
    np.testing.assert_allclose(outs[True].numpy(), outs[False].numpy(), rtol=1e-5, atol=1e-5)


def test_drop_path_block_under_training():
    """``drop_path_rate`` in a dense block: under training a batch row
    whose two residual branches are both dropped comes out as it went in
    (a quarter of the rows at rate 0.5), the others do not; at inference
    drop-path is the identity (no row comes out unchanged)."""
    block = Block(dim=32, heads=4, mlp_ratio=2, input_size=(4, 5), drop_path_rate=0.5)
    for module in block.modules():
        if hasattr(module, "reset_parameters"):
            module.reset_parameters(torch.Generator().manual_seed(11))
    x = torch.randn(64, 20, 32, generator=torch.Generator().manual_seed(12))
    with torch.no_grad():
        infer, _, _ = block(Ctx(), {}, x)
        train, _, _ = block(Ctx(training=True, generator=torch.Generator().manual_seed(13)), {}, x)
    unchanged = (train == x).all(dim=-1).all(dim=-1)
    assert 0 < int(unchanged.sum()) < 32
    assert not (infer == x).all(dim=-1).all(dim=-1).any()
    with pytest.raises(ValueError, match="drop_path_rate"):
        Block(dim=32, heads=4, mlp_ratio=2, input_size=(4, 5), drop_path_rate=1.5)
