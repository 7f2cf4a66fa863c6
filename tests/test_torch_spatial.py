"""The spatial cache in the port against the JAX package, on the same
weights (one ``.npz`` written by the JAX package's ``save_params``) and
inputs, in float32:

- ``FactorizedViViT`` with ``spatial_only`` (the features), ``temporal_only``
  (probabilities from given features) and ``batch_views=False`` (the views
  one at a time): at 1e-5 scaled, counts at rtol 1e-6;
- ``compute_vivit_spatial``'s files against the JAX function's (1e-5
  scaled, labels equal), each package's ``ViViTSpatial`` reading the
  other's files;
- the ``temporal_only`` model over the cache against the full model's
  ``apply`` on the same clips (the same operations on the CPU: 1e-6);
- the spatial entry points' ``main`` on the CPU (``model.device=cpu``,
  generated clips, small dotlist overrides), run from a directory whose
  ``configs`` is the repo's.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.core.counting import Counts, Ctx as JaxCtx
from eventful_transformer_tpu.core.policies import TokenNormTopK as JaxTopK
from eventful_transformer_tpu.data import SyntheticVideoClassification as JaxSynthetic
from eventful_transformer_tpu.data.vivit_spatial import ViViTSpatial as JaxViViTSpatial
from eventful_transformer_tpu.models import FactorizedViViT as JaxViViT
from eventful_transformer_tpu.utils.misc import set_policies as jax_set_policies
from eventful_transformer_tpu.utils.params import load_params, save_params
from eventful_transformer_tpu.utils.spatial import compute_vivit_spatial as jax_compute_spatial
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
from eventful_transformer_tpu_torch.data.synthetic import SyntheticVideoClassification
from eventful_transformer_tpu_torch.data.vivit_spatial import ViViTSpatial
from eventful_transformer_tpu_torch.models import FactorizedViViT
from eventful_transformer_tpu_torch.utils.misc import set_policies
from eventful_transformer_tpu_torch.utils.params import params_from_jax
from eventful_transformer_tpu_torch.utils.spatial import compute_vivit_spatial

REPO = Path(__file__).resolve().parent.parent
TOL, K = 1e-5, 9
SYNTHETIC = dict(n_items=2, n_frames=10, size=[36, 40], classes=10, seed=3)


def _config(**flags):
    """A small ViViT of EventfulBlocks (the spatial cache configurations'
    block class), 2 spatial x 2 temporal views of 8 frames."""
    block = dict(dim=32, heads=4, mlp_ratio=2)
    return dict(
        classes=10, input_shape=[8, 3, 32, 32], normalize_mean=0.45, normalize_std=0.225,
        spatial_views=2, temporal_stride=1, temporal_views=2, tubelet_shape=[2, 8, 8],
        spatial_config=dict(depth=2, position_encoding_size=[4, 4], block_class="EventfulBlock",
                            block_config=block),
        temporal_config=dict(depth=1, position_encoding_size=[4], block_config=block),
        **flags,
    )


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture
def weights(tmp_path):
    path = tmp_path / "weights.npz"
    like = JaxViViT(**_config()).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    save_params(path, jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.05 * rng.standard_normal(v.shape).astype(np.float32), like))
    return path


def _scaled_close(port, ref, tol=TOL):
    port = port.detach().float().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(port, ref, rtol=0, atol=tol * scale)


def _close_counts(port_counts, jax_ctx):
    ref = Counts.from_device(jax_ctx.counts)
    assert set(port_counts) == set(ref)
    for key in ref:
        np.testing.assert_allclose(port_counts[key], ref[key], rtol=1e-6, err_msg=key)


def _pair(weights, **flags):
    jax_model = JaxViViT(**_config(**flags))
    jax_model.split_flush = True
    model = params_from_jax(FactorizedViViT(**_config(**flags), device="cpu"), weights)
    jax_set_policies(jax_model, JaxTopK, k=K)
    set_policies(model, TokenNormTopK, k=K)
    return jax_model, load_params(weights, like=jax_model.init(jax.random.PRNGKey(0))), model


def _views(seed=5):
    return np.random.default_rng(seed).standard_normal((2, 4, 8, 3, 32, 32)).astype(np.float32)


@pytest.mark.parametrize("flags", [dict(spatial_only=True), dict(batch_views=False),
                                   dict(spatial_only=True, batch_views=False)],
                         ids=["spatial_only", "per_view", "spatial_only_per_view"])
def test_apply_views_matches_jax(weights, flags, monkeypatch):
    monkeypatch.setenv("EVT_UNROLL_BLOCKS", "1")
    jax_model, params, model = _pair(weights, **flags)
    views = _views()
    jax_ctx, ctx = JaxCtx(count_mode=True), Ctx(count_mode=True)
    ref = jax_model.apply_views(jax_ctx, params, jnp.asarray(views))
    got = model.apply_views(ctx, torch.from_numpy(views))
    want_shape = (8, 4, 32) if flags.get("spatial_only") else (2, 10)
    assert tuple(got.shape) == want_shape == ref.shape
    _scaled_close(got, ref)
    _close_counts(ctx.counts, jax_ctx)


def test_temporal_only_matches_jax(weights):
    jax_model, params, model = _pair(weights, temporal_only=True)
    features = np.random.default_rng(6).standard_normal((2, 4, 4, 32)).astype(np.float32)
    jax_ctx, ctx = JaxCtx(count_mode=True), Ctx(count_mode=True)
    ref = jax_model.apply(jax_ctx, params, features)
    got = model.apply(ctx, torch.from_numpy(features))
    assert got.shape == (2, 10)
    _scaled_close(got, ref)
    _close_counts(ctx.counts, jax_ctx)


def test_the_flags_are_attributes_a_caller_flips(weights):
    """One model, its flags flipped between calls (as the timing entry
    point does), gives the full model's probabilities."""
    _, _, model = _pair(weights)
    views = torch.from_numpy(_views())
    full = model.apply_views(Ctx(), views)
    model.spatial_only = True
    features = model.apply_views(Ctx(), views)
    model.spatial_only, model.temporal_only = False, True
    probs = model.apply(Ctx(), features.reshape(2, 4, 4, 32))
    torch.testing.assert_close(probs, full, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="not both"):
        FactorizedViViT(**_config(spatial_only=True, temporal_only=True), device="cpu")


def test_compute_vivit_spatial_files_match_jax(weights, tmp_path):
    config = dict(model=_config(spatial_only=True), k=K, weights=str(weights))
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_compute_spatial(config, jax_dir, JaxSynthetic(**SYNTHETIC))
    model_config = dict(config, model=dict(config["model"], device="cpu"))
    compute_vivit_spatial(model_config, port_dir, SyntheticVideoClassification(**SYNTHETIC))
    names = sorted(p.name for p in jax_dir.glob("*.npz"))
    assert names == sorted(p.name for p in port_dir.glob("*.npz")) == ["00000.npz", "00001.npz"]
    # each package's reader over the other's files
    for reader, directory, other in ((JaxViViTSpatial, port_dir, jax_dir),
                                     (ViViTSpatial, jax_dir, port_dir)):
        data, want = reader(directory), ViViTSpatial(other)
        assert len(data) == len(want) == 2
        for i in range(2):
            (spatial, label), (spatial_want, label_want) = data[i], want[i]
            assert spatial.dtype == spatial_want.dtype == np.float32
            assert spatial.shape == (4, 4, 32) and label == label_want
            _scaled_close(spatial, spatial_want)
    with pytest.raises(FileNotFoundError):
        ViViTSpatial(tmp_path / "none")


def test_temporal_only_over_the_cache_equals_full_apply(weights, tmp_path):
    config = dict(model=_config(spatial_only=True, device="cpu"), k=K, weights=str(weights))
    data = SyntheticVideoClassification(**SYNTHETIC)
    compute_vivit_spatial(config, tmp_path / "train" / f"spatial_{K}", data)
    cache = ViViTSpatial(tmp_path, split="train", k=K)
    full = params_from_jax(FactorizedViViT(**_config(), device="cpu"), weights)
    temporal = params_from_jax(FactorizedViViT(**_config(temporal_only=True), device="cpu"),
                               weights)
    for model in (full, temporal):
        set_policies(model, TokenNormTopK, k=K)
    for i in range(len(data)):
        video, label = data[i]
        spatial, cached_label = cache[i]
        assert cached_label == label
        want = full.apply(Ctx(), torch.from_numpy(video)[None])
        got = temporal.apply(Ctx(), torch.from_numpy(spatial)[None])
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_compute_vivit_spatial_requires_spatial_only(tmp_path):
    with pytest.raises(ValueError, match="spatial_only"):
        compute_vivit_spatial(dict(model=_config(device="cpu"), k=K), tmp_path,
                              SyntheticVideoClassification(**SYNTHETIC))


# small overrides of the spatial configurations: the tiny model above
SMALL = [
    "model.device=cpu", "model.input_shape=[8,3,32,32]", "model.tubelet_shape=[2,8,8]",
    "model.spatial_views=1", "model.temporal_views=2", "model.classes=10",
    "model.spatial_config.depth=1", "model.spatial_config.position_encoding_size=[4,4]",
    "model.spatial_config.block_config.dim=32", "model.spatial_config.block_config.heads=4",
    "model.temporal_config.depth=1", "model.temporal_config.position_encoding_size=[4]",
    "model.temporal_config.block_config.dim=32", "model.temporal_config.block_config.heads=4",
    "synthetic={n_items: 2, n_frames: 10, size: [36, 40], classes: 10, seed: 0}",
]


@pytest.fixture
def run_dir(tmp_path, monkeypatch):
    """A directory with the repo's configs and no weights or data, as the
    entry points' working directory."""
    (tmp_path / "configs").symlink_to(REPO / "configs", target_is_directory=True)
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.mark.parametrize("entry,name,splits", [
    ("vivit_kinetics400", "24", ["train_40/spatial_224_25_24", "val/spatial_224_25_24"]),
    ("vivit_epic_kitchens", "50", ["train/spatial_50", "validation/spatial_50"]),
])
def test_spatial_entry_points_on_cpu(run_dir, entry, name, splits, capsys):
    import importlib

    module = importlib.import_module(f"eventful_transformer_tpu_torch.scripts.spatial.{entry}")
    outputs = module.main([name, *SMALL])
    location = "kinetics400" if "kinetics" in entry else "epic_kitchens"
    assert [str(p) for p in outputs] == [f"data/{location}/{s}" for s in splits]
    for path in outputs:
        data = ViViTSpatial(run_dir / path)
        assert len(data) == 2
        spatial, label = data[0]
        assert spatial.shape == (2, 4, 32) and spatial.dtype == np.float32
        assert np.isfinite(spatial).all() and 0 <= label < 10
    out = capsys.readouterr().out
    assert "WARNING: weights file" in out and f"k={name}" in out


def test_spatial_entry_point_needs_the_card_by_default(run_dir):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run would take it")
    from eventful_transformer_tpu_torch.scripts.spatial import vivit_kinetics400

    with pytest.raises(RuntimeError, match="no CUDA device"):
        vivit_kinetics400.main(["24", *[o for o in SMALL if not o.startswith("model.device")]])
