"""The port's checkpoint converters (``scripts/convert/{vitdet,vivit}.py``,
``utils/params.py::convert_torch_state_dict``) against the JAX package's.

No published checkpoint is in the repo, so each test builds one: a tiny
JAX model's parameters, renamed to the detectron2 (ViTDet) or TAdaConv
(ViViT) names by the inverse of the pattern file's renames and put back in
torch's layouts (Linear (out, in), Conv (O, I, kh, kw), ConvTranspose
(I, O, kh, kw), the patch and tubelet embeddings as Conv2d/Conv3d weights,
LayerNorm ``weight``; ViTDet's ``pos_embed`` with a class-token row in
front). Both packages' converters then read it as ``.pth``/``.pyth`` and
``.pkl``: the two ``.npz`` files must hold the same keys and bitwise-equal
arrays, equal to the JAX model's parameters, and the port's and the JAX
package's models loaded from them compute the same forward."""

import pickle
import re
import subprocess
import sys
from argparse import Namespace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.core.counting import Ctx as JaxCtx
from eventful_transformer_tpu.models import FactorizedViViT as JaxViViT
from eventful_transformer_tpu.models.vitdet import ViTDet as JaxViTDet
from eventful_transformer_tpu.utils.params import _flatten, load_params as jax_load_params
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.models import FactorizedViViT, ViTDet
from eventful_transformer_tpu_torch.scripts.convert import vitdet as port_vitdet
from eventful_transformer_tpu_torch.scripts.convert import vivit as port_vivit
from eventful_transformer_tpu_torch.utils.misc import parse_patterns
from eventful_transformer_tpu_torch.utils.params import load_params

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from scripts.convert import vitdet as jax_vitdet  # noqa: E402
from scripts.convert import vivit as jax_vivit  # noqa: E402

TOL = 2e-5

VITDET = dict(
    classes=5, input_shape=[3, 64, 64], normalize_mean=[123.675, 116.28, 103.53],
    normalize_std=[58.395, 57.12, 57.375], output_channels=32, patch_size=[16, 16],
    scale_factors=[4.0, 2.0, 1.0, 0.5],
    backbone_config=dict(
        depth=2, position_encoding_size=[4, 4], window_indices=[0],
        block_config=dict(dim=48, heads=6, mlp_ratio=2, window_size=[2, 2],
                          relative_embedding_size=[4, 4]),
    ),
    rpn_config=dict(pre_nms_topk=200, post_nms_topk=50),
    roi_config=dict(test_topk_per_image=20),
)
VIVIT = dict(
    classes=10, input_shape=[8, 3, 32, 32], normalize_mean=0.45, normalize_std=0.225,
    spatial_views=1, temporal_stride=2, temporal_views=2, tubelet_shape=[2, 8, 8],
    spatial_config=dict(depth=2, position_encoding_size=[4, 4],
                        block_config=dict(dim=32, heads=4, mlp_ratio=2)),
    temporal_config=dict(depth=1, position_encoding_size=[4],
                         block_config=dict(dim=32, heads=4, mlp_ratio=2)),
)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _inverse_patterns(pattern_file):
    """The pattern file's renames backwards: (regex on a converted name,
    the checkpoint's name), in the file's order (a ``.norm.`` rename before
    the conv it belongs to); DISCARD renames have none."""
    inverse = []
    for regex, replacement in parse_patterns(pattern_file):
        if replacement == "DISCARD":
            continue
        source = regex.pattern
        whole = source.endswith("$")
        target = re.escape(replacement).replace(re.escape("\\1"), r"(\d+)")
        back = re.sub(r"\((\\d\*?|\\d)\)", r"\\1", source.strip("^$")).replace("\\.", ".")
        inverse.append((re.compile("^" + target + ("$" if whole else "")), back))
    return inverse


def _torch_layout(path, value, embedding_shape):
    """A JAX parameter as the torch checkpoint holds it: (name, array)."""
    *parts, leaf = path.split("/")
    if parts == ["embedding"] and leaf == "kernel":  # the patch / tubelet conv
        kernel = value.reshape(*embedding_shape, value.shape[-1])
        return "embedding.conv.weight", np.ascontiguousarray(np.moveaxis(kernel, -1, 0))
    if parts == ["embedding"]:
        return "embedding.conv.bias", value
    if leaf == "kernel" and value.ndim == 2:
        return ".".join(parts + ["weight"]), np.ascontiguousarray(value.T)
    if leaf == "kernel" and value.ndim == 4:
        return ".".join(parts + ["weight"]), np.ascontiguousarray(value.transpose(3, 2, 0, 1))
    if leaf == "scale":
        return ".".join(parts + ["weight"]), value
    return ".".join(parts + [leaf]), value


def _checkpoint(flat, pattern_file, embedding_shape):
    """{checkpoint name: array} whose conversion gives ``flat`` back."""
    inverse = _inverse_patterns(pattern_file)
    state = {}
    for path, value in flat.items():
        name, value = _torch_layout(path, np.asarray(value), embedding_shape)
        for regex, back in inverse:
            renamed, n = regex.subn(back, name)
            if n:
                name = renamed
                break
        else:
            raise AssertionError(f"no rename reaches {name}")
        state[name] = value
    return state


def _same_npz(ours, theirs, want):
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files) == sorted(want)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            assert np.array_equal(a[key], b[key]), key
            assert np.array_equal(a[key], np.asarray(want[key])), key


def _convert(port, jax_module, in_file, out_dir, pattern_file):
    ours, theirs = out_dir / "port.npz", out_dir / "jax.npz"
    port.main(port.parse_args([str(in_file), str(ours), str(pattern_file)]))
    jax_module.main(Namespace(in_file=str(in_file), out_file=str(theirs),
                              pattern_file=str(pattern_file), verbose=False))
    return ours, theirs


@pytest.fixture(scope="module")
def vitdet_weights():
    params = JaxViTDet(**VITDET).init(jax.random.PRNGKey(5))
    flat = {k: np.array(v) for k, v in _flatten(params).items()}
    state = _checkpoint(flat, REPO / "configs/convert/vitdet_b.txt", (3, 16, 16))
    encoding = state["backbone.net.pos_embed"]
    class_row = np.full((1, 1, encoding.shape[-1]), 7.0, np.float32)
    state["backbone.net.pos_embed"] = np.concatenate([class_row, encoding], axis=1)
    state["pixel_mean"] = np.zeros((3, 1, 1), np.float32)  # discarded
    return params, flat, state


@pytest.fixture(scope="module")
def vivit_weights():
    params = JaxViViT(**VIVIT).init(jax.random.PRNGKey(6))
    flat = {k: np.array(v) for k, v in _flatten(params).items()}
    state = _checkpoint(flat, REPO / "configs/convert/vivit_b.txt", (3, 2, 8, 8))
    state["head.linear2.weight"] = np.zeros((2, 2), np.float32)  # discarded
    return params, flat, state


@pytest.mark.parametrize("suffix", [".pth", ".pkl"])
def test_vitdet_converter_matches_jax(tmp_path, vitdet_weights, suffix):
    params, flat, state = vitdet_weights
    in_file = tmp_path / f"model_final{suffix}"
    if suffix == ".pkl":  # detectron2's pickles hold numpy arrays
        with open(in_file, "wb") as f:
            pickle.dump({"model": dict(state), "__author__": "test"}, f)
    else:
        torch.save({"model": {k: torch.from_numpy(v) for k, v in state.items()}}, in_file)
    ours, theirs = _convert(port_vitdet, jax_vitdet, in_file, tmp_path,
                            REPO / "configs/convert/vitdet_b.txt")
    _same_npz(ours, theirs, flat)


@pytest.mark.parametrize("suffix", [".pyth", ".pth"])
def test_vivit_converter_matches_jax(tmp_path, vivit_weights, suffix):
    params, flat, state = vivit_weights
    in_file = tmp_path / f"vivit{suffix}"
    torch.save({"model_state": {k: torch.from_numpy(v) for k, v in state.items()}}, in_file)
    ours, theirs = _convert(port_vivit, jax_vivit, in_file, tmp_path,
                            REPO / "configs/convert/vivit_b.txt")
    _same_npz(ours, theirs, flat)


def test_converted_vitdet_forward_matches_jax(tmp_path, vitdet_weights):
    """The converted ``.npz`` loaded by both packages: one frame through
    the (dense, windowed, rel-pos) backbone and the pyramid's input."""
    params, _, state = vitdet_weights
    in_file = tmp_path / "model_final.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in state.items()}}, in_file)
    out = tmp_path / "port.npz"
    port_vitdet.main(port_vitdet.parse_args([str(in_file), str(out),
                                             str(REPO / "configs/convert/vitdet_b.txt")]))
    jax_model = JaxViTDet(**VITDET)
    jax_params = jax_load_params(out, like=params)
    model = load_params(out, ViTDet(**VITDET, device="cpu"))
    frame = np.random.default_rng(2).uniform(0, 1, (1, 3, 64, 64)).astype(np.float32)
    ctx = JaxCtx()
    tokens = jax_model.pre_backbone(ctx, jax_params, jnp.asarray(frame))
    want, _ = jax_model.apply_backbone(ctx, jax_params, jax_model.init_state(1), tokens)
    with torch.no_grad():
        got = model.pre_backbone(Ctx(), torch.from_numpy(frame))
        got, _ = model.apply_backbone(Ctx(), model.init_state(1), got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_converted_vivit_forward_matches_jax(tmp_path, vivit_weights):
    params, _, state = vivit_weights
    in_file = tmp_path / "vivit.pyth"
    torch.save({"model_state": {k: torch.from_numpy(v) for k, v in state.items()}}, in_file)
    out = tmp_path / "port.npz"
    port_vivit.main(port_vivit.parse_args([str(in_file), str(out),
                                           str(REPO / "configs/convert/vivit_b.txt")]))
    jax_params = jax_load_params(out, like=params)
    model = load_params(out, FactorizedViViT(**VIVIT, device="cpu"))
    views = np.random.default_rng(3).standard_normal((1, 2, 8, 3, 32, 32)).astype(np.float32)
    want = JaxViViT(**VIVIT).apply_views(JaxCtx(), jax_params, jnp.asarray(views))
    with torch.no_grad():
        got = model.apply_views(Ctx(), torch.from_numpy(views))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=1e-6)


def test_converter_entry_point_runs_as_a_module(tmp_path, vivit_weights):
    """``python -m ...scripts.convert.vivit in out`` from the repo's root,
    with the default pattern file."""
    _, flat, state = vivit_weights
    in_file = tmp_path / "vivit.pyth"
    torch.save({"model_state": {k: torch.from_numpy(v) for k, v in state.items()}}, in_file)
    out = tmp_path / "cli.npz"
    proc = subprocess.run(
        [sys.executable, "-m", "eventful_transformer_tpu_torch.scripts.convert.vivit",
         str(in_file), str(out)], cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert f"Remapped {len(state)}/{len(state)} weights" in proc.stdout
    with np.load(out) as data:
        assert sorted(data.files) == sorted(flat)
