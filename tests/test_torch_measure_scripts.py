"""The port's two measurement scripts on the CPU:
``eventful_transformer_tpu_torch/scripts/misc/measure_vitdet_padding.py``
against the JAX script ``scripts/misc/measure_vitdet_padding.py`` on the
tmp VID fixture of tests/test_torch_harness.py, and
``measure_vivit_buckets.py`` at ``--device cpu`` on a tiny ViViT and two
capacities: its JSON lines, and each capacity's output against the JAX
forward of the same weights under ``TokenNormThreshold`` at that
capacity."""

import copy
import json
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.core.counting import Ctx as JaxCtx
from eventful_transformer_tpu.core.policies import TokenNormThreshold as JaxThreshold
from eventful_transformer_tpu.models import FactorizedViViT as JaxViViT
from eventful_transformer_tpu.utils.misc import set_policies as jax_set_policies
from eventful_transformer_tpu.utils.params import _flatten
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.scripts.misc import (
    measure_vitdet_padding,
    measure_vivit_buckets,
)
from eventful_transformer_tpu_torch.utils.params import params_from_jax

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from tests.test_torch_harness import _vid_layout  # noqa: E402

# a ViViT of 2 spatial blocks and 1 temporal block of 32 over 8 frames of
# 32 x 32 (17 spatial tokens), the script's 1 x 4 views
TINY = ["model.classes=16", "model.input_shape=[8, 3, 32, 32]", "model.tubelet_shape=[2, 8, 8]",
        "model.spatial_config.depth=2", "model.spatial_config.position_encoding_size=[4, 4]",
        "model.spatial_config.block_config={dim: 32, heads: 4, mlp_ratio: 4}",
        "model.temporal_config.depth=1", "model.temporal_config.position_encoding_size=[4]",
        "model.temporal_config.block_config={dim: 32, heads: 4, mlp_ratio: 4}"]
CAPACITIES = (4, 12)
THRESHOLD = 1.0
PROB_TOL = dict(rtol=1e-5, atol=1e-6)
JSON_KEYS = {"capacity", "dtype", "device", "card", "threshold", "clips", "views", "frames",
             "iters", "ms_per_clip", "ms_per_clip_min", "ms_per_clip_max", "spread",
             "clips_per_s", "max_memory_allocated"}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def test_padding_matches_jax_script(tmp_path, monkeypatch, capsys):
    _vid_layout(tmp_path / "data")
    monkeypatch.chdir(tmp_path)
    runpy.run_path(str(REPO / "scripts" / "misc" / "measure_vitdet_padding.py"),
                   run_name="__main__")
    want = capsys.readouterr().out.splitlines()
    shares = measure_vitdet_padding.main([])
    got = capsys.readouterr().out.splitlines()
    assert got[:-1] == want and len(want) == 2
    for line, size in zip(want, (672, 1024)):
        assert line.startswith(f"Size {size}: ")
        np.testing.assert_allclose(shares[size], float(line.split(": ")[1]), rtol=1e-4)
    assert json.loads(got[-1]) == {"split": "vid_val",
                                   "shares": {str(k): v for k, v in shares.items()}}
    # the fixture's frames are 24 x 32, resized to a short edge of 420 and 640
    assert 0 < shares[672] < 1 and 0 < shares[1024] < 1


def test_bucket_script_json_lines(capsys, monkeypatch):
    monkeypatch.chdir(REPO)
    rows = measure_vivit_buckets.main(
        ["--device", "cpu", "--capacities", *map(str, CAPACITIES), "--clips", "2", "--iters", "2",
         *TINY])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines == rows and [r["capacity"] for r in rows] == list(CAPACITIES)
    for row in rows:
        assert set(row) == JSON_KEYS
        assert (row["dtype"], row["device"], row["card"], row["max_memory_allocated"]) == (
            "float32", "cpu", None, None)
        assert (row["clips"], row["views"], row["frames"], row["iters"]) == (2, 4, 8, 2)
        assert 0 < row["ms_per_clip_min"] <= row["ms_per_clip"] <= row["ms_per_clip_max"]
        assert row["spread"] >= 0 and row["clips_per_s"] > 0


def test_bucket_model_matches_jax_at_each_capacity(monkeypatch):
    """The script's model (the config, its overrides, the threshold at each
    capacity) against the JAX forward of the same weights and policy; the
    two capacities select differently."""
    monkeypatch.chdir(REPO)
    kwargs = measure_vivit_buckets.model_config(TINY)
    jax_model = JaxViViT(**copy.deepcopy(kwargs))
    params = jax_model.init(jax.random.PRNGKey(0))
    flat = {k: np.array(v) for k, v in _flatten(params).items()}
    rng = np.random.default_rng(0)
    views = rng.standard_normal((2, 4, 8, 3, 32, 32)).astype(np.float32)
    outs = []
    for capacity in CAPACITIES:
        model = measure_vivit_buckets.bucket_model(capacity, THRESHOLD, TINY, device="cpu")
        params_from_jax(model, flat)
        with torch.no_grad():
            got = model.apply_views(Ctx(), torch.from_numpy(views)).numpy()
        jax_set_policies(jax_model, JaxThreshold, threshold=THRESHOLD, capacity=capacity)
        want = np.asarray(jax_model.apply_views(JaxCtx(), params, views))
        np.testing.assert_allclose(got, want, **PROB_TOL)
        outs.append(got)
    assert not np.allclose(outs[0], outs[1], rtol=0, atol=1e-6)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal on a host without GPUs")
def test_bucket_script_refuses_without_a_card():
    with pytest.raises(SystemExit, match="no CUDA device"):
        measure_vivit_buckets.main(["--capacities", "24"])
