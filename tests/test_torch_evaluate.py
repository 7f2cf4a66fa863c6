"""The port's evaluation harness against the JAX package's: ``run_evaluations``
over a tiny ViViT of EventfulBlocks (top-k, top-fraction and threshold
sweeps, the threshold also through the capacity-bucketed dispatch) and over
a tiny eventful ViTDet with the port's ``evaluate_vitdet_metrics`` (the JAX
one is ``scripts/evaluate/vitdet_vid.py``'s). Both packages load one
``.npz`` written by the JAX package's ``save_params``; their metrics.csv
must be equal and their counts.csv equal within 1e-6 relative, and the
bucketed dispatch must escalate as the JAX package's does. The bucketed
threshold is also held exact against capacity = N, and the CLI entry point
is run as a user runs it, with ``model.device=cpu``."""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import eventful_transformer_tpu.utils.bucketing as jax_bucketing
from eventful_transformer_tpu.data import SyntheticVideoClassification
from eventful_transformer_tpu.models import FactorizedViViT as JaxViViT
from eventful_transformer_tpu.models.vitdet import ViTDet as JaxViTDet
from eventful_transformer_tpu.utils.evaluate import (
    evaluate_vivit_metrics as jax_evaluate_vivit,
    run_evaluations as jax_run_evaluations,
)
from eventful_transformer_tpu.utils.params import save_params
from eventful_transformer_tpu_torch.models import FactorizedViViT, ViTDet
from eventful_transformer_tpu_torch.utils.evaluate import (
    evaluate_vitdet_metrics,
    evaluate_vivit_metrics,
    get_device_description,
    run_evaluations,
)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from scripts.evaluate.vitdet_vid import evaluate_vitdet_metrics as jax_evaluate_vitdet  # noqa: E402

COUNTS_RTOL = 1e-6

VIVIT = dict(
    classes=10, input_shape=[8, 3, 32, 32], normalize_mean=0.45, normalize_std=0.225,
    spatial_views=2, temporal_stride=2, temporal_views=2, tubelet_shape=[2, 8, 8],
    spatial_config=dict(depth=2, position_encoding_size=[4, 4], block_class="EventfulBlock",
                        block_config=dict(dim=32, heads=4, mlp_ratio=2)),
    temporal_config=dict(depth=1, position_encoding_size=[4],
                         block_config=dict(dim=32, heads=4, mlp_ratio=2)),
)
VITDET = dict(
    classes=5, input_shape=[3, 64, 64], normalize_mean=[123.675, 116.28, 103.53],
    normalize_std=[58.395, 57.12, 57.375], output_channels=32, patch_size=[16, 16],
    scale_factors=[4.0, 2.0, 1.0, 0.5],
    backbone_config=dict(
        depth=2, position_encoding_size=[4, 4], window_indices=[0],
        block_class="EventfulBlock", windowed_class="EventfulTokenwiseBlock",
        block_config=dict(dim=48, heads=6, mlp_ratio=2, window_size=[2, 2]),
    ),
    rpn_config=dict(pre_nms_topk=200, post_nms_topk=50),
    roi_config=dict(test_topk_per_image=20),
)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


class _SyntheticVID:
    """Two videos of 3 and 4 slightly varying [0, 1] frames of 56 x 60 (the
    model pads them to 64 x 64), one ground-truth box each."""

    def __init__(self, seed=0):
        rng = np.random.default_rng(seed)
        self.videos = []
        for n_frames in (3, 4):
            base = rng.uniform(0.0, 1.0, (3, 56, 60)).astype(np.float32)
            ann = {"boxes": np.asarray([[4.0, 4.0, 40.0, 40.0]], np.float32),
                   "labels": np.asarray([1], np.int32)}
            frames = [np.clip(base + rng.normal(0, 0.02, base.shape), 0, 1).astype(np.float32)
                      for _ in range(n_frames)]
            self.videos.append([(f, ann) for f in frames])

    def __len__(self):
        return len(self.videos)

    def __getitem__(self, i):
        return self.videos[i]


def _annotated(data, weights):
    """``data`` with each frame's ground truth replaced by the three
    highest-scoring detections of the port's model on ``weights`` (top-k,
    k = 8), moved by a pixel, so that the mAP the sweep reads is not 0."""
    from eventful_transformer_tpu_torch.core.counting import Ctx
    from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
    from eventful_transformer_tpu_torch.utils.misc import set_policies
    from eventful_transformer_tpu_torch.utils.params import params_from_jax

    model = params_from_jax(ViTDet(**VITDET, device="cpu"), weights)
    set_policies(model, TokenNormTopK, k=8)
    for video in data.videos:
        state = model.init_state()
        for t, (frame, _) in enumerate(video):
            padded = torch.zeros((1, 3, 64, 64))
            padded[0, :, :56, :60] = torch.from_numpy(frame)
            with torch.no_grad():
                out, state = model.apply(Ctx(), state, padded, content_hw=(56, 60),
                                         mode="flush" if t == 0 else "incremental")
            top = torch.argsort(out["scores"], descending=True, stable=True)[:3]
            video[t] = (frame, {"boxes": (out["boxes"][top] + 1.0).numpy(),
                                "labels": out["labels"][top].numpy().astype(np.int32)})
    return data


def _weights(tmp_path, model):
    path = tmp_path / "weights.npz"
    save_params(path, model.init(jax.random.PRNGKey(3)))
    return str(path)


def _csv(path):
    lines = Path(path).read_text().strip().splitlines()
    return lines[0].split(","), [[float(v) for v in line.split(",")] for line in lines[1:]]


def _same_results(ours, ref):
    assert (ours / "metrics.csv").read_text() == (ref / "metrics.csv").read_text()
    header, rows = _csv(ours / "counts.csv")
    ref_header, ref_rows = _csv(ref / "counts.csv")
    assert header == ref_header
    np.testing.assert_allclose(rows, ref_rows, rtol=COUNTS_RTOL)


@pytest.fixture
def _record_jax_dispatchers(monkeypatch):
    made = []

    class Recording(jax_bucketing.BucketedThresholdStep):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(jax_bucketing, "BucketedThresholdStep", Recording)
    return made


def test_vivit_run_evaluations_matches_jax(tmp_path):
    data = SyntheticVideoClassification(n_items=2, n_frames=20, size=(40, 48))
    config = dict(
        weights=_weights(tmp_path, JaxViViT(**VIVIT)), token_top_k=[6],
        token_top_fraction=[0.5], token_thresholds=[1.0, 0.5], bucket_capacities=[4, 8, 17],
        n_items=2,
    )
    jax_run_evaluations(dict(config, model=VIVIT, _output=str(tmp_path / "jax")), JaxViViT,
                        data, jax_evaluate_vivit)
    done = run_evaluations(
        dict(config, model=dict(VIVIT, device="cpu"), _output=str(tmp_path / "port")),
        FactorizedViViT, data, evaluate_vivit_metrics,
    )
    assert done == ["Token top k=6", "Token top 50.0%", "Token threshold 1.0",
                    "Token threshold 0.5"]
    _same_results(tmp_path / "port", tmp_path / "jax")
    text = (tmp_path / "port" / "output.txt").read_text()
    assert "cpu:cpu x1" in text and "Token threshold 0.5" in text


def test_vivit_bucketed_threshold_is_exact(tmp_path):
    """The bucketed sweep gives the unbucketed full-capacity run's CSVs."""
    data = SyntheticVideoClassification(n_items=2, n_frames=20, size=(40, 48))
    base = dict(model=dict(VIVIT, device="cpu"), token_thresholds=[1.0], n_items=2)
    run_evaluations(dict(base, _output=str(tmp_path / "full")), FactorizedViViT, data,
                    evaluate_vivit_metrics)
    run_evaluations(dict(base, _output=str(tmp_path / "bucketed"), bucket_capacities=[4, 8, 17]),
                    FactorizedViViT, data, evaluate_vivit_metrics)
    for name in ("metrics.csv", "counts.csv"):
        assert (tmp_path / "full" / name).read_text() == (tmp_path / "bucketed" / name).read_text()


@pytest.mark.parametrize("thresholds", [[0.05], [0.2]])
def test_vitdet_run_evaluations_matches_jax(tmp_path, thresholds, _record_jax_dispatchers):
    weights = _weights(tmp_path, JaxViTDet(**VITDET))
    data = _annotated(_SyntheticVID(), weights)
    config = dict(weights=weights, token_top_k=[8], token_thresholds=thresholds,
                  bucket_capacities=[4, 8, 16], n_items=2)
    jax_run_evaluations(dict(config, model=VITDET, _output=str(tmp_path / "jax")), JaxViTDet,
                        data, jax_evaluate_vitdet)
    dispatchers = []
    run_evaluations(dict(config, model=dict(VITDET, device="cpu"), _output=str(tmp_path / "port")),
                    ViTDet, data, lambda m, d, c: evaluate_vitdet_metrics(m, d, c, dispatchers))
    _same_results(tmp_path / "port", tmp_path / "jax")
    _, maps = _csv(tmp_path / "port" / "metrics.csv")
    assert all(row[1] > 0 for row in maps)  # map
    (ours,), (ref,) = dispatchers, _record_jax_dispatchers
    assert ours.escalations == ref.escalations
    assert ours.frames_per_level == ref.frames_per_level
    assert sum(ours.frames_per_level) == 7


def test_vitdet_bucketed_threshold_is_exact(tmp_path):
    """Per-frame escalation from a copy of the state gives the capacity = N
    run's metrics and counts, and leaves no frame unsaturated below the
    top bucket with a truncated selection."""
    data = _SyntheticVID()
    model = ViTDet(**VITDET, device="cpu")
    from eventful_transformer_tpu_torch.core.policies import TokenNormThreshold
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    set_policies(model, TokenNormThreshold, threshold=0.05)
    dispatchers = []
    full = evaluate_vitdet_metrics(model, data, {"n_items": 2}, dispatchers)
    assert dispatchers == []
    bucketed = evaluate_vitdet_metrics(model, data, {"n_items": 2, "bucket_capacities": [4, 8, 16]},
                                       dispatchers)
    (dispatcher,) = dispatchers
    assert dispatcher.escalations > 0 and dispatcher.frames_per_level[0] > 0
    assert bucketed["metrics"] == full["metrics"]
    assert set(bucketed["counts"]) == set(full["counts"])
    for key, value in full["counts"].items():
        np.testing.assert_allclose(bucketed["counts"][key], value, rtol=COUNTS_RTOL, err_msg=key)


def test_resume_skips_completed_entries(tmp_path):
    data = SyntheticVideoClassification(n_items=1, n_frames=12, size=(32, 32))
    config = dict(model=dict(VIVIT, device="cpu"), token_top_k=[4, 6], n_items=1,
                  _output=str(tmp_path / "out"))
    run_evaluations(dict(config, token_top_k=[4]), FactorizedViViT, data, evaluate_vivit_metrics)
    done = run_evaluations(dict(config, resume=True), FactorizedViViT, data,
                           evaluate_vivit_metrics)
    assert done == ["Token top k=4", "Token top k=6"]
    assert len((tmp_path / "out" / "metrics.csv").read_text().strip().splitlines()) == 3
    assert get_device_description(FactorizedViViT(**VIVIT, device="cpu")) == "cpu:cpu x1"


def test_missing_weights_warns_and_keeps_seed(tmp_path, capsys):
    data = SyntheticVideoClassification(n_items=1, n_frames=12, size=(32, 32))
    config = dict(model=dict(VIVIT, device="cpu"), token_top_k=[4], n_items=1,
                  weights=str(tmp_path / "absent.npz"))
    for run in ("a", "b"):
        run_evaluations(dict(config, _output=str(tmp_path / run)), FactorizedViViT, data,
                        evaluate_vivit_metrics)
    assert "WARNING: weights file" in capsys.readouterr().out
    assert (tmp_path / "a" / "metrics.csv").read_text() == (tmp_path / "b" / "metrics.csv").read_text()


def _cli(*args, env_extra=None):
    return subprocess.run(
        [sys.executable, "-m", "eventful_transformer_tpu_torch.scripts.evaluate.vivit_kinetics400",
         *args], cwd=REPO, capture_output=True, text=True, timeout=600,
    )


def test_cli_entry_point_on_cpu(tmp_path, monkeypatch):
    """The entry point as a user runs it, against the same config run in
    process: the same CSVs."""
    out = _cli("synthetic_smoke", "model.device=cpu", "n_items=1", "synthetic.n_items=1",
               f"_output={tmp_path}/cli")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Token top k=16" in out.stdout
    from eventful_transformer_tpu_torch.scripts.evaluate import vivit_kinetics400

    monkeypatch.chdir(REPO)
    done = vivit_kinetics400.main(["synthetic_smoke", "model.device=cpu", "n_items=1",
                                   "synthetic.n_items=1", f"_output={tmp_path}/inproc"])
    assert done == ["Token top k=8", "Token top k=16"]
    for name in ("metrics.csv", "counts.csv"):
        assert (tmp_path / "cli" / name).read_text() == (tmp_path / "inproc" / name).read_text()
    assert (tmp_path / "cli" / "config.yml").is_file()


def test_cli_runs_on_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run would take it")
    out = _cli("synthetic_smoke", "n_items=1", f"_output={tmp_path}/cli")
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_cli_parallel_options_are_not_ported(tmp_path, monkeypatch):
    from eventful_transformer_tpu_torch.scripts.evaluate import vitdet_vid, vivit_kinetics400

    monkeypatch.chdir(REPO)
    with pytest.raises(NotImplementedError, match="open item 17"):
        vivit_kinetics400.main(["synthetic_smoke", "data_parallel=true",
                                f"_output={tmp_path}/a"])
    for option in ("data_parallel", "sequence_parallel"):
        with pytest.raises(NotImplementedError, match="open item 17"):
            vitdet_vid.main(["threshold_1024", f"{option}=true", f"_output={tmp_path}/b"])
