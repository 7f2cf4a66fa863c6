"""The port's harness modules against the JAX package's on the same inputs:
config composition of every file under configs/evaluate (the same dict),
the dotlist CLI, the metrics and small utilities of utils/misc.py, the
image helpers (float32, within 1e-5), the data readers on tiny on-disk
fixtures (the same items; VIDResize within 1e-5), and the COCO mAP (1e-6,
through the C++ matcher and through numpy)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from PIL import Image

import eventful_transformer_tpu.utils.config as jax_config
import eventful_transformer_tpu.utils.image as jax_image
import eventful_transformer_tpu.utils.misc as jax_misc
import eventful_transformer_tpu_torch.utils.config as config
import eventful_transformer_tpu_torch.utils.image as image
import eventful_transformer_tpu_torch.utils.misc as misc

REPO = Path(__file__).resolve().parent.parent
EVAL_CONFIGS = sorted(
    str(p.relative_to(REPO)) for p in (REPO / "configs" / "evaluate").rglob("*.yml")
)
IMAGE_TOL = 1e-5
MAP_TOL = 1e-6


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


# -- config ------------------------------------------------------------------------


@pytest.mark.parametrize("path", EVAL_CONFIGS)
def test_config_composes_as_jax(path):
    assert config.load_config(REPO / path, root=REPO) == jax_config.load_config(
        REPO / path, root=REPO
    )


@pytest.mark.parametrize("argv", [
    ["synthetic_smoke"],
    ["temporal_24", "model.device=cpu", "token_top_k=[8,16]", "n_items=1"],
    ["synthetic_smoke", "_name=x", "synthetic.n_items=1", "model.spatial_config.depth=1"],
])
def test_cli_config_as_jax(argv, monkeypatch):
    monkeypatch.chdir(REPO)
    location = Path("configs", "evaluate", "vivit_kinetics400")
    got = config.get_cli_config(config_location=location, argv=argv)
    assert got == jax_config.get_cli_config(config_location=location, argv=argv)
    assert got["_output"] == f"results/evaluate/vivit_kinetics400/{got['_name']}/"


def test_initialize_run_snapshots_config(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO)
    location = Path("configs", "evaluate", "vitdet_vid")
    got = config.initialize_run(location, argv=["threshold_1024", f"_output={tmp_path}/run"])
    assert got["token_thresholds"] == [0.2, 1.0, 5.0]
    assert got["bucket_capacities"] == [512, 1024, 2048, 4096]
    assert config.load_config(tmp_path / "run" / "config.yml") == got


# -- utils/misc.py -------------------------------------------------------------------


def test_topk_accuracy_as_jax():
    rng = np.random.default_rng(0)
    pred = rng.standard_normal((40, 11))
    true = rng.integers(0, 11, 40)
    for k in (1, 5):
        ours, ref = misc.TopKAccuracy(k), jax_misc.TopKAccuracy(k)
        for i in range(0, 40, 8):
            ours.update(pred[i : i + 8], true[i : i + 8])
            ref.update(pred[i : i + 8], true[i : i + 8])
        assert (ours.correct, ours.total) == (ref.correct, ref.total)
        assert ours.compute() == ref.compute()
        ours.reset()
        assert (ours.correct, ours.total) == (0, 0)


def test_mean_value_as_jax():
    ours, ref = misc.MeanValue(), jax_misc.MeanValue()
    assert ours.compute() == ref.compute() == 0.0
    for v in np.random.default_rng(1).standard_normal(50):
        ours.update(v)
        ref.update(v)
    assert ours.compute() == ref.compute()
    ours.reset()
    assert ours.compute() == 0.0


def test_seeded_shuffle_as_jax():
    for seed in (0, 42, 7):
        a, b = list(range(30)), list(range(30))
        misc.seeded_shuffle(a, seed)
        jax_misc.seeded_shuffle(b, seed)
        assert a == b != list(range(30))


def test_tee_print(tmp_path, capsys):
    with open(tmp_path / "log.txt", "w") as f:
        misc.tee_print("line", f)
    assert capsys.readouterr().out == "line\n"
    assert (tmp_path / "log.txt").read_text() == "line\n"


def test_patterns_and_remap_as_jax(tmp_path):
    (tmp_path / "p.txt").write_text(
        "# comment\n^blocks\\.(\\d+)\\.attn\nblocks.\\1.qkv\n\nhead.*\nDISCARD\n"
    )
    weights = {"blocks.0.attn": 1, "blocks.3.attn": 2, "head.fc": 3, "other": 4}
    patterns = misc.parse_patterns(tmp_path / "p.txt")
    assert [(r.pattern, s) for r, s in patterns] == [
        (r.pattern, s) for r, s in jax_misc.parse_patterns(tmp_path / "p.txt")
    ]
    assert misc.remap_weights(weights, patterns) == jax_misc.remap_weights(
        weights, jax_misc.parse_patterns(tmp_path / "p.txt")
    )


def test_token_gates_and_set_policies():
    from eventful_transformer_tpu_torch.core.blocks import EventfulBlock
    from eventful_transformer_tpu_torch.core.policies import TokenNormThreshold

    blk = EventfulBlock(dim=32, heads=4, input_size=(2, 3), mlp_ratio=2)
    gates = misc.token_gates(blk)
    assert len(gates) == 5  # qkv, projection, MLP, v and matmul gates
    misc.set_policies(blk, TokenNormThreshold, threshold=0.5, capacity=4)
    assert all(g.policy.threshold == 0.5 and g.policy.capacity(6) == 4 for g in gates)
    assert len({id(g.policy) for g in gates}) == 5


# -- utils/image.py ------------------------------------------------------------------


def _close(got, want, tol=IMAGE_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_image_helpers_as_jax():
    rng = np.random.default_rng(2)
    u8 = rng.integers(0, 255, (3, 24, 30), dtype=np.uint8)
    f = u8.astype(np.float32) / 255.0
    _close(image.as_float32(u8), jax_image.as_float32(u8))
    assert image.as_float32((255, 51)) == jax_image.as_float32((255, 51))
    assert np.array_equal(image.as_uint8(f * 1.1 - 0.05), jax_image.as_uint8(f * 1.1 - 0.05))
    _close(image.pad_to_size(f, (32, 40)), jax_image.pad_to_size(f, (32, 40)))
    _close(image.pad_to_size(f, (32, 40), 0.5), jax_image.pad_to_size(f, (32, 40), 0.5))
    fill = np.linspace(0, 1, 3, dtype=np.float32).reshape(3, 1, 1)
    _close(image.pad_to_size(f, (26, 31), fill), jax_image.pad_to_size(f, (26, 31), fill))
    with pytest.raises(ValueError):
        image.pad_to_size(f, (20, 40))
    for scale in (0.5, 1.0, 1.37, 2.0):
        _close(image.rescale(f, scale), jax_image.rescale(f, scale))
    _close(image.rescale(f, 0.6, antialias=False), jax_image.rescale(f, 0.6, antialias=False))
    _close(image.resize_to_fit(f, (40, 40)), jax_image.resize_to_fit(f, (40, 40)))


def test_write_image(tmp_path):
    rng = np.random.default_rng(3)
    frame = rng.integers(0, 255, (3, 8, 10), dtype=np.uint8)
    image.write_image(tmp_path / "a.png", frame)
    assert np.array_equal(np.moveaxis(np.asarray(Image.open(tmp_path / "a.png")), -1, 0), frame)


# -- data readers (fixtures as tests/test_datasets.py builds them) ----------------------


def _write_frames(directory, names, size=(24, 32)):
    directory.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    for name in names:
        arr = rng.integers(0, 255, (size[0], size[1], 3), dtype=np.uint8)
        Image.fromarray(arr).save(directory / name)


def _vid_layout(tmp_path):
    base = tmp_path / "vid"
    frames = base / "vid_val" / "frames" / "0000"
    _write_frames(frames, [f"{i:06d}.jpg" for i in (0, 1, 2, 5, 6)])
    _write_frames(base / "vid_val" / "frames" / "0001", [f"{i:06d}.jpg" for i in (0, 1)])
    images = [
        {"id": i, "file_name": f"VID_val_0000_{i:06d}.JPEG", "width": 32, "height": 24}
        for i in (0, 1, 2, 5, 6)
    ] + [
        {"id": 10 + i, "file_name": f"VID_val_0001_{i:06d}.JPEG", "width": 32, "height": 24}
        for i in (0, 1)
    ]
    annotations = [
        {"id": 0, "image_id": 0, "category_id": 3, "bbox": [2, 4, 10, 8]},
        {"id": 1, "image_id": 5, "category_id": 1, "bbox": [1, 1, 5, 5]},
        {"id": 2, "image_id": 11, "category_id": 30, "bbox": [3.5, 2, 7, 9.25]},
        {"id": 3, "image_id": 11, "category_id": 2, "bbox": [0, 0, 31, 23]},
    ]
    with open(base / "vid_val" / "labels.json", "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)
    (base / "unpacked").touch()
    return base


def _same_annotations(a, b):
    assert set(a) == set(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("shuffle", [False, True])
def test_vid_as_jax(tmp_path, shuffle):
    from eventful_transformer_tpu.data.vid import VID as JaxVID
    from eventful_transformer_tpu_torch.data.vid import VID

    base = _vid_layout(tmp_path)
    ours, ref = VID(base, shuffle=shuffle), JaxVID(base, shuffle=shuffle)
    assert len(ours) == len(ref) == 3
    for i in range(len(ref)):
        assert len(ours[i]) == len(ref[i])
        for t in range(len(ref[i])):
            (frame, ann), (ref_frame, ref_ann) = ours[i][t], ref[i][t]
            assert np.array_equal(frame, ref_frame)
            _same_annotations(ann, ref_ann)


@pytest.mark.parametrize("edges", [(48, 64), (16, 30), (24, 32)])
def test_vid_resize_as_jax(tmp_path, edges):
    from eventful_transformer_tpu.data.vid import VID as JaxVID, VIDResize as JaxVIDResize
    from eventful_transformer_tpu_torch.data.vid import VID, VIDResize

    base = _vid_layout(tmp_path)
    ours = VID(base, shuffle=False, combined_transform=VIDResize(*edges))
    ref = JaxVID(base, shuffle=False, combined_transform=JaxVIDResize(*edges))
    for i in range(len(ref)):
        for t in range(len(ref[i])):
            (frame, ann), (ref_frame, ref_ann) = ours[i][t], ref[i][t]
            assert isinstance(frame, np.ndarray) and frame.dtype == np.float32
            assert frame.shape == np.asarray(ref_frame).shape
            _close(frame, ref_frame)
            np.testing.assert_allclose(ann["boxes"], ref_ann["boxes"], rtol=IMAGE_TOL)
            np.testing.assert_array_equal(ann["labels"], ref_ann["labels"])


def test_epic_kitchens_as_jax(tmp_path):
    from eventful_transformer_tpu.data.epic_kitchens import EPICKitchens as JaxEPIC
    from eventful_transformer_tpu_torch.data.epic_kitchens import EPICKitchens

    base = tmp_path / "epic"
    (base / "validation").mkdir(parents=True)
    header = (
        "narration_id,participant_id,video_id,narration_timestamp,"
        "start_timestamp,stop_timestamp,start_frame,stop_frame,"
        "narration,verb,verb_class,noun,noun_class\n"
    )
    rows = [
        f"P01_01_{i},P01,P01_01,a,00:00:0{i}.00,00:00:0{i + 1}.00,0,10,x,v,{3 * i + 1},n,3\n"
        for i in range(3)
    ]
    (base / "EPIC_100_validation.csv").write_text(header + "".join(rows))
    for clip in range(3):
        _write_frames(base / "validation" / "frames" / f"{clip:05d}",
                      [f"{t:04d}.jpg" for t in range(1, 3 + clip)])
    (base / "validation" / "decoded").touch()
    for shuffle in (False, True):
        ours = EPICKitchens(base, split="validation", shuffle=shuffle)
        ref = JaxEPIC(base, split="validation", shuffle=shuffle)
        assert len(ours) == len(ref) == 3
        for i in range(3):
            (video, label), (ref_video, ref_label) = ours[i], ref[i]
            assert np.array_equal(video, ref_video) and label == ref_label


def test_kinetics400_as_jax(tmp_path):
    from eventful_transformer_tpu.data.kinetics400 import Kinetics400 as JaxK400
    from eventful_transformer_tpu_torch.data.kinetics400 import Kinetics400

    base = tmp_path / "k400" / "val"
    frames = base / "frames_224_25"
    base.mkdir(parents=True)
    (base / "labels.csv").write_text(
        "label,youtube_id,time_start,time_end,split\n"
        "zumba,abc,0,10,val\n"
        "abseiling,xyz,5,15,val\n"
        "yoga,klm,1,11,val\n"
    )
    for vid in ("abc_000000_000010", "xyz_000005_000015", "klm_000001_000011"):
        _write_frames(frames / vid, ["001.jpg", "002.jpg"])
    for stage in ("downloaded", "unpacked", "decoded_224_25"):
        (base / stage).touch()
    for shuffle in (False, True):
        kwargs = dict(split="val", decode_size=224, decode_fps=25, shuffle=shuffle)
        ours = Kinetics400(tmp_path / "k400", **kwargs)
        ref = JaxK400(tmp_path / "k400", **kwargs)
        assert len(ours) == len(ref) == 3
        for i in range(3):
            (video, label), (ref_video, ref_label) = ours[i], ref[i]
            assert np.array_equal(video, ref_video) and label == ref_label


def test_synthetic_as_jax():
    from eventful_transformer_tpu.data.synthetic import (
        SyntheticVideoClassification as JaxSynthetic,
    )
    from eventful_transformer_tpu_torch.data import SyntheticVideoClassification

    kwargs = dict(n_items=3, n_frames=10, size=(40, 48), classes=7, seed=5)
    ours, ref = SyntheticVideoClassification(**kwargs), JaxSynthetic(**kwargs)
    for i in range(3):
        (video, label), (ref_video, ref_label) = ours[i], ref[i]
        assert np.array_equal(video, ref_video) and label == ref_label
    with pytest.raises(IndexError):
        ours[3]


# -- COCO mAP --------------------------------------------------------------------------


def _detections(seed, n_images=12, classes=4):
    """Per-image predictions and targets: targets of random boxes and
    labels (some images without any), predictions near them (jittered,
    some of the wrong class, some spurious, with tied scores)."""
    rng = np.random.default_rng(seed)
    preds, targets = [], []
    for i in range(n_images):
        n_gt = int(rng.integers(0, 4)) if i % 5 else 0
        lt = rng.uniform(0, 50, (n_gt, 2))
        gt = np.concatenate([lt, lt + rng.uniform(5, 40, (n_gt, 2))], -1).astype(np.float32)
        labels = rng.integers(0, classes, n_gt).astype(np.int32)
        targets.append({"boxes": gt, "labels": labels})
        jitter = gt + rng.normal(0, 3, gt.shape).astype(np.float32)
        spurious_lt = rng.uniform(0, 60, (2, 2))
        spurious = np.concatenate([spurious_lt, spurious_lt + 10], -1).astype(np.float32)
        boxes = np.concatenate([jitter, spurious]).astype(np.float32)
        pred_labels = np.concatenate([labels, rng.integers(0, classes, 2)]).astype(np.int32)
        flip = rng.uniform(size=len(pred_labels)) < 0.15
        pred_labels[flip] = (pred_labels[flip] + 1) % classes
        scores = np.round(rng.uniform(0.05, 1.0, len(boxes)), 1).astype(np.float32)
        preds.append({"boxes": boxes, "scores": scores, "labels": pred_labels,
                      "mask": np.ones(len(boxes), bool)})
    return preds, targets


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_map_as_jax(seed, use_native):
    from eventful_transformer_tpu.detection.map_metric import (
        MeanAveragePrecision as JaxMeanAveragePrecision,
    )
    from eventful_transformer_tpu_torch.detection.map_metric import MeanAveragePrecision

    preds, targets = _detections(seed)
    ours = MeanAveragePrecision(use_native=use_native)
    ref = JaxMeanAveragePrecision(use_native=False)
    for i in range(0, len(preds), 3):
        ours.update(preds[i : i + 3], targets[i : i + 3])
        ref.update(preds[i : i + 3], targets[i : i + 3])
    got, want = ours.compute(), ref.compute()
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=MAP_TOL, atol=MAP_TOL, err_msg=key)
    assert 0.0 < got["map"] < 1.0


def test_map_native_builds_into_build_dir():
    from eventful_transformer_tpu_torch import native

    lib = native.load("map_matcher")
    if lib is None:
        pytest.skip("no g++ here: the numpy matcher runs instead")
    assert Path(lib._name).parent == REPO / "eventful_transformer_tpu_torch" / "_build"
