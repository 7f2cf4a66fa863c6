"""The evaluation harness: policy sweeps with CSV and tee'd text output
(port of ``eventful_transformer_tpu/utils/evaluate.py`` and of
``evaluate_vitdet_metrics`` in ``scripts/evaluate/vitdet_vid.py``).

``run_evaluations`` builds the model from ``config["model"]`` (on the card
unless ``model.device`` names another device), loads the weights, and runs
``evaluate_function(model, data, config)`` once per entry of the sweep:
``vanilla``, ``token_top_k``, ``token_top_fraction`` and
``token_thresholds``, each after ``set_policies``. The port reads a
policy's capacity when a step runs, so one model serves every entry; the
steps are plain callables under ``torch.no_grad()``.

A threshold entry with ``bucket_capacities`` runs through
``utils/bucketing.py::BucketedThresholdStep``: per video for ViViT (each
``apply_views`` call builds its own state) and per frame for ViTDet.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from eventful_transformer_tpu_torch.core.counting import (
    Counts,
    Ctx,
    dict_csv_header,
    dict_csv_line,
    dict_string,
)
from eventful_transformer_tpu_torch.core.policies import (
    TokenNormThreshold,
    TokenNormTopFraction,
    TokenNormTopK,
)
from eventful_transformer_tpu_torch.detection.map_metric import MeanAveragePrecision
from eventful_transformer_tpu_torch.utils.bucketing import BucketedThresholdStep
from eventful_transformer_tpu_torch.utils.misc import (
    TopKAccuracy,
    set_policies,
    tee_print,
    token_gates,
)
from eventful_transformer_tpu_torch.utils.params import params_from_jax


def _progress(iterable):
    try:
        from tqdm import tqdm

        return tqdm(iterable, ncols=0)
    except ImportError:
        return iterable


def _parameter(model):
    return next(model.parameters())


def get_device_description(model):
    """The device the model runs on, as the JAX package words it:
    ``gpu:<card name> x<cards>`` or ``cpu:cpu x1``."""
    device = _parameter(model).device
    if device.type == "cuda":
        return f"gpu:{torch.cuda.get_device_name(device)} x{torch.cuda.device_count()}"
    return f"{device.type}:{device.type} x1"


def _threshold_buckets(model, config):
    """The threshold policy the gates hold, when ``bucket_capacities``
    routes it through the bucketed dispatch; else None."""
    gates = token_gates(model)
    policy = gates[0].policy if gates else None
    if config.get("bucket_capacities") and isinstance(policy, TokenNormThreshold):
        return policy
    return None


def make_vivit_step(model, count_mode=True):
    """views (1, n_views, t, c, h, w) -> (probabilities, counts)."""

    @torch.no_grad()
    def step(views):
        ctx = Ctx(count_mode=count_mode)
        out = model.apply_views(ctx, views)
        return out, ctx.counts

    return step


def make_bucketed_vivit_step(model, config):
    """The capacity-bucketed step of a threshold sweep entry with
    ``bucket_capacities`` (per video: an escalation re-runs the whole
    video, exact since each call builds its own state); None for any other
    entry. The dispatcher is the step's ``dispatcher``."""
    policy = _threshold_buckets(model, config)
    if policy is None:
        return None

    def build_step(_capacity=None):
        plain = make_vivit_step(model)

        def step(state, views):
            out, counts = plain(views)
            return out, state, counts

        return step

    dispatcher = BucketedThresholdStep(
        model, build_step, policy.threshold, config["bucket_capacities"]
    )

    def step(views):
        out, _, counts = dispatcher(None, views)
        return out, counts

    step.dispatcher = dispatcher
    return step


def vivit_views(model, video):
    """A (T, C, H, W) video as ViViT's views (1, n_views, t, c, h, w), made
    on the model's device and cast to its dtype."""
    p = _parameter(model)
    video = torch.as_tensor(np.asarray(video)[None]).to(p.device)
    return torch.stack(model.preprocessing(video), dim=1).to(p.dtype)


def evaluate_vivit_metrics(model, data, config):
    """Top-1 and top-5 accuracy and the mean counts per video over a video
    classification dataset; each video starts from a fresh state."""
    top_1 = TopKAccuracy(k=1)
    top_5 = TopKAccuracy(k=5)
    step = make_bucketed_vivit_step(model, config) or make_vivit_step(model)
    n_items = min(config.get("n_items") or len(data), len(data))
    total_counts = Counts()
    for i in _progress(range(n_items)):
        video, label = data[i]
        output, counts = step(vivit_views(model, video))
        output = output.float().cpu().numpy()
        top_1.update(output, np.asarray(label))
        top_5.update(output, np.asarray(label))
        total_counts = total_counts + counts
    metrics = {"top_1": top_1.compute(), "top_5": top_5.compute()}
    return {"metrics": metrics, "counts": (total_counts / n_items).nonzero()}


def make_vitdet_step(model):
    """(state, frame, content_hw, first) -> (detections, state, counts):
    frame 0 of a video flushes (``mode="flush"``), the rest run
    incrementally."""
    aux = model.precompute()

    @torch.no_grad()
    def step(state, frame, content_hw, first):
        ctx = Ctx(count_mode=True)
        out, state = model.apply(
            ctx, state, frame, aux=aux, content_hw=content_hw,
            mode="flush" if first else "incremental",
        )
        return out, state, ctx.counts

    return step


def evaluate_vitdet_metrics(model, data, config, dispatchers=None):
    """COCO mAP over all frames and the mean counts per frame over a VID
    dataset; each video starts from a fresh state. Frames are padded on the
    host to the model's input shape and carry their content size, which the
    model re-zeroes after normalising. A threshold entry with
    ``bucket_capacities`` dispatches each frame through
    ``BucketedThresholdStep``, which is appended to the list
    ``dispatchers`` where one is given (for its escalations and frames per
    level)."""
    mean_ap = MeanAveragePrecision()
    c, in_h, in_w = model.input_shape
    p = _parameter(model)
    policy = _threshold_buckets(model, config)
    if policy is not None:
        step = BucketedThresholdStep(
            model, lambda _capacity=None: make_vitdet_step(model), policy.threshold,
            config["bucket_capacities"],
        )
    else:
        step = make_vitdet_step(model)
        step.reset = lambda: None
    if policy is not None and dispatchers is not None:
        dispatchers.append(step)
    total_counts = Counts()
    n_frames = 0
    n_items = min(config.get("n_items") or len(data), len(data))
    for i in range(n_items):
        vid_item = data[i]
        state = model.init_state(1, p.dtype, p.device)
        step.reset()
        for t in range(len(vid_item)):
            frame, annotations = vid_item[t]
            frame = np.asarray(frame, np.float32)
            padded = np.zeros((1, c, in_h, in_w), np.float32)
            padded[0, :, : frame.shape[-2], : frame.shape[-1]] = frame
            content_hw = tuple(frame.shape[-2:])
            padded = torch.from_numpy(padded).to(device=p.device, dtype=p.dtype)
            out, state, counts = step(state, padded, content_hw, t == 0)
            mask = out["mask"].cpu().numpy()
            mean_ap.update(
                [{
                    "boxes": out["boxes"].float().cpu().numpy()[mask],
                    "scores": out["scores"].float().cpu().numpy()[mask],
                    "labels": out["labels"].cpu().numpy()[mask],
                }],
                [annotations],
            )
            total_counts = total_counts + counts
            n_frames += 1
    metrics = mean_ap.compute()
    return {"metrics": metrics, "counts": (total_counts / max(n_frames, 1)).nonzero()}


def run_evaluations(config, model_class, data, evaluate_function):
    """The policy sweep, with the text of each entry tee'd into
    ``<_output>/output.txt`` and its result dicts appended to
    ``<_output>/<key>.csv``. With ``resume``, the entries already in
    metrics.csv are skipped. Returns the titles of the entries done."""
    model = model_class(**{"seed": config.get("seed", 0), **config["model"]})
    _load_model_params(model, config)

    completed = []
    output_dir = Path(config["_output"])
    output_dir.mkdir(parents=True, exist_ok=True)
    skip = 0
    metrics_csv = output_dir / "metrics.csv"
    if config.get("resume") and metrics_csv.is_file():
        skip = max(len(metrics_csv.read_text().strip().splitlines()) - 1, 0)
        print(f"Resuming: skipping {skip} completed sweep entries", flush=True)

    def do_evaluation(title):
        nonlocal skip
        if skip > 0:
            skip -= 1
            completed.append(title)
            return
        with open(output_dir / "output.txt", "a") as tee_file:
            results = evaluate_function(model, data, config)
            tee_print(title, tee_file)
            tee_print(get_device_description(model), tee_file)
            if isinstance(results, dict):
                save_csv_results(
                    results, output_dir,
                    first_run=(len(completed) == 0 and not metrics_csv.is_file()),
                )
                for key, val in results.items():
                    tee_print(key.capitalize(), tee_file)
                    tee_print(dict_string(val), tee_file)
            else:
                tee_print(results, tee_file)
            tee_print("", tee_file)
            completed.append(title)

    if config.get("vanilla", False):
        do_evaluation("Vanilla")
    for k in config.get("token_top_k", []):
        set_policies(model, TokenNormTopK, k=k)
        do_evaluation(f"Token top k={k}")
    for fraction in config.get("token_top_fraction", []):
        set_policies(model, TokenNormTopFraction, fraction=fraction)
        do_evaluation(f"Token top {fraction * 100:.1f}%")
    for threshold in config.get("token_thresholds", []):
        capacity = config.get("threshold_capacity")
        set_policies(model, TokenNormThreshold, threshold=threshold, capacity=capacity)
        do_evaluation(f"Token threshold {threshold}")
    return completed


def _load_model_params(model, config):
    """The weights of ``config["weights"]``, a ``.npz`` of the JAX
    package's ``save_params``, into ``model``; where there is no such file,
    the model keeps the weights its seed made, with a warning if a file was
    named."""
    weights = config.get("weights")
    if weights and Path(weights).is_file():
        params_from_jax(model, weights)
    elif weights:
        print(f"WARNING: weights file {weights} not found; using random init")
    return model


def save_csv_results(results, output_dir, first_run=False):
    for key, val in results.items():
        with open(Path(output_dir) / f"{key}.csv", "a") as csv_file:
            if first_run:
                print(dict_csv_header(val), file=csv_file)
            print(dict_csv_line(val), file=csv_file)
