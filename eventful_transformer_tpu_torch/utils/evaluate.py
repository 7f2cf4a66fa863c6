"""The evaluation harness: policy sweeps with CSV and tee'd text output
(port of ``eventful_transformer_tpu/utils/evaluate.py`` and of
``evaluate_vitdet_metrics`` in ``scripts/evaluate/vitdet_vid.py``).

``run_evaluations`` builds the model from ``config["model"]`` (on the card
unless ``model.device`` names another device), loads the weights, and runs
``evaluate_function(model, data, config)`` once per entry of the sweep:
``vanilla``, ``token_top_k``, ``token_top_fraction`` and
``token_thresholds``, each after ``set_policies``. The steps run under
``torch.no_grad()``.

On the card the step builders capture their step as a CUDA graph
(``utils/graphs.py``), as the JAX builders jit theirs: ViViT's whole
``apply_views`` (one graph per capacity of a bucketed threshold entry),
ViTDet's whole frame (``ViTDet.frame_step``: the preprocessing, the
backbone and the head, one graph for the flush frame and one for the
incremental frames, and per capacity of a bucketed threshold entry). A
policy change gives a new key, so one model still serves every entry.
``graph=False`` gives the eager step; on a CPU model the step is eager and
``graph=True`` raises.

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
from eventful_transformer_tpu_torch.utils.graphs import GraphStep, model_step, use_graph
from eventful_transformer_tpu_torch.utils.misc import (
    TopKAccuracy,
    set_policies,
    tee_print,
    token_gates,
)
from eventful_transformer_tpu_torch.utils.params import params_from_jax


def progress(iterable):
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


def make_vivit_step(model, count_mode=True, graph=None):
    """views (1, n_views, t, c, h, w) -> (probabilities, counts): the
    model's ``apply_views``, captured on the card (``graph`` as in
    ``utils/graphs.py::use_graph``), its state built inside the step each
    call as the JAX step builds it. The graph step is the step's
    ``graph`` (None when eager)."""
    run = model_step(model, model.apply_views, graph=graph, count_mode=count_mode,
                     name="vivit step")

    @torch.no_grad()
    def step(views):
        return run(views)

    step.graph = run if isinstance(run, GraphStep) else None
    return step


def make_bucketed_vivit_step(model, config, graph=None):
    """The capacity-bucketed step of a threshold sweep entry with
    ``bucket_capacities`` (per video: an escalation re-runs the whole
    video, exact since each call builds its own state); None for any other
    entry. The dispatcher is the step's ``dispatcher``. On the card each
    capacity has its own graph; the dispatcher reads the counts between
    runs, outside the graphs, as the JAX dispatcher does."""
    policy = _threshold_buckets(model, config)
    if policy is None:
        return None
    graph = use_graph(model, graph)

    def build_step(_capacity=None):
        plain = make_vivit_step(model, graph=graph)

        def step(state, views):
            out, counts = plain(views)
            return out, state, counts

        step.graph = plain.graph
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
    step = make_bucketed_vivit_step(model, config) or make_vivit_step(model)
    n_items = min(config.get("n_items") or len(data), len(data))
    return vivit_metrics(vivit_item_results(model, data, range(n_items), step))


def vivit_item_results(model, data, indices, step):
    """[(probabilities (1, classes) float32, label, counts)] of the videos
    at ``indices`` of ``data``, in order, each through ``step``."""
    results = []
    for i in progress(indices):
        video, label = data[i]
        output, counts = step(vivit_views(model, video))
        results.append((output.float().cpu().numpy(), np.asarray(label), counts))
    return results


def vivit_metrics(results):
    """The metrics and mean counts of :func:`vivit_item_results`' list."""
    top_1 = TopKAccuracy(k=1)
    top_5 = TopKAccuracy(k=5)
    total_counts = Counts()
    for output, label, counts in results:
        top_1.update(output, label)
        top_5.update(output, label)
        total_counts = total_counts + counts
    metrics = {"top_1": top_1.compute(), "top_5": top_5.compute()}
    return {"metrics": metrics, "counts": (total_counts / len(results)).nonzero()}


def make_vitdet_step(model, graph=None, keep_tokens=False):
    """(state, frame, content_hw, first) -> (detections, state, counts):
    frame 0 of a video flushes (``mode="flush"``), the rest run
    incrementally. On the card (``graph`` as in
    ``utils/graphs.py::use_graph``) the whole frame replays its graph
    (``ViTDet.frame_step``: the state it returns is the step's static
    state, overwritten by the next frame); a call reads the host once, for
    the counts. ``content_hw``: an int32 (2,) tensor on the model's device,
    or (h, w), or None for a frame with no padding; a tuple or None is made
    a tensor here, outside the graph. ``keep_tokens``: the detections dict
    also holds the backbone's tokens. The frame step is the step's
    ``graph`` (None when eager)."""
    frame_step = model.frame_step(graph=graph, keep_tokens=keep_tokens)
    p = _parameter(model)
    full = torch.tensor(model.input_shape[1:], dtype=torch.int32).to(p.device)

    @torch.no_grad()
    def step(state, frame, content_hw, first):
        if content_hw is None:
            content_hw = full
        elif not isinstance(content_hw, torch.Tensor):
            content_hw = torch.tensor(tuple(content_hw), dtype=torch.int32).to(p.device)
        return frame_step(state, frame, content_hw, mode="flush" if first else "incremental")

    step.graph = frame_step if isinstance(frame_step, GraphStep) else None
    return step


def evaluate_vitdet_metrics(model, data, config, dispatchers=None, graph=None):
    """COCO mAP over all frames and the mean counts per frame over a VID
    dataset; each video starts from a fresh state. Frames are padded on the
    host to the model's input shape and carry their content size, which the
    model re-zeroes after normalising. A threshold entry with
    ``bucket_capacities`` dispatches each frame through
    ``BucketedThresholdStep``, which is appended to the list
    ``dispatchers`` where one is given (for its escalations and frames per
    level). ``graph`` as in :func:`make_vitdet_step`."""
    step = make_vitdet_eval_step(model, config, dispatchers, graph)
    n_items = min(config.get("n_items") or len(data), len(data))
    return vitdet_metrics(vitdet_item_results(model, data, range(n_items), step))


def make_vitdet_eval_step(model, config, dispatchers=None, graph=None):
    """The step of :func:`evaluate_vitdet_metrics`, with ``reset()`` to
    call at each video's start: the bucketed dispatch for a threshold entry
    with ``bucket_capacities`` (appended to ``dispatchers``), else
    :func:`make_vitdet_step`'s; ``graph`` as there."""
    policy = _threshold_buckets(model, config)
    if policy is None:
        step = make_vitdet_step(model, graph=graph)
        step.reset = lambda: None
        return step
    # one frame step for every capacity: on the card each capacity (in the
    # step's key) gets its own graphs, and all share one static state
    frame_step = make_vitdet_step(model, graph=graph)
    step = BucketedThresholdStep(model, lambda _capacity=None: frame_step, policy.threshold,
                                 config["bucket_capacities"])
    if dispatchers is not None:
        dispatchers.append(step)
    return step


def vitdet_item_results(model, data, indices, step):
    """Per video at ``indices`` of ``data``, in order, its frames'
    [(detections kept, as numpy, annotations, counts)], each video from a
    fresh state through ``step`` (``(state, frame, content_hw, first) ->
    (detections, state, counts)``, ``reset()`` at the video's start)."""
    c, in_h, in_w = model.input_shape
    p = _parameter(model)
    results = []
    for i in indices:
        vid_item = data[i]
        state = model.init_state(1, p.dtype, p.device)
        step.reset()
        frames = []
        for t in range(len(vid_item)):
            frame, annotations = vid_item[t]
            frame = np.asarray(frame, np.float32)
            padded = np.zeros((1, c, in_h, in_w), np.float32)
            padded[0, :, : frame.shape[-2], : frame.shape[-1]] = frame
            # on the card before the step: a captured step takes CUDA tensors
            content_hw = torch.tensor(frame.shape[-2:], dtype=torch.int32).to(p.device)
            padded = torch.from_numpy(padded).to(device=p.device, dtype=p.dtype)
            out, state, counts = step(state, padded, content_hw, t == 0)
            mask = out["mask"].cpu().numpy()
            kept = {
                "boxes": out["boxes"].float().cpu().numpy()[mask],
                "scores": out["scores"].float().cpu().numpy()[mask],
                "labels": out["labels"].cpu().numpy()[mask],
            }
            frames.append((kept, annotations, counts))
        results.append(frames)
    return results


def vitdet_metrics(results):
    """The mAP and mean counts per frame of :func:`vitdet_item_results`'
    list."""
    mean_ap = MeanAveragePrecision()
    total_counts = Counts()
    n_frames = 0
    for frames in results:
        for kept, annotations, counts in frames:
            mean_ap.update([kept], [annotations])
            total_counts = total_counts + counts
            n_frames += 1
    metrics = mean_ap.compute()
    return {"metrics": metrics, "counts": (total_counts / max(n_frames, 1)).nonzero()}


def run_evaluations(config, model_class, data, evaluate_function, write=True):
    """The policy sweep, with the text of each entry tee'd into
    ``<_output>/output.txt`` and its result dicts appended to
    ``<_output>/<key>.csv``. With ``resume``, the entries already in
    metrics.csv are skipped. Returns the titles of the entries done.
    ``write=False`` (every rank of a multi-process run but the first)
    evaluates every entry and writes and prints nothing."""
    model = model_class(**{"seed": config.get("seed", 0), **config["model"]})
    load_model_params(model, config)

    completed = []
    output_dir = Path(config["_output"])
    if write:
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
        if not write:
            evaluate_function(model, data, config)
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


def load_model_params(model, config):
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
