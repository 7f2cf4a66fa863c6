"""ViTDet wall-clock timing on the card (port of
``scripts/time/vitdet_vid.py``; reference scripts/time/vitdet_vid.py):
per frame the ``pre_backbone``, ``apply_backbone`` and ``post_backbone``
segments, their means with and without each video's first (flush) frame.

    python -m eventful_transformer_tpu_torch.scripts.time.vitdet_vid \
        <config> [overrides]

run from the repo's root: ``<config>`` names a file of
``configs/time/vitdet_vid/``; VID is read from ``data/vid`` (unpacked from
``data/vid/data.tar`` at first use), or generated with a ``synthetic``
entry (the keywords of ``data/synthetic.py::SyntheticVID``), and resized
to ``input_size`` (``VIDResize``); ``model.device=cpu`` runs on the CPU.
The times go to ``<_output>/times.csv`` and ``output.txt``. The card is
synchronised before each clock read. On the card each segment is a
captured step, as the JAX script jits its three: ``pre`` (``pre_backbone``,
the frame and its content size in static buffers), ``mid``
(``ViTDet.backbone_step``: one CUDA graph for the flush frame and one for
the rest; a video's first frame also copies its fresh state into the
step's static state) and ``post`` (``post_backbone``, the head with the
NMS kernel of ``csrc/nms.cu``, which reads nothing back).
"""

from pathlib import Path

import numpy as np
import torch

from eventful_transformer_tpu_torch.data.synthetic import SyntheticVID
from eventful_transformer_tpu_torch.data.vid import VID, VIDResize
from eventful_transformer_tpu_torch.models.vitdet import ViTDet
from eventful_transformer_tpu_torch.utils.config import initialize_run
from eventful_transformer_tpu_torch.utils.evaluate import run_evaluations
from eventful_transformer_tpu_torch.utils.graphs import model_step
from eventful_transformer_tpu_torch.utils.misc import MeanValue
from eventful_transformer_tpu_torch.utils.timing import clock


def segment_steps(model, graph=None):
    """The three timed segments as steps (``utils/graphs.py::model_step``,
    captured on the card unless ``graph=False``), counting nothing: ``pre``
    (frame, content_hw) -> tokens, ``mid`` (state, tokens, mode=...) ->
    (tokens, state) (``ViTDet.backbone_step``) and ``post`` (tokens) ->
    detections."""
    pre = model_step(model, model.pre_backbone, graph=graph, count_mode=False,
                     name="vitdet pre step")
    mid = model.backbone_step(graph=graph, count_mode=False)
    post = model_step(model, model.post_backbone, graph=graph, count_mode=False,
                      name="vitdet post step")
    return pre, mid, post


def evaluate_vitdet_runtime(model, data, config):
    """{"times": {"backbone", "backbone_non_first", "other",
    "other_non_first", "total", "total_non_first"}}: mean seconds per
    frame; "other" is the pre- and post-backbone segments together."""
    c, in_h, in_w = model.input_shape
    p = next(model.parameters())
    pre, step, post = segment_steps(model)
    backbone = MeanValue()
    backbone_non_first = MeanValue()
    other = MeanValue()
    other_non_first = MeanValue()

    n_items = min(config.get("n_items") or len(data), len(data))
    for i in range(n_items):
        vid_item = data[i]
        state = model.init_state(1, p.dtype, p.device)
        for t in range(len(vid_item)):
            frame, _ = vid_item[t]
            frame = np.asarray(frame, np.float32)
            padded = np.zeros((1, c, in_h, in_w), np.float32)
            padded[0, :, : frame.shape[-2], : frame.shape[-1]] = frame
            content_hw = torch.tensor(frame.shape[-2:], dtype=torch.int32).to(p.device)
            padded = torch.from_numpy(padded).to(device=p.device, dtype=p.dtype)
            with torch.no_grad():
                t_0 = clock()
                tokens, _ = pre(padded, content_hw)
                t_1 = clock()
                tokens, state, _ = step(state, tokens, mode="flush" if t == 0 else "incremental")
                t_2 = clock()
                post(tokens)
                t_3 = clock()
            t_backbone = t_2 - t_1
            t_other = (t_3 - t_2) + (t_1 - t_0)
            backbone.update(t_backbone)
            other.update(t_other)
            if t > 0:
                backbone_non_first.update(t_backbone)
                other_non_first.update(t_other)
    times = {
        "backbone": backbone.compute(),
        "backbone_non_first": backbone_non_first.compute(),
        "other": other.compute(),
        "other_non_first": other_non_first.compute(),
        "total": backbone.compute() + other.compute(),
        "total_non_first": backbone_non_first.compute() + other_non_first.compute(),
    }
    return {"times": times}


def main(argv=None):
    config = initialize_run(config_location=Path("configs", "time", "vitdet_vid"), argv=argv)
    input_size = config.get("input_size", 1024)
    resize = VIDResize(short_edge_length=640 * input_size // 1024, max_size=input_size)
    if config.get("synthetic"):
        data = SyntheticVID(**dict(config["synthetic"]), combined_transform=resize)
    else:
        data = VID(
            Path("data", "vid"),
            split=config["split"],
            tar_path=Path("data", "vid", "data.tar"),
            combined_transform=resize,
        )
    return run_evaluations(config, ViTDet, data, evaluate_vitdet_runtime)


if __name__ == "__main__":
    main()
