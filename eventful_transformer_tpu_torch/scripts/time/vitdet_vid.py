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
synchronised before each clock read. The backbone segment is the captured
step on the card (``ViTDet.backbone_step``: one CUDA graph for the flush
frame and one for the rest, as the JAX script jits its segments; a video's
first frame also copies its fresh state into the step's static state);
``pre_backbone`` and ``post_backbone`` run eagerly.
"""

from pathlib import Path

import numpy as np
import torch

from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.data.synthetic import SyntheticVID
from eventful_transformer_tpu_torch.data.vid import VID, VIDResize
from eventful_transformer_tpu_torch.models.vitdet import ViTDet
from eventful_transformer_tpu_torch.utils.config import initialize_run
from eventful_transformer_tpu_torch.utils.evaluate import run_evaluations
from eventful_transformer_tpu_torch.utils.misc import MeanValue
from eventful_transformer_tpu_torch.utils.timing import clock


def evaluate_vitdet_runtime(model, data, config):
    """{"times": {"backbone", "backbone_non_first", "other",
    "other_non_first", "total", "total_non_first"}}: mean seconds per
    frame; "other" is the pre- and post-backbone segments together."""
    c, in_h, in_w = model.input_shape
    p = next(model.parameters())
    step = model.backbone_step(count_mode=False)
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
            content_hw = tuple(frame.shape[-2:])
            padded = torch.from_numpy(padded).to(device=p.device, dtype=p.dtype)
            with torch.no_grad():
                t_0 = clock()
                tokens = model.pre_backbone(Ctx(), padded, content_hw)
                t_1 = clock()
                tokens, state, _ = step(state, tokens, mode="flush" if t == 0 else "incremental")
                t_2 = clock()
                model.post_backbone(Ctx(), tokens)
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
