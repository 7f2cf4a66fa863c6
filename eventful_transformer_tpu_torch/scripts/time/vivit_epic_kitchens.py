"""ViViT wall-clock timing on the card: the spatial and temporal sub-models'
seconds per clip (port of ``scripts/time/vivit_epic_kitchens.py``;
reference scripts/time/vivit_epic_kitchens.py:17-45).

    python -m eventful_transformer_tpu_torch.scripts.time.vivit_epic_kitchens \
        <config> [overrides]

run from the repo's root: ``<config>`` names a file of
``configs/time/vivit_epic_kitchens/``; the clips are read from
``data/epic_kitchens`` (validation), or generated with a ``synthetic``
entry (the keywords of ``data/synthetic.py::SyntheticVideoClassification``);
``model.device=cpu`` runs on the CPU. The times of each sweep entry go to
``<_output>/times.csv`` and ``output.txt``.

The spatial step flips the model's ``spatial_only`` on for its call, and
the temporal step ``temporal_only`` (``apply`` on the spatial features), as
the JAX script flips ``spatial_only``. On the card each step is captured
(``utils/graphs.py``; the flipped attribute is part of a graph's key), as
the JAX script jits both. Each clip runs once untimed, then once timed;
the card is synchronised before each clock read.
"""

from pathlib import Path

import torch

from eventful_transformer_tpu_torch.data.epic_kitchens import EPICKitchens
from eventful_transformer_tpu_torch.data.synthetic import SyntheticVideoClassification
from eventful_transformer_tpu_torch.models import FactorizedViViT
from eventful_transformer_tpu_torch.utils.config import initialize_run
from eventful_transformer_tpu_torch.utils.evaluate import (
    make_vivit_step,
    run_evaluations,
    vivit_views,
)
from eventful_transformer_tpu_torch.utils.graphs import model_step
from eventful_transformer_tpu_torch.utils.misc import MeanValue
from eventful_transformer_tpu_torch.utils.timing import clock


def evaluate_vivit_runtime(model, data, config):
    """{"times": {"spatial", "temporal", "total"}}: mean seconds per clip."""
    spatial_time = MeanValue()
    temporal_time = MeanValue()

    spatial = make_vivit_step(model, count_mode=False)
    temporal = model_step(model, model.apply, count_mode=False, name="vivit temporal step")

    def spatial_step(views):
        model.spatial_only, model.temporal_only = True, False
        try:
            return spatial(views)[0]
        finally:
            model.spatial_only = False

    @torch.no_grad()
    def temporal_step(x):
        model.temporal_only = True
        try:
            return temporal(x[None])[0]
        finally:
            model.temporal_only = False

    n_items = min(config.get("n_items") or len(data), len(data))
    for i in range(n_items):
        video, _ = data[i]
        views = vivit_views(model, video)
        temporal_step(spatial_step(views))  # warm start at this shape
        t_0 = clock()
        x = spatial_step(views)
        t_1 = clock()
        temporal_step(x)
        t_2 = clock()
        spatial_time.update(t_1 - t_0)
        temporal_time.update(t_2 - t_1)
    times = {
        "spatial": spatial_time.compute(),
        "temporal": temporal_time.compute(),
        "total": spatial_time.compute() + temporal_time.compute(),
    }
    return {"times": times}


def main(argv=None):
    config = initialize_run(
        config_location=Path("configs", "time", "vivit_epic_kitchens"), argv=argv
    )
    if config.get("synthetic"):
        data = SyntheticVideoClassification(**dict(config["synthetic"]))
    else:
        data = EPICKitchens(Path("data", "epic_kitchens"), split="validation")
    return run_evaluations(config, FactorizedViViT, data, evaluate_vivit_runtime)


if __name__ == "__main__":
    main()
