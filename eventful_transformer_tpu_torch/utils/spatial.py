"""Spatial-output caching for temporal fine-tuning (port of
``eventful_transformer_tpu/utils/spatial.py``; reference
utils/spatial.py:13-33): run the spatial sub-model (eventful,
``TokenNormTopK`` at budget k) over a dataset and save one .npz per clip.

The model is built from ``config["model"]`` (``spatial_only``) on the card
unless ``model.device`` names another device, and takes the weights of
``config["weights"]``, or its seed's where there is no such file (as
``run_evaluations`` does). Each clip's views are made on the model's
device and run through ``utils/evaluate.py::make_vivit_step``: on the card
one captured step (a CUDA graph), as the JAX package jits it. numpy has no
bfloat16, so ``spatial`` is stored as float32 (the
features of a bfloat16 model widened exactly): the files load in either
package's ``ViViTSpatial``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
from eventful_transformer_tpu_torch.utils.evaluate import (
    load_model_params,
    make_vivit_step,
    progress,
    vivit_views,
)
from eventful_transformer_tpu_torch.utils.misc import set_policies


def compute_vivit_spatial(config, output_dir, data, model_class=None):
    """Writes ``output_dir/{i:05d}.npz`` (``spatial`` (views, t, dim)
    float32, ``label``) for each clip i of ``data``. Returns the model."""
    from eventful_transformer_tpu_torch.models import FactorizedViViT

    model_class = model_class or FactorizedViViT
    model = model_class(**{"seed": config.get("seed", 0), **config["model"]})
    if not model.spatial_only:
        raise ValueError("spatial caching requires model.spatial_only")
    load_model_params(model, config)
    set_policies(model, TokenNormTopK, k=config["k"])

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    step = make_vivit_step(model, count_mode=False)
    for i in progress(range(len(data))):
        video, label = data[i]
        spatial, _ = step(vivit_views(model, video))
        np.savez(
            output_dir / f"{i:05d}.npz",
            spatial=spatial.float().cpu().numpy(),
            label=np.asarray(label),
        )
    return model
