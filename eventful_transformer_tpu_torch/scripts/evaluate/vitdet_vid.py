"""Eventful-ViTDet evaluation on ImageNet VID, on the card: the state resets
per video, and the mAP is computed once over every frame's detections.

    python -m eventful_transformer_tpu_torch.scripts.evaluate.vitdet_vid \
        <config> [overrides]

run from the repo's root: ``<config>`` names a file of
``configs/evaluate/vitdet_vid/``; VID is read from ``data/vid`` (unpacked
from ``data/vid/data.tar`` at first use) and resized to the model's input
(``VIDResize``); ``model.device=cpu`` runs on the CPU. The evaluation
itself is ``utils/evaluate.py::evaluate_vitdet_metrics``.
"""

from pathlib import Path

from eventful_transformer_tpu_torch.core.nn import not_ported
from eventful_transformer_tpu_torch.data.vid import VID, VIDResize
from eventful_transformer_tpu_torch.models.vitdet import ViTDet
from eventful_transformer_tpu_torch.utils.config import initialize_run
from eventful_transformer_tpu_torch.utils.evaluate import evaluate_vitdet_metrics, run_evaluations


def main(argv=None):
    config = initialize_run(config_location=Path("configs", "evaluate", "vitdet_vid"), argv=argv)
    if config.get("sequence_parallel"):
        raise not_ported("sequence_parallel", 17)
    if config.get("data_parallel"):
        raise not_ported("data_parallel", 17)
    long_edge = max(config["model"]["input_shape"][-2:])
    data = VID(
        Path("data", "vid"),
        split=config["split"],
        tar_path=Path("data", "vid", "data.tar"),
        combined_transform=VIDResize(
            short_edge_length=640 * long_edge // 1024, max_size=long_edge
        ),
    )
    return run_evaluations(config, ViTDet, data, evaluate_vitdet_metrics)


if __name__ == "__main__":
    main()
