"""Eventful-ViTDet evaluation on ImageNet VID, on the card: the state resets
per video, and the mAP is computed once over every frame's detections.

    python -m eventful_transformer_tpu_torch.scripts.evaluate.vitdet_vid \
        <config> [overrides]

run from the repo's root: ``<config>`` names a file of
``configs/evaluate/vitdet_vid/``; VID is read from ``data/vid`` (unpacked
from ``data/vid/data.tar`` at first use), or generated with a ``synthetic``
entry (the keywords of ``data/synthetic.py::SyntheticVID``), and resized to
the model's input (``VIDResize``); ``model.device=cpu`` runs on the CPU.
The evaluation itself is ``utils/evaluate.py::evaluate_vitdet_metrics``.

Over every process torchrun starts, one a GPU (NCCL; gloo with
``model.device=cpu``), only the first writing the output:
``sequence_parallel: <axis>`` runs the backbone token-sharded over them
(the blocks must name the same axis, as ``ulysses_smoke_672.yml`` does);
``data_parallel=true`` shares the videos out:

    torchrun --standalone --nproc_per_node=N -m \
        eventful_transformer_tpu_torch.scripts.evaluate.vitdet_vid ulysses_smoke_672
"""

from functools import partial
from pathlib import Path

from eventful_transformer_tpu_torch.data.synthetic import SyntheticVID
from eventful_transformer_tpu_torch.data.vid import VID, VIDResize
from eventful_transformer_tpu_torch.models.vitdet import ViTDet
from eventful_transformer_tpu_torch.utils.config import get_cli_config, save_run_config
from eventful_transformer_tpu_torch.utils.evaluate import evaluate_vitdet_metrics, run_evaluations


def load_data(config):
    long_edge = max(config["model"]["input_shape"][-2:])
    resize = VIDResize(short_edge_length=640 * long_edge // 1024, max_size=long_edge)
    if config.get("synthetic"):
        return SyntheticVID(**dict(config["synthetic"]), combined_transform=resize)
    return VID(Path("data", "vid"), split=config["split"], tar_path=Path("data", "vid", "data.tar"),
               combined_transform=resize)


def main(argv=None):
    config = get_cli_config(config_location=Path("configs", "evaluate", "vitdet_vid"), argv=argv)
    if config.get("sequence_parallel"):
        from eventful_transformer_tpu_torch.parallel.evaluate import evaluate_vitdet_metrics_sp

        axis = str(config["sequence_parallel"])
        evaluate = partial(evaluate_vitdet_metrics_sp, axis=axis)
    elif config.get("data_parallel"):
        from eventful_transformer_tpu_torch.parallel.evaluate import evaluate_vitdet_metrics_dp

        axis, evaluate = "data", evaluate_vitdet_metrics_dp
    else:
        save_run_config(config)
        return run_evaluations(config, ViTDet, load_data(config), evaluate_vitdet_metrics)
    from eventful_transformer_tpu_torch.parallel.mesh import entry_mesh, first_then_rest

    with entry_mesh(config, axis) as (mesh, writes):
        if writes:
            save_run_config(config)
        data = first_then_rest(lambda: load_data(config), writes)
        return run_evaluations(config, ViTDet, data, partial(evaluate, mesh=mesh), write=writes)


if __name__ == "__main__":
    main()
