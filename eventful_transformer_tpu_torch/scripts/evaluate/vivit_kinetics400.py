"""Eventful-ViViT evaluation on Kinetics-400, on the card.

    python -m eventful_transformer_tpu_torch.scripts.evaluate.vivit_kinetics400 \
        <config> [overrides]

run from the repo's root: ``<config>`` names a file of
``configs/evaluate/vivit_kinetics400/``, the overrides are ``a.b.c=value``
(``model.device=cpu`` runs the plain versions on the CPU). A ``synthetic``
entry evaluates generated clips (``data/synthetic.py``) instead of
Kinetics-400 from ``data/kinetics400``. ``data_parallel=true`` shares the
videos out over every process torchrun starts, one a GPU (NCCL; gloo with
``model.device=cpu``), and only the first writes the output:

    torchrun --standalone --nproc_per_node=N -m \
        eventful_transformer_tpu_torch.scripts.evaluate.vivit_kinetics400 \
        <config> data_parallel=true [overrides]
"""

from functools import partial
from pathlib import Path

from eventful_transformer_tpu_torch.data.kinetics400 import Kinetics400
from eventful_transformer_tpu_torch.data.synthetic import SyntheticVideoClassification
from eventful_transformer_tpu_torch.models import FactorizedViViT
from eventful_transformer_tpu_torch.utils.config import get_cli_config, save_run_config
from eventful_transformer_tpu_torch.utils.evaluate import evaluate_vivit_metrics, run_evaluations


def load_data(config):
    if config.get("synthetic"):
        return SyntheticVideoClassification(**dict(config["synthetic"]))
    return Kinetics400(Path("data", "kinetics400"), split="val", decode_size=224, decode_fps=25)


def main(argv=None):
    config = get_cli_config(config_location=Path("configs", "evaluate", "vivit_kinetics400"),
                            argv=argv)
    if not config.get("data_parallel"):
        save_run_config(config)
        return run_evaluations(config, FactorizedViViT, load_data(config), evaluate_vivit_metrics)
    from eventful_transformer_tpu_torch.parallel.evaluate import evaluate_vivit_metrics_dp
    from eventful_transformer_tpu_torch.parallel.mesh import entry_mesh, first_then_rest

    with entry_mesh(config, "data") as (mesh, writes):
        if writes:
            save_run_config(config)
        data = first_then_rest(lambda: load_data(config), writes)
        return run_evaluations(config, FactorizedViViT, data,
                               partial(evaluate_vivit_metrics_dp, mesh=mesh), write=writes)


if __name__ == "__main__":
    main()
