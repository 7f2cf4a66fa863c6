"""Eventful-ViViT evaluation on Kinetics-400, on the card.

    python -m eventful_transformer_tpu_torch.scripts.evaluate.vivit_kinetics400 \
        <config> [overrides]

run from the repo's root: ``<config>`` names a file of
``configs/evaluate/vivit_kinetics400/``, the overrides are ``a.b.c=value``
(``model.device=cpu`` runs the plain versions on the CPU). A ``synthetic``
entry evaluates generated clips (``data/synthetic.py``) instead of
Kinetics-400 from ``data/kinetics400``.
"""

from pathlib import Path

from eventful_transformer_tpu_torch.core.nn import not_ported
from eventful_transformer_tpu_torch.data.kinetics400 import Kinetics400
from eventful_transformer_tpu_torch.data.synthetic import SyntheticVideoClassification
from eventful_transformer_tpu_torch.models import FactorizedViViT
from eventful_transformer_tpu_torch.utils.config import initialize_run
from eventful_transformer_tpu_torch.utils.evaluate import evaluate_vivit_metrics, run_evaluations


def main(argv=None):
    config = initialize_run(
        config_location=Path("configs", "evaluate", "vivit_kinetics400"), argv=argv
    )
    if config.get("data_parallel"):
        raise not_ported("data_parallel", 17)
    if config.get("synthetic"):
        data = SyntheticVideoClassification(**dict(config["synthetic"]))
    else:
        data = Kinetics400(
            Path("data", "kinetics400"), split="val", decode_size=224, decode_fps=25
        )
    return run_evaluations(config, FactorizedViViT, data, evaluate_vivit_metrics)


if __name__ == "__main__":
    main()
