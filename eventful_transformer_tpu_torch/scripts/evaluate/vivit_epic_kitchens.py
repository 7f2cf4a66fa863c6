"""Eventful-ViViT evaluation on EPIC-Kitchens-100, on the card.

    python -m eventful_transformer_tpu_torch.scripts.evaluate.vivit_epic_kitchens \
        <config> [overrides]

run from the repo's root: ``<config>`` names a file of
``configs/evaluate/vivit_epic_kitchens/``; the data are read from
``data/epic_kitchens``; ``model.device=cpu`` runs on the CPU.
"""

from pathlib import Path

from eventful_transformer_tpu_torch.data.epic_kitchens import EPICKitchens
from eventful_transformer_tpu_torch.models import FactorizedViViT
from eventful_transformer_tpu_torch.utils.config import initialize_run
from eventful_transformer_tpu_torch.utils.evaluate import evaluate_vivit_metrics, run_evaluations


def main(argv=None):
    config = initialize_run(
        config_location=Path("configs", "evaluate", "vivit_epic_kitchens"), argv=argv
    )
    data = EPICKitchens(Path("data", "epic_kitchens"), split="validation")
    return run_evaluations(config, FactorizedViViT, data, evaluate_vivit_metrics)


if __name__ == "__main__":
    main()
