"""Cache the eventful spatial sub-model's outputs for EPIC-Kitchens, on the
card (port of ``scripts/spatial/vivit_epic_kitchens.py``).

    python -m eventful_transformer_tpu_torch.scripts.spatial.vivit_epic_kitchens \
        <config> [overrides]

run from the repo's root: ``<config>`` names a file of
``configs/spatial/vivit_epic_kitchens/`` (``50``, ``100``, ``200``: k);
``model.device=cpu`` runs on the CPU. Each split's clips (``train``,
``validation``) are read from ``data/epic_kitchens`` and cached as
``data/epic_kitchens/<split>/spatial_<k>/{i:05d}.npz``; a ``synthetic``
entry caches generated clips instead, as in ``vivit_kinetics400``.
"""

from pathlib import Path

from eventful_transformer_tpu_torch.data.epic_kitchens import EPICKitchens
from eventful_transformer_tpu_torch.data.synthetic import SyntheticVideoClassification
from eventful_transformer_tpu_torch.utils.config import get_cli_config
from eventful_transformer_tpu_torch.utils.spatial import compute_vivit_spatial


def main(argv=None):
    config = get_cli_config(
        config_location=Path("configs", "spatial", "vivit_epic_kitchens"), argv=argv
    )
    k = config["k"]
    location = Path("data", "epic_kitchens")
    outputs = []
    for split in "train", "validation":
        print(f"{split.capitalize()}, k={k}", flush=True)
        if config.get("synthetic"):
            data = SyntheticVideoClassification(**dict(config["synthetic"]))
        else:
            data = EPICKitchens(location, split=split, shuffle=False)
        outputs.append(location / split / f"spatial_{k}")
        compute_vivit_spatial(config, outputs[-1], data)
    return outputs


if __name__ == "__main__":
    main()
