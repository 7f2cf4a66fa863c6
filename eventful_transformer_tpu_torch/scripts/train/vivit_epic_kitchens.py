"""Temporal fine-tuning of ViViT on cached EPIC-Kitchens spatial outputs, on
the card (port of ``scripts/train/vivit_epic_kitchens.py``).

    python -m eventful_transformer_tpu_torch.scripts.train.vivit_epic_kitchens \
        <config> [overrides]

run from the repo's root: ``<config>`` names a file of
``configs/train/vivit_epic_kitchens/`` (``final_50``, ``final_100``,
``final_200``: k); the overrides are ``a.b.c=value`` (``model.device=cpu``
runs on the CPU). The cache that ``scripts/spatial/vivit_epic_kitchens.py``
writes is read from ``data/epic_kitchens/{train,validation}/spatial_<k>``;
a ``data`` entry names another root than ``data/epic_kitchens``.
"""

from pathlib import Path

from eventful_transformer_tpu_torch.data.vivit_spatial import ViViTSpatial
from eventful_transformer_tpu_torch.utils.config import get_cli_config
from eventful_transformer_tpu_torch.utils.train import train_vivit_temporal


def main(argv=None):
    config = get_cli_config(
        config_location=Path("configs", "train", "vivit_epic_kitchens"), argv=argv
    )
    location = Path(config.get("data", Path("data", "epic_kitchens")))
    train_data = ViViTSpatial(location, split="train", k=config["k"])
    val_data = ViViTSpatial(location, split="validation", k=config["k"])
    return train_vivit_temporal(config, train_data, val_data)


if __name__ == "__main__":
    main()
