"""Temporal fine-tuning of ViViT on cached Kinetics-400 spatial outputs, on
the card (port of ``scripts/train/vivit_kinetics400.py``).

    python -m eventful_transformer_tpu_torch.scripts.train.vivit_kinetics400 \
        <config> [overrides]

run from the repo's root: ``<config>`` names a file of
``configs/train/vivit_kinetics400/`` (``final_24``, ``final_48``,
``final_96``: k); the overrides are ``a.b.c=value`` (``model.device=cpu``
runs on the CPU). The cache that ``scripts/spatial/vivit_kinetics400.py``
writes is read from ``data/kinetics400/{train_40,val}/spatial_224_25_<k>``;
a ``data`` entry names another root than ``data/kinetics400``.
"""

from pathlib import Path

from eventful_transformer_tpu_torch.data.vivit_spatial import ViViTSpatial
from eventful_transformer_tpu_torch.utils.config import get_cli_config
from eventful_transformer_tpu_torch.utils.train import train_vivit_temporal


def main(argv=None):
    config = get_cli_config(config_location=Path("configs", "train", "vivit_kinetics400"), argv=argv)
    location = Path(config.get("data", Path("data", "kinetics400")))
    train_data = ViViTSpatial(location, split="train_40", base_name="spatial_224_25", k=config["k"])
    val_data = ViViTSpatial(location, split="val", base_name="spatial_224_25", k=config["k"])
    return train_vivit_temporal(config, train_data, val_data)


if __name__ == "__main__":
    main()
