"""Cache the eventful spatial sub-model's outputs for Kinetics-400, on the
card (port of ``scripts/spatial/vivit_kinetics400.py``).

    python -m eventful_transformer_tpu_torch.scripts.spatial.vivit_kinetics400 \
        <config> [overrides]

run from the repo's root: ``<config>`` names a file of
``configs/spatial/vivit_kinetics400/`` (``24``, ``48``, ``96``: k), the
overrides are ``a.b.c=value`` (``model.device=cpu`` runs on the CPU). Each
split's clips (``train``, capped at ``max_tars`` tars, and ``val``) are read
from ``data/kinetics400`` and cached as
``data/kinetics400/<split>/spatial_224_25_<k>/{i:05d}.npz``. A
``synthetic`` entry (the keywords of ``data/synthetic.py::
SyntheticVideoClassification``) caches generated clips instead.
"""

from pathlib import Path

from eventful_transformer_tpu_torch.data.kinetics400 import Kinetics400
from eventful_transformer_tpu_torch.data.synthetic import SyntheticVideoClassification
from eventful_transformer_tpu_torch.utils.config import get_cli_config
from eventful_transformer_tpu_torch.utils.spatial import compute_vivit_spatial


def main(argv=None):
    config = get_cli_config(
        config_location=Path("configs", "spatial", "vivit_kinetics400"), argv=argv
    )
    k = config["k"]
    location = Path("data", "kinetics400")
    outputs = []
    for split in "train", "val":
        print(f"{split.capitalize()}, k={k}", flush=True)
        max_tars = config.get("max_tars", None) if (split == "train") else None
        if config.get("synthetic"):
            data = SyntheticVideoClassification(**dict(config["synthetic"]))
        else:
            data = Kinetics400(
                location, split=split, decode_size=224, decode_fps=25, max_tars=max_tars,
                shuffle=False,
            )
        if max_tars is not None:
            split = f"{split}_{max_tars}"
        outputs.append(location / split / f"spatial_224_25_{k}")
        compute_vivit_spatial(config, outputs[-1], data)
    return outputs


if __name__ == "__main__":
    main()
