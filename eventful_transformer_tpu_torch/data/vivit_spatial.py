"""A copy of ``eventful_transformer_tpu/data/vivit_spatial.py`` for the port.

Dataset over cached spatial-sub-model outputs
(reference datasets/vivit_spatial.py:10-62): per-clip .npz files with
``spatial`` features and ``label``, produced by utils/spatial.py (of either
package: the files are the same format)."""

from __future__ import annotations

from pathlib import Path

import numpy as np


class ViViTSpatial:
    def __init__(self, location, split=None, k=None, base_name="spatial"):
        """Either pass the cache directory directly as ``location``, or
        (location, split, k) to address ``location/split/{base_name}_{k}``
        as in the reference layout."""
        location = Path(location)
        if split is not None:
            location = location / split / f"{base_name}_{k}"
        self.location = location
        self.files = sorted(self.location.glob("*.npz"))
        if not self.files:
            raise FileNotFoundError(f"no cached spatial outputs in {self.location}")

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index):
        with np.load(self.files[index]) as data:
            return data["spatial"], int(data["label"])
