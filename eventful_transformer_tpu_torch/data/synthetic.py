"""A copy of ``eventful_transformer_tpu/data/synthetic.py`` for the port.

Synthetic video datasets for tests and benchmarks.

Generates temporally-redundant videos (static background + a small moving
patch) so eventful gating has realistic sparsity structure. No real-data
dependency; real loaders live in kinetics400.py / vid.py / epic_kitchens.py.
"""

from __future__ import annotations

import numpy as np


class SyntheticVideoClassification:
    """Dataset of (video, label) items: video (T, C, H, W) uint8."""

    def __init__(self, n_items=8, n_frames=40, size=(64, 64), classes=10, seed=0):
        self.n_items = n_items
        self.n_frames = n_frames
        self.size = tuple(size)
        self.classes = classes
        self.seed = seed

    def __len__(self):
        return self.n_items

    def __getitem__(self, index):
        if not 0 <= index < self.n_items:
            raise IndexError(index)
        rng = np.random.default_rng(self.seed + index)
        h, w = self.size
        label = int(rng.integers(self.classes))
        background = rng.integers(0, 255, (1, 3, h, w), dtype=np.uint8)
        video = np.repeat(background, self.n_frames, axis=0)
        # A moving square whose speed/direction depends on the label.
        ph, pw = max(4, h // 8), max(4, w // 8)
        patch = rng.integers(0, 255, (3, ph, pw), dtype=np.uint8)
        speed = 1 + label % 3
        for t in range(self.n_frames):
            y = (t * speed) % (h - ph)
            x = (t * (1 + label % 5)) % (w - pw)
            video[t, :, y : y + ph, x : x + pw] = patch
        return video, label
