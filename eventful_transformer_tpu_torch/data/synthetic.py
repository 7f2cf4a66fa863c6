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


class SyntheticVID:
    """Dataset of generated VID videos, each a list of ``n_frames``
    (frame, annotations) items as ``VIDItem`` gives them: a random uint8
    image with a little noise each frame and a white rectangle (a
    quarter of the height by three sixteenths of the width at 720 x 1280)
    that drifts right by a 160th of the width each frame, its box the one
    ground-truth box, its label the frame's index modulo ``classes``;
    through ``combined_transform`` (``VIDResize``) where one is given.
    Video i is drawn from ``seed + i``."""

    def __init__(self, n_items=1, n_frames=5, size=(720, 1280), classes=30, seed=0,
                 combined_transform=None):
        self.n_items = n_items
        self.n_frames = n_frames
        self.size = tuple(size)
        self.classes = classes
        self.seed = seed
        self.combined_transform = combined_transform
        self._videos = {}

    def __len__(self):
        return self.n_items

    def __getitem__(self, index):
        if not 0 <= index < self.n_items:
            raise IndexError(index)
        if index not in self._videos:
            self._videos[index] = self._video(index)
        return self._videos[index]

    def _video(self, index):
        rng = np.random.default_rng(self.seed + index)
        h, w = self.size
        base = rng.integers(0, 256, (3, h, w)).astype(np.float32)
        y0, x0 = h * 200 // 720, w * 300 // 1280
        bh, bw, step = h * 160 // 720, w * 240 // 1280, max(1, w // 160)
        items = []
        for t in range(self.n_frames):
            frame = base + rng.normal(0.0, 3.0, base.shape)
            x = x0 + step * t
            frame[:, y0 : y0 + bh, x : x + bw] = 255.0
            box = np.asarray([[x, y0, x + bw, y0 + bh]], np.float32)
            ann = {"boxes": box, "labels": np.asarray([t % self.classes], np.int32)}
            item = (frame.clip(0, 255).astype(np.uint8), ann)
            if self.combined_transform is not None:
                item = self.combined_transform(item)
            items.append(item)
        return items
