"""Metrics, policy injection and small utilities (port of
``eventful_transformer_tpu/utils/misc.py``)."""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
import urllib.request
from pathlib import Path
from random import Random

import numpy as np

from eventful_transformer_tpu_torch.core.gating import TokenGate


class MeanValue:
    """Streaming mean metric (same surface as reference utils/misc.py:12-26).

    Kept as an incremental running mean (mean += (v - mean) / n) rather than
    a sum/count pair — numerically stabler for long timing runs."""

    def __init__(self):
        self._mean = 0.0
        self._n = 0

    def update(self, value):
        self._n += 1
        self._mean += (float(value) - self._mean) / self._n

    def compute(self):
        return self._mean if self._n else 0.0

    def reset(self):
        self._mean, self._n = 0.0, 0


class TopKAccuracy:
    """Top-k classification accuracy (reference utils/misc.py:29-45)."""

    def __init__(self, k):
        self.k = k
        self.correct = 0
        self.total = 0

    def compute(self):
        return self.correct / self.total

    def reset(self):
        self.correct = 0
        self.total = 0

    def update(self, pred, true):
        pred = np.asarray(pred)
        true = np.asarray(true).reshape(-1)
        top_k = np.argsort(pred, axis=-1)[..., -self.k:]
        self.correct += int((top_k == true[:, None]).sum())
        self.total += true.size


def token_gates(model):
    """Every token gate of ``model`` (the v and matmul gates of an
    ``EventfulBlock`` included), in module order."""
    return [
        gate
        for module in model.modules()
        for gate in vars(module).values()
        if isinstance(gate, TokenGate)
    ]


def set_policies(model, policy_class, **policy_kwargs):
    """Give every token gate of ``model`` a fresh policy instance. The port
    reads a policy's capacity when a step runs, so nothing has to be
    rebuilt after a change."""
    for gate in token_gates(model):
        gate.policy = policy_class(**policy_kwargs)


def seeded_shuffle(sequence, seed):
    """In-place deterministic shuffle. Algorithm pinned to ``random.Random``
    (Mersenne-Twister Fisher-Yates) so dataset subset selection reproduces
    the reference's item order exactly (utils/misc.py:134-137)."""
    Random(seed).shuffle(sequence)


def tee_print(s, file, flush=True):
    """Print to stdout and to a log file (reference utils/misc.py:150-152)."""
    for stream in (sys.stdout, file):
        print(s, file=stream, flush=flush)


def decode_video(
    input_path,
    output_path,
    name_format="%d",
    image_format="png",
    ffmpeg_input_args=None,
    ffmpeg_output_args=None,
):
    """Decode a video into numbered image frames with ffmpeg (host-side
    preprocessing, out of the model path — SURVEY.md §2.6). Returns the
    ffmpeg exit code (0 = success); callers treat nonzero as a failed clip
    and drop it."""
    frames_dir = Path(output_path)
    frames_dir.mkdir(exist_ok=True)
    command = ["ffmpeg", "-loglevel", "error"]
    command += list(ffmpeg_input_args or ())
    command += ["-i", str(input_path)]
    command += list(ffmpeg_output_args or ())
    command.append(str(frames_dir / f"{name_format}.{image_format}"))
    return subprocess.run(command, check=False).returncode


def download_file(url, output_path, chunk_size=1 << 20, verbose=True):
    """Stream a URL to disk via stdlib urllib (no third-party HTTP client).
    Writes to a .part file first so interrupted downloads never leave a
    truncated file at the final path (dataset bootstraps check existence)."""
    if verbose:
        print(f"Downloading {url}...", flush=True)
    partial = Path(str(output_path) + ".part")
    with urllib.request.urlopen(url) as source, open(partial, "wb") as sink:
        shutil.copyfileobj(source, sink, length=chunk_size)
    partial.replace(output_path)


def parse_patterns(pattern_file):
    """Parse a weight-remapping pattern file: alternating regex /
    replacement lines (reference utils/misc.py:97-111)."""
    patterns = []
    last_regex = None
    with open(pattern_file, "r") as text:
        for line in text:
            line = line.strip()
            if line == "" or line.startswith("#"):
                continue
            elif last_regex is None:
                last_regex = re.compile(line)
            else:
                patterns.append((last_regex, line))
                last_regex = None
    return patterns


def remap_weights(in_weights, patterns, verbose=False):
    """First-match regex rename with DISCARD sentinel
    (reference utils/misc.py:113-131)."""
    n_remapped = 0
    out_weights = {}
    for in_key, weight in in_weights.items():
        out_key = in_key
        discard = False
        for regex, replacement in patterns:
            out_key, n_matches = regex.subn(replacement, out_key)
            if n_matches > 0:
                if replacement == "DISCARD":
                    discard = True
                    out_key = "DISCARD"
                n_remapped += 1
                if verbose:
                    print(f"{in_key}  ==>  {out_key}")
                break
        if not discard:
            out_weights[out_key] = weight
    return out_weights, n_remapped
