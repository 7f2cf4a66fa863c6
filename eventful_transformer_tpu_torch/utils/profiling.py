"""Profiling and tracing helpers (port of
``eventful_transformer_tpu/utils/profiling.py``).

:func:`trace` records a ``torch.profiler`` trace, the card's kernels
included, and writes it as a Chrome trace (viewable in Perfetto or
``chrome://tracing``); :func:`annotate` names a region in it. Wall-clock
timing is ``utils/timing.py``; FLOP accounting is ``core/counting.py``.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextmanager
def trace(log_dir="profiles"):
    """Capture a trace: ``with trace("profiles"): step(...)``. The CPU's
    activity and, where there is a card, the card's; written on exit to
    ``log_dir/trace_<pid>_<ms>.json``. Yields the profiler, whose
    ``trace_path`` names the file after the block."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.trace_path = log_dir / f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"
    prof.export_chrome_trace(str(prof.trace_path))


def annotate(name):
    """A named region of the trace: ``with annotate("backbone"): ...``."""
    return record_function(name)
