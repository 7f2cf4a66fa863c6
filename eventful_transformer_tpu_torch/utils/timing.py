"""Wall-clock timing on the card (port of
``eventful_transformer_tpu/utils/timing.py``).

The JAX package reduced each output to a scalar on the device and read it
back (``scalar_probe``), because on its TPU platform
``block_until_ready`` returned without waiting. A CUDA card needs no such
probe: wherever CUDA is in use in the process, the card is synchronised
before and after each timed region (:func:`clock`), whatever device the
arguments lie on, so a model that moves host arguments to the card itself
is timed to the end of its work; the helpers time the region by CUDA
events then, and by ``time.perf_counter`` on the CPU. ``scalar_probe``
stays for callers that want one number of an output. ``compile_parallel``
has no counterpart: the port compiles nothing per shape; its kernels are
built once, at first use, for every shape, and a captured step records its
graph at its first call of a shape. Each timer warms up first, so that
build, capture and every first-call cost of the shape fall outside the
timed calls. The JAX helpers jit what they time (JAX
``utils/timing.py:43`` and ``:125``); these time the callable they are
given, so a caller times the port's counterpart by handing them a captured
step (``utils/graphs.py``, the step builders of ``utils/evaluate.py``); the
time entry points time captured steps with :func:`clock`.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _tensors(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _tensors(value)


def scalar_probe(tree):
    """The sum of every tensor in ``tree`` as one float32 scalar, on the
    device of the first."""
    leaves = list(_tensors(tree))
    if not leaves:
        raise ValueError("no tensor to probe")
    return sum(leaf.float().sum().to(leaves[0].device) for leaf in leaves)


def synchronize():
    """Wait for the card's queued work, where CUDA is in use."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def clock():
    """``time.perf_counter`` once the card's queued work has finished."""
    synchronize()
    return time.perf_counter()


class _Timer:
    """Seconds of the region between :meth:`start` and :meth:`stop`, the
    card synchronised before it starts and after it ends: CUDA events where
    CUDA is in use when the region starts, else ``time.perf_counter``."""

    def start(self):
        self.card = torch.cuda.is_initialized()
        if self.card:
            torch.cuda.synchronize()
            self.events = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            self.events[0].record()
        else:
            self.t0 = time.perf_counter()

    def stop(self):
        if self.card:
            self.events[1].record()
            torch.cuda.synchronize()
            return self.events[0].elapsed_time(self.events[1]) / 1e3
        return clock() - self.t0


def time_jitted(fn, args, iters=5, warmup=2, median=True):
    """Seconds per call of ``fn(*args)``: ``warmup`` calls (at least one)
    untimed, then ``iters`` timed calls, each its own region. Returns the
    median (the mean with ``median=False``)."""
    timer = _Timer()
    for _ in range(max(warmup, 1)):
        fn(*args)
    times = []
    for _ in range(iters):
        timer.start()
        fn(*args)
        times.append(timer.stop())
    return float(np.median(times) if median else np.mean(times))


def time_jitted_pair(fn_a, args_a, fn_b, args_b, iters=5, warmup=2, full=False):
    """Time two callables interleaved, A, B, A, B, ..., so that clock and
    thermal drift hit both alike, after ``warmup`` rounds (at least one) of
    both. Returns the two medians in seconds, or with ``full=True`` the two
    arrays of times."""
    timer = _Timer()
    for _ in range(max(warmup, 1)):
        fn_a(*args_a)
        fn_b(*args_b)
    times_a, times_b = [], []
    for _ in range(iters):
        timer.start()
        fn_a(*args_a)
        times_a.append(timer.stop())
        timer.start()
        fn_b(*args_b)
        times_b.append(timer.stop())
    if full:
        return np.asarray(times_a), np.asarray(times_b)
    return float(np.median(times_a)), float(np.median(times_b))


def time_repeated(fn, args, repeat=64, iters=5, warmup=1):
    """Seconds per call of ``fn(*args)`` with the per-call host overhead
    amortised: ``repeat`` calls in one timed region, divided by
    ``repeat``; the median of ``iters`` regions, after ``warmup`` untimed
    ones (at least one). Calls on one CUDA stream run in order, so the JAX
    package's data dependence between iterations has no counterpart."""
    timer = _Timer()

    def region():
        for _ in range(repeat):
            fn(*args)

    for _ in range(max(warmup, 1)):
        region()
    times = []
    for _ in range(iters):
        timer.start()
        region()
        times.append(timer.stop())
    return float(np.median(times)) / repeat
