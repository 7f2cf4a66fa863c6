"""Capacity-bucketed dispatch for threshold policies (port of
``eventful_transformer_tpu/utils/bucketing.py``).

A ``TokenNormThreshold`` with a fixed capacity is exact as long as no gate
has every candidate over the threshold. Each frame runs at the smallest
capacity of a ladder that is likely to hold its selection; a gate that
saturates (``policy_saturated`` > 0) may have cut its selection short, so
the frame is run again from the same state at the next larger capacity.
The result is that of capacity = N whenever the last run is unsaturated or
at the top of the ladder. A decay probe retries the next smaller capacity
after ``decay_interval`` frames at one level.

The port's kernels update the state in place, and a captured step
(``utils/graphs.py``) keeps the state in static tensors that the caller's
state is: a run overwrites it. So before a run that may be discarded the
state is copied into a backup set, allocated once for each shape of the
state, and copied back before the rerun at the next capacity: one state
copy a run below the top of the ladder. A run at the top is never
discarded and takes no copy.
"""

from __future__ import annotations

import torch

from eventful_transformer_tpu_torch.core.policies import TokenNormThreshold
from eventful_transformer_tpu_torch.utils.misc import set_policies


def copy_state(dst, src):
    """Copy every tensor leaf of ``src`` into the same leaf of ``dst`` (two
    states of one structure) where they are not the same tensor."""
    if isinstance(src, dict):
        for key, value in src.items():
            copy_state(dst[key], value)
    elif isinstance(src, (list, tuple)):
        for d, value in zip(dst, src):
            copy_state(d, value)
    elif isinstance(src, torch.Tensor) and dst.data_ptr() != src.data_ptr():
        dst.copy_(src)


def _signature(state):
    if isinstance(state, dict):
        return tuple((key, _signature(value)) for key, value in state.items())
    if isinstance(state, (list, tuple)):
        return tuple(_signature(value) for value in state)
    if isinstance(state, torch.Tensor):
        return (tuple(state.shape), state.dtype, state.device)
    return None


def clone_state(state):
    """A copy of a model state (nested dicts, lists and tuples of tensors)
    whose tensors share no memory with the original."""
    if isinstance(state, dict):
        return {key: clone_state(value) for key, value in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(clone_state(value) for value in state)
    if isinstance(state, torch.Tensor):
        return state.clone()
    return state


class BucketedThresholdStep:
    """Escalating dispatch over a ladder of capacities.

    ``build_step(capacity)``: called once per capacity after the policies
    were set to it; returns ``step(state, *args) -> (out, new_state,
    counts)``, with ``counts`` from a counting context, so that it holds
    ``policy_saturated``. The port reads a policy's capacity when the step
    runs, so the policies are installed again on every dispatch to a
    bucket, before its step runs.
    """

    def __init__(self, model, build_step, threshold, capacities, decay_interval=16):
        self.model = model
        self.build_step = build_step
        self.threshold = threshold
        self.capacities = sorted(capacities)
        self.decay_interval = decay_interval
        self._steps = {}
        self._backups = {}  # state signature -> the backup state
        self._level = 0
        self._since_change = 0
        self.escalations = 0
        self.frames_per_level = [0] * len(self.capacities)

    def _step_for(self, level):
        capacity = self.capacities[level]
        set_policies(self.model, TokenNormThreshold, threshold=self.threshold, capacity=capacity)
        if capacity not in self._steps:
            self._steps[capacity] = self.build_step(capacity)
        return self._steps[capacity]

    def reset(self):
        """Back to the smallest capacity, for the next video (the built
        steps and the tallies stay)."""
        self._level = 0
        self._since_change = 0

    def _snapshot(self, state):
        """``state`` copied into its backup set (allocated at the first
        snapshot of its shape); returns the backup."""
        key = _signature(state)
        backup = self._backups.get(key)
        if backup is None:
            backup = self._backups[key] = clone_state(state)
        else:
            copy_state(backup, state)
        return backup

    def __call__(self, state, *args):
        if self._level > 0 and self._since_change >= self.decay_interval:
            self._level -= 1
            self._since_change = 0
        backup = None
        while True:
            step = self._step_for(self._level)
            at_top = self._level == len(self.capacities) - 1
            if backup is not None:
                copy_state(state, backup)  # the discarded run's writes undone
            if not at_top:
                backup = self._snapshot(state) if backup is None else backup
            out, new_state, counts = step(state, *args)
            # Reading the counts is this frame's one host synchronisation
            # (core/counting.py::Ctx.counts): the escalation decision needs
            # policy_saturated on the host, as in the JAX package, after the
            # step's graph has replayed where the step is captured.
            if counts["policy_saturated"] == 0.0 or at_top:
                self.frames_per_level[self._level] += 1
                self._since_change += 1
                return out, new_state, counts
            self.escalations += 1
            self._level += 1
            self._since_change = 0
