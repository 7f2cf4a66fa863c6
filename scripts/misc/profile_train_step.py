"""Profile one step of the ViViT temporal fine-tune on one NVIDIA GPU.

    python3 scripts/misc/profile_train_step.py [--steps 6] [--out-dir DIR]

Builds the model of configs/train/vivit_kinetics400/final_24.yml as
``chip_smoke.py``'s train phase does (the full ViViT-B K400 model,
temporal_only, weights from the seed, float32; AdamW lr 2e-6, weight decay
0.05, dropout 0.5) and one generated batch of ``train_batch_size`` clips of
(12, 16, 768) features (192 sequences of 17 tokens), warms up one step,
then:

- CUDA events around the forward (``loss_fn`` under
  ``Ctx(training=True)``), the backward and the optimizer's step of each of
  ``--steps`` steps, and the peak of allocated memory;
- a ``torch.profiler`` trace of one step: device time by kernel, and the
  device's busy share (the kernels' device time over the step's wall
  time).

Prints one JSON line and writes the profiler's kernel table to
``<out-dir>/profile_train_step.txt`` (``results/profile`` by default).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from eventful_transformer_tpu_torch.core.counting import Ctx  # noqa: E402
from eventful_transformer_tpu_torch.models import FactorizedViViT  # noqa: E402
from eventful_transformer_tpu_torch.utils.train import loss_fn, make_optimizer  # noqa: E402


def step(model, optimizer, inputs, labels, generator, events=None):
    """One optimizer step, CUDA events (start, forward, backward, step)
    recorded where given."""
    mark = (lambda i: events[i].record()) if events else (lambda i: None)
    mark(0)
    optimizer.zero_grad(set_to_none=True)
    loss, _ = loss_fn(model, inputs, labels, Ctx(training=True, generator=generator))
    mark(1)
    loss.backward()
    mark(2)
    optimizer.step()
    mark(3)
    return loss


def device_us(event):
    return getattr(event, "self_device_time_total", None) or getattr(event, "self_cuda_time_total", 0)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=6)
    parser.add_argument("--out-dir", type=Path, default=REPO / "results" / "profile")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_step: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    args.out_dir.mkdir(parents=True, exist_ok=True)
    smi = cs.phase_env()
    config = cs.harness_config("vivit_kinetics400", [cs.TRAIN_CONFIG], kind="train")
    model = FactorizedViViT(**{"seed": cs.SEED, **config["model"]}, device=device)
    optimizer = make_optimizer(config, model)
    rng = np.random.default_rng(cs.SEED)
    batch = config["train_batch_size"]
    shape = (batch, *cs.train_shape(config["model"]))
    inputs = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
    labels = torch.from_numpy(rng.integers(0, 400, batch)).to(device)
    generator = torch.Generator(device=device).manual_seed(42)
    step(model, optimizer, inputs, labels, generator)  # warm-up
    torch.cuda.reset_peak_memory_stats(device)
    parts = []
    for _ in range(args.steps):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        step(model, optimizer, inputs, labels, generator, events)
        torch.cuda.synchronize()
        parts.append([a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])])
    peak = torch.cuda.max_memory_allocated(device)

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        step(model, optimizer, inputs, labels, generator)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    averages = prof.key_averages()
    on_device = [e for e in averages if str(getattr(e, "device_type", "")).endswith("CUDA")]
    device_ms = sum(device_us(e) for e in on_device) / 1e3
    (args.out_dir / "profile_train_step.txt").write_text(
        averages.table(sort_by="self_cuda_time_total", row_limit=60))
    top = sorted(on_device, key=device_us, reverse=True)
    print(json.dumps(dict(
        card=smi, config=f"train/vivit_kinetics400/{cs.TRAIN_CONFIG}", dtype="float32",
        sequences=batch * shape[1], tokens=shape[2] + 1,
        columns=["forward_ms", "backward_ms", "optimizer_ms"], step_parts_ms=parts,
        max_memory_allocated=peak, profiled_step_wall_ms=wall * 1e3,
        profiled_step_device_ms=device_ms, device_busy_share=device_ms / (wall * 1e3),
        top_kernels=[dict(name=e.key[:90], device_ms=device_us(e) / 1e3, calls=e.count)
                     for e in top[:15]],
    )), flush=True)


if __name__ == "__main__":
    main()
