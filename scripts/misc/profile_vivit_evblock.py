"""Profile the eventful ViViT-B K400 models of ``chip_smoke.py`` on one NVIDIA GPU.

    python3 scripts/misc/profile_vivit_evblock.py [--runs flagship_dense flagship dense auto v3]
        [--out-dir DIR]

Two configurations, each beside its dense twin (weights from the seed,
bfloat16):
- the flagship (``chip_smoke.py``'s phases ``slice`` and ``time``):
  ``EventfulTokenwiseBlock``, k = 98, the "v4" step, on the bench's input (2
  clips x 4 views x 32 frames x 224 x 224) through
  ``FactorizedViViT.apply_views``: runs ``flagship`` and ``flagship_dense``;
- the paper's (the ``vivit_evblock`` phases): ``EventfulBlock``, k = 24, 12
  views, one raw clip (1 x 250 x 3 x 224 x 398 uint8) through
  ``FactorizedViViT.apply``: runs ``dense`` and each named run of
  ``chip_smoke.EV_RUNS``.
Each run goes once through its model to warm up, three times under CUDA
events (ms per clip, no profiler), then once under ``torch.profiler``: the
device's busy share (the kernels' device time over the call's wall time),
the device ms per clip, the device kernels launched per clip and the top
kernels by device time. Prints one JSON line per run
and writes the profiler's tables to ``<out-dir>/profile_vivit_<run>.txt``
(``results/profile`` by default). Needs a CUDA device.
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
from profile_vitdet_e2e import device_us  # noqa: E402

FLAGSHIP_RUNS = ("flagship_dense", "flagship")


def profile_run(run, clips, name, out_dir):
    """``run()`` (``clips`` clips) under torch.profiler: (busy share, device
    ms per clip, kernels launched per clip, wall ms per clip, the top
    kernels by device time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        run()
        wall = time.perf_counter() - start
    averages = prof.key_averages()
    on_device = [e for e in averages if str(getattr(e, "device_type", "")).endswith("CUDA")]
    device_total = sum(device_us(e) for e in on_device) / 1e3
    (out_dir / f"profile_vivit_{name}.txt").write_text(
        averages.table(sort_by="self_cuda_time_total", row_limit=60))
    top = sorted(on_device, key=device_us, reverse=True)[:12]
    kernels = [dict(name=e.key[:90], device_ms=device_us(e) / 1e3, calls=e.count) for e in top]
    launched = sum(e.count for e in on_device)
    return (device_total / (wall * 1e3), device_total / clips, launched / clips,
            wall * 1e3 / clips, kernels)


def ms_per_clip(run, clips, iters=3):
    """Mean ms per clip of ``run()`` over ``iters`` calls, CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters / clips


def flagship(device):
    """The flagship's models, eventful and dense, in bfloat16 on the card,
    built as phase ``slice`` builds them, and the bench's input."""
    from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
    from eventful_transformer_tpu_torch.models import FactorizedViViT
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    views = np.random.default_rng(0).standard_normal(
        (cs.CLIPS, cs.VIEWS, cs.FRAMES, 3, cs.SIZE, cs.SIZE)).astype(np.float32)
    models = {}
    for eventful in (True, False):
        model = FactorizedViViT(**cs.vivit_config(eventful), device="cpu", seed=cs.SEED)
        if eventful:
            set_policies(model, TokenNormTopK, k=cs.K)
        models[eventful] = model.to(device, torch.bfloat16)
    return models, torch.from_numpy(views).to(device, torch.bfloat16)


def runs(names, device):
    """(name, run, clips) of each named run, its models built once."""
    out = []
    if any(name in FLAGSHIP_RUNS for name in names):
        models, views = flagship(device)
        for name in names:
            if name in FLAGSHIP_RUNS:
                model = models[name == "flagship"]
                out.append((name, lambda m=model: cs.run_model(m, views), views.shape[0]))
    if any(name not in FLAGSHIP_RUNS for name in names):
        clip = cs.ev_clip(device)
        eventful = cs.ev_model(True, device, torch.bfloat16)
        dense = cs.ev_model(False, device, torch.bfloat16)
        for name in names:
            if name in FLAGSHIP_RUNS:
                continue

            def run(name=name):
                if name != "dense":
                    cs.set_ev_run(eventful, cs.EV_RUNS[name])
                cs.run_apply(dense if name == "dense" else eventful, clip)

            out.append((name, run, 1))
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", nargs="+", default=["flagship_dense", "flagship", "dense",
                                                      "auto", "v3"],
                        choices=[*FLAGSHIP_RUNS, "dense", *cs.EV_RUNS])
    parser.add_argument("--out-dir", type=Path, default=REPO / "results" / "profile")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_vivit_evblock: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    args.out_dir.mkdir(parents=True, exist_ok=True)
    smi = cs.phase_env()
    for name, run, clips in runs(args.runs, device):
        run()  # warm-up
        ms = ms_per_clip(run, clips)
        busy, device_ms, launched, wall_ms, kernels = profile_run(run, clips, name, args.out_dir)
        print(json.dumps(dict(
            run=name, card=smi, ms_per_clip=ms, wall_ms_per_clip=wall_ms, device_busy_share=busy,
            device_ms_per_clip=device_ms, device_kernels_per_clip=launched, top_kernels=kernels,
        )), flush=True)


if __name__ == "__main__":
    main()
