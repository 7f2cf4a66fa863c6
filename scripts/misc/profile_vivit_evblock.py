"""Profile the paper's eventful ViViT-B K400 configuration on one NVIDIA GPU.

    python3 scripts/misc/profile_vivit_evblock.py [--runs dense auto v3] [--out-dir DIR]

Builds the models of ``chip_smoke.py``'s ``vivit_evblock`` phases (weights
from the seed, bfloat16; EventfulBlock, k = 24, 12 views) and its raw clip
(1 x 250 x 3 x 224 x 398 uint8), runs one clip through
``FactorizedViViT.apply`` to warm up, then one clip under
``torch.profiler`` for the dense twin and for each named run of
``chip_smoke.EV_RUNS``: the device's busy share (the kernels' device time
over the call's wall time), the device ms per clip, the device kernels
launched per clip and the top kernels by device time. Prints one JSON line
per run and writes the profiler's tables to
``<out-dir>/profile_vivit_evblock_<run>.txt`` (``results/profile`` by
default). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from profile_vitdet_e2e import device_us  # noqa: E402


def profile_clip(model, clip, name, out_dir):
    """One clip under torch.profiler: (busy share, device ms, kernels
    launched, the top kernels by device time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        cs.run_apply(model, clip)
        wall = time.perf_counter() - start
    averages = prof.key_averages()
    on_device = [e for e in averages if str(getattr(e, "device_type", "")).endswith("CUDA")]
    device_total = sum(device_us(e) for e in on_device) / 1e3
    (out_dir / f"profile_vivit_evblock_{name}.txt").write_text(
        averages.table(sort_by="self_cuda_time_total", row_limit=60))
    top = sorted(on_device, key=device_us, reverse=True)[:12]
    kernels = [dict(name=e.key[:90], device_ms=device_us(e) / 1e3, calls=e.count) for e in top]
    launched = sum(e.count for e in on_device)
    return device_total / (wall * 1e3), device_total, launched, wall * 1e3, kernels


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", nargs="+", default=["dense", "auto", "v3"],
                        choices=["dense", *cs.EV_RUNS])
    parser.add_argument("--out-dir", type=Path, default=REPO / "results" / "profile")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_vivit_evblock: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    args.out_dir.mkdir(parents=True, exist_ok=True)
    smi = cs.phase_env()
    clip = cs.ev_clip(device)
    eventful = cs.ev_model(True, device, torch.bfloat16)
    dense = cs.ev_model(False, device, torch.bfloat16)
    for name in args.runs:
        model = dense if name == "dense" else eventful
        if name != "dense":
            cs.set_ev_run(eventful, cs.EV_RUNS[name])
        cs.run_apply(model, clip)  # warm-up
        busy, device_ms, launched, wall_ms, kernels = profile_clip(model, clip, name, args.out_dir)
        print(json.dumps(dict(
            run=name, card=smi, wall_ms_per_clip=wall_ms, device_busy_share=busy,
            device_ms_per_clip=device_ms, device_kernels_per_clip=launched, top_kernels=kernels,
        )), flush=True)


if __name__ == "__main__":
    main()
