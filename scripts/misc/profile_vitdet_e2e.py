"""Profile ViTDet-B detection end to end at 672 on one NVIDIA GPU.

    python3 scripts/misc/profile_vitdet_e2e.py [--frames 4] [--out-dir DIR] [--coco]

Builds spatiotemporal_672 (k = 256) and base_672 as ``chip_smoke.py``'s
e2e phase does (weights from the seed, bfloat16, one stream), or with
``--coco`` ViTDet-B COCO at 1024 as its coco phase does
(configs/models/vitdet_b_coco.yml, dense, the cascade and mask heads), runs a flush
frame and ``--frames`` frames through ``ViTDet.apply`` once to warm up,
then for each model:

- CUDA events around the backbone (``pre_backbone`` + ``apply_backbone``)
  and the head (``post_backbone``: pyramid, RPN, ROIAlign, NMS, ROI
  heads) of every incremental frame, and the NMS loops' host
  synchronisations per frame;
- a ``torch.profiler`` trace of one call: device time by kernel, and the
  device's busy share (the kernels' device time over the call's wall
  time).

Prints one JSON line per model and writes the profiler's kernel tables to
``<out-dir>/profile_vitdet_e2e_<model>.txt`` (``results/profile`` by
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
from eventful_transformer_tpu_torch.core.counting import Ctx  # noqa: E402
from eventful_transformer_tpu_torch.detection import nms  # noqa: E402


def split_frames(model, frames):
    """[(backbone ms, head ms)] of every incremental frame, CUDA events."""
    ctx = Ctx()
    state = model.init_state(1, frames.dtype, frames.device)
    aux = model.precompute()
    eventful = "qkv_gate" in state["blocks"][0]
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(3)] for _ in range(frames.shape[0])]
    for t in range(frames.shape[0]):
        mode = ("flush" if t == 0 else "incremental") if eventful else None
        events[t][0].record()
        tokens = model.pre_backbone(ctx, frames[t])
        tokens, state = model.apply_backbone(ctx, state, tokens, aux, mode=mode)
        events[t][1].record()
        model.post_backbone(ctx, tokens)
        events[t][2].record()
    torch.cuda.synchronize()
    return [(a.elapsed_time(b), b.elapsed_time(c)) for a, b, c in events[1:]]


def device_us(event):
    return getattr(event, "self_device_time_total", None) or getattr(event, "self_cuda_time_total", 0)


def profile_call(model, frames, name, out_dir):
    """One e2e call under torch.profiler: (busy share, device ms per frame,
    the top kernels by device time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        cs.run_e2e(model, frames)
        wall = time.perf_counter() - start
    averages = prof.key_averages()
    # the kernels and copies on the device, not the host ops that launched them
    on_device = [e for e in averages if str(getattr(e, "device_type", "")).endswith("CUDA")]
    device_total = sum(device_us(e) for e in on_device) / 1e3
    (out_dir / f"profile_vitdet_e2e_{name}.txt").write_text(
        averages.table(sort_by="self_cuda_time_total", row_limit=60))
    top = sorted(on_device, key=device_us, reverse=True)[:15]
    kernels = [dict(name=e.key[:90], device_ms=device_us(e) / 1e3, calls=e.count) for e in top]
    return device_total / (wall * 1e3), device_total / frames.shape[0], kernels


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=4)
    parser.add_argument("--out-dir", type=Path, default=REPO / "results" / "profile")
    parser.add_argument("--coco", action="store_true",
                        help="ViTDet-B COCO at 1024 (the cascade and mask heads) instead")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_vitdet_e2e: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    out_dir = args.out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = cs.phase_env()
    if args.coco:
        size = cs.COCO_SIZE
        builds = {"coco": lambda: cs.coco_model(device, torch.bfloat16)}
    else:
        size = cs.E2E_SIZE
        builds = {name: lambda eventful=eventful: cs.e2e_model(eventful, device, torch.bfloat16)
                  for name, eventful in (("eventful", True), ("dense", False))}
    frames = cs.vitdet_frames(args.frames + 1, 1, device, torch.bfloat16, size)
    for name, build in builds.items():
        model = build()
        cs.run_e2e(model, frames)  # warm-up: builds, cuDNN plans
        syncs = nms.host_syncs
        split = split_frames(model, frames)
        syncs = (nms.host_syncs - syncs) / frames.shape[0]
        busy, device_ms, kernels = profile_call(model, frames, name, out_dir)
        print(json.dumps(dict(
            model=name, card=smi, frames=args.frames + 1,
            backbone_ms=[round(b, 4) for b, _ in split], head_ms=[round(h, 4) for _, h in split],
            nms_host_syncs_per_frame=syncs, device_busy_share=busy,
            device_ms_per_frame=device_ms, top_kernels=kernels,
        )), flush=True)
        del model
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
