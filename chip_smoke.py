"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, eventful ViViT-B inference on Kinetics-400
shaped clips, through ``FactorizedViViT.apply_views`` and the six
hand-written kernels, and checks it. Phases, one JSON line each:

  1. env:     torch, CUDA and nvcc versions and the card (nvidia-smi).
  2. build:   nvcc builds the kernels from eventful_transformer_tpu_torch/csrc.
  3. kernels: each kernel against its plain PyTorch version at the main
              path's shapes, float32 and bfloat16, each output within the
              bounds stated in ops/kernel_check.py, and both timed.
  4. slice:   eventful ViViT-B (k=98 of 197 tokens) on the bench's input in
              bfloat16, with the kernels' launch counts (and the dense
              twin's); one clip in
              float32 on the card against the same model on the CPU (plain
              versions); counted GFLOPs/clip of the eventful model and its
              dense twin against the JAX package's counts.
  5. time:    dense twin against eventful, ms/clip (a record, not a claim).

Then the card's name and power limit, one JSON line with every kernel's
numbers, and last ``{"ok": true, "device": {...}}``. Any failed check
raises, and the script exits non-zero; without a CUDA device it raises
before printing any result. Imports nothing of JAX.
"""

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

# Weights come from this seed; the input is the bench's: rng seed 0,
# standard normal, 2 clips x 4 views x 32 frames x 3 x 224 x 224.
SEED = 0
CLIPS, VIEWS, FRAMES, SIZE = 2, 4, 32, 224
N_TOKENS, K = 197, 98
STEPS = FRAMES // 2  # tubelet [2, 16, 16]: 16 steps, step 0 a flush
DEPTH, TEMPORAL_DEPTH = 12, 4
# The JAX package's counted GFLOPs/clip at this point (BENCH_r05.json)
GFLOPS_DENSE, GFLOPS_EVENTFUL = 1119.86, 615.18
# One clip in float32, card against CPU: the sums run in other orders, so
# norms differ in their last bits and a near tie at the k-th norm can
# select another token; each such flip moves one token's update.
PROB_TOL = 1e-5  # max |probability difference|, probabilities ~ 1/400
MAX_FLIP_SHARE = 1e-3  # of all gate selections made in the clip


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def vivit_config(eventful):
    block = dict(dim=768, heads=12, mlp_ratio=4)
    return dict(
        classes=400, input_shape=[FRAMES, 3, SIZE, SIZE], normalize_mean=0.45,
        normalize_std=0.225, spatial_views=1, temporal_stride=2, temporal_views=VIEWS,
        tubelet_shape=[2, 16, 16],
        spatial_config=dict(
            depth=DEPTH, position_encoding_size=[14, 14],
            block_class="EventfulTokenwiseBlock" if eventful else "Block",
            block_config=block,
        ),
        temporal_config=dict(
            depth=TEMPORAL_DEPTH, position_encoding_size=[16], block_config=block
        ),
    )


def phase_env():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's main path needs one")
    import eventful_transformer_tpu_torch
    from eventful_transformer_tpu_torch.ops import _build

    package = Path(eventful_transformer_tpu_torch.__file__).resolve().parent
    if package.parent != REPO:
        raise RuntimeError(f"imported the port from {package}, not from this checkout")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    nvcc = subprocess.run(
        [_build.nvcc_path(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit(
        "env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, nvcc=nvcc, nvidia_smi=smi,
        device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
    )
    return smi


def phase_build():
    from eventful_transformer_tpu_torch.ops import _build

    start = time.perf_counter()
    _build.load_library()
    seconds = time.perf_counter() - start
    log = _build.library_path().with_suffix(".log").read_text()
    spills = sorted({
        line.strip() for line in log.splitlines()
        if "spill" in line and not line.strip().startswith("0 bytes stack frame, 0 bytes spill")
    })
    emit("build", seconds=round(seconds, 3), library=_build.library_path().name,
         spill_lines=spills)


def phase_kernels(device):
    """Every kernel at the spatial stack's shapes (N = 197); the two dense
    kernels also at the temporal model's (N = 17)."""
    from eventful_transformer_tpu_torch.ops import kernel_check

    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        for n in (N_TOKENS, STEPS + 1):
            d = kernel_check.make_inputs(8, n, 768, 12, min(K, n), dtype, device, seed=SEED)
            names = kernel_check.KERNELS if n == N_TOKENS else DENSE_KERNELS
            for name in names:
                results[(name, dtype, n)] = dict(
                    kernel=name, dtype=str(dtype).split(".")[-1], n=n,
                    outputs=kernel_check.errors(name, d),
                    ms=kernel_check.time_ms(name, d),
                    plain_ms=kernel_check.time_ms(name, d, plain=True),
                )
    emit("kernels", bounds=dict(float32_scaled=kernel_check.F32_SCALED,
                                **kernel_check.BF16_BOUNDS),
         rows=list(results.values()))
    for (name, dtype, n), row in results.items():
        for out in row["outputs"]:
            if not out["ok"]:
                raise AssertionError(f"{name} {dtype} N={n} output {out['output']}: {out}")
    return results


def run_model(model, views, count=False):
    from eventful_transformer_tpu_torch.core.counting import Ctx

    ctx = Ctx(count_mode=count)
    with torch.no_grad():
        out = model.apply_views(ctx, views)
    if views.is_cuda:
        torch.cuda.synchronize()
    return out, ctx.counts


def gflops(counts):
    return sum(v for k, v in counts.items() if k != "policy_saturated") / 1e9


# the kernels of the dense blocks (the eventful flush step, the temporal
# model and the whole dense twin)
DENSE_KERNELS = ("window_attention", "dense_mlp_residual")


def wrappers():
    from eventful_transformer_tpu_torch.ops import kernel_check

    return {name: entry[0] for name, entry in kernel_check.KERNELS.items()}


def expected_launches(eventful):
    """Launches per forward. Eventful: 15 incremental steps, ln_norms once
    per step (the first block) and kernels A, B and C once per block and
    step; the flush step's 12 blocks and the 4 temporal blocks run the
    global attention, the temporal blocks the dense MLP. The dense twin
    runs both dense kernels in every block at every step."""
    want = dict.fromkeys(wrappers(), 0)
    if eventful:
        want.update(dict.fromkeys(("qkv_attention_group", "proj_group", "gate_group_mlp"),
                                  DEPTH * (STEPS - 1)))
        want["ln_norms"] = STEPS - 1
        want["window_attention"] = DEPTH + TEMPORAL_DEPTH
        want["dense_mlp_residual"] = TEMPORAL_DEPTH
    else:
        want.update(dict.fromkeys(DENSE_KERNELS, DEPTH * STEPS + TEMPORAL_DEPTH))
    return want


def counted_run(model, views, eventful):
    """One forward with every launch count set to 0 just before and read
    just after; checks the counts and the class probabilities."""
    for fn in wrappers().values():
        fn.launches = 0
    probs, _ = run_model(model, views)
    launches = {name: fn.launches for name, fn in wrappers().items()}
    want = expected_launches(eventful)
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    probs = probs.float()
    if probs.shape != (views.shape[0], 400) or not torch.isfinite(probs).all():
        raise AssertionError(f"bad output: shape {tuple(probs.shape)}")
    sums = probs.sum(-1)
    if not torch.allclose(sums, torch.ones_like(sums), atol=1e-2):
        raise AssertionError(f"probabilities sum to {sums.tolist()}")
    return launches, sums.tolist()


def card_vs_cpu(cpu_model, clip, device):
    """One clip in float32 on the card against the same model on the CPU,
    where every kernel wrapper runs its plain version. The coverages each
    run selects are recorded around the blocks' coverage_from_norms.
    Returns the numbers compared and the card run's counts."""
    from eventful_transformer_tpu_torch.core import blocks

    card_model = copy.deepcopy(cpu_model).to(device)
    coverage_from_norms = blocks.coverage_from_norms
    logs = {"card": [], "cpu": []}
    runs = {}
    try:
        for tag, model, views in (("card", card_model, clip.to(device)), ("cpu", cpu_model, clip)):
            def recorded(norms, k, log=logs[tag]):
                cov = coverage_from_norms(norms, k)
                log.append(cov)
                return cov

            blocks.coverage_from_norms = recorded
            start = time.perf_counter()
            runs[tag] = run_model(model, views, count=True)
            runs[tag + "_s"] = time.perf_counter() - start
    finally:
        blocks.coverage_from_norms = coverage_from_norms
    if not logs["card"] or len(logs["cpu"]) != len(logs["card"]):
        raise AssertionError("the two runs selected at different numbers of gates")
    prob_diff = float((runs["card"][0].cpu() - runs["cpu"][0]).abs().max())
    selections = flips = 0
    for a, b in zip(logs["card"], logs["cpu"]):
        selections += int(b.sum())
        flips += int((a.cpu() != b).sum()) // 2  # a flip swaps one token for another
    numbers = dict(
        f32_card_vs_cpu_max_prob_diff=prob_diff, prob_tol=PROB_TOL,
        gate_selections=selections, selections_differing=flips,
        max_flip_share=MAX_FLIP_SHARE, f32_card_s=runs["card_s"], f32_cpu_s=runs["cpu_s"],
    )
    if prob_diff > PROB_TOL or flips > MAX_FLIP_SHARE * selections:
        raise AssertionError(f"float32 card run disagrees with the CPU run: {numbers}")
    return numbers, runs["card"][1]


def phase_slice(device):
    from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
    from eventful_transformer_tpu_torch.models import FactorizedViViT
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    views = np.random.default_rng(0).standard_normal(
        (CLIPS, VIEWS, FRAMES, 3, SIZE, SIZE)
    ).astype(np.float32)
    views = torch.from_numpy(views)
    cpu_model = FactorizedViViT(**vivit_config(True), seed=SEED)
    set_policies(cpu_model, TokenNormTopK, k=K)
    dense_cpu = FactorizedViViT(**vivit_config(False), seed=SEED)

    eventful = copy.deepcopy(cpu_model).to(device, torch.bfloat16)
    dense = copy.deepcopy(dense_cpu).to(device, torch.bfloat16)
    views_bf16 = views.to(device, torch.bfloat16)
    launches, sums = counted_run(eventful, views_bf16, eventful=True)
    dense_launches, _ = counted_run(dense, views_bf16, eventful=False)
    numbers, counts = card_vs_cpu(cpu_model, views[:1], device)
    dense_counts = run_model(copy.deepcopy(dense_cpu).to(device), views[:1].to(device), True)[1]
    g_dense, g_eventful = gflops(dense_counts), gflops(counts)
    emit(
        "slice", launches=launches, dense_twin_launches=dense_launches,
        bf16_probs_sum=sums, **numbers,
        gflops_per_clip_dense=g_dense, gflops_per_clip_eventful=g_eventful,
    )
    for got, target in ((g_dense, GFLOPS_DENSE), (g_eventful, GFLOPS_EVENTFUL)):
        if abs(round(got, 2) - target) > 1e-6:
            raise AssertionError(f"counted {got} GFLOPs/clip, expected {target}")
    return eventful, dense, views_bf16, launches


def time_model(model, views, warmup=1, iters=3):
    for _ in range(warmup):
        run_model(model, views)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run_model(model, views)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters / views.shape[0]


def phase_time(eventful, dense, views, smi):
    # alternate the two so that drift of clocks and power hits both alike
    times = {"dense": [], "eventful": []}
    for name in ("dense", "eventful", "eventful", "dense"):
        times[name].append(time_model(eventful if name == "eventful" else dense, views))
    emit(
        "time", card=smi, clips=views.shape[0], views=VIEWS, frames=FRAMES, k=K,
        dtype="bfloat16", dense_ms_per_clip=times["dense"],
        eventful_ms_per_clip=times["eventful"],
    )


def main():
    smi = phase_env()
    device = torch.device("cuda", 0)
    phase_build()
    kernel_rows = phase_kernels(device)
    eventful, dense, views, launches = phase_slice(device)
    phase_time(eventful, dense, views, smi)
    from eventful_transformer_tpu_torch.ops import kernel_check

    kernels = []
    for name, (_, _, source, replaces, _) in kernel_check.KERNELS.items():
        row = kernel_rows[(name, torch.bfloat16, N_TOKENS)]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(out["max_abs_err"] for out in row["outputs"]),
            ms=row["ms"], plain_ms=row["plain_ms"],
        ))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
