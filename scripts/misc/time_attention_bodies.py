"""Time the attention kernel's wrappers, kernels A and B, the gate-fusion
kernels (rows 12 and 13) and the small row kernels in bfloat16 at the
paths' shapes on one NVIDIA GPU, each beside the one PyTorch call that
computes the same function (the GEMM rows: their yardstick), with the host
microseconds of one call.

    python3 scripts/misc/time_attention_bodies.py [ROOT] [--breakdown] [--case=TAG ...]

Imports ``eventful_transformer_tpu_torch`` from ROOT (the checkout this
script lies in by default), so that two versions of the package, each in a
directory of its own, can be timed one after the other in one call on one
card, under this script's timer for both. Prints the card's name and power
limit, builds the kernels, prints the registers and spills ptxas reported
for the tensor-core body (``csrc/attention_tc.cuh``), then, for each entry
and shape, checks the kernel against its plain version
(``kernel_check.errors``) and prints:

- its ms by CUDA events and that of its library call
  (``kernel_check.library_call``: SDPA; for the grid form the partition of
  the map, SDPA and the inverse partition; ``Tensor.scatter_``,
  ``torch.gather``, ``torch.where``, ``Tensor.index_put_`` for the row
  kernels; cuBLAS on the GEMM's operands for kernels A and B, with SDPA
  for A; none where the version timed has none), ITERS back-to-back calls
  after 3 warm-ups, and their ratio;
- the host microseconds of one call of each (``time.perf_counter_ns`` over
  ITERS back-to-back calls);
- the device microseconds of one call of the kernel: the sum of its
  kernels' times under ``torch.profiler`` over 20 calls, once per entry;

each the median of ROUNDS rounds, the kernel and the library call in turns,
since the host's times spread from one moment to the next. The timed call
is the wrapper's alone, its arguments resolved beforehand as the library
call's are. The entries: kernels A (``qkv_attention_group``, whose
attention stage is the attention kernel) and B (``proj_group``) at ViViT's
8 x 197; rows 12 (``ln_select_matmul``: "post" and "none" at the paper's
ViViT's 12 x 197, "pre" at ViViT's 8 x 197 with its gates before LN) and
13 (``select_linear_skip_norms``: with the next LN at 12 x 197, without
at 8 x 197); the attention wrappers (ViViT's 8 x 197 global attention, the
temporal 8 x 17, ViTDet's 18 windows at 672, 9 at 672 with
one stream, 50 at 1024, plain and padded; ``window_attention_grid`` on the
672 map, with and without the rel-pos tables, and on 1024's padded one)
and the row kernels whose host time is most of a call (rows 19
``scatter_rows_inplace``, 20 ``gather_rows``, 18 ``scatter_blend``, 14
``ln_select`` and 10 ``block_select_p`` without the LN, 11
``block_scatter_rows``). ``--case=TAG`` (repeatable) times only the
cases of those tags (``vivit``, ``temporal``, ``672``, ``e2e``,
``vivit_evblock``, ``vivit_pre_ln``, ``1024``). ``--breakdown`` (the checkout's own version
only) adds where the host time of one ``scatter_rows_inplace`` call at
C = 768 goes: its operand checks, the stream read, the C call, and the old
stream read through ``torch.cuda.current_stream`` for comparison. Needs a
CUDA device.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time
from pathlib import Path

ARGS = [a for a in sys.argv[1:] if not a.startswith("--")]
ROOT = Path(ARGS[0] if ARGS else Path(__file__).resolve().parents[2]).resolve()
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from eventful_transformer_tpu_torch.ops import _build, kernel_check  # noqa: E402

# (tag, batch, N, k, make_inputs keywords, entries): chip_smoke.py's shapes
CASES = [
    ("vivit", 8, 197, 98, dict(window=(4, 6)),
     ("window_attention", "fused_attention", "fused_attention_cast", "qkv_attention_group",
      "proj_group", "ln_select_noln")),
    ("temporal", 8, 17, 17, dict(window=(4, 6)), ("window_attention",)),
    ("672", 2, 1764, 256, dict(window=(14, 14), pool=(21, 21), pad_window=(14, 14)),
     ("window_attention_windowed", "window_attention_grid", "window_attention_grid_noterms",
      "scatter_rows_inplace", "scatter_rows_inplace_qkv", "scatter_rows_inplace_qkv_masked",
      "gather_rows_qkv", "scatter_blend", "scatter_blend_qkv", "block_select_p_noln")),
    ("e2e", 1, 1764, 256, dict(window=(14, 14), pool=(21, 21)), ("window_attention_windowed",)),
    ("vivit_evblock", 12, 197, 24, dict(window=(4, 6)),
     ("ln_select_matmul_post", "ln_select_matmul_none", "select_linear_skip_norms",
      "scatter_rows_inplace_qkv", "gather_rows_qkv")),
    ("vivit_pre_ln", 8, 197, 98, dict(window=(4, 6)),
     ("ln_select_matmul_pre", "select_linear_skip_norms_noln")),
    ("1024", 2, 4096, 256,
     dict(window=(14, 14), windows=50, pool=(32, 32), pad_window=(14, 14)),
     ("window_attention_windowed", "window_attention_padded", "window_attention_grid",
      "block_select_p_noln", "block_scatter_rows")),
]
TAGS = [a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--case=")]
ITERS = 200  # host-bound calls: more than kernel_check's 20, to average the host's spread
ROUNDS = 5


def host_us(fn, iters=ITERS):
    """As ``kernel_check.host_us``, written here so that a version without
    it is timed the same way."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter_ns()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter_ns() - start
    torch.cuda.synchronize()
    return elapsed / iters / 1e3


def device_us(fn, calls=20):
    """Device microseconds of one ``fn()`` call: its kernels' times summed
    under ``torch.profiler`` over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA")) / calls


def bound(name, fn, d):
    """``fn`` with entry ``name``'s arguments from ``d`` resolved once: the
    timed call is the wrapper's alone, as the library call is, and not
    ``kernel_check``'s dispatch on ``name``."""
    captured = []

    def record(*args, **kwargs):
        captured.append((args, kwargs))
        return (None,) * 8

    kernel_check._invoke(name, record, d)
    ((args, kwargs),) = captured
    return lambda: fn(*args, **kwargs)


def breakdown(device):
    """Host microseconds of the pieces of one scatter_rows_inplace call."""
    from eventful_transformer_tpu_torch.ops import scatter

    d = kernel_check.make_inputs(2, 1764, 768, 12, 256, torch.bfloat16, device, seed=0)
    buf, values, index = d["rows_buf"].clone(), d["rows_vals"], d["rows_index"]
    args = (_build.dtype_code(buf), _build.dtype_code(values), buf.data_ptr(), values.data_ptr(),
            index.data_ptr(), 0, 0, 2, 1764, 768, 256, _build.stream_of(buf))
    pieces = {
        "wrapper": lambda: scatter.scatter_rows_inplace(buf, values, index),
        "checks": lambda: scatter._check_cuda("scatter_rows_inplace", buf, index, values),
        "stream_of": lambda: _build.stream_of(buf),
        "current_stream (old)": lambda: torch.cuda.current_stream(buf.device).cuda_stream,
        "launch (C call + kernel launch)": lambda: _build.launch("etk_scatter_rows", *args),
        "Tensor.scatter_": kernel_check.library_call("scatter_rows_inplace", d),
    }
    for label, fn in pieces.items():
        print("breakdown", label, "host_us", round(host_us(fn), 3), flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("time_attention_bodies: needs a CUDA device")
    if not Path(kernel_check.__file__).resolve().is_relative_to(ROOT):
        raise SystemExit(f"imported the package from {kernel_check.__file__}, not {ROOT}")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    ).stdout.strip()
    start = time.perf_counter()
    _build.load_library()
    log = _build.library_path().with_suffix(".log").read_text().splitlines()
    ptxas = sorted({
        line.strip() for i, line in enumerate(log)
        if ("registers" in line or "spill" in line)
        and "attention_tc" in "".join(log[max(0, i - 3):i])
    })
    print("card", smi, "root", ROOT, "build_s", round(time.perf_counter() - start, 1), ptxas)
    device = torch.device("cuda")
    for tag, bsz, n, k, inputs, names in CASES:
        if TAGS and tag not in TAGS:
            continue
        d = kernel_check.make_inputs(bsz, n, 768, 12, k, torch.bfloat16, device, seed=0, **inputs)
        for name in names:
            ok = all(row["ok"] for row in kernel_check.errors(name, d))
            dd = {key: v.clone() if torch.is_tensor(v) else v for key, v in d.items()}
            call = bound(name, kernel_check.KERNELS[name][0], dd)
            library = kernel_check.library_call(name, d)
            times = {"ms": [], "us": [], "lib_ms": [], "lib_us": []}
            for _ in range(ROUNDS):
                times["ms"].append(kernel_check.time_call(call, ITERS))
                times["us"].append(host_us(call))
                if library is not None:
                    times["lib_ms"].append(kernel_check.time_call(library, ITERS))
                    times["lib_us"].append(host_us(library))
            ms, us, lib_ms, lib_us = (statistics.median(v) if v else None for v in times.values())
            ratio = None if lib_ms is None else round(ms / lib_ms, 2)
            print(tag, name, "ms", round(ms, 4), "host_us", round(us, 2), "device_us",
                  round(device_us(call), 2),
                  "library_ms", lib_ms and round(lib_ms, 4), "library_host_us",
                  lib_us and round(lib_us, 2), "ratio", ratio, "within bounds", ok, flush=True)
            del dd
        del d
        torch.cuda.empty_cache()
    if "--breakdown" in sys.argv:
        breakdown(device)


if __name__ == "__main__":
    main()
