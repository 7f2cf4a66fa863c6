"""Time the attention kernel's wrappers in bfloat16 at the paths' shapes on
one NVIDIA GPU, beside ``scaled_dot_product_attention``.

    python3 scripts/misc/time_attention_bodies.py [ROOT]

Imports ``eventful_transformer_tpu_torch`` from ROOT (the checkout this
script lies in by default), so that two versions of the package, each in a
directory of its own, can be timed one after the other in one call on one
card. Builds the kernels, prints the registers and spills ptxas reported
for the tensor-core body (``csrc/attention_tc.cuh``), then, for each
wrapper and shape (ViViT's 8 x 197 global attention, the temporal 8 x 17,
ViTDet's 18 windows at 672, 9 at 672 with one stream, 50 at 1024, plain
and padded), checks the kernel against its plain version
(``kernel_check.errors``) and prints its ms and SDPA's (``kernel_check``'s
timing: 20 calls after 3 warm-ups) and their ratio. Needs a CUDA device.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parents[2]).resolve()
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from eventful_transformer_tpu_torch.ops import _build, kernel_check  # noqa: E402

# (tag, batch, N, k, make_inputs keywords, entries): chip_smoke.py's shapes
CASES = [
    ("vivit", 8, 197, 98, dict(window=(4, 6)),
     ("window_attention", "fused_attention", "fused_attention_cast", "qkv_attention_group")),
    ("temporal", 8, 17, 17, dict(window=(4, 6)), ("window_attention",)),
    ("672", 2, 1764, 256, dict(window=(14, 14), pool=(21, 21)), ("window_attention_windowed",)),
    ("e2e", 1, 1764, 256, dict(window=(14, 14), pool=(21, 21)), ("window_attention_windowed",)),
    ("1024", 2, 4096, 256,
     dict(window=(14, 14), windows=50, pool=(32, 32), pad_window=(14, 14)),
     ("window_attention_windowed", "window_attention_padded")),
]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("time_attention_bodies: needs a CUDA device")
    if not Path(kernel_check.__file__).resolve().is_relative_to(ROOT):
        raise SystemExit(f"imported the package from {kernel_check.__file__}, not {ROOT}")
    torch.backends.cuda.matmul.allow_tf32 = False
    start = time.perf_counter()
    _build.load_library()
    log = _build.library_path().with_suffix(".log").read_text().splitlines()
    ptxas = sorted({
        line.strip() for i, line in enumerate(log)
        if ("registers" in line or "spill" in line)
        and "attention_tc" in "".join(log[max(0, i - 3):i])
    })
    print("root", ROOT, "build_s", round(time.perf_counter() - start, 1), ptxas)
    device = torch.device("cuda")
    for tag, bsz, n, k, inputs, names in CASES:
        d = kernel_check.make_inputs(bsz, n, 768, 12, k, torch.bfloat16, device, seed=0, **inputs)
        for name in names:
            ok = all(row["ok"] for row in kernel_check.errors(name, d))
            ms = kernel_check.time_ms(name, d)
            library = kernel_check.library_call(name, d)
            sdpa = None if library is None else kernel_check.time_call(library)
            ratio = None if sdpa is None else round(ms / sdpa, 2)
            print(tag, name, "ms", round(ms, 4), "sdpa_ms", sdpa and round(sdpa, 4), "ratio", ratio,
                  "within bounds", ok, flush=True)
        del d
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
