"""Time the attention kernel's wrappers, kernels A and B, the gate-fusion
kernels (rows 12 and 13), the A.V kernel (row 8), the row passes of rows 1
and 9, the rel-pos bias add (rows 16 and 17) and the small row kernels in
bfloat16 at the paths' shapes on one
NVIDIA GPU, each beside the one
PyTorch call that computes the same function (the GEMM rows: their
yardstick), with the host microseconds of one call.

    python3 scripts/misc/time_attention_bodies.py [ROOT] [--breakdown] [--tiles]
        [--row11] [--case=TAG ...] [--entry=NAME ...]
    python3 scripts/misc/time_attention_bodies.py [ROOT] --f32 [--simt-tiles]
        [--outputs=FILE] [--case=TAG ...] [--entry=NAME ...]
    python3 scripts/misc/time_attention_bodies.py [ROOT] --nms [--nms-inputs=FILE]

Imports ``eventful_transformer_tpu_torch`` from ROOT (the checkout this
script lies in by default), so that two versions of the package, each in a
directory of its own, can be timed one after the other in one call on one
card, under this script's timer for both. Prints the card's name and power
limit, builds the kernels, prints the registers and spills ptxas reported
for the tensor-core body (``csrc/attention_tc.cuh``) and for the rel-pos
kernels (``ptxas relpos``), then, for each entry
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
  ITERS back-to-back calls), and of one call of the kernel made with the
  card idle (``host_idle_us``: the median of calls each after a
  synchronisation, which no full launch queue can hold back);
- the device microseconds of one call of the kernel: the sum of its
  kernels' times under ``torch.profiler`` over 20 calls, once per entry
  (where the profiler catches no device event, CUDA events around 20
  calls queued behind a sleeping kernel, ``device_us_by``),
  beside the card's bound for the same work (``kernel_check.bound``) and
  the share of it they reach, and the device microseconds of one library
  call measured the same way (``library_device_us``);
  and the kernels one call launches (the profiler's kernel names, short,
  each with its launches and device microseconds a call) and the device
  allocations it makes (the caching allocator's count,
  ``allocation.all.allocated``);

each the median of ROUNDS rounds, the kernel and the library call in turns,
since the host's times spread from one moment to the next. The timed call
is the wrapper's alone, its arguments resolved beforehand as the library
call's are. The entries: kernels A (``qkv_attention_group``, whose
attention stage is the attention kernel) and B (``proj_group``) at ViViT's
8 x 197; row 7 (``gate_group_linear``: "post", "none" and "pre", each also
selecting its own rows, at ViTDet-672's 2 x 1764, k = 256; "post" and
"none" at the e2e path's one stream) and row 4 (``gate_group_mlp``, which
shares its compaction and gathered GEMM, at 672); rows 12
(``ln_select_matmul``: "post" and "none" at the paper's ViViT's 12 x 197,
"pre" at ViViT's 8 x 197 with its gates before LN) and
13 (``select_linear_skip_norms``: with the next LN at 12 x 197, without
at 8 x 197); row 8 (``softmax_select_matmul``: the fused form with
rel-pos terms at ViTDet-1024's global blocks, 2 x 4096 queries over 32 x
32 pooled keys, and on the e2e path, 1 x 1764 over 21 x 21; the logits
form without terms at the paper's ViViT's cached product, 12 views x 197
over 197 keys); the attention wrappers (ViViT's 8 x 197 global attention, the
temporal 8 x 17, ViTDet's 18 windows at 672, 9 at 672 with
one stream, 50 at 1024, plain and padded; ``window_attention_grid`` on the
672 map, with and without the rel-pos tables, and on 1024's padded one)
and the row passes of rows 1 (``ln_norms`` at ViViT's 8 x 197, the
paper's ViViT's 12 x 197, ViTDet-672's 2 x 1764 and 1024's 2 x 4096) and 9
(``block_select_scatter`` at 1024: the qkv, projection and MLP forms and
the qkv and MLP forms without the LN), the rel-pos bias add (row 17
``relpos_bias_add_v2`` over 672's dense 42 x 42 and pooled 21 x 21 keys at
2 x 1764, 1024's dense 64 x 64 and flush 32 x 32 keys at 2 x 4096, the e2e
path's dense and 21 x 21 keys at 1 x 1764; row 16 ``relpos_bias_add`` at
the last: each line names its ``keys``, and where x and out fit the 50 MB
L2 also reads ``device_us_l2_flushed``, the device microseconds with the
L2 emptied before each call), and the row kernels whose host time
is most of a call (rows 19
``scatter_rows_inplace``, 20 ``gather_rows``, 18 ``scatter_blend`` at
stgt_672's C, 3C and 4C (masked) buffers and at ViViT's 8 x 197, 11
``block_scatter_rows``), and the selects of rows 10 (``block_select_p``
with the LN at 672, 1024 and the e2e path's one stream, without it at 672
and 1024) and 14 (``ln_select`` with the LN at the paper's ViViT's 12 x
197, without it at ViViT's 8 x 197), each also with ``device_us_cov0``,
the device microseconds of the same call with no row selected (its grid
alone). ``--case=TAG`` (repeatable) times only the
cases of those tags (``vivit``, ``temporal``, ``672``, ``e2e``,
``vivit_evblock``, ``vivit_blend``, ``vivit_pre_ln``, ``1024``), and
``--entry=NAME`` (repeatable) only those entries of them.
``--tiles`` (the checkout's own version only) also times each rel-pos
entry under every tile the tiled body takes whose logits are within 1 MB
(the plan forced one tile at a time, device microseconds from CUDA events
behind a sleep, each call checked against the plain version), the data
behind ``ops/relpos.py``'s plan constants. ``--breakdown`` adds where
the host time of one ``scatter_rows_inplace`` call at C = 768, of one
``gather_rows`` call at 3C and of one call of rows 10 and 14 without the
LN (at 672 and at ViViT's 8 x 197) goes: the operand checks, the stream
read, the plan, the allocation, the C call with its launch, the old
stream read through ``torch.cuda.current_stream`` for comparison, and the
library call (``torch.where`` for rows 10 and 14). The registers and
spills ptxas reported for the row passes' select kernels are its ``ptxas
row passes`` line, and for the row scatter of rows 11 and 19 its ``ptxas
row scatter`` line. ``--row11`` times row 11 (``block_scatter_rows``) at
its three path shapes in bfloat16, and at 1024 in float32 (:func:`row11`),
beside ``Tensor.index_put_``, in its windowed qkv group's form too: with
``--case=NONE`` it times that alone.

``--f32`` times the float32 entries instead (F32_CASES, PERF.md section
6's float32 rows): the GEMM rows 4 and 5 (rows 4t, 4v, 4p, 5m, 5a, 5t, 5p,
5s), row 7 (7p) at their paths' shapes, each beside cuBLAS on the GEMM's
operands with TF32 off and with its TFLOP/s against the CUDA cores' 67;
and row 8's float32 forms (8t, 8p, 8e, the 197-key logits form and the
fused form at the paper's ViViT's 12 x 197 over 197 keys), each
also under the matmul-2 cast (bfloat16 state, ``cast``), beside the share
of the bound (and what bounds it, bytes or operations) and the plain
version's ms. ``--simt-tiles`` (the checkout's own version only) also
times each float32 GEMM entry under each tile of ``gemm_core.SIMT_TILES``
(the plan forced, device microseconds from CUDA events behind a sleep,
each call checked), the data behind ``SIMT_TILE_RATE``. ``--outputs=FILE``
compares the outputs of each float32 entry on the same inputs across two
versions: the first run that names FILE writes them there, every later one
prints, for each entry, whether its outputs equal them bit for bit and
their largest difference; run it on the parent and the checkout in turns.
``--nms`` times row 22 (``nms_padded``, greedy NMS) instead
(:func:`nms_main`): on the two calls the e2e eventful model's flush frame
makes (the RPN's 4096 -> 300 at IoU 0.7, the ROI heads' 4096 -> 100 at
0.5; ``--nms-inputs=FILE`` keeps them in FILE so that the parent and the
change take the same tensors) and on out-of-order contract inputs at the
same shapes, each with its device microseconds split by kernel and its
launches a call.
Needs a CUDA device.
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
      "proj_group", "ln_select_noln", "ln_norms")),
    ("temporal", 8, 17, 17, dict(window=(4, 6)), ("window_attention",)),
    ("672", 2, 1764, 256, dict(window=(14, 14), pool=(21, 21), pad_window=(14, 14)),
     ("window_attention_windowed", "window_attention_grid", "window_attention_grid_noterms",
      "scatter_rows_inplace", "scatter_rows_inplace_qkv", "scatter_rows_inplace_qkv_masked",
      "gather_rows_qkv", "scatter_blend", "scatter_blend_qkv", "scatter_blend_wide",
      "block_select_p", "block_select_p_noln",
      "gate_group_linear_post", "gate_group_linear", "gate_group_linear_pre",
      "gate_group_linear_post_topk", "gate_group_linear_topk", "gate_group_linear_pre_topk",
      "gate_group_mlp", "ln_norms", "relpos_bias_add_v2")),
    ("672", 2, 1764, 256, dict(window=(14, 14), pool=(21, 21), relpos_keys=(42, 42)),
     ("relpos_bias_add_v2",)),
    ("e2e", 1, 1764, 256, dict(window=(14, 14), pool=(21, 21)),
     ("window_attention_windowed", "gate_group_linear_post", "gate_group_linear",
      "softmax_select_matmul", "relpos_bias_add_v2", "relpos_bias_add", "block_select_p")),
    ("e2e", 1, 1764, 256, dict(window=(14, 14), pool=(21, 21), relpos_keys=(42, 42)),
     ("relpos_bias_add_v2",)),
    ("vivit_evblock", 12, 197, 24, dict(window=(4, 6), pool=(1, 197)),
     ("ln_select_matmul_post", "ln_select_matmul_none", "select_linear_skip_norms",
      "scatter_rows_inplace_qkv", "gather_rows_qkv", "softmax_select_matmul_logits_noterms",
      "ln_norms", "ln_select")),
    ("vivit_blend", 8, 197, 98, dict(window=(4, 6)), ("scatter_blend", "scatter_blend_qkv")),
    ("vivit_pre_ln", 8, 197, 98, dict(window=(4, 6)),
     ("ln_select_matmul_pre", "select_linear_skip_norms_noln")),
    ("1024", 2, 4096, 256,
     dict(window=(14, 14), windows=50, pool=(32, 32), pad_window=(14, 14)),
     ("window_attention_windowed", "window_attention_padded", "window_attention_grid",
      "block_select_p", "block_select_p_noln", "block_scatter_rows", "softmax_select_matmul",
      "ln_norms",
      "block_select_scatter_qkv", "block_select_scatter_proj", "block_select_scatter_mlp",
      "block_select_scatter_qkv_noln", "block_select_scatter_mlp_noln", "relpos_bias_add_v2")),
    ("1024", 2, 4096, 256,
     dict(window=(14, 14), windows=50, pool=(32, 32), pad_window=(14, 14), relpos_keys=(64, 64)),
     ("relpos_bias_add_v2",)),
]
# The float32 entries (``--f32``): (tag, batch, N, k, make_inputs keywords,
# entries, (C, heads)); PERF.md section 6's rows, chip_smoke.py's shapes
P672 = dict(window=(14, 14), pool=(21, 21))
F32_CASES = [
    ("4t", 12, 197, 197, dict(window=(4, 6)), ("gate_group_mlp_threshold",), (768, 12)),
    ("5m", 12, 197, 197, dict(window=(4, 6)), ("dense_mlp_residual",), (768, 12)),
    ("5a", 12, 361, 361, {}, ("dense_mlp_residual",), (768, 12)),
    ("5t", 192, 17, 17, dict(window=(4, 6)), ("dense_mlp_residual",), (768, 12)),
    ("5s", 12, 17, 17, dict(window=(4, 6)), ("dense_mlp_residual",), (768, 12)),
    ("4v", 12, 197, 24, dict(window=(4, 6), pool=(1, 197)),
     ("gate_group_mlp", "softmax_select_matmul_logits_noterms", "softmax_select_matmul_noterms"),
     (768, 12)),
    ("p672", 1, 1764, 512, P672,
     ("dense_mlp_residual", "gate_group_mlp", "gate_group_linear", "gate_group_linear_post",
      "softmax_select_matmul"), (768, 12)),
    ("8t", 1, 4096, 512, dict(window=(14, 14), windows=50, pool=(64, 64), pad_window=(14, 14),
                              relpos_keys=(8, 8)), ("softmax_select_matmul_threshold",), (768, 12)),
    ("8e", 4, 197, 24, dict(window=(4, 6), pool=(1, 197)), ("softmax_select_matmul_noterms",),
     (384, 6)),
]
F32_PEAK_TFLOPS = 67.0
TAGS = [a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--case=")]
ENTRIES = [a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--entry=")]
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


def host_idle_us(fn, calls=100):
    """Host microseconds of one ``fn()`` call made with the card idle: the
    median over ``calls`` calls, each after a synchronisation."""
    times = []
    for _ in range(calls + 3):
        torch.cuda.synchronize()
        start = time.perf_counter_ns()
        fn()
        times.append(time.perf_counter_ns() - start)
    torch.cuda.synchronize()
    return statistics.median(times[3:]) / 1e3


def device_us(fn, calls=20):
    """(device microseconds of one ``fn()`` call, {kernel: [launches,
    microseconds] a call}): its kernels' times summed under
    ``torch.profiler`` over ``calls`` calls, by their names cut to the
    function's own."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    kernels = {}
    for e in events:
        short = e.name.split("(")[0].split("<")[0].split("::")[-1].strip().split(" ")[-1]
        count, us = kernels.get(short, (0, 0.0))
        kernels[short] = (count + 1 / calls, us + e.time_range.elapsed_us() / calls)
    return sum(e.time_range.elapsed_us() for e in events) / calls, kernels


L2_BYTES = 50 * 2**20  # the H100's L2
# the row-pass kernels whose registers and spills ptxas reports (``ptxas row
# passes``): rows 9, 10 and 14's warp select and their block-per-row kernels
ROW_PASS_PTXAS = ("select_warp_kernel", "diff_norms_warp_kernel", "select_scatter_kernel",
                  "ln_select_kernel", "select_rows_kernel", "diff_norms_kernel")
# rows 10 and 14: the coverage each entry reads, zeroed for ``device_us_cov0``
SELECT_COV = {"block_select_p": "cov1", "block_select_p_noln": "cov1", "ln_select": "cov3",
              "ln_select_noln": "cov3"}


def flushed_device_us(fn, kernels, calls=20):
    """Device microseconds of one ``fn()`` call whose operands start out of
    the L2: each call follows a write of twice the L2's bytes, and only the
    kernels named in ``kernels`` (those :func:`device_us` found in a call)
    are summed."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.events():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        short = e.name.split("(")[0].split("<")[0].split("::")[-1].strip().split(" ")[-1]
        if short in kernels:
            total += e.time_range.elapsed_us()
    return total / calls


def ptxas_lines(log, needle):
    """The registers and spills ptxas reported for each kernel whose
    mangled name holds ``needle``, from the build's log."""
    out, entry = [], None
    for line in log:
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        if entry and needle in entry and ("registers" in line or "spill" in line):
            out.append(f"{entry}: {line.split(':', 1)[-1].strip()}")
    return sorted(set(out))


def allocations(fn, calls=20):
    """Device allocations one ``fn()`` call makes (the caching allocator's
    count, reused blocks included)."""
    fn()
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (torch.cuda.memory_stats()["allocation.all.allocated"] - before) / calls


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


def tile_sweep(name, d):
    """Device microseconds of rel-pos entry ``name`` on ``d`` under each
    tile (r, s) of the tiled body whose logits are within 1 MB, fastest
    first, with whether each call held kernel_check's bounds."""
    from eventful_transformer_tpu_torch.ops import relpos

    bh = d["rp_x"].shape[0] * d["rp_x"].shape[1]
    a, p, c = d["rp_a"], d["rp_p"], d["rp_q"].shape[-1]
    max_shared = relpos.TILE_SHAPES[p[1] % 8 == 0][0]
    sides = [[t for t in range(1, relpos.TILE_MAX_SIDE + 1) if n % t == 0] for n in a]
    tiles = [(r, s) for r in sides[0] for s in sides[1]
             if 4 * r * s * p[0] * p[1] <= 2**20 and relpos._tile_smem(r, s, p, c) <= max_shared]
    wrapper, plain = kernel_check.KERNELS[name][:2]
    want = kernel_check._invoke(name, plain, d)[0]
    planned = relpos.relpos_plan
    out = []
    try:
        for tile in tiles:
            relpos.relpos_plan = lambda *args, tile=tile: tile
            ok = kernel_check.compare(kernel_check._invoke(name, wrapper, d)[0], want)["ok"]
            us = min(kernel_check.queued_device_us(lambda: kernel_check._invoke(name, wrapper, d))
                     for _ in range(2))
            out.append((round(us, 2), tile, ok))
    finally:
        relpos.relpos_plan = planned
    return planned(bh, tuple(a), tuple(p), c), sorted(out)


def breakdown(device):
    """Host microseconds of the pieces of one scatter_rows_inplace call at
    C = 768, of one gather_rows call at 3C, and of one call of rows 10
    (``block_select_p`` without the LN at 672) and 14 (``ln_select``
    without the LN at ViViT's 8 x 197), each beside its library call."""
    from eventful_transformer_tpu_torch.ops import row_copy, scatter

    d = kernel_check.make_inputs(2, 1764, 768, 12, 256, torch.bfloat16, device, seed=0)
    buf, values, index = d["rows_buf"].clone(), d["rows_vals"], d["rows_index"]
    args = (_build.dtype_code(buf), _build.dtype_code(values), buf.data_ptr(), values.data_ptr(),
            index.data_ptr(), 0, 0, 2, 1764, 768, 256, _build.stream_of(buf))
    qkv = d["rows_buf_qkv"]
    plan = row_copy.gather_plan(2304, 2, 2, 256)
    rows = torch.empty((2, 256, 2304), dtype=qkv.dtype, device=device)
    gather_args = (1, qkv.data_ptr(), index.data_ptr(), 0, rows.data_ptr(), 2, 1764, 2304, 256,
                   plan.per, plan.stages, plan.grid, _build.stream_of(qkv))
    pieces = {
        "wrapper": lambda: scatter.scatter_rows_inplace(buf, values, index),
        "checks": lambda: scatter._check_cuda("scatter_rows_inplace", buf, index, values),
        "stream_of": lambda: _build.stream_of(buf),
        "current_stream (old)": lambda: torch.cuda.current_stream(buf.device).cuda_stream,
        "launch (C call + kernel launch)": lambda: _build.launch("etk_scatter_rows", *args),
        "Tensor.scatter_": kernel_check.library_call("scatter_rows_inplace", d),
        "gather_rows wrapper": lambda: scatter.gather_rows(qkv, index),
        "gather_rows checks": lambda: scatter._check_cuda("gather_rows", qkv, index),
        "gather_rows plan (cached)": lambda: row_copy.gather_plan(2304, 2, 2, 256),
        "gather_rows torch.empty": lambda: torch.empty((2, 256, 2304), dtype=qkv.dtype,
                                                       device=device),
        "gather_rows launch (C call + kernel launch)":
            lambda: _build.launch("etk_gather_rows", *gather_args),
        "torch.gather": kernel_check.library_call("gather_rows_qkv", d),
    }
    vivit = kernel_check.make_inputs(8, 197, 768, 12, 98, torch.bfloat16, device, seed=0)
    for name, dd, cov, p in (("block_select_p_noln", d, "cov1", "p_qkv"),
                             ("ln_select_noln", vivit, "cov3", "p_mlp")):
        pieces.update(select_pieces(name, dd["x"], dd[p].clone(), dd[cov]))
        pieces[f"{name} torch.where"] = kernel_check.library_call(name, dd)
    for label, fn in pieces.items():
        print("breakdown", label, "host_us", round(host_us(fn), 3), flush=True)


def select_pieces(name, x, p, cov):
    """The pieces of one call of entry ``name`` (rows 10 and 14 without the
    LN): the wrapper, its checks (this checkout's ``select_args``, which
    also picks the body and reads the stream, or the helpers
    ``_build.check_operands`` and ``check_shape`` that a version without
    it calls), the stream read, and the C call with its launch."""
    from eventful_transformer_tpu_torch.ops import gate_block

    wrapper = kernel_check.KERNELS[name][0]
    pieces = {f"{name} wrapper": lambda: wrapper(x, p, cov, None, None, apply_ln=False)}
    if hasattr(gate_block, "select_args"):
        _, args = gate_block.select_args(name, x, p, cov, None, None, False)
        pieces[f"{name} checks (select_args)"] = (
            lambda: gate_block.select_args(name, x, p, cov, None, None, False))
    else:
        args = (_build.dtype_code(x), x.data_ptr(), p.data_ptr(), cov.data_ptr(), None, None, 0,
                x.numel() // x.shape[-1], x.shape[-1], _build.stream_of(x))

        def checks():
            _build.check_operands(name, x, ("cov",), p=p, cov=cov)
            _build.check_shape(name, "p", p, x.shape)
            _build.check_shape(name, "cov", cov, x.shape[:-1])

        pieces[f"{name} checks (check_operands, check_shape)"] = checks
    pieces[f"{name} stream_of"] = lambda: _build.stream_of(x)
    pieces[f"{name} launch (C call + kernel launch)"] = (
        lambda: _build.launch("etk_block_select_p", *args))
    return pieces


# row 11 at its paths' shapes (tag, batch, token grid, dtype): ViTDet-1024's
# windowed qkv groups over the 70 x 70 window-major rows of its 64 x 64 grid,
# ViTDet-672's over 42 x 42 and the e2e path's one stream; windows of 14 x 14
ROW11 = [("1024", 2, (64, 64), torch.bfloat16), ("1024", 2, (64, 64), torch.float32),
         ("672", 2, (42, 42), torch.bfloat16), ("e2e", 1, (42, 42), torch.bfloat16)]
ROW11_WINDOW, ROW11_K, ROW11_F = (14, 14), 256, 2304


def window_map(grid, window):
    """(h * w + 1,) int32 map of row-major token -> window-major row of the
    grid padded to whole windows, the marker h * w -> -1, and the number of
    window-major rows (``core/indexing.py::window_row_map``, written here
    so that a version without it is timed on the same map)."""
    (h, w), d = grid, window
    hp, wp = h + -h % d[0], w + -w % d[1]
    rowmajor = torch.full((hp, wp), h * w, dtype=torch.int64)
    rowmajor[:h, :w] = torch.arange(h * w).reshape(h, w)
    perm = rowmajor.reshape(hp // d[0], d[0], wp // d[1], d[1]).permute(0, 2, 1, 3).reshape(-1)
    out = torch.full((h * w + 1,), -1, dtype=torch.int32)
    valid = perm < h * w
    out[perm[valid]] = torch.nonzero(valid)[:, 0].to(torch.int32)
    return out, hp * wp


def row11(device):
    """Row 11 (``block_scatter_rows``) at ROW11's shapes: the model's call,
    k = 256 selected tokens of each stream row-major in ascending order (as
    ``index_from_coverage`` lists them) into the window-major qkv buffer.
    Three forms, each checked against ``Tensor.index_put_`` on a clone:
    ``kernel``, the wrapper on window-major rows taken beforehand (the same
    call in every version); ``site``, what the windowed qkv group runs: the
    map handed to the wrapper where it takes one (``row_map``), else the
    map's gather on the card and the wrapper; ``library``,
    ``Tensor.index_put_`` on the rows and values gathered beforehand. Each
    with its ms (CUDA events), host µs, device µs and kernels a call
    (profiler; where it catches no device event, CUDA events around calls
    queued behind a sleeping kernel, ``device_us_by``) and allocations,
    medians of ROUNDS rounds in turns, beside
    the bound: the index and map entries read, and h's rows read and b's
    written at the valid slots."""
    import inspect

    from eventful_transformer_tpu_torch.ops import gate_block

    fn = gate_block.block_scatter_rows
    mapped = "row_map" in inspect.signature(fn).parameters
    for tag, bsz, grid, dtype in ROW11:
        row_map, nw = window_map(grid, ROW11_WINDOW)
        g = torch.Generator().manual_seed(0)
        n = grid[0] * grid[1]
        index = torch.stack([torch.randperm(n, generator=g)[:ROW11_K].sort().values
                             for _ in range(bsz)]).to(torch.int32)
        buf = torch.randn((bsz, nw, ROW11_F), generator=g).to(device, dtype)
        h = torch.randn((bsz, ROW11_K, ROW11_F), generator=g).to(device, dtype)
        index, row_map = index.to(device), row_map.to(device)
        taken = row_map[index]
        rows = torch.arange(bsz, device=device)[:, None].expand(index.shape)
        pairs, values = (rows.reshape(-1), taken.reshape(-1).long()), h.reshape(-1, ROW11_F)
        first = buf.clone()
        want = first.clone().index_put_(pairs, values)
        lib_buf = buf.clone()
        forms = {
            "kernel": lambda: fn(buf, taken, h),
            "site": (lambda: fn(buf, index, h, row_map)) if mapped
            else (lambda: fn(buf, row_map[index], h)),
            "library": lambda: lib_buf.index_put_(pairs, values),
        }
        ok = {}
        for form in ("kernel", "site"):
            buf.copy_(first)
            ok[form] = torch.equal(forms[form](), want)
        times = {form: {"ms": [], "us": []} for form in forms}
        for _ in range(ROUNDS):
            for form, call in forms.items():
                times[form]["ms"].append(kernel_check.time_call(call, ITERS))
                times[form]["us"].append(host_us(call))
        size = buf.element_size()
        bound_us = (2 * index.numel() * 4 + 2 * index.numel() * ROW11_F * size) / 3.35e12 * 1e6
        for form, call in forms.items():
            dev_us, kernels = device_us(call)
            by = "profiler"
            if not dev_us:  # the profiler caught no device event: events around queued calls
                dev_us, by = kernel_check.queued_device_us(call), "events behind a sleep"
            print("row11", tag, str(dtype).split(".")[-1], form, "nw", nw,
                  "ms", round(statistics.median(times[form]["ms"]), 4),
                  "host_us", round(statistics.median(times[form]["us"]), 2),
                  "host_idle_us", round(host_idle_us(call), 2), "device_us", round(dev_us, 2),
                  "device_us_by", by, "bound_us", round(bound_us, 3),
                  "bound_share", round(bound_us / dev_us, 3) if dev_us else None,
                  "matches index_put_", ok.get(form),
                  "kernels", {k: [round(c, 2), round(t, 2)] for k, (c, t) in kernels.items()},
                  "allocations", allocations(call), flush=True)
        del buf, h, lib_buf, want, first
        torch.cuda.empty_cache()


def gemm_flops(name, d):
    """Operations of the GEMMs of one call of GEMM entry ``name`` (rows 4,
    5 and 7) on ``d``: 2 M K N each, over the rows the kernel computes."""
    bsz, n, c = d["x"].shape
    if name.startswith("gate_group_linear"):
        f = 3 * c if name.startswith("gate_group_linear_post") else c
        return 2 * bsz * d["k"] * c * f
    rows = bsz * n if name.startswith("dense_mlp") else bsz * d["k"]
    return 2 * 2 * rows * c * d["w1"].shape[-1]


def outputs_of(name, d):
    """The outputs of one call of entry ``name`` on clones of ``d``'s
    tensors, on the CPU."""
    dd = {key: v.clone() if torch.is_tensor(v) else v for key, v in d.items()}
    out = kernel_check._invoke(name, kernel_check.KERNELS[name][0], dd)
    torch.cuda.synchronize()
    return [t.detach().cpu() for t in out if torch.is_tensor(t)]


def simt_tile_sweep(name, d):
    """Device microseconds of float32 GEMM entry ``name`` on ``d`` under
    each choice of tiles of ``gemm_core.SIMT_TILES`` (the plan forced: one
    tile for each of the entry's GEMMs, GEMM 1 first), with whether each
    call held kernel_check's bounds."""
    import itertools

    from eventful_transformer_tpu_torch.ops import gemm_core

    wrapper = kernel_check.KERNELS[name][0]
    c = d["x"].shape[-1]
    gemms = 2 if "w1" in d and "mlp" in name else 1
    planned = gemm_core.simt_plan
    out = []
    try:
        for tiles in itertools.product(range(len(gemm_core.SIMT_TILES)), repeat=gemms):
            # GEMM 1 reads C columns of A; an MLP's GEMM 2 reads the hidden ones
            gemm_core.simt_plan = lambda m, k, n, tiles=tiles: gemm_core.simt_tile_plan(
                m, k, n, tiles[0 if k == c else -1])
            gemm_core.gemm_launch.cache_clear()
            gemm_core.mlp_launch.cache_clear()
            ok = all(row["ok"] for row in kernel_check.errors(name, d))
            dd = {key: v.clone() if torch.is_tensor(v) else v for key, v in d.items()}
            us = min(kernel_check.queued_device_us(lambda: kernel_check._invoke(name, wrapper, dd))
                     for _ in range(2))
            out.append((tiles, round(us, 2), ok))
    finally:
        gemm_core.simt_plan = planned
        gemm_core.gemm_launch.cache_clear()
        gemm_core.mlp_launch.cache_clear()
    return out


def f32_main(device):
    """The float32 entries (F32_CASES): each entry's times and, with
    ``--outputs``, its outputs against the saved ones."""
    saved_path = next((a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--outputs=")),
                      None)
    saved = torch.load(saved_path) if saved_path and Path(saved_path).exists() else None
    outputs = {}
    for tag, bsz, n, k, inputs, names, width in F32_CASES:
        if TAGS and tag not in TAGS:
            continue
        base = kernel_check.make_inputs(bsz, n, *width, k, torch.float32, device, seed=0,
                                        **inputs)
        for name in names:
            if ENTRIES and name not in ENTRIES:
                continue
            row8 = name.startswith("softmax_select_matmul")
            for cast in (False, True) if row8 else (False,):
                d = dict(base)
                if cast:  # the matmul-2 cast: float32 q, k and terms over bfloat16 state
                    for key in ("p_a", "p_v", "av_logits"):
                        d[key] = d[key].to(torch.bfloat16)
                label = f"{tag}/{name}" + ("/cast" if cast else "")
                ok = all(row["ok"] for row in kernel_check.errors(name, d))
                outputs[label] = outputs_of(name, d)
                dd = {key: v.clone() if torch.is_tensor(v) else v for key, v in d.items()}
                call = bound(name, kernel_check.KERNELS[name][0], dd)
                library = kernel_check.library_call(name, d)
                times = {"ms": [], "lib_ms": []}
                for _ in range(ROUNDS):
                    times["ms"].append(kernel_check.time_call(call, 20))
                    if library is not None:
                        times["lib_ms"].append(kernel_check.time_call(library, 20))
                ms, lib_ms = (statistics.median(v) if v else None for v in times.values())
                dev_us = kernel_check.queued_device_us(call)
                bound_ms, bound_by = kernel_check.bound(name, d)
                bound_us = bound_ms * 1e3
                plain = kernel_check.KERNELS[name][1]
                dp = {key: v.clone() if torch.is_tensor(v) else v for key, v in d.items()}
                plain_ms = statistics.median(kernel_check.time_call(
                    lambda: kernel_check._invoke(name, plain, dp), 20) for _ in range(3))
                extra = {}
                if not row8:
                    extra["tflops"] = round(gemm_flops(name, d) / dev_us / 1e6, 2)
                    extra["of_peak"] = round(extra["tflops"] / F32_PEAK_TFLOPS, 3)
                if saved is not None and label in saved:
                    pairs = list(zip(outputs[label], saved[label]))
                    extra["bit_equal_to_saved"] = all(torch.equal(a, b) for a, b in pairs)
                    extra["max_abs_diff_to_saved"] = max(
                        float((a.float() - b.float()).abs().max()) for a, b in pairs)
                print("f32", label, "ms", round(ms, 4), "device_us", round(dev_us, 2),
                      "bound_us", round(bound_us, 2), "bound_by", bound_by,
                      "bound_share", round(bound_us / dev_us, 3), "plain_ms", round(plain_ms, 4),
                      "library_ms", lib_ms and round(lib_ms, 4),
                      "ratio", lib_ms and round(ms / lib_ms, 3), "within bounds", ok,
                      *(v for item in extra.items() for v in item), flush=True)
                if "--simt-tiles" in sys.argv and not row8:
                    print("f32", label, "simt tiles", simt_tile_sweep(name, d), flush=True)
                del d, dd, dp
        del base
        torch.cuda.empty_cache()
    if saved_path and saved is None:
        torch.save(outputs, saved_path)
        print("f32 outputs written to", saved_path, flush=True)


# row 22's inputs beside the recorded ones: (tag, n, max_out, threshold, case,
# whether put in score order here) of kernel_check.nms_inputs at the RPN's
# and ROI heads' shapes: the sort path, and "sorted_rpn", sort_rpn's boxes
# and scores in score order (the stable descending sort batched_nms hands
# over), which every version's cases can make
NMS_CASES = [("sort_rpn", 4096, 300, 0.7, "random", False),
             ("sorted_rpn", 4096, 300, 0.7, "random", True),
             ("sort_roi", 4096, 100, 0.5, "random", False),
             ("ties_rpn", 4096, 300, 0.7, "ties", False),
             ("chains_rpn", 4096, 300, 0.7, "chains", False)]


def nms_inputs(device):
    """[(tag, boxes, scores, threshold, max_out)]: the two NMS calls of the
    e2e eventful model's flush frame (ViTDet-B 672, bf16, ROOT's
    ``chip_smoke.e2e_model`` and ``recorded_nms_inputs``; with
    ``--nms-inputs=FILE`` read from FILE where it exists, else recorded and
    written there, so that two versions take the same tensors), then
    NMS_CASES."""
    path = next((a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--nms-inputs=")),
                None)
    if path and Path(path).exists():
        recorded = torch.load(path)
    else:
        import chip_smoke

        model = chip_smoke.e2e_model(True, device, torch.bfloat16)
        frames = chip_smoke.vitdet_frames(chip_smoke.E2E_FRAMES + 1, 1, device, torch.bfloat16,
                                          chip_smoke.E2E_SIZE)
        recorded = [(b.cpu(), s.cpu(), t, m)
                    for b, s, t, m in chip_smoke.recorded_nms_inputs(model, frames[0])]
        del model, frames
        if path:
            Path(path).parent.mkdir(parents=True, exist_ok=True)
            torch.save(recorded, path)
    out = [(tag, b.to(device), s.to(device), t, m)
           for tag, (b, s, t, m) in zip(("rpn", "roi"), recorded)]
    for tag, n, max_out, t, case, in_order in NMS_CASES:
        b, s = kernel_check.nms_inputs(n, max_out, t, device, seed=n + max_out, case=case)
        if in_order:
            order = torch.sort(s, descending=True, stable=True).indices
            b, s = b[order].contiguous(), s[order].contiguous()
        out.append((tag, b, s, t, max_out))
    return out


def nms_main(device):
    """``--nms``: row 22 (``ops/nms.py::nms_padded``) on :func:`nms_inputs`,
    each call checked against the plain version index for index, with its
    ms (CUDA events over ITERS calls, the median of ROUNDS), host
    microseconds, device microseconds (torch.profiler over 20 calls; each
    kernel's events over the calls rounded to its launches a call, times
    its mean event time, since the profiler may drop an event), the
    kernels a call by name with their launches and device microseconds, the
    bound (``kernel_check.bound``) and its share, the plain version's ms,
    the design's bytes where the version reports them, and the kept count."""
    from eventful_transformer_tpu_torch.detection.nms import BLOCK

    wrapper = kernel_check.KERNELS["nms_padded"][0]
    for tag, boxes, scores, t, max_out in nms_inputs(device):
        d = dict(nms_boxes=boxes, nms_scores=scores, nms_threshold=t, nms_max_out=max_out)
        ok = all(row["ok"] for row in kernel_check.errors("nms_padded", d))

        def call():
            return wrapper(boxes, scores, t, max_out, BLOCK)

        ms = statistics.median(kernel_check.time_call(call, ITERS) for _ in range(ROUNDS))
        us = statistics.median(host_us(call) for _ in range(ROUNDS))
        _, kernels = device_us(call)
        kernels = {k: (round(n), v / n * round(n)) for k, (n, v) in kernels.items() if round(n)}
        dev_us = sum(v for _, v in kernels.values())
        bound_ms, bound_by = kernel_check.bound("nms_padded", d)
        design = {}
        if hasattr(kernel_check, "nms_design_bytes"):
            design["smem_bytes"], design["scratch_bytes"] = kernel_check.nms_design_bytes(d)
        elif hasattr(kernel_check, "nms_word_bytes"):
            design["word_bytes"] = kernel_check.nms_word_bytes(boxes.shape[0])
        print("nms", tag, "n", boxes.shape[0], "max_out", max_out, "threshold", t,
              "scores", str(scores.dtype).split(".")[-1], "kept", int(call()[1].sum()),
              "ms", round(ms, 4), "host_us", round(us, 2), "device_us", round(dev_us, 2),
              "launches", round(sum(n for n, _ in kernels.values()), 2),
              "kernels", {k: [round(n, 2), round(v, 2)] for k, (n, v) in kernels.items()},
              "bound_us", round(bound_ms * 1e3, 5), "bound_by", bound_by,
              "bound_share", round(bound_ms * 1e3 / dev_us, 6) if dev_us else None,
              "plain_ms", round(kernel_check.time_ms("nms_padded", d, plain=True), 4),
              *(v for item in design.items() for v in item), "equal", ok, flush=True)


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
    print("card", smi, "root", ROOT, "build_s", round(time.perf_counter() - start, 1),
          ptxas_lines(log, "attention_tc"))
    print("ptxas relpos", ptxas_lines(log, "relpos"))
    print("ptxas row passes", [line for needle in ROW_PASS_PTXAS
                               for line in ptxas_lines(log, needle)])
    print("ptxas row scatter", ptxas_lines(log, "scatter_rows"))
    device = torch.device("cuda")
    if "--nms" in sys.argv:
        print("ptxas nms", ptxas_lines(log, "nms"))
        nms_main(device)
        return
    if "--f32" in sys.argv:
        print("ptxas f32 bodies", ptxas_lines(log, "gemm_simt") + ptxas_lines(log, "av_simt"))
        f32_main(device)
        return
    for tag, bsz, n, k, inputs, names in CASES:
        if TAGS and tag not in TAGS:
            continue
        d = kernel_check.make_inputs(bsz, n, 768, 12, k, torch.bfloat16, device, seed=0, **inputs)
        for name in names:
            if ENTRIES and name not in ENTRIES:
                continue
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
            dev_us, kernels = device_us(call)
            by = "profiler"
            if not dev_us:  # the profiler caught no device event: events around queued calls
                dev_us, by = kernel_check.queued_device_us(call), "events behind a sleep"
            lib_dev_us = None if library is None else device_us(library)[0]
            bound_us = kernel_check.bound(name, d)[0] * 1e3
            extra = {}
            if name.startswith("relpos_bias_add"):
                extra["keys"] = "x".join(map(str, d["rp_p"]))
                if 2 * d["rp_x"].nbytes < L2_BYTES:
                    extra["device_us_l2_flushed"] = round(flushed_device_us(call, kernels), 2)
            if name in SELECT_COV:  # the grid alone: no row selected
                empty = dict(dd, **{SELECT_COV[name]: torch.zeros_like(d[SELECT_COV[name]])})
                empty_call = bound(name, kernel_check.KERNELS[name][0], empty)
                extra["device_us_cov0"] = round(device_us(empty_call)[0], 2)
            if "--tiles" in sys.argv and name.startswith("relpos_bias_add"):
                plan, swept = tile_sweep(name, dd)
                print(tag, name, "keys", extra["keys"], "plan", plan, "tiles", swept, flush=True)
            print(tag, name, *(v for item in extra.items() for v in item), "ms", round(ms, 4),
                  "host_us", round(us, 2), "host_idle_us", round(host_idle_us(call), 2),
                  "device_us", round(dev_us, 2), "device_us_by", by,
                  "bound_us", round(bound_us, 2),
                  "bound_share", round(bound_us / dev_us, 3) if dev_us else None,
                  "library_ms", lib_ms and round(lib_ms, 4),
                  "library_device_us", lib_dev_us and round(lib_dev_us, 2), "library_host_us",
                  lib_us and round(lib_us, 2), "ratio", ratio, "within bounds", ok,
                  "kernels", {k: [round(n, 2), round(t, 2)] for k, (n, t) in kernels.items()},
                  "allocations", allocations(call), flush=True)
            del dd
        del d
        torch.cuda.empty_cache()
    if "--row11" in sys.argv:
        row11(device)
    if "--breakdown" in sys.argv:
        breakdown(device)


if __name__ == "__main__":
    main()
