"""Build the CUDA kernels of ``csrc/`` and call them through ``ctypes``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` to an object file, one
process per source, all started together, and links the objects into one
shared library with a plain C interface, under
``eventful_transformer_tpu_torch/_build/`` (listed in ``.gitignore``). The
file name carries a hash of the sources and the flags, so an edited source
builds anew. This is the hand-built route
rather than ``torch.utils.cpp_extension.load``: the sources include no
PyTorch header, and the build takes seconds instead of minutes.

Each C entry launches its kernels on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()``; :func:`launch` raises when that
is not 0. Pointers and the stream cross as ``c_void_p`` so that 64-bit
addresses are not cut to 32 bits.

The small kernels take a few microseconds on the card, so a wrapper's host
time is what a call costs, and the launch path is kept short: each C entry
is bound once (:func:`launch` keeps the ctypes function it first looked
up), the stream is read as the raw handle of the current stream
(:func:`stream_of`, without building a ``torch.cuda.Stream``), and the
operand checks (:func:`check_operands`) read each tensor's attributes once.
Every card path's checks also refuse an operand that requires grad while
grad mode is on (:func:`check_no_grad`): no kernel has a backward.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    "etk_ln_norms": [_I, _I, _P, _P, _P, _P, _P, _L, _I, _P],
    "etk_qkv_attention_group": [_I, _I, _I] + [_P] * 11 + [_I, _I, _I, _I, _F, _I, _I, _P, _P],
    "etk_proj_group": [_I, _I] + [_P] * 11 + [_I] * 5 + [_P, _P],
    "etk_gate_group_mlp": [_I, _I] + [_P] * 21 + [_I] * 9 + [_P, _P],
    "etk_attention_smem_bytes": [_I] * 6,
    "etk_window_attention": [_I, _I, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P, _P] + [_I] * 6
    + [_P],
    "etk_gate_group_linear": [_I, _I] + [_P] * 17 + [_I] * 8 + [_P, _P],
    "etk_block_select_p": [_I, _I] + [_P] * 5 + [_L, _I, _P],
    "etk_block_scatter_rows": [_I, _P, _P, _P, _P] + [_I] * 5 + [_P],
    "etk_block_select_scatter": [_I, _I] + [_P] * 9 + [_I] + [_P] * 5 + [_I] * 5 + [_P],
    "etk_softmax_select_matmul": [_I, _I, _I] + [_P] * 7 + [_I] * 7 + [_F, _P],
    "etk_dense_mlp_residual": [_I, _I] + [_P] * 10 + [_I] * 6 + [_P, _P],
    "etk_relpos_bias_add": [_I, _I, _I] + [_P] * 5 + [_I] * 8 + [_P],
    "etk_ln_select_matmul": [_I, _I] + [_P] * 9 + [_L] + [_I] * 5 + [_P, _P],
    "etk_select_linear_skip_norms": [_I, _I] + [_P] * 11 + [_L] + [_I] * 5 + [_P, _P],
    "etk_softmax_select_matmul_logits": [_I, _I, _I] + [_P] * 6 + [_I] * 7 + [_P],
    "etk_scatter_blend": [_I, _I, _P, _P, _P, _I, _P, _P] + [_I] * 7 + [_P],
    "etk_scatter_rows": [_I, _I, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P],
    "etk_gather_rows": [_I, _P, _P, _I, _P] + [_I] * 7 + [_P],
    "etk_fused_attention": [_I, _I, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    "etk_window_attention_grid": [_I, _I] + [_P] * 4 + [_I] * 7 + [_F, _I, _I, _P],
    "etk_gemm_tc": [_P] * 5 + [_I] * 5 + [_P],
    "etk_gemm_simt": [_P] * 4 + [_I] * 4 + [_P],
    "etk_nms": [_P, _I, _P, _I, _I, _F, _I, _I, _I] + [_P] * 4,
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SHARED_BYTES = 232448  # dynamic shared memory one block may use on Hopper
MAX_ROW_WIDTH = 8192  # the row kernels keep one (C,) float32 row in 48 KB


def nvcc_path():
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [shutil.which("nvcc")]
    if cuda_home:
        candidates.append(str(Path(cuda_home) / "bin" / "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if path and Path(path).is_file():
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path():
    """Path of the library built from the current sources and flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libetk_kernels_{digest.hexdigest()[:16]}.so"


@functools.cache
def load_library():
    """Build the kernels if needed, load them, and declare their C types."""
    path = library_path()
    if not path.exists():
        _build(path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.etk_error_string.argtypes = [_I]
    lib.etk_error_string.restype = ctypes.c_char_p
    lib.etk_tensor_map_encodes.argtypes = []
    lib.etk_tensor_map_encodes.restype = _L
    return lib


def _build(path):
    """Compile each source in its own ``nvcc`` process, all at once, then
    link; the compiler's output goes to ``<library>.log``."""
    BUILD_DIR.mkdir(exist_ok=True)
    tag = f"{path.stem}.{os.getpid()}"
    nvcc = nvcc_path()
    jobs = []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src.name, obj, proc))
    log, failed = [], []
    for name, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{name} (code {proc.returncode}):\n{out[-8000:]}")
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    if not failed:
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
        result = subprocess.run(cmd, capture_output=True, text=True, check=False)
        log.append(f"== link\n{result.stdout}{result.stderr}")
        if result.returncode != 0:
            failed.append(f"link (code {result.returncode}):\n{result.stderr[-8000:]}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    path.with_suffix(".log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, path)


_ENTRIES = {}  # C entry name -> its ctypes function, bound at its first launch


def _entry(name):
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = _ENTRIES[name] = getattr(load_library(), name)
    return fn


def launch(name, *args):
    """Call C entry ``name``; raise if it reports a CUDA error."""
    code = _entry(name)(*args)
    if code != 0:
        message = load_library().etk_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {message}")


def dtype_code(t):
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}") from None


def stream_of(t):
    """The raw handle of the current CUDA stream of ``t``'s device, as an
    int for ctypes; raises unless that device is the current one. ``t``
    lies on the card, so CUDA is initialised and the current device is
    read without ``torch.cuda``'s initialisation check."""
    return stream_on(t.get_device())


def stream_on(index):
    """:func:`stream_of` for a tensor on device ``index``, read by the
    caller."""
    current = torch._C._cuda_getDevice()
    if index != current:
        raise ValueError(f"tensor on cuda:{index} but the current device is cuda:{current}")
    return torch._C._cuda_getCurrentRawStream(index)


def check_no_grad(name, *tensors):
    """Raise where grad mode is on and an operand (None skipped) requires
    grad: the kernels have no backward, so a launch would cut the autograd
    graph without a word. Training takes the blocks' plain PyTorch paths
    (``Ctx.training``); inference runs under ``torch.no_grad()``."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an operand requires grad and the kernel has no backward; run it under "
            "torch.no_grad(), or train through the plain path (Ctx(training=True))"
        )


def check_operands(name, ref, float32=(), **tensors):
    """Raise unless ``ref`` and every tensor lie on one CUDA device and are
    contiguous, with ``ref``'s dtype, or float32 for the names in
    ``float32``, and none requires grad in grad mode
    (:func:`check_no_grad`). A tensor given as None (an operand the call
    leaves out, such as the coverage of a group that selects its own rows)
    is skipped."""
    device, dtype = ref.device, ref.dtype
    if device.type != "cuda":
        raise ValueError(f"{name}: expected CUDA or CPU tensors, got {device}")
    check_no_grad(name, ref, *tensors.values())
    dtype_code(ref)
    if not ref.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    if ref.shape[-1] > MAX_ROW_WIDTH:
        raise ValueError(f"{name}: C={ref.shape[-1]} exceeds {MAX_ROW_WIDTH}")
    for key, t in tensors.items():
        if t is None:
            continue
        want = torch.float32 if key in float32 else dtype
        if t.device != device:
            raise ValueError(f"{name}: {key} on {t.device}, expected {device}")
        if t.dtype != want:
            raise TypeError(f"{name}: {key} is {t.dtype}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def aligned16(*tensors):
    """Whether every tensor given (None skipped) starts on a 16-byte
    boundary, as the tensor-core kernels' 16-byte copies and TMA need."""
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def check_shape(name, key, t, shape):
    """Raise unless ``t`` (None skipped, as in :func:`check_operands`) has
    ``shape``."""
    if t is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {tuple(shape)}")
