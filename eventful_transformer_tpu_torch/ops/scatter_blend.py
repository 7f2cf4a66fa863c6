"""``put_rows`` as one kernel (port of ``scatter_blend`` from
``eventful_transformer_tpu/ops/pallas/scatter_blend.py``).

The one-hot blend, not an index copy:

    out[b, n] = rnd(x[b, n] * (1 - cov[b, n]) + sum_j onehot[b, j, n] * values[b, j])

in float32, ``values`` first cast to x's dtype, ``cov[b, n]`` the number
of valid slots j with ``index[b, j] == n``, rounded once to x's dtype.
Slots with mask False (and any index outside [0, N)) match no row. With
distinct valid indices this is ``put_rows`` bit for bit; a row that two
slots name takes ``-x + v1 + v2``, where an index copy keeps one write.
``core/indexing.py::put_rows`` routes here under ``USE_PALLAS_BLEND``.

The CUDA kernel is ``csrc/scatter_blend.cu``, a bulk row copy that
rewrites only the rows the slots name, with its launch plan from
``ops/row_copy.py::blend_plan``. The wrapper counts its launches in
``launches``.
"""

from __future__ import annotations

import torch

from eventful_transformer_tpu_torch.ops import _build
from eventful_transformer_tpu_torch.ops.row_copy import blend_plan

_INDEX_DTYPES = (torch.int32, torch.int64)


def _valid_index(index, mask, n):
    """index with every masked-off or out-of-range slot sent to N."""
    index = index.long()
    ok = (index >= 0) & (index < n)
    if mask is not None:
        ok = ok & mask
    return torch.where(ok, index, n)


def scatter_blend_plain(x, values, index, mask=None):
    """x (B, N, C), values (B, k, C), index (B, k), mask (B, k) bool or
    None -> the blend above, (B, N, C) in x's dtype. The matches of a row
    are summed in slot order."""
    bsz, n, c = x.shape
    index = _valid_index(index, mask, n)
    flat = (index + torch.arange(bsz, device=x.device)[:, None] * (n + 1)).reshape(-1)
    vals = values.to(x.dtype).float().reshape(-1, c)
    scattered = torch.zeros((bsz * (n + 1), c), dtype=torch.float32, device=x.device)
    scattered.index_add_(0, flat, vals)
    cov = torch.zeros(bsz * (n + 1), dtype=torch.float32, device=x.device)
    cov.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    scattered = scattered.reshape(bsz, n + 1, c)[:, :n]
    cov = cov.reshape(bsz, n + 1, 1)[:, :n]
    return (x.float() * (1.0 - cov) + scattered).to(x.dtype)


def scatter_blend(x, values, index, mask=None):
    """The wrapper of :func:`scatter_blend_plain`, which CPU tensors take.
    CUDA tensors launch the kernel of csrc/scatter_blend.cu: one
    allocation (the output) and one launch, the operands checked in one
    pass, each tensor's attributes read once. The kernel takes float32 or
    bfloat16 values into either dtype of x and int32 or int64 indices
    itself; values of another dtype, indices of another integer dtype and
    values or indices that are not contiguous are converted first (one
    more launch and allocation each)."""
    if x.is_cpu:
        return scatter_blend_plain(x, values, index, mask)
    name = "scatter_blend"
    if not x.is_cuda:
        raise ValueError(f"{name}: expected CUDA or CPU tensors, got {x.device}")
    _build.check_no_grad(name, x, values)
    code = _build.dtype_code(x)
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    bsz, n, c = x.shape
    if c > _build.MAX_ROW_WIDTH:
        raise ValueError(f"{name}: C={c} exceeds {_build.MAX_ROW_WIDTH}")
    k = index.shape[-1]
    device = x.get_device()
    if values.get_device() != device:
        raise ValueError(f"{name}: values on {values.device}, expected {x.device}")
    if values.dtype not in _build.DTYPE_CODES:
        values = values.to(x.dtype)
    if not values.is_contiguous():
        values = values.contiguous()
    if values.shape != (bsz, k, c):
        _build.check_shape(name, "values", values, (bsz, k, c))
    if index.dtype not in _INDEX_DTYPES:
        index = index.long()
    if not index.is_contiguous():
        index = index.contiguous()
    for key, t in (("index", index), ("mask", mask)):
        if t is None:
            continue
        if t.get_device() != device or (
                key == "mask" and (t.dtype != torch.bool or not t.is_contiguous())):
            want = "torch.int32 or torch.int64" if key == "index" else "torch.bool"
            raise ValueError(f"{name}: {key} must be a contiguous {want} tensor on {x.device}")
        if t.shape != (bsz, k):
            _build.check_shape(name, key, t, (bsz, k))
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    plan = blend_plan(c, x.element_size(), bsz, n)
    _build.launch(
        "etk_scatter_blend", code, _build.DTYPE_CODES[values.dtype], x.data_ptr(),
        values.data_ptr(), index.data_ptr(), int(index.dtype == torch.int64),
        None if mask is None else mask.data_ptr(), out.data_ptr(), bsz, n, c, k, plan.rows,
        plan.stages, plan.grid, _build.stream_of(x),
    )
    scatter_blend.launches += 1
    return out


scatter_blend.launches = 0
