"""Row scatter into a buffer in place, and row gather, by index (port of
``scatter_rows_inplace`` and ``gather_rows`` from
``eventful_transformer_tpu/ops/pallas/scatter.py``).

    scatter_rows_inplace: buffer[b, index[b, i]] = values[b, i] where mask[b, i]
    gather_rows:          rows[b, i] = buffer[b, index[b, i]]

Pure row copies: ``values`` is cast to the buffer's dtype, and nothing else
is computed, so both equal the JAX kernels bit for bit. The scatter writes
into the caller's buffer and returns it (the JAX kernel aliases it,
``input_output_aliases``). Valid indices of a batch row must be distinct,
as in the JAX package; two slots naming one row race on the card. A slot
whose index lies outside [0, N) writes nothing (the scatter) or a row of
zeros (the gather). Rows are whole 128-lane multiples wide, as the JAX
kernels require, so the same calls are valid in both packages.

No path of the JAX package calls these kernels (its ``put_rows`` and
``take_rows`` are index ops or the scatter-blend); the port's are held
against ``core/indexing.py::put_rows`` and ``take_rows`` by
``chip_smoke.py``. The CUDA kernels are ``csrc/scatter.cu`` (the gather a
bulk row copy, planned by ``ops/row_copy.py``); each wrapper counts its
launches in ``launches``.
"""

from __future__ import annotations

import torch

from eventful_transformer_tpu_torch.ops import _build
from eventful_transformer_tpu_torch.ops.row_copy import gather_plan

LANE = 128
_INDEX_DTYPES = (torch.int32, torch.int64)


def _check(name, buffer, index, values=None, mask=None):
    """The JAX kernels' argument rules: a (B, N, C) buffer with C a
    multiple of 128, a (B, K) index, (B, K, C) values and a (B, K) mask.
    Returns (B, N, C, K)."""
    shape = buffer.shape
    if len(shape) != 3 or shape[2] % LANE:
        raise ValueError(f"{name}: buffer {tuple(shape)} is not (B, N, C), C % {LANE} == 0")
    bsz, n, c = shape
    index_shape = index.shape
    k = index_shape[-1]
    if index_shape != (bsz, k):
        _build.check_shape(name, "index", index, (bsz, k))
    if values is not None and values.shape != (bsz, k, c):
        _build.check_shape(name, "values", values, (bsz, k, c))
    if mask is not None and mask.shape != (bsz, k):
        _build.check_shape(name, "mask", mask, (bsz, k))
    if index.dtype not in _INDEX_DTYPES:
        raise TypeError(f"{name}: index is {index.dtype}, expected an int32 or int64 tensor")
    return bsz, n, c, k


def _valid(index, mask, n):
    """(B, K) bool: the slots that name a row, with mask True."""
    ok = (index >= 0) & (index < n)
    return ok if mask is None else ok & mask.bool()


def scatter_rows_inplace_plain(buffer, values, index, mask=None):
    """buffer (B, N, C) <- values (B, K, C) at rows index (B, K) where mask
    (B, K) is True (None: every slot), in place; returns buffer."""
    _check("scatter_rows_inplace", buffer, index, values, mask)
    ok = _valid(index, mask, buffer.shape[1])
    rows = torch.arange(buffer.shape[0], device=buffer.device)[:, None].expand(index.shape)
    buffer[rows[ok], index.long()[ok]] = values[ok].to(buffer.dtype)
    return buffer


def gather_rows_plain(buffer, index):
    """rows (B, K, C) <- buffer (B, N, C) at index (B, K); zeros where the
    index lies outside [0, N)."""
    _check("gather_rows", buffer, index)
    n = buffer.shape[1]
    ok = _valid(index, None, n)
    rows = torch.arange(buffer.shape[0], device=buffer.device)[:, None].expand(index.shape)
    out = buffer[rows, index.long().clamp(0, n - 1)]
    return torch.where(ok[..., None], out, out.new_zeros(()))


def _check_cuda(name, buffer, index, values=None, mask=None):
    """The plain version's argument rules (:func:`_check`), then the
    kernels' (:func:`cuda_operands`). Returns (B, N, C, K), the dtype codes
    of the buffer and the values (0 for values not given), the data
    pointers of the buffer, the values, the index and the mask (0 for one
    not given) and the buffer's device index."""
    dims = _check(name, buffer, index, values, mask)
    codes, pointers, device = cuda_operands(name, buffer, values, index, mask)
    return dims, codes, pointers[:4], device


def cuda_operands(name, buffer, values, index, mask=None, row_map=None):
    """One pass over the operands of a CUDA row copy (rows 19 and 20 here,
    row 11 in ``gate_block``), each tensor's attributes read once: the
    buffer a contiguous CUDA tensor of float32 or bfloat16 whose rows (C <=
    MAX_ROW_WIDTH values) are whole 16-byte words; the values, the index,
    the mask and the map (each None where not given) contiguous on its
    device; the buffer and the values (float32 or bfloat16) on 16-byte
    boundaries, since the kernels copy 16-byte words. The messages are
    ``_build.check_operands``'s. Shapes and the index's dtype are the
    caller's to check. Returns the dtype codes of the buffer and the values
    (0 for values not given), the data pointers of the buffer, the values,
    the index, the mask and the map (0 for one not given) and the buffer's
    device index."""
    if not buffer.is_cuda:
        raise ValueError(f"{name}: expected CUDA or CPU tensors, got {buffer.device}")
    codes = (_build.dtype_code(buffer), 0 if values is None else _build.dtype_code(values))
    if not buffer.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    c = buffer.shape[-1]
    if c > _build.MAX_ROW_WIDTH:
        raise ValueError(f"{name}: C={c} exceeds {_build.MAX_ROW_WIDTH}")
    if c * buffer.element_size() % 16:
        raise ValueError(f"{name}: rows of {c} {buffer.dtype} values are not whole 16-byte words")
    device = buffer.get_device()
    pointers = []
    for key, t in (("buffer", buffer), ("values", values), ("index", index), ("mask", mask),
                   ("row_map", row_map)):
        if t is None:
            pointers.append(0)
            continue
        if t.get_device() != device or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be a contiguous tensor on {buffer.device}")
        ptr = t.data_ptr()
        if ptr % 16 and key in ("buffer", "values"):
            raise ValueError(f"{name}: {key} must start on a 16-byte boundary")
        pointers.append(ptr)
    return codes, pointers, device


def scatter_rows_inplace(buffer, values, index, mask=None):
    """The wrapper of :func:`scatter_rows_inplace_plain`, which CPU tensors
    take. CUDA tensors launch the kernel of csrc/scatter.cu, which casts
    float32 or bfloat16 values to the buffer's dtype itself. Its host time
    is most of a call's, so the operands are checked in one pass
    (:func:`_check_cuda`)."""
    if buffer.is_cpu:
        return scatter_rows_inplace_plain(buffer, values, index, mask)
    name = "scatter_rows_inplace"
    if mask is not None and mask.dtype != torch.bool:
        mask = mask != 0
    (bsz, n, c, k), (code, values_code), pointers, device = _check_cuda(
        name, buffer, index, values, mask
    )
    buffer_ptr, values_ptr, index_ptr, mask_ptr = pointers
    _build.launch(
        "etk_scatter_rows", code, values_code, buffer_ptr, values_ptr, index_ptr,
        int(index.dtype == torch.int64), mask_ptr, bsz, n, c, k, _build.stream_on(device),
    )
    scatter_rows_inplace.launches += 1
    return buffer


def gather_rows(buffer, index):
    """The wrapper of :func:`gather_rows_plain`, which CPU tensors take.
    CUDA tensors launch the bulk row-copy kernel of csrc/scatter.cu with
    its plan from ``row_copy.gather_plan``: one allocation (the rows) and
    one launch, none where there are no slots."""
    if buffer.is_cpu:
        return gather_rows_plain(buffer, index)
    name = "gather_rows"
    (bsz, n, c, k), (code, _), (buffer_ptr, _, index_ptr, _), device = _check_cuda(
        name, buffer, index
    )
    rows = torch.empty((bsz, k, c), dtype=buffer.dtype, device=buffer.device)
    plan = gather_plan(c, buffer.element_size(), bsz, k)
    if plan is None:
        return rows
    _build.launch(
        "etk_gather_rows", code, buffer_ptr, index_ptr, int(index.dtype == torch.int64),
        rows.data_ptr(), bsz, n, c, k, plan.per, plan.stages, plan.grid, _build.stream_on(device),
    )
    gather_rows.launches += 1
    return rows


scatter_rows_inplace.launches = 0
gather_rows.launches = 0
