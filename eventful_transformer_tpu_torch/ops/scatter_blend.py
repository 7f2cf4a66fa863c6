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

The CUDA kernel is ``csrc/scatter_blend.cu``. The wrapper counts its
launches in ``launches``.
"""

from __future__ import annotations

import torch

from eventful_transformer_tpu_torch.ops import _build

MAX_SLOTS = 12288  # the kernel holds a batch row's indices in 48 KB of shared memory


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
    CUDA tensors launch the kernel of csrc/scatter_blend.cu."""
    if x.device.type == "cpu":
        return scatter_blend_plain(x, values, index, mask)
    name = "scatter_blend"
    bsz, n, c = x.shape
    k = index.shape[-1]
    values = values.to(x.dtype).contiguous()
    index = index.long().contiguous()
    _build.check_operands(name, x, values=values)
    _build.check_shape(name, "values", values, (bsz, k, c))
    for key, t, dtype in (("index", index, torch.int64), ("mask", mask, torch.bool)):
        if t is None:
            continue
        if t.device != x.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be a contiguous {dtype} tensor on {x.device}")
        _build.check_shape(name, key, t, (bsz, k))
    if k > MAX_SLOTS:
        raise ValueError(f"{name}: {k} slots exceed {MAX_SLOTS}")
    out = torch.empty_like(x)
    _build.launch(
        "etk_scatter_blend", _build.dtype_code(x), x.data_ptr(), values.data_ptr(),
        index.data_ptr(), None if mask is None else mask.data_ptr(), out.data_ptr(), bsz, n, c,
        k, _build.stream_of(x),
    )
    scatter_blend.launches += 1
    return out


scatter_blend.launches = 0
