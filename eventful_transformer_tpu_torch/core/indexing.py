"""Top-k selection coverage and index helpers (port of the parts of
``eventful_transformer_tpu/core/indexing.py`` that the eventful paths use).

The selection is the exact set ``jax.lax.top_k`` picks: the k largest error
norms, ties at the k-th value going to the smallest indices. It is derived
from the k-th largest *value* and the tie rank, never from
``torch.topk``'s indices: on CUDA, ``torch.topk`` does not promise which of
several tied indices it returns, while its values are well defined. Where a
caller needs the selected indices themselves, :func:`index_from_coverage`
lists them in ascending order; every consumer of an index list in the
JAX package is order-free (scatters and selects by position, the pooled
dedupe sorts).

The JAX package's one-hot gather and scatter forms (``_one_hot_rows``,
the one-hot blend of ``put_rows``/``put_cols``) are TPU layout devices; the
port gathers, selects and scatters by index, with the same results wherever
the valid indices of a row are distinct (the JAX package's own
precondition, which top-k and the pooled dedupe meet). The JAX package's
switch ``USE_PALLAS_BLEND`` routes ``put_rows`` to its scatter-blend kernel;
the port has the same switch and routes the same calls to
``ops/scatter_blend.py::scatter_blend``, which computes the one-hot blend
itself (``-x + v1 + v2`` at a duplicated index).
"""

from __future__ import annotations

import numpy as np
import torch

from eventful_transformer_tpu_torch.ops.scatter_blend import scatter_blend

# Route put_rows to the scatter-blend kernel (core/indexing.py:107-145 of the
# JAX package); off by default there, as here.
USE_PALLAS_BLEND = False


def window_permutation(input_size, window):
    """(perm, inv) numpy int32 maps between the row-major tokens of an
    (h, w) grid and the window-major positions of its windows of
    ``window``, the grid padded at the bottom and right to whole windows:
    perm holds the row-major token of each window-major position (pad
    positions -> h * w); inv the window-major position of each row-major
    token."""
    (h, w), d = input_size, window
    hp, wp = h + -h % d[0], w + -w % d[1]
    rowmajor = np.full((hp, wp), h * w, dtype=np.int32)
    rowmajor[:h, :w] = np.arange(h * w, dtype=np.int32).reshape(h, w)
    perm = rowmajor.reshape(hp // d[0], d[0], wp // d[1], d[1]).transpose(0, 2, 1, 3).reshape(-1)
    inv = np.zeros(h * w, dtype=np.int32)
    valid = perm < h * w
    inv[perm[valid]] = np.nonzero(valid)[0].astype(np.int32)
    return perm, inv


def window_row_map(input_size, window):
    """(h * w + 1,) int32 numpy map of row-major token -> window-major row
    (:func:`window_permutation`), with the selection's out-of-range marker
    h * w -> -1: the map ``ops.gate_block.block_scatter_rows`` reads (the
    JAX package's ``_window_inv_ext``)."""
    _, inv = window_permutation(input_size, window)
    return np.concatenate([inv, np.full((1,), -1, np.int32)])


def _blend_eligible(x, index):
    """The JAX package's ``_pallas_blend_eligible``: the switch on, a 3-D x,
    a 2-D index and a row width that is a multiple of 128. Its platform
    test (not the CPU, where Pallas runs interpreted) is the wrapper's: a
    CUDA x launches the kernel, a CPU x takes its plain version, which
    computes the same blend."""
    return USE_PALLAS_BLEND and x.ndim == 3 and index.ndim == 2 and x.shape[-1] % 128 == 0


def coverage_from_norms(norms, k):
    """norms (..., n) -> coverage (..., n) float32 with exactly min(k, n)
    ones per row: the top-k set with ties broken by smallest index."""
    if k >= norms.shape[-1]:
        return torch.ones(norms.shape, dtype=torch.float32, device=norms.device)
    kth = torch.topk(norms, k, dim=-1).values[..., k - 1 : k]
    return coverage_from_kth(norms, kth, k)


def coverage_from_kth(norms, kth, k):
    """:func:`coverage_from_norms` given the k-th largest value (..., 1)."""
    gt = norms > kth
    n_gt = gt.sum(dim=-1, keepdim=True)
    eq = norms == kth
    tie_rank = torch.cumsum(eq.to(torch.int32), dim=-1)  # inclusive
    cov = gt | (eq & (tie_rank <= k - n_gt))
    return cov.to(torch.float32)


def index_from_coverage(cov, k):
    """The positions of a coverage with exactly k ones per row, ascending:
    (..., n) -> (..., k) int64. No host synchronisation."""
    n = cov.shape[-1]
    pos = torch.arange(n, device=cov.device).expand(cov.shape)
    key = torch.where(cov > 0, pos, n)
    return key.sort(dim=-1).values[..., :k]


def coverage(index, mask, n):
    """Indicator (..., n) float32 of the positions ``index`` (..., k)
    selects; slots with mask False are excluded. Valid indices must be
    distinct, as in the JAX package."""
    ones = torch.ones(index.shape, dtype=torch.float32, device=index.device)
    if mask is not None:
        ones = ones * mask
    cov = torch.zeros(index.shape[:-1] + (n,), dtype=torch.float32, device=index.device)
    return cov.scatter_add_(-1, index.long(), ones)


def _aligned(cov, index_ndim, ndim):
    """Insert the broadcast axes that align an (..., n) coverage of an
    index with ``index_ndim`` dims to an operand with ``ndim`` dims."""
    lead = cov.shape[:-1]
    return cov.reshape(lead + (1,) * (ndim - index_ndim) + cov.shape[-1:])


def _row_index(index, ndim):
    """(..., k) -> the (..., 1s, k, 1) view aligned to axis -2 of an ndim
    operand (index leading dims align left, as in the JAX package)."""
    shape = index.shape[:-1] + (1,) * (ndim - index.ndim - 1) + (index.shape[-1], 1)
    return index.long().reshape(shape)


def _col_index(index, ndim):
    """(..., k) -> the (..., 1s, k) view aligned to axis -1 of an ndim operand."""
    return index.long().reshape(index.shape[:-1] + (1,) * (ndim - index.ndim) + index.shape[-1:])


def take_rows(x, index):
    """Gather rows (axis -2): x (..., N, C), index (..., k) -> (..., k, C)."""
    index = _row_index(index, x.ndim).expand(x.shape[:-2] + index.shape[-1:] + x.shape[-1:])
    return torch.gather(x, -2, index)


def take_cols(x, index):
    """Gather columns (axis -1): x (..., M, N), index (..., k) -> (..., M, k)."""
    index = _col_index(index, x.ndim).expand(x.shape[:-1] + index.shape[-1:])
    return torch.gather(x, -1, index)


def put_rows(x, index, values, mask=None):
    """x with row ``index[j]`` (axis -2) replaced by row j of ``values``
    (..., k, C), cast to x's dtype; slots with mask False write nothing.
    Valid indices of a row must be distinct. An index copy into x with one
    spare row that the masked-off slots are sent to, then dropped: equal
    to the JAX package's one-hot blend wherever that precondition holds.
    Under ``USE_PALLAS_BLEND`` the calls :func:`_blend_eligible` takes
    run the blend itself, :func:`~..ops.scatter_blend.scatter_blend`."""
    if _blend_eligible(x, index):
        return scatter_blend(x, values, index, mask)
    n = x.shape[-2]
    if mask is not None:
        index = torch.where(mask, index, n)
    spare = torch.cat([x, x.new_zeros(x.shape[:-2] + (1, x.shape[-1]))], dim=-2)
    index = _row_index(index, x.ndim).expand(values.shape)
    return spare.scatter(-2, index, values.to(x.dtype))[..., :n, :]


def put_cols(x, index, values, mask=None):
    """Column (axis -1) version of :func:`put_rows`: values (..., M, k)."""
    n = x.shape[-1]
    if mask is not None:
        index = torch.where(mask, index, n)
    spare = torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], dim=-1)
    index = _col_index(index, x.ndim).expand(values.shape)
    return spare.scatter(-1, index, values.to(x.dtype))[..., :n]


def mask_rows(x, mask):
    """x (..., k, C) with the rows of the slots where mask (..., k) is False
    zeroed."""
    return torch.where(_row_index(mask, x.ndim).bool(), x, x.new_zeros(()))


def mask_cols(x, mask):
    """x (..., M, k) with the columns of the masked-off slots zeroed."""
    return torch.where(_col_index(mask, x.ndim).bool(), x, x.new_zeros(()))


def select_rows(p, c, index, mask=None):
    """Replace the rows (axis -2) of ``p`` selected by ``index`` with the
    same rows of ``c``: an elementwise select, as in the JAX package."""
    cov = _aligned(coverage(index, mask, p.shape[-2]), index.ndim, p.ndim - 1)
    return torch.where(cov[..., None] > 0, c, p)


def select_cols(p, c, index, mask=None):
    """Column (axis -1) version of :func:`select_rows`."""
    cov = _aligned(coverage(index, mask, p.shape[-1]), index.ndim, p.ndim)
    return torch.where(cov > 0, c, p)


def valid_fraction(mask):
    """Share of valid entries in a selection mask, used to scale counts;
    the static 1 when there is no mask (every slot valid). A 0-d tensor
    otherwise, read only where a count is taken."""
    if mask is None:
        return 1
    return mask.float().mean()
