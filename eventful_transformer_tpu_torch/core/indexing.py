"""Top-k selection coverage (port of the parts of
``eventful_transformer_tpu/core/indexing.py`` that the eventful main path
uses).

The selection is the exact set ``jax.lax.top_k`` picks: the k largest error
norms, ties at the k-th value going to the smallest indices. It is derived
from the k-th largest *value* and the tie rank, never from
``torch.topk``'s indices: on CUDA, ``torch.topk`` does not promise which of
several tied indices it returns, while its values are well defined.

The JAX package's one-hot gather and scatter forms (``_one_hot_rows``,
``put_rows``, ``USE_PALLAS_BLEND``) are TPU layout devices and are not
ported; the kernels gather and scatter by index.
"""

from __future__ import annotations

import torch


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


def valid_fraction(mask):
    """Share of valid entries in a selection mask, used to scale counts;
    the static 1 when there is no mask (every slot valid)."""
    if mask is None:
        return 1
    return float(mask.float().mean())
