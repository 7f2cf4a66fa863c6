"""Token-selection policies (port of the mask-free top-k policies of
``eventful_transformer_tpu/core/policies.py``).

The eventful path selects from per-token error norms that the kernels emit,
so a policy here only fixes the capacity k and the norm order; the selection
itself is :func:`~.indexing.coverage_from_norms`. ``TokenNormThreshold``
(masked, saturation-counted) waits for slice 2 of the port (ROADMAP.md,
open item 11).
"""

from __future__ import annotations


def vector_norm(e, dim, order):
    """Per-token error norm of ``e`` reduced over ``dim``, in float32."""
    e = e.float()
    if order == 2:
        return e.square().sum(dim=dim).sqrt()
    if order == 1:
        return e.abs().sum(dim=dim)
    return (e.abs() ** order).sum(dim=dim) ** (1.0 / order)


class TokenNormTopK:
    """Select the k tokens with the largest error norm."""

    def __init__(self, k, order=2):
        self.k = k
        self.order = order

    def capacity(self, n_tokens):
        return min(self.k, n_tokens)


class TokenNormTopFraction(TokenNormTopK):
    """Select a fraction of the tokens with the largest error norm."""

    def __init__(self, fraction, order=2):
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"fraction must lie in [0, 1], got {fraction}")
        super().__init__(k=None, order=order)
        self.fraction = fraction

    def capacity(self, n_tokens):
        return int(self.fraction * n_tokens)


def check_kernel_policy(policy):
    """Raise unless ``policy`` is one the kernel pipeline implements: a
    mask-free order-2 top-k (``TokenNormTopK`` or ``TokenNormTopFraction``),
    whose selection comes from the L2 norms the kernels emit."""
    if not isinstance(policy, TokenNormTopK) or policy.order != 2:
        raise NotImplementedError(
            f"policy {policy!r}: only order-2 TokenNormTopK/TokenNormTopFraction "
            "are ported (ROADMAP.md, open item 11)"
        )
