"""Token-selection policies (port of the mask-free top-k policies of
``eventful_transformer_tpu/core/policies.py``).

The eventful path selects from per-token error norms that the kernels emit,
so a policy fixes the capacity k and the norm order; the selection itself
is :func:`~.indexing.coverage_from_norms`, and
:func:`~.indexing.index_from_coverage` lists the same set as indices
(:meth:`TokenNormTopK.select`, for the gates that gather).
``TokenNormThreshold`` (masked, saturation-counted) is not ported yet
(ROADMAP.md, open item 11).
"""

from __future__ import annotations

from eventful_transformer_tpu_torch.core.indexing import coverage_from_norms, index_from_coverage


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

    def select(self, e, norm_axis):
        """Select from the error tensor ``e``, its norm taken over
        ``norm_axis``; the token axis is the remaining last one."""
        return self.select_from_norms(vector_norm(e, norm_axis, self.order))

    def select_from_norms(self, norms):
        """(index (..., k), None) for error norms (..., N): the set
        ``lax.top_k`` selects, ties to the smallest index, listed in
        ascending order (every consumer is order-free); None: every slot
        is valid."""
        k = self.capacity(norms.shape[-1])
        return index_from_coverage(coverage_from_norms(norms, k), k), None


class TokenNormTopFraction(TokenNormTopK):
    """Select a fraction of the tokens with the largest error norm."""

    def __init__(self, fraction, order=2):
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"fraction must lie in [0, 1], got {fraction}")
        super().__init__(k=None, order=order)
        self.fraction = fraction

    def capacity(self, n_tokens):
        return int(self.fraction * n_tokens)


def in_kernel_topk_eligible(policy):
    """Whether a group kernel may select its own rows under ``policy`` (the
    policy half of the JAX package's ``_use_in_kernel_topk``): exactly a
    ``TokenNormTopK`` (not a subclass such as ``TokenNormTopFraction``) of
    order 2, whose L2 norms the kernel computes. The JAX rule also asks for
    no saved status, which the port's policies never keep."""
    return type(policy) is TokenNormTopK and policy.order == 2


def check_kernel_policy(policy):
    """Raise unless ``policy`` is one the kernel paths implement: a
    mask-free top-k (``TokenNormTopK`` or ``TokenNormTopFraction``). The
    kernels emit L2 norms, so the norm order is ignored, as in the JAX
    package's fused modes; the "v4" dispatch requires order 2 besides."""
    if policy is None:
        raise ValueError("a gate has no policy: set the policies before running the model")
    if not isinstance(policy, TokenNormTopK):
        raise NotImplementedError(
            f"policy {policy!r}: only TokenNormTopK/TokenNormTopFraction "
            "are ported (ROADMAP.md, open item 11)"
        )
