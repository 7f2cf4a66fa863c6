"""Token-selection policies (port of ``eventful_transformer_tpu/core/policies.py``).

The eventful path selects from per-token error norms that the kernels emit,
so a policy fixes the capacity k and the norm order. The top-k policies
select the exact set ``lax.top_k`` picks (:func:`~.indexing.coverage_from_norms`,
ties to the smallest index), listed as indices in ascending order by
:func:`~.indexing.index_from_coverage`; every slot is valid (mask None).
``TokenNormThreshold`` takes the same top-``capacity`` candidates and masks
those whose norm is not above the threshold, counting a saturated selection
(every candidate above it) in ``policy_saturated``, the signal of the
capacity-bucketed dispatch (``utils/bucketing.py``).
"""

from __future__ import annotations

import torch

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
    """Select the k tokens with the largest error norm. ``save_status``
    keeps the last error tensor and selection a gate handed to
    :meth:`select` in ``last_input`` and ``last_output`` (for debugging and
    visualisation); a gate whose policy saves its status takes none of the
    select-only and in-kernel shortcuts, as in the JAX package."""

    def __init__(self, k, order=2, save_status=False):
        self.k = k
        self.order = order
        self.save_status = save_status
        self.last_input = None
        self.last_output = None

    def capacity(self, n_tokens):
        return min(self.k, n_tokens)

    def select(self, e, norm_axis, ctx=None):
        """Select from the error tensor ``e``, its norm taken over
        ``norm_axis``; the token axis is the remaining last one. Returns
        (index, mask)."""
        index, mask = self.select_from_norms(vector_norm(e, norm_axis, self.order), ctx)
        if self.save_status:
            self.last_input = e
            self.last_output = index
        return index, mask

    def select_from_norms(self, norms, ctx=None):
        """(index (..., k), None) for error norms (..., N): the set
        ``lax.top_k`` selects, ties to the smallest index, listed in
        ascending order (every consumer is order-free); None: every slot
        is valid."""
        del ctx
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


class TokenNormThreshold:
    """Select the tokens whose error norm exceeds ``threshold``, with a
    fixed capacity: the top-``capacity`` tokens by norm (the whole sequence
    when ``capacity`` is None) are the candidates, listed as the top-k
    policies list them, and the mask keeps those whose norm is above the
    threshold. With capacity >= N this is the reference's variable-k
    selection."""

    def __init__(self, threshold=0.0, order=2, capacity=None):
        self.threshold = threshold
        self.order = order
        self._capacity = capacity

    def capacity(self, n_tokens):
        return n_tokens if self._capacity is None else min(self._capacity, n_tokens)

    def select(self, e, norm_axis, ctx=None):
        return self.select_from_norms(vector_norm(e, norm_axis, self.order), ctx)

    def select_from_norms(self, norms, ctx=None):
        """(index (..., k), mask (..., k)). Below full capacity it adds to
        ``policy_saturated`` the batch rows whose every candidate is over
        the threshold (the selection may have been cut short); the count
        stays on the device until the caller reads the counts."""
        n = norms.shape[-1]
        k = self.capacity(n)
        index = index_from_coverage(coverage_from_norms(norms, k), k)
        mask = torch.gather(norms, -1, index) > self.threshold
        if ctx is not None and k < n:
            ctx.add("policy_saturated", mask.all(dim=-1).float().sum())
        return index, mask


def in_kernel_topk_eligible(policy):
    """Whether a group kernel may select its own rows under ``policy`` (the
    policy half of the JAX package's ``_use_in_kernel_topk``): exactly a
    ``TokenNormTopK`` (not a subclass such as ``TokenNormTopFraction``) of
    order 2, whose L2 norms the kernel computes, that saves no status."""
    return type(policy) is TokenNormTopK and policy.order == 2 and not policy.save_status


def topk_coverage_ok(policy):
    """Whether a group may take its coverage straight from the norms, with
    no index list or mask (the JAX package's coverage-only path): a top-k
    policy (``TokenNormTopK`` or ``TokenNormTopFraction``) that saves no
    status."""
    return isinstance(policy, TokenNormTopK) and not policy.save_status


def check_kernel_policy(policy):
    """Raise unless ``policy`` is one the kernel paths implement: a top-k
    (``TokenNormTopK``, ``TokenNormTopFraction``) or ``TokenNormThreshold``.
    The kernels emit L2 norms, so the norm order is ignored, as in the JAX
    package's fused modes; the "v4" dispatch requires order 2 besides."""
    if policy is None:
        raise ValueError("a gate has no policy: set the policies before running the model")
    if not isinstance(policy, (TokenNormTopK, TokenNormThreshold)):
        raise NotImplementedError(
            f"policy {policy!r}: the port has TokenNormTopK, TokenNormTopFraction and "
            "TokenNormThreshold"
        )
