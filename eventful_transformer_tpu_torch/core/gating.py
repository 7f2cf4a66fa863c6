"""Gates, token buffers and the matmul buffer (port of
``eventful_transformer_tpu/core/gating.py``).

State is a plain dict of tensors, as in the JAX package. On the eventful
paths the incremental gate and buffer updates run inside the kernels
(``ops/``), which update ``p`` and ``b`` in place;
:meth:`TokenGate.incremental_select` is the same gate update written in
plain PyTorch. ``EventfulBlock`` recomputes its A.V product from the gate
states (``recompute_av``), so of ``TokenDeltaGate`` only the state is used
and of ``MatmulBuffer`` only :meth:`~MatmulBuffer.incremental_recompute`
(or its counts alone, where the A.V kernel computes the product).
The gathered delta paths (``TokenDeltaGate.incremental``,
``MatmulDeltaAccumulator``, ``SimpleSTGTGate``) are not ported yet
(ROADMAP.md, open item 10).
"""

from __future__ import annotations

import torch

from eventful_transformer_tpu_torch.core.indexing import coverage_from_norms, valid_fraction
from eventful_transformer_tpu_torch.core.nn import counted_matmul, not_ported
from eventful_transformer_tpu_torch.core.policies import vector_norm


class TokenGate:
    """Reference-state token gate. ``structure``: "row" gates the token
    axis -2, "col" the axis -1."""

    def __init__(self, structure="row"):
        if structure not in ("row", "col"):
            raise ValueError(f"structure must be 'row' or 'col', got {structure!r}")
        self.structure = structure
        self.policy = None  # set by utils.misc.set_policies

    def init_state(self, shape, dtype, device):
        return {"p": torch.zeros(shape, dtype=dtype, device=device)}

    def flush(self, state, c):
        """First time step: pass everything through, store the reference."""
        del state
        return c, {"p": c}

    def incremental_select(self, ctx, state, c, norms=None):
        """Gate-state update without gathering the selected rows: the top-k
        rows of ``c`` by error norm replace those rows of ``p``. ``norms``:
        precomputed order-2 error norms. Returns (kcap, state)."""
        ctx.add("gate_flops", c.numel())
        p = state["p"]
        if norms is None:
            norms = vector_norm(c - p, -1, self.policy.order)
        kcap = self.policy.capacity(c.shape[-2])
        cov = coverage_from_norms(norms, kcap)
        return kcap, {"p": torch.where(cov[..., None] > 0, c, p)}


class TokenDeltaGate(TokenGate):
    """Token gate that also emits the error deltas. Its state is what the
    recompute A.V path keeps; the delta-emitting update is not ported."""

    def incremental(self, *args, **kwargs):
        raise not_ported("TokenDeltaGate.incremental (recompute_av=False)", 10)


class TokenBuffer:
    """Persistent token state. Its incremental scatter runs inside
    ``ops.gate_group.gate_group_mlp`` on the main path."""

    def init_state(self, shape, dtype, device):
        return {"b": torch.zeros(shape, dtype=dtype, device=device)}

    def flush(self, state, x):
        del state
        return x, {"b": x}


class MatmulBuffer:
    """The q.kT product of ``EventfulMatmul1Block``. The cached product is
    pure memoization (``product == q @ k`` at every step), so the port
    recomputes it in incremental steps, as the JAX package's default
    ``recompute_product`` does; the cached-and-scattered update is not
    ported."""

    def flush(self, ctx, state, q, k):
        del state
        product = counted_matmul(ctx, q, k)
        return product, {"product": product}

    def incremental_recompute(self, ctx, q, k, index_q, index_k, mask_q=None, mask_k=None):
        """q @ k in q's dtype, counted as the reference's two incremental
        matmuls (rows of the selected queries, columns of the selected
        keys)."""
        self.count_incremental(ctx, q, k, index_q, index_k, mask_q, mask_k)
        return torch.matmul(q, k)

    @staticmethod
    def count_incremental(ctx, q, k, index_q, index_k, mask_q=None, mask_k=None):
        """The counts of :meth:`incremental_recompute` for q (..., N, d) and
        k (..., d, Np), where a kernel computes the product instead."""
        d, n = q.shape[-1], q.shape[-2]
        batch = q.numel() // (n * d)
        rows_out = batch * index_q.shape[-1] * k.shape[-1]
        cols_out = batch * n * index_k.shape[-1]
        ctx.add("matmul_flops", valid_fraction(mask_q) * float(rows_out * d))
        ctx.add("matmul_flops", valid_fraction(mask_k) * float(cols_out * d))


class MatmulDeltaAccumulator:
    """The delta-accumulated A.V product; ``EventfulBlock`` recomputes it
    from the gate states instead (``recompute_av``)."""

    def init_state(self, *args, **kwargs):
        raise not_ported("MatmulDeltaAccumulator (recompute_av=False)", 10)
