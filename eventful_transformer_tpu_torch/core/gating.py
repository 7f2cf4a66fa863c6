"""Gates, token buffers and the matmul accumulators (port of
``eventful_transformer_tpu/core/gating.py``).

State is a plain dict of tensors, as in the JAX package. On the kernel
paths the incremental gate and buffer updates run inside the kernels
(``ops/``), which update ``p`` and ``b`` in place; the methods here are the
same updates in plain PyTorch, for the gathered paths (the unfused regime,
the qkv and MLP groups that gather rows, the reference's cached q.kT
product and delta-accumulated A.V product). Selections are index lists
from the policy (ascending; a threshold policy's with a mask) or forced by
the caller (pooled and deduplicated, with a mask). ``SimpleSTGTGate`` runs on the
unfused path only, as in the JAX package.
"""

from __future__ import annotations

import torch

from eventful_transformer_tpu_torch.core.indexing import (
    coverage_from_norms,
    mask_cols,
    mask_rows,
    put_cols,
    put_rows,
    select_cols,
    select_rows,
    take_cols,
    take_rows,
    valid_fraction,
)
from eventful_transformer_tpu_torch.core.nn import counted_matmul
from eventful_transformer_tpu_torch.core.policies import topk_coverage_ok, vector_norm


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

    def _select(self, e, forced_index, forced_mask, ctx=None):
        if forced_index is not None:
            return forced_index, forced_mask
        return self.policy.select(e, -1 if self.structure == "row" else -2, ctx)

    def incremental(self, ctx, state, c, forced_index=None, forced_mask=None):
        """The selected tokens of ``c`` replace those of the reference.
        Returns (c_tilde, index, mask, state): c_tilde the selected rows
        (columns) of c."""
        ctx.add("gate_flops", c.numel())
        p = state["p"]
        index, mask = self._select(c - p, forced_index, forced_mask, ctx)
        if self.structure == "row":
            return take_rows(c, index), index, mask, {"p": select_rows(p, c, index, mask)}
        return take_cols(c, index), index, mask, {"p": select_cols(p, c, index, mask)}

    def select_only_ok(self):
        """Whether :meth:`incremental_select` may stand in for
        :meth:`incremental` where the gathered rows and indices go unused."""
        return type(self) is TokenGate and self.structure == "row" and topk_coverage_ok(self.policy)

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
    """Token gate that also emits the error deltas ``e_tilde``; the slots
    with mask False get zero deltas, so that they add nothing to a delta
    accumulator."""

    def incremental(self, ctx, state, c, forced_index=None, forced_mask=None):
        """Returns (c_tilde, e_tilde, index, mask, state). Valid forced
        indices must be distinct (the column state update scatters them)."""
        ctx.add("gate_flops", c.numel())
        p = state["p"]
        if forced_index is None:
            index, mask = self._select(c - p, None, None, ctx)
        else:
            index, mask = forced_index, forced_mask
        if self.structure == "row":
            c_tilde = take_rows(c, index)
            e_tilde = c_tilde - take_rows(p, index)
            if mask is not None:
                e_tilde = mask_rows(e_tilde, mask)
            p = select_rows(p, c, index, mask)
        else:
            c_tilde = take_cols(c, index)
            e_tilde = c_tilde - take_cols(p, index)
            if mask is not None:
                e_tilde = mask_cols(e_tilde, mask)
            p = put_cols(p, index, c_tilde, mask)
        return c_tilde, e_tilde, index, mask, {"p": p}


class SimpleSTGTGate(TokenGate):
    """The baseline gate of "Spatio-Temporal Gated Transformers": the
    reference is overwritten with the whole current input each step, so the
    error is measured against the previous frame rather than each token's
    last update. Row structure only."""

    def __init__(self, structure="row"):
        if structure != "row":
            raise ValueError(f"SimpleSTGTGate gates rows only, got structure={structure!r}")
        super().__init__(structure)

    def incremental(self, ctx, state, c, forced_index=None, forced_mask=None):
        """Returns (c_tilde, index, mask, state), the state ``c`` itself."""
        ctx.add("gate_flops", c.numel())
        index, mask = self._select(c - state["p"], forced_index, forced_mask, ctx)
        return take_rows(c, index), index, mask, {"p": c}


class TokenBuffer:
    """Persistent token state. Its incremental scatter runs inside the
    group kernels on the kernel paths; :meth:`incremental` is the gathered
    paths' scatter."""

    def __init__(self, structure="row"):
        if structure not in ("row", "col"):
            raise ValueError(f"structure must be 'row' or 'col', got {structure!r}")
        self.structure = structure

    def init_state(self, shape, dtype, device):
        return {"b": torch.zeros(shape, dtype=dtype, device=device)}

    def flush(self, state, x):
        del state
        return x, {"b": x}

    def incremental(self, state, x, index, mask=None):
        put = put_rows if self.structure == "row" else put_cols
        b = put(state["b"], index, x, mask)
        return b, {"b": b}


class MatmulBuffer:
    """The q.kT product of ``EventfulMatmul1Block``. The cached product is
    pure memoization (``product == q @ k`` at every step), so by default
    (``recompute_product``) an incremental step recomputes it
    (:meth:`incremental_recompute`); :meth:`incremental` is the reference's
    cached form, the selected rows and columns recomputed and scattered in."""

    def init_state(self, shape, dtype, device):
        return {"product": torch.zeros(shape, dtype=dtype, device=device)}

    def flush(self, ctx, state, q, k):
        del state
        product = counted_matmul(ctx, q, k)
        return product, {"product": product}

    def incremental(self, ctx, state, q, k, index_q, index_k, mask_q=None, mask_k=None):
        """q (..., N, d), k (..., d, Np): rows ``index_q`` of the product
        from q's selected rows, then columns ``index_k`` from k's selected
        columns, each in q's dtype."""
        product = state["product"]
        rows = counted_matmul(ctx, take_rows(q, index_q), k, valid_fraction(mask_q))
        product = put_rows(product, index_q, rows, mask_q)
        cols = counted_matmul(ctx, q, take_cols(k, index_k), valid_fraction(mask_k))
        product = put_cols(product, index_k, cols, mask_k)
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
    """The delta-accumulated A.V product of ``EventfulBlock`` with
    ``recompute_av = False``:

        product += a_n_tilde @ v_delta_tilde
        product += a_delta_tilde @ (v_n_tilde - v_delta_tilde)

    the two adds in this order, each product and sum in the state's dtype.
    Invalid slots arrive with zero deltas (:class:`TokenDeltaGate`) and add
    nothing."""

    def init_state(self, shape, dtype, device):
        return {"product": torch.zeros(shape, dtype=dtype, device=device)}

    def flush(self, ctx, state, a, v):
        del state
        product = counted_matmul(ctx, a, v)
        return product, {"product": product}

    def incremental(
        self, ctx, state, a_n_tilde, v_n_tilde, a_delta_tilde, v_delta_tilde, mask=None
    ):
        product = state["product"]
        frac = valid_fraction(mask)
        ctx.add("accumulator_flops", frac * float(v_n_tilde.numel()) + 2.0 * product.numel())
        product = product + counted_matmul(ctx, a_n_tilde, v_delta_tilde, frac)
        product = product + counted_matmul(ctx, a_delta_tilde, v_n_tilde - v_delta_tilde, frac)
        return product, {"product": product}
