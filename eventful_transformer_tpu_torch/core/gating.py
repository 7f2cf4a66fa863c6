"""Token gate and token buffer (port of ``TokenGate`` and ``TokenBuffer``
from ``eventful_transformer_tpu/core/gating.py``).

State is a plain dict of tensors, as in the JAX package. On the eventful
main path the incremental gate and buffer updates run inside the kernels
(``ops/``), which update ``p`` and ``b`` in place;
:meth:`TokenGate.incremental_select` is the same gate update written in
plain PyTorch. ``TokenDeltaGate``, ``SimpleSTGTGate``, ``MatmulBuffer`` and
``MatmulDeltaAccumulator`` wait for slice 2 (ROADMAP.md, open item 10).
"""

from __future__ import annotations

import torch

from eventful_transformer_tpu_torch.core.indexing import coverage_from_norms
from eventful_transformer_tpu_torch.core.policies import vector_norm


class TokenGate:
    """Reference-state token gate over the token axis (-2)."""

    def __init__(self):
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


class TokenBuffer:
    """Persistent token state. Its incremental scatter runs inside
    ``ops.gate_group.gate_group_mlp`` on the main path."""

    def init_state(self, shape, dtype, device):
        return {"b": torch.zeros(shape, dtype=dtype, device=device)}

    def flush(self, state, x):
        del state
        return x, {"b": x}
