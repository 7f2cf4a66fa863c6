"""Model helpers (port of ``set_policies`` from
``eventful_transformer_tpu/utils/misc.py``)."""

from __future__ import annotations

from eventful_transformer_tpu_torch.core.gating import TokenGate


def set_policies(model, policy_class, **policy_kwargs):
    """Give every token gate of ``model`` (the v and matmul gates of an
    ``EventfulBlock`` included, as in the JAX package) a fresh policy
    instance."""
    for module in model.modules():
        for gate in vars(module).values():
            if isinstance(gate, TokenGate):
                gate.policy = policy_class(**policy_kwargs)
