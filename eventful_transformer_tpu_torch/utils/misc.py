"""Model helpers (port of ``set_policies`` from
``eventful_transformer_tpu/utils/misc.py``)."""

from __future__ import annotations

from eventful_transformer_tpu_torch.core.blocks import EventfulTokenwiseBlock


def set_policies(model, policy_class, **policy_kwargs):
    """Give every token gate of ``model`` a fresh policy instance."""
    for module in model.modules():
        if isinstance(module, EventfulTokenwiseBlock):
            for gate in module.gates:
                gate.policy = policy_class(**policy_kwargs)
