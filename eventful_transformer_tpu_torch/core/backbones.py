"""ViT backbone: position encoding plus a block stack (port of
``eventful_transformer_tpu/core/backbones.py``).

Blocks are chosen by class name, as the configs name them; ``window_indices``
picks the blocks that take ``windowed_class`` and ``windowed_overrides``
(ViTDet's windowed blocks), and every other block attends globally. The
stack runs as a Python loop; the JAX package's layer scan
(``_apply_scanned``) exists for tracing and is not ported. In an
incremental step an eventful block's last kernel emits the next block's
qkv-gate norms where the JAX package's ``_next_gate_info`` rule allows it
(``share_gate_passes`` not False on either block), so only the first block
of such a chain computes its own.
"""

from __future__ import annotations

from math import prod

from torch import nn

from eventful_transformer_tpu_torch.core.blocks import (
    BLOCK_CLASSES,
    EventfulTokenwiseBlock,
)
from eventful_transformer_tpu_torch.core.embeddings import PositionEncoding
from eventful_transformer_tpu_torch.core.nn import not_ported


class ViTBackbone(nn.Module):
    def __init__(
        self,
        block_config,
        depth,
        position_encoding_size,
        input_size,
        block_class="Block",
        has_class_token=False,
        window_indices=(),
        windowed_class=None,
        windowed_overrides=None,
    ):
        super().__init__()
        for name in (block_class, windowed_class):
            if name is not None and name not in BLOCK_CLASSES:
                raise not_ported(f"block class {name!r}", 10)
        self.input_size = tuple(input_size)
        self.has_class_token = has_class_token
        self.position_encoding = PositionEncoding(
            block_config["dim"], position_encoding_size, input_size, has_class_token
        )
        blocks = []
        for i in range(depth):
            class_i = block_class
            config_i = dict(block_config)
            if i in window_indices:
                if windowed_class is not None:
                    class_i = windowed_class
                if windowed_overrides is not None:
                    config_i.update(windowed_overrides)
            else:
                config_i["window_size"] = None
            blocks.append(BLOCK_CLASSES[class_i](input_size=input_size, **config_i))
        self.blocks = nn.ModuleList(blocks)

    @property
    def n_tokens(self):
        return prod(self.input_size) + int(self.has_class_token)

    def init_state(self, batch, dtype, device):
        return {
            "blocks": [
                block.init_state(batch, self.n_tokens, dtype, device) for block in self.blocks
            ]
        }

    def precompute(self):
        """Loop-invariant derived tensors (the sized position encoding, the
        blocks' rel-pos tables), computed once for many frames."""
        return {
            "position_encoding": self.position_encoding.precompute(),
            "blocks": [block.precompute() for block in self.blocks],
        }

    def forward(self, ctx, state, x, mode=None, aux=None):
        """``mode``: "flush" or "incremental" for eventful blocks. ``aux``:
        :meth:`precompute`, computed here when not given."""
        if aux is None:
            aux = self.precompute()
        x = self.position_encoding(ctx, x, aux["position_encoding"])
        new_states = []
        norms = None
        for i, block in enumerate(self.blocks):
            give = None
            if mode == "incremental" and i + 1 < len(self.blocks):
                give = _next_gate(block, self.blocks[i + 1], x, state["blocks"][i + 1])
            x, s, norms = block(
                ctx, state["blocks"][i], x, mode=mode, qkv_norms=norms, next_gate=give,
                aux=aux["blocks"][i],
            )
            new_states.append(s)
        return x, {"blocks": new_states}


def _next_gate(block, nxt, x, next_state):
    """The next block's (p_qkv, ln_scale, ln_bias), whose qkv-gate norms the
    last kernel of ``block`` then emits, or None (the JAX package's
    ``ViTBackbone._next_gate_info``). Both blocks must be eventful; ``block``
    must step in a regime whose last kernel emits them ("v2", "blocked" or
    "v4"; the JAX package excludes "v2mlp"); the next gate must take
    order-2 norms; neither may gate before LN (the emitted norms are
    LN-domain) or hold STGT gates; the token count must not change (it
    cannot: the port has no ATS); the next qkv gate state must be C
    wide; and neither block may have ``share_gate_passes`` False."""
    for b in (block, nxt):
        if not isinstance(b, EventfulTokenwiseBlock) or b.gate_before_ln or b.stgt:
            return None
        if b.share_gate_passes is False:
            return None
    if block._fused_mode(x.shape[-2]) not in ("v2", "blocked", "v4"):
        return None
    if getattr(nxt.qkv_gate.policy, "order", 2) != 2:
        return None
    p_next = next_state.get("qkv_gate", {}).get("p")
    if p_next is None or p_next.shape[-1] != block.dim:
        return None
    ln = nxt.input_layer_norm
    return p_next, ln.scale, ln.bias
