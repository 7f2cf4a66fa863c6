"""ViT backbone: position encoding plus a block stack (port of
``eventful_transformer_tpu/core/backbones.py``).

Blocks are chosen by class name, as the configs name them. The stack runs
as a Python loop; the JAX package's layer scan (``_apply_scanned``) exists
for tracing and is not ported. In an incremental step each eventful block's
kernel C emits the next eventful block's qkv-gate norms, so only the first
block of a step runs ``ln_norms``.
"""

from __future__ import annotations

from math import prod

from torch import nn

from eventful_transformer_tpu_torch.core.blocks import (
    BLOCK_CLASSES,
    EventfulTokenwiseBlock,
    not_ported,
)
from eventful_transformer_tpu_torch.core.embeddings import PositionEncoding


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
        if window_indices or windowed_class or windowed_overrides:
            raise not_ported("windowed blocks", 13)
        if block_class not in BLOCK_CLASSES:
            raise not_ported(f"block class {block_class!r}", 10)
        self.input_size = tuple(input_size)
        self.has_class_token = has_class_token
        self.position_encoding = PositionEncoding(
            block_config["dim"], position_encoding_size, input_size, has_class_token
        )
        config = dict(block_config, window_size=None)
        self.blocks = nn.ModuleList(
            BLOCK_CLASSES[block_class](input_size=input_size, **config)
            for _ in range(depth)
        )

    @property
    def n_tokens(self):
        return prod(self.input_size) + int(self.has_class_token)

    def init_state(self, batch, dtype, device):
        return {
            "blocks": [
                block.init_state(batch, self.n_tokens, dtype, device) for block in self.blocks
            ]
        }

    def forward(self, ctx, state, x, mode=None):
        """``mode``: "flush" or "incremental" for eventful blocks."""
        x = self.position_encoding(ctx, x)
        new_states = []
        norms = None
        for i, block in enumerate(self.blocks):
            give = None
            if mode == "incremental" and i + 1 < len(self.blocks):
                give = _next_gate(block, self.blocks[i + 1], state["blocks"][i + 1])
            x, s, norms = block(
                ctx, state["blocks"][i], x, mode=mode, qkv_norms=norms, next_gate=give
            )
            new_states.append(s)
        return x, {"blocks": new_states}


def _next_gate(block, nxt, next_state):
    """The next block's (p_qkv, ln_scale, ln_bias) when both blocks are
    eventful: kernel C of ``block`` then emits ``nxt``'s qkv-gate norms."""
    if not (isinstance(block, EventfulTokenwiseBlock) and isinstance(nxt, EventfulTokenwiseBlock)):
        return None
    ln = nxt.input_layer_norm
    return next_state["qkv_gate"]["p"], ln.scale, ln.bias
