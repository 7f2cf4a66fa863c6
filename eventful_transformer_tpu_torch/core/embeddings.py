"""Learned absolute position encoding (port of ``PositionEncoding`` from
``eventful_transformer_tpu/core/embeddings.py``).

Only the path where the stored encoding already has the input's token grid
is ported, which is the flagship's case ([14, 14] spatial, [16] temporal).
A grid that needs the bicubic resize raises until ``ops/resize.py`` is
ported (ROADMAP.md, open item 7); the class-token carve-out belongs to that
resize path.
"""

from __future__ import annotations

from math import prod

import torch
from torch import nn

from eventful_transformer_tpu_torch.core.nn import counted_add, trunc_normal_


class PositionEncoding(nn.Module):
    def __init__(self, dim, encoding_size, input_size, has_class_token):
        super().__init__()
        self.encoding_size = tuple(encoding_size)
        self.input_size = tuple(input_size)
        if self.input_size != self.encoding_size:
            raise NotImplementedError(
                f"position encoding {self.encoding_size} -> {self.input_size} needs "
                "the bicubic resize (ROADMAP.md, open item 7)"
            )
        tokens = prod(self.encoding_size) + int(has_class_token)
        self.encoding = nn.Parameter(torch.zeros(1, tokens, dim))

    def reset_parameters(self, generator):
        trunc_normal_(self.encoding, generator)

    def forward(self, ctx, x):
        return counted_add(ctx, x, self.encoding.to(x.dtype))
