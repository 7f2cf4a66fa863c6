"""Position encodings (port of ``eventful_transformer_tpu/core/embeddings.py``).

Both modules have a loop-invariant derived quantity: the encoding resized
to the input grid, and the relative-position tables resized to the
attention grid and pooled. :meth:`precompute` builds it; callers that run
many frames compute it once (``ViTBackbone.precompute``) and pass it in.

``RelativePositionEmbedding`` adds the decomposed bias to attention logits
through the bias-add wrappers of ``ops/relpos.py``, whose plain versions
are the JAX package's einsum path (its ``apply`` with the flat-expander and
Pallas options off) and whose kernels are its ``use_pallas_kernel`` True
and "v2" forms; ``use_kernel`` picks the rounding rule. The flat-expander
path is a TPU tiling device: it computes the same two per-axis terms and
the same sum.
"""

from __future__ import annotations

from math import prod

import torch
from torch import nn

from eventful_transformer_tpu_torch.core.nn import counted_add, trunc_normal_
from eventful_transformer_tpu_torch.ops.relpos import (
    relpos_bias_add,
    relpos_bias_add_plain,
    relpos_bias_add_v2,
    relpos_bias_add_v2_plain,
)
from eventful_transformer_tpu_torch.ops.resize import (
    avg_pool_1d,
    resize_bicubic,
    resize_bicubic_1d,
)


class PositionEncoding(nn.Module):
    """Learned absolute position encoding, bicubic-resized from
    ``encoding_size`` to ``input_size`` with a class-token carve-out. The
    interpolation is not counted, as in the reference."""

    def __init__(self, dim, encoding_size, input_size, has_class_token):
        super().__init__()
        self.encoding_size = tuple(encoding_size)
        self.input_size = tuple(input_size)
        self.has_class_token = has_class_token
        tokens = prod(self.encoding_size) + int(has_class_token)
        self.encoding = nn.Parameter(torch.zeros(1, tokens, dim))

    def reset_parameters(self, generator):
        trunc_normal_(self.encoding, generator)

    def precompute(self):
        """The stored encoding resized to the input token grid, float32."""
        encoding = self.encoding.float()
        if self.input_size == self.encoding_size:
            return encoding
        class_token = None
        if self.has_class_token:
            class_token, encoding = encoding[:, :1], encoding[:, 1:]
        encoding = encoding.transpose(1, 2)
        encoding = encoding.reshape(encoding.shape[:-1] + self.encoding_size)
        if len(self.encoding_size) == 2:
            encoding = resize_bicubic(encoding, self.input_size)
        else:
            encoding = resize_bicubic_1d(encoding, self.input_size[0])
        encoding = encoding.reshape(encoding.shape[:2] + (-1,)).transpose(1, 2)
        if class_token is not None:
            encoding = torch.cat([class_token, encoding], dim=1)
        return encoding

    def forward(self, ctx, x, sized_encoding=None):
        if sized_encoding is None:
            sized_encoding = self.precompute()
        return counted_add(ctx, x, sized_encoding.to(x.dtype))


class RelativePositionEmbedding(nn.Module):
    """Decomposed relative position embeddings, ViTDet-style (after
    detectron2's ``add_decomposed_rel_pos``).

    ``use_kernel`` takes the JAX ``use_pallas_kernel`` values and picks the
    rounding rule of :meth:`forward`: True, ``relpos_bias_add`` (row 16's:
    the terms' float32 sum rounded once); any other value, "auto" (the
    default), "v2" or False (the JAX einsum path, which rounds as row 17
    does), ``relpos_bias_add_v2`` (row 17's: each term rounded, then their
    sum). Each wrapper runs its plain version on CPU tensors and its kernel
    on the card; under ``ctx.training`` the plain version of the same rule
    runs on either device (the kernels have no backward)."""

    use_kernel = "auto"

    def __init__(self, attention_size, embedding_size, head_dim, pool_size=None):
        super().__init__()
        self.attention_size = tuple(attention_size)
        self.embedding_size = tuple(embedding_size)
        self.pool_size = tuple(pool_size) if pool_size is not None else None
        self.y_embedding = nn.Parameter(torch.zeros(2 * self.embedding_size[0] - 1, head_dim))
        self.x_embedding = nn.Parameter(torch.zeros(2 * self.embedding_size[1] - 1, head_dim))

    def reset_parameters(self, generator):
        trunc_normal_(self.y_embedding, generator)
        trunc_normal_(self.x_embedding, generator)

    def _get_relative(self, embedding, dim):
        """The (attention, pooled, head_dim) float32 table of one axis."""
        size = self.embedding_size[dim]
        r = torch.arange(size, device=embedding.device)
        relative = embedding.float()[r[:, None] - r[None, :] + size - 1]  # (S, S, c)
        if self.embedding_size != self.attention_size:
            relative = relative.permute(2, 1, 0)[None]
            relative = resize_bicubic(relative, self.attention_size)
            relative = relative[0].permute(2, 1, 0)
        if self.pool_size is not None:
            relative = avg_pool_1d(relative.transpose(1, 2), self.pool_size[dim])
            relative = relative.transpose(1, 2)
        return relative

    def pooled_size(self):
        a = self.attention_size
        if self.pool_size is None:
            return a
        return (a[0] // self.pool_size[0], a[1] // self.pool_size[1])

    def precompute(self):
        return {
            "y_relative": self._get_relative(self.y_embedding, dim=0),
            "x_relative": self._get_relative(self.x_embedding, dim=1),
        }

    def window_tab(self, derived, dtype):
        """(t, p0 + p1, c) per-token table of a window: row n holds
        [y_relative[n // a1], x_relative[n % a1]], in ``dtype``."""
        a0, a1 = self.attention_size
        return torch.cat(
            [
                derived["y_relative"].to(dtype).repeat_interleave(a1, dim=0),
                derived["x_relative"].to(dtype).repeat(a0, 1, 1),
            ],
            dim=1,
        )

    def bias_terms(self, ctx, q, derived):
        """(B, H, N, p0 + p1) per-axis bias terms of UNSCALED q (B, H, N, c)
        in q's dtype, counted as the reference's two term einsums."""
        a = self.attention_size
        p = self.pooled_size()
        bsz, heads, _, c = q.shape
        q5 = q.reshape(bsz, heads, a[0], a[1], c)
        term_y = torch.einsum("abhwc,hkc->abhwk", q5, derived["y_relative"].to(q.dtype))
        term_x = torch.einsum("abhwc,wkc->abhwk", q5, derived["x_relative"].to(q.dtype))
        ctx.add("einsum_flops", term_y.numel() * c)
        ctx.add("einsum_flops", term_x.numel() * c)
        return torch.cat(
            [term_y.reshape(bsz, heads, -1, p[0]), term_x.reshape(bsz, heads, -1, p[1])],
            dim=-1,
        )

    def forward(self, ctx, x, q, derived=None):
        """Add the decomposed terms of unscaled q (B, H, N, c) to attention
        logits x (B, H, N, Np): ``x[n, k] + (term_y[n, k // p1] +
        term_x[n, k % p1])``, rounded to x's dtype by the rule
        ``use_kernel`` picks. Counted as the reference's two term einsums
        and two adds."""
        if self.use_kernel not in (False, True, "v2", "auto"):
            raise ValueError(f"use_kernel must be False, True, 'v2' or 'auto', got {self.use_kernel!r}")
        if derived is None:
            derived = self.precompute()
        p = self.pooled_size()
        bsz, heads, n, c = q.shape
        ctx.add("einsum_flops", float(bsz * heads * n * c * (p[0] + p[1])))
        ctx.add("add_flops", 2.0 * x.numel())
        if ctx.training:  # the kernel has no backward: the plain version, same rounding
            bias_add = relpos_bias_add_plain if self.use_kernel is True else relpos_bias_add_v2_plain
        else:
            bias_add = relpos_bias_add if self.use_kernel is True else relpos_bias_add_v2
        return bias_add(
            x.contiguous(), q.contiguous(), derived["y_relative"].to(x.dtype).contiguous(),
            derived["x_relative"].to(x.dtype).contiguous(), a=self.attention_size, p=p,
        )
