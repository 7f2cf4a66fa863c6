"""Sequence-parallel (Ulysses) attention (port of
``eventful_transformer_tpu/parallel/sequence.py``).

Tokens are sharded over the processes of a group through the token-wise
ops (LN, the qkv and projection linears, the MLP act per token and need no
communication); attention, the only all-token op, runs through two
all-to-alls:

    token-sharded qkv  --all_to_all-->  head-sharded qkv of the full sequence
    -> exact attention over every token for heads/P heads ->
    head-sharded output  --all_to_all-->  token-sharded output

It needs N % P == 0 and heads % P == 0, as the JAX package asserts. The
dense ``Block`` takes it with ``sequence_parallel`` (``core/blocks.py``),
through :func:`ulysses_attention` (JAX ``make_ulysses_attention``) with its
own single-process attention between the two exchanges. ``shard_tokens``
slices a backbone's ``precompute`` (every leaf over its token axis) as the
JAX sequence-parallel step shards it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _exchange(x, group):
    """x (P, ...): block j goes to rank j; returns (P, ...), block i the
    one rank i sent here."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def heads_for_tokens(qkv, heads, group):
    """Token-sharded packed qkv (B, N/P, 3C) -> (B, N, 3C/P), the packed
    qkv of this rank's heads/P heads (heads r·H/P ... (r+1)·H/P - 1) over
    all N tokens, in the qkv linear's (3, heads, head_dim) order."""
    p = dist.get_world_size(group)
    b, n_local, c3 = qkv.shape
    if heads % p:
        raise ValueError(f"{heads} heads do not divide over {p} sequence shards")
    local_heads = heads // p
    d = c3 // (3 * heads)
    x = qkv.reshape(b, n_local, 3, p, local_heads, d).permute(3, 0, 1, 2, 4, 5)
    x = _exchange(x, group)  # (P, B, N/P, 3, H/P, d): rank i's tokens
    return x.permute(1, 0, 2, 3, 4, 5).reshape(b, p * n_local, 3 * local_heads * d)


def tokens_for_heads(x, group):
    """The attention of this rank's heads over all N tokens (B, N, C/P) ->
    the token shard (B, N/P, C) of every head."""
    p = dist.get_world_size(group)
    b, n, c_local = x.shape
    x = x.reshape(b, p, n // p, c_local).permute(1, 0, 2, 3)
    x = _exchange(x, group)  # (P, B, N/P, C/P): rank j's heads of these tokens
    return x.permute(1, 2, 0, 3).reshape(b, n // p, p * c_local)


def ulysses_attention(qkv, heads, group, attend):
    """Exact multi-head attention of token-sharded packed qkv (B, N/P, 3C)
    -> (B, N/P, C): ``attend`` (packed qkv (B, N, 3C/P) -> (B, N, C/P), the
    attention of as many heads as its width holds) on this rank's heads/P
    heads over all N tokens, between the two all-to-alls."""
    return tokens_for_heads(attend(heads_for_tokens(qkv, heads, group)), group)


def shard_tokens(tree, rank, size):
    """Every tensor leaf of ``tree`` (nested dicts and lists) cut to the
    ``rank``-th of ``size`` equal blocks of its axis 1, the token axis (the
    JAX step's ``P(None, axis, None)`` on every leaf)."""
    if isinstance(tree, dict):
        return {k: shard_tokens(v, rank, size) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tokens(v, rank, size) for v in tree)
    n = tree.shape[1]
    if n % size:
        raise ValueError(f"{n} tokens do not divide over {size} sequence shards")
    return tree.narrow(1, rank * (n // size), n // size)


def gather_tokens(x, group):
    """Token shards (B, N/P, C) of every rank -> (B, N, C) in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=1)
