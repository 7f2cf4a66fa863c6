"""Pipeline parallelism over the block stack, frames as micro-batches (port
of ``eventful_transformer_tpu/parallel/pipeline.py``).

The depth-L stack splits into P contiguous stages of L/P blocks, one a
process of the mesh axis ("pipe"): stage p holds blocks [p·L/P, (p+1)·L/P)
and their temporal state, which never leaves it. Frame t enters stage 0
while frame t - 1 is in stage 1, and activations go from stage p to p + 1
by ``send``/``recv`` (NCCL on the card, gloo on the CPU). Each stage runs
its T frames in order and nothing else: where the JAX package computes
placeholder work in the fill and drain bubble and masks its state
updates, a stage here skips its bubble steps (it waits in ``recv``), so
the eventful state is the sequential scan's by construction.

Inside a stage the blocks pass each other the qkv-gate norms as
``ViTBackbone`` does; across a stage boundary the first block computes its
own (``ViTBackbone.run_blocks``), the same norms by the same formula. So
the outputs and every block's state equal those of the backbone's block
loop (``run_blocks`` over the whole stack) in one process.

Scope, as in the JAX package: homogeneous stacks with depth % P == 0;
counting off (the single-process path counts). ``run`` drives the block
stack only: the frames come after the position encoding.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from eventful_transformer_tpu_torch.core.counting import Ctx


def _leaves(tree, path=()):
    """[(path, leaf)] of nested dicts in sorted key order."""
    if isinstance(tree, dict):
        return [item for key in sorted(tree) for item in _leaves(tree[key], path + (key,))]
    return [(path, tree)]


def _rebuild(tree, values):
    """``tree`` with its leaves (in :func:`_leaves` order) replaced by the
    iterator ``values``'s."""
    if isinstance(tree, dict):
        return {key: _rebuild(tree[key], values) for key in sorted(tree)}
    return next(values)


def _broadcast_state(state, like, src, group, mine):
    """Block state ``state`` (on its owner, ``mine``) on every rank of
    ``group``, made in the structure of ``like`` (its initial state) on
    the others. The stacks the pipeline takes hold tensors only."""
    leaves = _leaves(state if mine else like)
    if mine and [p for p, _ in leaves] != [p for p, _ in _leaves(like)]:
        raise ValueError("a block's state changed its structure in the pipeline")
    out = []
    for _, leaf in leaves:
        buf = leaf.contiguous() if mine else torch.empty_like(leaf)
        dist.broadcast(buf, src=src, group=group)
        out.append(buf)
    return _rebuild(like, iter(out))


def make_pipelined_backbone(backbone, mesh, axis="pipe"):
    """``run(state, frames) -> (outputs, state)``: the block stack of
    ``backbone`` (a ``ViTBackbone``) as a P-stage pipeline over the
    ``axis`` group of ``mesh``, this rank its stage.

    ``frames`` (T, B, N, C), time-major, after the position encoding, a
    video's first T frames; ``state`` the backbone's ``init_state``, on
    every rank; frame 0 flushes the eventful blocks, the rest step
    incrementally. Returns, on every rank, the last stage's outputs
    (T, B, N, C) and every block's new state, equal to the sequential
    frame loop's. Refuses a depth that P does not divide and a stack that
    is not :attr:`~ViTBackbone.homogeneous`."""
    group = mesh.get_group(axis)
    n_stages, stage = dist.get_world_size(group), dist.get_rank(group)
    depth = len(backbone.blocks)
    if depth % n_stages:
        raise ValueError(f"{depth} blocks do not divide into {n_stages} stages")
    if not backbone.homogeneous:
        raise ValueError("pipeline stages must be structurally equal: the stack is not "
                         "homogeneous")
    per_stage = depth // n_stages
    start, stop = stage * per_stage, (stage + 1) * per_stage
    rank_of = [dist.get_global_rank(group, p) for p in range(n_stages)]
    aux = backbone.precompute()["blocks"]

    @torch.no_grad()
    def run(state, frames):
        states = list(state["blocks"])
        ctx = Ctx()
        ys = []
        for t in range(frames.shape[0]):
            mode = "flush" if t == 0 else "incremental"
            if stage == 0:
                x = frames[t]
            else:
                x = torch.empty_like(frames[t])
                dist.recv(x, src=rank_of[stage - 1], group=group)
            x, states[start:stop] = backbone.run_blocks(ctx, states, x, mode, aux, start, stop)
            if stage + 1 < n_stages:
                dist.send(x.contiguous(), dst=rank_of[stage + 1], group=group)
            else:
                ys.append(x)
        outputs = torch.stack(ys) if stage + 1 == n_stages else torch.empty_like(frames)
        dist.broadcast(outputs, src=rank_of[-1], group=group)
        new_states = [
            _broadcast_state(states[i], state["blocks"][i], rank_of[i // per_stage], group,
                             i // per_stage == stage)
            for i in range(depth)
        ]
        return outputs, {"blocks": new_states}

    return run
