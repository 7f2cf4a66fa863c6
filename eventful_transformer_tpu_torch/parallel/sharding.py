"""Tensor parallelism (port of ``eventful_transformer_tpu/parallel/sharding.py``):
Megatron's split of the ViT blocks over the processes of a "model" axis.

Column-parallel: the qkv and mlp_1 kernels (and their biases) keep their
output columns of this rank. Row-parallel: the projection and mlp_2 kernels
keep their input rows of this rank; their biases are replicated and added
once, after the all-reduce. Everything else (LN, embeddings, class tokens,
the classifier) is replicated. :func:`vit_param_specs` states the rule as
the JAX ``PartitionSpec`` tuples do: which axis of each parameter is
sharded over "model".

The JAX spec of the (C, 3C) qkv kernel is a layout that GSPMD reshards as
it needs; here the columns are cut by head: rank r of tp holds the q, k and
v columns of heads [r·H/tp, (r+1)·H/tp), packed [q_r | k_r | v_r], which is
the packed qkv of H/tp heads that the block's attention takes as it is
(``core/blocks.py::Block._attention``: as many heads as its width holds).
The projection's rows are the attention output's features, head-major, so
rank r's contiguous block of them belongs to the same heads.

Megatron's two operators wrap the linears (``Block._forward_tensor_parallel``):
:func:`to_model_parallel` before each column linear (identity forward,
all-reduce of the gradient backward) and :func:`from_model_parallel` after
each row linear (all-reduce forward, identity backward). The second is not
``torch.distributed.nn.functional.all_reduce``, whose backward all-reduces
the gradient again and so multiplies it by tp.

Every block class of ``core/blocks.py::BLOCK_CLASSES`` is split, ATS
blocks included, as the JAX package shards them by parameter name whatever
the class: the eventful blocks' gates and buffers take the widths and the
collectives ``core/blocks.py``'s docstring sets out, and each eventful
block's projection gate gets the group as its ``norm_group``. Refused at
tp > 1: a block class the port does not know (its state's widths and
collectives are not stated), rel-pos (the JAX package has no
tensor-parallel path for it: ViTDet, the only model with rel-pos, has no
such entry point, and a rel-pos ViViT fails in the JAX package under any
mesh), and ``sequence_parallel`` (a block shards its heads or its tokens,
not both).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

COL_PARALLEL = {"qkv", "mlp_1"}
ROW_PARALLEL = {"projection", "mlp_2"}


def vit_param_spec(path_parts, leaf, tp_axis="model"):
    """The sharded axes of one parameter, by its path: a tuple with
    ``tp_axis`` at the sharded axis and None elsewhere, () where the
    parameter is replicated (the JAX ``PartitionSpec``)."""
    parent = path_parts[-1] if path_parts else ""
    if parent in COL_PARALLEL:
        if leaf == "kernel":
            return (None, tp_axis)
        if leaf == "bias":
            return (tp_axis,)
    if parent in ROW_PARALLEL and leaf == "kernel":
        return (tp_axis, None)
    return ()


def vit_param_specs(model, tp_axis="model"):
    """{parameter name: :func:`vit_param_spec`} over ``model``'s
    parameters."""
    specs = {}
    for name, _ in model.named_parameters():
        *parts, leaf = name.split(".")
        specs[name] = vit_param_spec(parts, leaf, tp_axis)
    return specs


class _ToModelParallel(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _FromModelParallel(torch.autograd.Function):
    """The partial sums all-reduced over the group forward; identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def to_model_parallel(x, group):
    """Megatron's f: x unchanged; its gradient summed over ``group``."""
    return _ToModelParallel.apply(x, group)


def from_model_parallel(x, group):
    """Megatron's g: the sum of every rank's x over ``group``; the gradient
    passed through."""
    return _FromModelParallel.apply(x, group)


def _check_splittable(block, tp):
    from eventful_transformer_tpu_torch.core.blocks import BLOCK_CLASSES

    if type(block) not in BLOCK_CLASSES.values():
        raise ValueError(f"tensor parallelism takes the block classes {sorted(BLOCK_CLASSES)}, "
                         f"not {type(block).__name__} (its state's widths and collectives "
                         "under tp are not stated)")
    if block.relative_position is not None:
        raise ValueError("tensor parallelism takes blocks without rel-pos (the JAX package has "
                         "no tensor-parallel path for a rel-pos block)")
    if block.sequence_parallel is not None:
        raise ValueError("a block is tensor- or sequence-parallel, not both")
    hidden = block.mlp_1.out_features
    if block.heads % tp or hidden % tp:
        raise ValueError(f"{block.heads} heads and {hidden} hidden units do not divide over "
                         f"{tp} ranks")


def _by_head(t, heads, lo, hi):
    """The columns of heads [lo, hi) of each of q, k and v of a packed qkv
    kernel (C, 3C) or bias (3C,), packed [q | k | v]."""
    lead = t.shape[:-1]
    d = t.shape[-1] // (3 * heads)
    return t.reshape(lead + (3, heads, d))[..., lo:hi, :].reshape(lead + (-1,))


def _set(linear, name, value):
    setattr(linear, name, nn.Parameter(value.detach().clone(memory_format=torch.contiguous_format),
                                       requires_grad=getattr(linear, name).requires_grad))


def shard_params(mesh, model, tp_axis="model"):
    """Narrow every block of ``model`` to this rank's share of the
    ``tp_axis`` group of ``mesh`` (the qkv columns by head, the mlp_1
    columns, the projection and mlp_2 rows) and record the group on it
    (and, on an eventful block, on its projection gate), in place; returns
    ``model``. At tp = 1 nothing changes, and the blocks
    keep their single-process forward; a block split over this group
    already stays as it is. Raises where a block cannot be split (see the
    module's docstring)."""
    from eventful_transformer_tpu_torch.core.blocks import Block, EventfulTokenwiseBlock

    group = mesh.get_group(tp_axis)
    tp, r = dist.get_world_size(group), dist.get_rank(group)
    if tp == 1:
        return model
    blocks = [m for m in model.modules() if isinstance(m, Block)]
    for block in blocks:
        _check_splittable(block, tp)
        if block.tp_group not in (None, group):
            raise ValueError("the model's blocks are sharded over another group")
    for block in blocks:
        if block.tp_group is group:
            continue
        h = block.heads // tp
        _set(block.qkv, "kernel", _by_head(block.qkv.kernel, block.heads, r * h, (r + 1) * h))
        _set(block.qkv, "bias", _by_head(block.qkv.bias, block.heads, r * h, (r + 1) * h))
        block.qkv.out_features //= tp
        n = block.mlp_1.out_features // tp
        _set(block.mlp_1, "kernel", block.mlp_1.kernel[:, r * n : (r + 1) * n])
        _set(block.mlp_1, "bias", block.mlp_1.bias[r * n : (r + 1) * n])
        block.mlp_1.out_features = n
        for linear in (block.projection, block.mlp_2):
            n = linear.in_features // tp
            _set(linear, "kernel", linear.kernel[r * n : (r + 1) * n])
            linear.in_features = n
        block.tp_group = group
        if isinstance(block, EventfulTokenwiseBlock):
            block.projection_gate.norm_group = group
    return model


def gathered_params(mesh, model, tp_axis="model"):
    """{name: the whole parameter} of a model :func:`shard_params` split,
    gathered over the ``tp_axis`` group (the qkv shards back in head
    order); the same on every rank of the group."""
    from eventful_transformer_tpu_torch.core.blocks import Block

    group = mesh.get_group(tp_axis)
    tp = dist.get_world_size(group)
    split = {}
    for prefix, module in model.named_modules():
        if isinstance(module, Block) and module.tp_group is not None:
            split[f"{prefix}.qkv"] = ("heads", module.heads)
            split[f"{prefix}.mlp_1"] = ("cols", None)
            split[f"{prefix}.projection"] = ("rows", None)
            split[f"{prefix}.mlp_2"] = ("rows", None)
    out = {}
    for name, p in model.named_parameters():
        parent, leaf = name.rsplit(".", 1)
        how, heads = split.get(parent, (None, None))
        value = p.detach()
        if how is None or (how == "rows" and leaf == "bias"):
            out[name] = value.clone()
            continue
        parts = [torch.empty_like(value) for _ in range(tp)]
        dist.all_gather(parts, value.contiguous(), group=group)
        if how == "heads":
            lead = value.shape[:-1]
            parts = [t.reshape(lead + (3, heads // tp, -1)) for t in parts]
            out[name] = torch.cat(parts, dim=-2).reshape(lead + (-1,))
        else:
            out[name] = torch.cat(parts, dim=-1 if how == "cols" else 0)
    return out
