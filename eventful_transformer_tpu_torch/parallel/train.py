"""The data-parallel x tensor-parallel training step (port of
``eventful_transformer_tpu/parallel/train.py``).

Over a ("data", "model") mesh (``parallel/mesh.py::best_dp_tp_mesh``): the
batch is split over "data", the blocks over "model" (``parallel/
sharding.py``: the dense, eventful and ATS blocks; an eventful model's
gates take the policies the caller set, as ``utils/misc.py::set_policies``
sets them). Each rank computes the loss of its data shard through autograd
(``Ctx(training=True)``: every block on its plain path, the eventful blocks
stepping unfused, Megatron's all-reduces inside the blocks); then every gradient, zero where
autograd gives none (as ``jax.value_and_grad`` does), is all-reduced over
"data" and divided by dp, the gradient of the mean loss over the whole
batch, and each rank steps its optimizer. The replicated parameters get the
same gradient on every rank of a "model" group, so they stay equal.

``full_model=True`` trains the whole ViViT end to end on views (the
multi-chip dry run's step); ``full_model=False`` the temporal model and the
classifier on cached spatial features (the reference's fine-tune path).

Dropout and drop-path draw from a generator seeded by (the step's seed,
the data rank) (:func:`data_generator`): the ranks of one "model" group
share a data shard and draw the same masks, in the same order, since every
draw has a replicated shape.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.parallel.sharding import shard_params, vit_param_specs
from eventful_transformer_tpu_torch.utils.train import make_optimizer


def cross_entropy_from_probs(probs, labels, eps=1e-9):
    """-mean log(p + eps) of each row's label: the cross-entropy of the
    model's probabilities (the model ends in a softmax, reference
    models/vivit.py:136). ``utils/train.py::loss_fn`` keeps the other JAX
    loss, the probabilities taken as logits."""
    logp = torch.log(probs + eps)
    return -logp.gather(-1, labels.long()[:, None])[:, 0].mean()


def data_generator(seed, data_rank, device):
    """The dropout and drop-path generator of data rank ``data_rank`` for
    a step seeded ``seed``, on ``device``."""
    state = np.random.SeedSequence([seed, data_rank]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _allreduce_mean(tensors, group, size):
    """Every tensor replaced by its mean over ``group``, one all-reduce a
    dtype."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        flat /= size
        offset = 0
        for t in same:
            t.copy_(flat[offset : offset + t.numel()].view_as(t))
            offset += t.numel()


def make_sharded_train_step(model, optimizer, mesh, full_model=True):
    """``(init_fn, make_step)`` for dp x tp training of a ``FactorizedViViT``
    on ``mesh`` (axes "data" and "model"), as the JAX function returns them.

    ``optimizer``: the optimizer's config, as the train configs give it
    (``{"optimizer": "AdamW", "optimizer_kwargs": {"lr": ...}}``, optax's
    names and defaults: ``utils/train.py::make_optimizer``).

    ``init_fn()`` shards ``model``'s blocks in place, makes every
    parameter trainable and returns (the torch optimizer over all of them,
    :func:`~.sharding.vit_param_specs`). ``make_step(optimizer, specs)``
    returns ``step(batch, seed) -> loss``: ``batch`` is the whole batch,
    ``{"inputs": views (B, V, T, C, H, W) or, without ``full_model``,
    spatial features (B, V, t, dim), "labels": (B,)}``, B a multiple of dp,
    of which each rank takes its data shard; ``seed`` seeds the step's
    draws (:func:`data_generator`); the loss is the mean over "data", on
    every rank."""
    data = mesh.get_group("data")
    dp, data_rank = dist.get_world_size(data), dist.get_rank(data)

    def init_fn():
        shard_params(mesh, model)
        params = [p.requires_grad_(True) for p in model.parameters()]
        return make_optimizer(optimizer, model, params), vit_param_specs(model)

    def loss_fn(inputs, labels, ctx):
        if full_model:
            probs = model.apply_views(ctx, inputs)
        else:
            probs = model._forward_temporal(ctx, inputs, inputs.shape[0])
        return cross_entropy_from_probs(probs, labels)

    def make_step(opt, specs):
        del specs  # the sharding is the modules' own
        params = [p for group in opt.param_groups for p in group["params"]]
        device = params[0].device

        def shard(x):
            if x.shape[0] % dp:
                raise ValueError(f"a batch of {x.shape[0]} does not divide over {dp} data ranks")
            n = x.shape[0] // dp
            return x.narrow(0, data_rank * n, n).to(device)

        def step(batch, seed):
            opt.zero_grad(set_to_none=True)
            ctx = Ctx(training=True, generator=data_generator(seed, data_rank, device))
            loss = loss_fn(shard(batch["inputs"]), shard(batch["labels"]), ctx)
            loss.backward()
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            loss = loss.detach().reshape(1)
            _allreduce_mean([p.grad for p in params] + [loss], data, dp)
            opt.step()
            return loss[0]

        return step

    return init_fn, make_step
