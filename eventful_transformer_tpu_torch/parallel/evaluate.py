"""Multi-process evaluation (port of ``eventful_transformer_tpu/parallel/
evaluate.py``): data parallelism over videos and Ulysses sequence
parallelism over ViTDet's tokens, one process per GPU (``parallel/mesh.py``).

Data parallel: videos are independent (each starts from a fresh state), so
rank r of the "data" axis evaluates items r, r + P, ... with the
single-process driver's own per-item loop (``utils/evaluate.py``), and the
predictions and counts go to the axis's first rank, which computes the
metrics over the items in their sequential order: the same metrics and
counts as the single-process driver, since no padding item is ever run or
counted (the JAX package instead runs the last group padded in lockstep).

Sequence parallel: ViTDet's backbone runs token-sharded over the "seq"
axis (each dense ``Block`` with ``sequence_parallel`` trades tokens for
heads in its attention), while ``pre_backbone`` and the detection head run
whole on every rank; only the backbone's counts are summed over the ranks.

Every function returns the same dict on every rank of its axis.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from eventful_transformer_tpu_torch.core.blocks import Block
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.parallel.sequence import gather_tokens, shard_tokens
from eventful_transformer_tpu_torch.utils.evaluate import (
    make_bucketed_vivit_step,
    make_vitdet_eval_step,
    make_vivit_step,
    vitdet_item_results,
    vitdet_metrics,
    vivit_item_results,
    vivit_metrics,
)


def _first(group):
    """The global rank of ``group``'s first member."""
    return dist.get_global_rank(group, 0)


def _sequential(results, group):
    """Each rank's list of per-item results (rank r's items r, r + P, ...)
    -> every item in sequential order, on the group's first rank (None on
    the others)."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    gathered = [None] * size if rank == 0 else None
    dist.gather_object(results, gathered, dst=_first(group), group=group)
    if rank != 0:
        return None
    ordered = [None] * sum(len(r) for r in gathered)
    for r, items in enumerate(gathered):
        ordered[r::size] = items
    return ordered


def _from_first(result, group):
    """The group's first rank's ``result`` on every rank."""
    box = [result]
    dist.broadcast_object_list(box, src=_first(group), group=group)
    return box[0]


def evaluate_vivit_metrics_dp(model, data, config, mesh, axis="data"):
    """Data-parallel ``utils.evaluate.evaluate_vivit_metrics``: top-1,
    top-5 and the mean counts per video."""
    group = mesh.get_group(axis)
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    step = make_bucketed_vivit_step(model, config) or make_vivit_step(model)
    n_items = min(config.get("n_items") or len(data), len(data))
    ordered = _sequential(vivit_item_results(model, data, range(rank, n_items, size), step),
                          group)
    return _from_first(None if ordered is None else vivit_metrics(ordered), group)


def evaluate_vitdet_metrics_dp(model, data, config, mesh, axis="data"):
    """Data-parallel ``utils.evaluate.evaluate_vitdet_metrics``: the mAP
    over every frame and the mean counts per frame."""
    group = mesh.get_group(axis)
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    step = make_vitdet_eval_step(model, config)
    n_items = min(config.get("n_items") or len(data), len(data))
    ordered = _sequential(vitdet_item_results(model, data, range(rank, n_items, size), step),
                          group)
    return _from_first(None if ordered is None else vitdet_metrics(ordered), group)


def make_sequence_parallel_vitdet_step(model, mesh, axis="seq", count_mode=True):
    """The Ulysses ViTDet step, ``step(frame, content_hw) -> (detections,
    counts)``: ``pre_backbone`` whole, the backbone on this rank's block of
    N/P tokens (the position encoding sliced alike: every leaf of the
    backbone's ``precompute`` over its token axis), the tokens gathered,
    then ``post_backbone`` whole. The backbone's counts are summed over the
    ranks (the single-process totals); the outer counts are taken once.
    Needs a dense global-attention backbone whose blocks set
    ``sequence_parallel`` to ``axis`` (they find its group in the
    backbone's context; any other backbone is refused, since its blocks
    would attend within their shard), N % P == 0 and heads % P == 0."""
    odd = [i for i, block in enumerate(model.backbone.blocks)
           if type(block) is not Block or block.sequence_parallel != axis]
    if odd:
        raise ValueError(f"sequence parallelism over {axis!r} needs every backbone block a "
                         f"dense Block with sequence_parallel={axis!r}; blocks {odd} are not")
    group = mesh.get_group(axis)
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    aux = shard_tokens(model.precompute(), rank, size)
    p = next(model.parameters())
    on = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend(group) == "nccl" \
        else torch.device("cpu")

    @torch.no_grad()
    def step(frame, content_hw):
        ctx = Ctx(count_mode=count_mode)
        tokens = model.pre_backbone(ctx, frame, content_hw)
        backbone_ctx = Ctx(count_mode=count_mode, groups={axis: group})
        state = model.init_state(tokens.shape[0], p.dtype, p.device)
        local, _ = model.apply_backbone(backbone_ctx, state, shard_tokens(tokens, rank, size), aux)
        tokens = gather_tokens(local, group)
        if count_mode:
            counts = backbone_ctx.counts
            keys = sorted(counts)
            summed = torch.tensor([counts[k] for k in keys], dtype=torch.float64, device=on)
            dist.all_reduce(summed, group=group)
            for key, value in zip(keys, summed.tolist()):
                ctx.add(key, value)
        out = model.post_backbone(ctx, tokens)
        return out, ctx.counts

    return step


def evaluate_vitdet_metrics_sp(model, data, config, mesh, axis="seq"):
    """Sequence-parallel ViTDet evaluation (a dense backbone): the
    single-process driver's per-frame protocol with the backbone
    token-sharded over ``axis``; the same mAP and counts on every rank."""
    sp_step = make_sequence_parallel_vitdet_step(model, mesh, axis)

    def step(state, frame, content_hw, first):
        del first
        out, counts = sp_step(frame, content_hw)
        return out, state, counts

    step.reset = lambda: None
    n_items = min(config.get("n_items") or len(data), len(data))
    return vitdet_metrics(vitdet_item_results(model, data, range(n_items), step))
