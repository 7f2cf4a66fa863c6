"""The rank functions of tests/test_torch_parallel.py,
test_torch_tensor_parallel.py, test_torch_tensor_parallel_eventful.py and
test_torch_pipeline.py, run in processes
that ``eventful_transformer_tpu_torch.parallel.mesh.spawn`` starts. This module
imports nothing of JAX, so a rank starts in about a second. Each rank runs a
list of jobs ``(name, *arguments)``, every job on a process group of its own
(a FileStore in ``store_dir``), and returns one result a job."""

import contextlib
import io
import os
import signal
import time

import torch
import torch.distributed as dist

from eventful_transformer_tpu_torch.core.backbones import ViTBackbone
from eventful_transformer_tpu_torch.core.blocks import Block
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.models import FactorizedViViT, ViTDet
from eventful_transformer_tpu_torch.parallel import evaluate as parallel_evaluate
from eventful_transformer_tpu_torch.parallel.mesh import INIT_METHOD_ENV, distributed, make_mesh
from eventful_transformer_tpu_torch.parallel.sequence import shard_tokens
from eventful_transformer_tpu_torch.utils.params import params_from_jax


def _seq_group():
    group = make_mesh((-1,), ("seq",), "cpu").get_group("seq")
    return group, dist.get_rank(group), dist.get_world_size(group)


def attention_block(qkv, heads, sequence_parallel=None):
    """The dense ``Block`` whose attention takes the packed qkv (B, N, 3C)
    ``qkv`` with ``heads`` heads (the tokens one row of the map)."""
    return Block(dim=qkv.shape[-1] // 3, heads=heads, input_size=(1, qkv.shape[1]), mlp_ratio=2,
                 sequence_parallel=sequence_parallel)


def ulysses(qkv, heads):
    """This rank's token block of the attention of an ``attention_block``
    with ``sequence_parallel="seq"`` (``parallel.sequence.ulysses_attention``
    around the single-process route at the full N)."""
    group, rank, size = _seq_group()
    block = attention_block(qkv, heads, "seq")
    with torch.no_grad():
        y, _, _ = block._forward_attention(Ctx(groups={"seq": group}),
                                           shard_tokens(torch.from_numpy(qkv), rank, size), None)
    return y.numpy()


def sp_backbone(config, flat, x):
    """A ``ViTBackbone`` whose blocks set ``sequence_parallel="seq"`` on
    this rank's token block of x: (its output block, this rank's counts)."""
    group, rank, size = _seq_group()
    backbone = ViTBackbone(**config)
    params_from_jax(backbone, flat)
    aux = shard_tokens(backbone.precompute(), rank, size)
    ctx = Ctx(count_mode=True, groups={"seq": group})
    with torch.no_grad():
        y, _ = backbone(ctx, backbone.init_state(x.shape[0], torch.float32, "cpu"),
                        shard_tokens(torch.from_numpy(x), rank, size), aux=aux)
    return y.numpy(), dict(ctx.counts)


def _vitdet(config, flat):
    model = ViTDet(**config, device="cpu")
    return params_from_jax(model, flat)


def vitdet_sp(config, flat, data, eval_config):
    mesh = make_mesh((-1,), ("seq",), "cpu")
    return parallel_evaluate.evaluate_vitdet_metrics_sp(_vitdet(config, flat), data, eval_config,
                                                        mesh)


def vitdet_sp_refused(configs):
    """``make_sequence_parallel_vitdet_step`` over "seq" on each config's
    model: the ValueError's message, or None where it was taken."""
    mesh = make_mesh((-1,), ("seq",), "cpu")
    messages = []
    for config in configs:
        try:
            parallel_evaluate.make_sequence_parallel_vitdet_step(ViTDet(**config, device="cpu"),
                                                                 mesh)
            messages.append(None)
        except ValueError as error:
            messages.append(str(error))
    return messages


def _set_policy(model, policy):
    """``policy``: ("top_k", k) or ("threshold", threshold)."""
    from eventful_transformer_tpu_torch.core.policies import TokenNormThreshold, TokenNormTopK
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    name, value = policy
    if name == "top_k":
        set_policies(model, TokenNormTopK, k=value)
    else:
        set_policies(model, TokenNormThreshold, threshold=value)
    return model


def vitdet_dp(config, flat, data, eval_config, policy):
    mesh = make_mesh((-1,), ("data",), "cpu")
    model = _set_policy(_vitdet(config, flat), policy)
    return parallel_evaluate.evaluate_vitdet_metrics_dp(model, data, eval_config, mesh)


def vivit_dp(config, weights, data, eval_config, policy):
    mesh = make_mesh((-1,), ("data",), "cpu")
    model = _set_policy(params_from_jax(FactorizedViViT(**config, device="cpu"), weights), policy)
    return parallel_evaluate.evaluate_vivit_metrics_dp(model, data, eval_config, mesh)


def entry(module, argv, repo):
    """``<module>.main(argv)`` from the repo's root, as torchrun runs it:
    the entry point makes the group and must destroy it. Returns (the
    titles it did, whether a group was left)."""
    import importlib

    main = importlib.import_module(module).main
    with contextlib.chdir(repo), contextlib.redirect_stdout(io.StringIO()):
        done = main(argv)
    return done, dist.is_initialized()


# chip_smoke.py's parallel paths at slim widths on the CPU
SMOKE_VITDET = ["model.device=cpu", "model.output_channels=32", "model.backbone_config.depth=2",
                "model.backbone_config.block_config.dim=96",
                "model.rpn_config={pre_nms_topk: 200, post_nms_topk: 50}"]
SMOKE_VIVIT = ["model.device=cpu", "model.spatial_config.depth=1", "model.temporal_config.depth=1",
               "model.spatial_config.block_config.dim=96",
               "model.temporal_config.block_config.dim=96"]


def _slim_vivit(config):
    """A ViViT config of chip_smoke.py cut to 2 spatial blocks and 1
    temporal block of 96 (12 heads of 8) over 8 frames of 32 x 32 and 2
    views."""
    block = dict(dim=96, heads=12, mlp_ratio=4)
    return dict(
        config, input_shape=[8, 3, 32, 32], tubelet_shape=[2, 8, 8], spatial_views=1,
        temporal_views=2,
        spatial_config=dict(config["spatial_config"], depth=2, position_encoding_size=[4, 4],
                            block_config=block),
        temporal_config=dict(config["temporal_config"], depth=1, position_encoding_size=[4],
                             block_config=block),
    )


def smoke_rank(out, frames, items):
    """``chip_smoke.parallel_rank`` on a gloo rank at slim widths, the
    card's calls replaced as the script's CPU rehearsals replace them (the
    plain versions count no launch, so the launch checks are the card's)."""
    import chip_smoke
    from eventful_transformer_tpu_torch.ops import _build
    from eventful_transformer_tpu_torch.parallel import dryrun, mesh
    from eventful_transformer_tpu_torch.scripts.evaluate import vivit_kinetics400

    vivit = chip_smoke.vivit_config
    chip_smoke.vivit_config = lambda eventful: _slim_vivit(vivit(eventful))
    chip_smoke.tp_config = lambda: chip_smoke.vivit_config(False)
    chip_smoke.K = 8
    chip_smoke.rank_device = lambda: torch.device("cpu")
    dryrun.dryrun_multichip = lambda n: dryrun.dryrun_here("cpu")
    torch.cuda.reset_peak_memory_stats = lambda device=None: None
    torch.cuda.max_memory_allocated = lambda device=None: 0
    config, main = chip_smoke.harness_config, vivit_kinetics400.main
    make, group = mesh.make_mesh, mesh.distributed
    chip_smoke.harness_config = (lambda location, argv, kind="evaluate":
                                 config(location, argv + SMOKE_VITDET, kind))
    vivit_kinetics400.main = lambda argv: main(argv + SMOKE_VIVIT)
    mesh.make_mesh = lambda shape, axes, device: make(shape, axes, "cpu")
    mesh.distributed = lambda device: group("cpu")
    _build.load_library = lambda: None
    torch.cuda.synchronize = lambda: None
    torch.cuda.current_device = lambda: 0
    torch.cuda.get_device_name = lambda device=None: "cpu"
    chip_smoke.parallel_rank(out, frames, items)


def smoke_tp_eventful_rank(out):
    """``chip_smoke.tp_eventful_rank`` on a gloo rank at slim widths (12
    heads of 8, 6 a rank at tp = 2; 2 spatial blocks and 1 temporal block
    over 8 frames of 32 x 32, so 17 spatial tokens, of which the top-k
    gates keep 4), the card's calls replaced as in :func:`smoke_rank`."""
    import chip_smoke
    from eventful_transformer_tpu_torch.ops import _build
    from eventful_transformer_tpu_torch.parallel import mesh

    config = chip_smoke.tp_eventful_model_config

    def slim(name, **depths):
        model, policy, attrs = config(name, **depths)
        if policy is not None:
            policy = (policy[0], dict(k=4))
        model = dict(model, input_shape=[8, 3, 32, 32], tubelet_shape=[2, 8, 8])
        for part, size, depth in (("spatial_config", [4, 4], 2), ("temporal_config", [4], 1)):
            model[part] = dict(model[part], position_encoding_size=size,
                               depth=min(model[part]["depth"], depth),
                               block_config=dict(model[part]["block_config"], dim=96, heads=12))
        return model, policy, attrs

    chip_smoke.tp_eventful_model_config = slim
    chip_smoke.rank_device = lambda: torch.device("cpu")
    torch.cuda.reset_peak_memory_stats = lambda device=None: None
    torch.cuda.max_memory_allocated = lambda device=None: 0
    torch.cuda.synchronize = lambda: None
    _build.load_library = lambda: None
    make, group = mesh.best_dp_tp_mesh, mesh.distributed
    mesh.best_dp_tp_mesh = lambda max_tp, device: make(max_tp=max_tp, device="cpu")
    mesh.distributed = lambda device: group("cpu")
    chip_smoke.tp_eventful_rank(out)


def _tp_model(config, flat, max_tp):
    from eventful_transformer_tpu_torch.parallel.mesh import best_dp_tp_mesh

    mesh = best_dp_tp_mesh(max_tp=max_tp, device="cpu")
    return mesh, params_from_jax(FactorizedViViT(**config, device="cpu"), flat)


def _ranks(mesh):
    return {axis: dist.get_rank(mesh.get_group(axis)) for axis in ("data", "model")}


def tp_forward(config, flat, views, max_tp):
    """The sharded ViViT's probabilities of this rank's data shard of
    ``views`` on ``best_dp_tp_mesh(4, max_tp)``, with this rank's qkv
    shard of the first spatial block."""
    from eventful_transformer_tpu_torch.parallel.sharding import shard_params

    mesh, model = _tp_model(config, flat, max_tp)
    shard_params(mesh, model)
    ranks = _ranks(mesh)
    dp = dist.get_world_size(mesh.get_group("data"))
    n = views.shape[0] // dp
    with torch.no_grad():
        probs = model.apply_views(Ctx(), torch.from_numpy(views[ranks["data"] * n:][:n]))
    qkv = model.spatial_model.backbone.blocks[0].qkv
    return dict(ranks, probs=probs.numpy(), qkv_kernel=qkv.kernel.detach().numpy(),
                qkv_bias=qkv.bias.detach().numpy())


def tp_train(config, flat, inputs, labels, optimizer, steps, max_tp, seed, policy=None):
    """``steps`` steps of ``make_sharded_train_step`` (``optimizer``: its
    config) on the whole batch, the step i seeded ``seed + i``, every gate
    on ``policy`` (:func:`_set_policy`) where given: the losses, the
    replicated parameters' gradients of the first step, the gathered
    parameters after the last."""
    from eventful_transformer_tpu_torch.parallel.sharding import gathered_params
    from eventful_transformer_tpu_torch.parallel.train import make_sharded_train_step

    mesh, model = _tp_model(config, flat, max_tp)
    if policy is not None:
        _set_policy(model, policy)
    init_fn, make_step = make_sharded_train_step(model, optimizer, mesh)
    opt, specs = init_fn()
    step = make_step(opt, specs)
    batch = {"inputs": torch.from_numpy(inputs), "labels": torch.from_numpy(labels)}
    losses, grads = [], None
    for i in range(steps):
        losses.append(float(step(batch, seed + i)))
        if grads is None:
            grads = {name: p.grad.numpy().copy() for name, p in model.named_parameters()
                     if specs[name] == ()}
    params = {name: v.numpy() for name, v in gathered_params(mesh, model).items()}
    return dict(_ranks(mesh), losses=losses, grads=grads, params=params)


class UnknownBlock(Block):
    """A block class the port's tensor parallelism does not know."""


def tp_refused(configs):
    """``shard_params`` on the ("data", "model") mesh of tp = 2 for each
    config's ViViT: the ValueError's message, or None where it was taken.
    A config ``(config, "unknown")`` makes its first spatial block an
    :class:`UnknownBlock`; ``(config, "sequence")`` names a "seq" axis in
    it (``Block.sequence_parallel``)."""
    from eventful_transformer_tpu_torch.parallel.mesh import best_dp_tp_mesh
    from eventful_transformer_tpu_torch.parallel.sharding import shard_params

    mesh = best_dp_tp_mesh(max_tp=2, device="cpu")
    messages = []
    for config in configs:
        how = None
        if isinstance(config, tuple):
            config, how = config
        model = FactorizedViViT(**config, device="cpu")
        block = model.spatial_model.backbone.blocks[0]
        if how == "unknown":
            block.__class__ = UnknownBlock
        elif how == "sequence":
            block.sequence_parallel = "seq"
        try:
            shard_params(mesh, model)
            messages.append(None)
        except ValueError as error:
            messages.append(str(error))
    return messages


class SelectionLog:
    """Every selection a forward makes, in order: each top-k coverage
    (``coverage_from_norms`` where the gates, the policies and ATS call
    it: ("topk", the calling module's name, norms, k, coverage); the
    blocks module's are ATS's) and each threshold mask ("threshold",
    "policies", norms, threshold, mask), as numpy, while it is
    entered."""

    def __init__(self):
        self.entries = []
        self._undo = []

    def __enter__(self):
        from eventful_transformer_tpu_torch.core import blocks, gating, policies

        for module in (blocks, gating, policies):
            self._patch(module, "coverage_from_norms",
                        self._topk(module.coverage_from_norms, module.__name__.split(".")[-1]))
        threshold = policies.TokenNormThreshold
        self._patch(threshold, "select_from_norms", self._threshold(threshold.select_from_norms))
        return self

    def __exit__(self, *exc):
        for owner, name, value in reversed(self._undo):
            setattr(owner, name, value)

    def _patch(self, owner, name, value):
        self._undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def _topk(self, fn, where):
        def recorded(norms, k):
            cov = fn(norms, k)
            self.entries.append(("topk", where, norms.detach().numpy().copy(), k,
                                 cov.numpy().copy()))
            return cov
        return recorded

    def _threshold(self, fn):
        def recorded(policy, norms, ctx=None):
            index, mask = fn(policy, norms, ctx)
            self.entries.append(("threshold", "policies", norms.detach().numpy().copy(),
                                 policy.threshold,
                                 (torch.gather(norms, -1, index) > policy.threshold).numpy()))
            return index, mask
        return recorded


def selection_margin(entries):
    """The least relative margin of the selections in ``entries``
    (:class:`SelectionLog`): of a top-k, the gap between the k-th and
    (k+1)-th largest norms over the k-th; of a threshold, the distance of
    each norm from the threshold over the threshold. inf where none
    could flip."""
    import numpy as np

    least = np.inf
    for kind, _, norms, bar, _ in entries:
        norms = norms.reshape(-1, norms.shape[-1]).astype(np.float64)
        if kind == "topk":
            if bar >= norms.shape[-1]:
                continue
            top = -np.sort(-norms, axis=-1)
            kth = top[:, bar - 1]
            gap = (kth - top[:, bar]) / np.maximum(np.abs(kth), 1e-30)
        else:
            gap = np.abs(norms - bar) / max(abs(bar), 1e-30)
        least = min(least, float(gap.min()))
    return least


def tp_eventful_forward(config, flat, views, max_tp, policy, blocks=None):
    """The eventful ViViT (every gate on ``policy``; ``blocks``: attributes
    set on every spatial block) on this rank's data shard of ``views``
    under ``best_dp_tp_mesh(4, max_tp)``, sharded and not: the sharded
    probabilities and counts; the port's own unsharded probabilities in
    its default regime ("auto") and on the unfused path (the one the
    sharded blocks take) with its counts; the selections of the unfused
    and the sharded runs (:class:`SelectionLog`) and their least margin."""
    from eventful_transformer_tpu_torch.parallel.sharding import shard_params

    mesh, model = _tp_model(config, flat, max_tp)
    ranks = _ranks(mesh)
    dp = dist.get_world_size(mesh.get_group("data"))
    n = views.shape[0] // dp
    mine = torch.from_numpy(views[ranks["data"] * n:][:n])

    def build(fused=None):
        built = _set_policy(params_from_jax(FactorizedViViT(**config, device="cpu"), flat), policy)
        for block in built.spatial_model.backbone.blocks:
            for key, value in dict(blocks or {}, **({} if fused is None
                                                     else {"fused_gates": fused})).items():
                setattr(block, key, value)
        return built

    def run(built):
        ctx = Ctx(count_mode=True)
        with SelectionLog() as log, torch.no_grad():
            probs = built.apply_views(ctx, mine)
        return probs.numpy(), dict(ctx.counts), log.entries

    auto, _, _ = run(build())
    unfused, unfused_counts, want = run(build(fused=False))
    model = build()
    shard_params(mesh, model)
    probs, counts, got = run(model)
    return dict(ranks, probs=probs, counts=counts, auto=auto, unfused=unfused,
                unfused_counts=unfused_counts, selections=[(e[1], e[4]) for e in got],
                want_selections=[(e[1], e[4]) for e in want], margin=selection_margin(want))


def _backbone(config, flat, k):
    backbone = params_from_jax(ViTBackbone(**config), flat)
    if k is not None:
        _set_policy(backbone, ("top_k", k))
    return backbone


def _state_numpy(state):
    if isinstance(state, dict):
        return {key: _state_numpy(v) for key, v in state.items()}
    return state.numpy() if isinstance(state, torch.Tensor) else state


def pipeline(config, flat, k, frames):
    """``make_pipelined_backbone`` over every rank ("pipe"): the outputs and
    every block's state, on this rank."""
    from eventful_transformer_tpu_torch.parallel.pipeline import make_pipelined_backbone

    backbone = _backbone(config, flat, k)
    mesh = make_mesh((-1,), ("pipe",), "cpu")
    run = make_pipelined_backbone(backbone, mesh)
    frames = torch.from_numpy(frames)
    out, state = run(backbone.init_state(frames.shape[1], torch.float32, "cpu"), frames)
    return out.numpy(), _state_numpy(state)


def pipeline_refused(cases):
    """``make_pipelined_backbone`` of each (config, flat, k): the
    ValueError's message, or None where it was taken."""
    from eventful_transformer_tpu_torch.parallel.pipeline import make_pipelined_backbone

    mesh = make_mesh((-1,), ("pipe",), "cpu")
    messages = []
    for config in cases:
        try:
            make_pipelined_backbone(ViTBackbone(**config), mesh)
            messages.append(None)
        except ValueError as error:
            messages.append(str(error))
    return messages


def joined(address, world_size):
    """``initialize_distributed`` at ``address`` as this process's rank (of
    the spawn), then a sum over the group; the group is left for the
    spawn to destroy."""
    from eventful_transformer_tpu_torch.parallel.mesh import initialize_distributed

    rank = int(os.environ["RANK"])
    made = initialize_distributed(address, world_size, rank, device="cpu")
    x = torch.tensor([float(rank + 1)])
    dist.all_reduce(x)
    return made, dist.get_rank(), dist.get_world_size(), dist.get_backend(), float(x[0])


def outcome(failing_rank, how, wait=0.5):
    """This rank's number after ``wait`` seconds; rank ``failing_rank``
    fails first: ``how`` "raise" raises a ValueError, a signal's name
    ("SIGKILL", "SIGSEGV") ends it with that signal. The checks of
    ``mesh.spawn``'s report (tests/test_torch_spawn.py)."""
    rank = int(os.environ["RANK"])
    if rank == failing_rank:
        if how == "raise":
            raise ValueError(f"planted failure on rank {rank}")
        os.kill(os.getpid(), getattr(signal, how))
    time.sleep(wait)
    return rank


JOBS = dict(ulysses=ulysses, sp_backbone=sp_backbone, vitdet_sp=vitdet_sp,
            vitdet_sp_refused=vitdet_sp_refused, vitdet_dp=vitdet_dp, vivit_dp=vivit_dp,
            entry=entry, tp_forward=tp_forward, tp_train=tp_train, tp_refused=tp_refused,
            tp_eventful_forward=tp_eventful_forward,
            pipeline=pipeline, pipeline_refused=pipeline_refused)


def run_jobs(jobs, store_dir):
    """Each job ``(name, *arguments)`` of ``jobs`` on a process group of its
    own (an entry point makes and destroys its own); one result a job."""
    results = []
    for i, (name, *args) in enumerate(jobs):
        os.environ[INIT_METHOD_ENV] = f"file://{store_dir}/store_{i}"
        if name == "entry":
            results.append(JOBS[name](*args))
            continue
        with distributed("cpu"):
            results.append(JOBS[name](*args))
    return results
