"""The rank functions of tests/test_torch_parallel.py, run in processes that
``eventful_transformer_tpu_torch.parallel.mesh.spawn`` starts. This module
imports nothing of JAX, so a rank starts in about a second. Each rank runs a
list of jobs ``(name, *arguments)``, every job on a process group of its own
(a FileStore in ``store_dir``), and returns one result a job."""

import contextlib
import io
import os

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


def smoke_rank(out, frames, items):
    """``chip_smoke.parallel_rank`` on a gloo rank at slim widths, the
    card's calls replaced as the script's CPU rehearsals replace them (the
    plain versions count no launch, so the launch checks are the card's)."""
    import chip_smoke
    from eventful_transformer_tpu_torch.ops import _build
    from eventful_transformer_tpu_torch.parallel import mesh
    from eventful_transformer_tpu_torch.scripts.evaluate import vivit_kinetics400

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


JOBS = dict(ulysses=ulysses, sp_backbone=sp_backbone, vitdet_sp=vitdet_sp,
            vitdet_sp_refused=vitdet_sp_refused, vitdet_dp=vitdet_dp, vivit_dp=vivit_dp,
            entry=entry)


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
