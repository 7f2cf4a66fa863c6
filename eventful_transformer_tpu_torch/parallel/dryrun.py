"""The multi-process dry run (counterpart of the JAX package's
``__graft_entry__.py::dryrun_multichip``): every parallel path of the port
once, at tiny shapes, on seed weights and generated inputs.

    torchrun --standalone --nproc_per_node=N -m eventful_transformer_tpu_torch.parallel.dryrun --devices N
    python -m eventful_transformer_tpu_torch.parallel.dryrun --devices N --device cpu

On N processes, one a GPU (or N gloo ranks on the CPU, which
``--device cpu`` spawns itself):

1. one data-parallel x tensor-parallel train step of a tiny ViViT (dropout
   and drop-path on) on ``best_dp_tp_mesh(N, max_tp=4)``: a finite loss;
2. a tiny eventful stack (``EventfulTokenwiseBlock``, top-k 6) pipelined
   over min(4, N) stages, one block a stage, over 3 frames: finite outputs;
3. Ulysses sequence parallelism through a 2-block backbone over min(4, N)
   ranks: finite tokens;
4. data-parallel evaluation of a tiny eventful ViTDet over min(2, N)
   ranks, one 2-frame video a rank: a finite mAP.

On the card the world size must be N and every rank needs its GPU: fewer
GPUs than N is an error, never a quiet run on the CPU. The JAX package's
fall back to a virtual CPU mesh has no counterpart.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.parallel.mesh import (
    best_dp_tp_mesh,
    distributed,
    prefix_mesh,
    spawn,
)

TRAIN_MODEL = dict(
    classes=16,
    input_shape=[8, 3, 32, 32],
    normalize_mean=0.45,
    normalize_std=0.225,
    spatial_views=1,
    temporal_stride=2,
    temporal_views=2,
    tubelet_shape=[2, 8, 8],
    dropout_rate=0.1,
    spatial_config=dict(
        depth=2,
        position_encoding_size=[4, 4],
        block_config=dict(dim=32, heads=4, mlp_ratio=4, drop_path_rate=0.1),
    ),
    temporal_config=dict(
        depth=1,
        position_encoding_size=[4],
        block_config=dict(dim=32, heads=4, mlp_ratio=4),
    ),
)
DETECTOR = dict(
    classes=5,
    input_shape=[3, 64, 64],
    normalize_mean=[123.675, 116.28, 103.53],
    normalize_std=[58.395, 57.12, 57.375],
    output_channels=32,
    patch_size=[16, 16],
    scale_factors=[4.0, 2.0, 1.0, 0.5],
    backbone_config=dict(
        depth=2,
        position_encoding_size=[4, 4],
        window_indices=[0],
        block_class="EventfulTokenwiseBlock",
        windowed_class="EventfulTokenwiseBlock",
        block_config=dict(dim=32, heads=4, mlp_ratio=2, window_size=[2, 2]),
    ),
    rpn_config=dict(pre_nms_topk=64, post_nms_topk=16),
    roi_config=dict(test_topk_per_image=8),
)
TOP_K = 6


def _seeded(module, seed, device):
    """``module`` with every parameter drawn from ``seed`` on the CPU, as
    the models' constructors draw them, then moved to ``device``."""
    generator = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
    return module.to(device)


def _finite(name, x):
    if not torch.isfinite(torch.as_tensor(x)).all():
        raise AssertionError(f"dry run: {name} is not finite")


def train_step(device):
    """Path 1: one dp x tp step; returns (dp, tp, the loss)."""
    from eventful_transformer_tpu_torch.models import FactorizedViViT
    from eventful_transformer_tpu_torch.parallel.train import make_sharded_train_step

    mesh = best_dp_tp_mesh(max_tp=4, device=device.type)
    dp = dist.get_world_size(mesh.get_group("data"))
    tp = dist.get_world_size(mesh.get_group("model"))
    model = FactorizedViViT(**TRAIN_MODEL, device=device, seed=0)
    optimizer = {"optimizer": "AdamW", "optimizer_kwargs": {"lr": 1e-4}}
    init_fn, make_step = make_sharded_train_step(model, optimizer, mesh)
    step = make_step(*init_fn())
    rng = np.random.default_rng(0)
    batch = {
        "inputs": torch.from_numpy(rng.standard_normal((2 * dp, 2, 8, 3, 32, 32))
                                   .astype(np.float32)),
        "labels": torch.from_numpy(rng.integers(0, 16, (2 * dp,))),
    }
    loss = float(step(batch, 1))
    _finite("the train step's loss", loss)
    return dp, tp, loss


def pipeline(device, n_pipe):
    """Path 2 on the ranks of the pipe axis; None on the others."""
    from eventful_transformer_tpu_torch.core.backbones import ViTBackbone
    from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
    from eventful_transformer_tpu_torch.parallel.pipeline import make_pipelined_backbone
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    mesh = prefix_mesh(n_pipe, "pipe", device.type)
    if mesh is None:
        return None
    backbone = ViTBackbone(
        block_config=dict(dim=32, heads=4, mlp_ratio=2), depth=n_pipe,
        position_encoding_size=[4, 4], input_size=(4, 4), block_class="EventfulTokenwiseBlock",
    )
    set_policies(_seeded(backbone, 2, device), TokenNormTopK, k=TOP_K)
    frames = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 2, 16, 32))
                              .astype(np.float32)).to(device)
    run = make_pipelined_backbone(backbone, mesh, axis="pipe")
    outputs, _ = run(backbone.init_state(2, torch.float32, device), frames)
    _finite("the pipeline's outputs", outputs)
    return tuple(outputs.shape)


def sequence_parallel(device, n_seq):
    """Path 3 on the ranks of the seq axis; None on the others."""
    from eventful_transformer_tpu_torch.core.backbones import ViTBackbone
    from eventful_transformer_tpu_torch.parallel.sequence import gather_tokens, shard_tokens

    mesh = prefix_mesh(n_seq, "seq", device.type)
    if mesh is None:
        return None
    group = mesh.get_group("seq")
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    backbone = _seeded(ViTBackbone(
        block_config=dict(dim=32, heads=4, mlp_ratio=2, sequence_parallel="seq"), depth=2,
        position_encoding_size=[4, 8], input_size=(4, 8),
    ), 3, device)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 32, 32))
                         .astype(np.float32)).to(device)
    aux = shard_tokens(backbone.precompute(), rank, size)
    with torch.no_grad():
        y, _ = backbone(Ctx(groups={"seq": group}), backbone.init_state(2, torch.float32, device),
                        shard_tokens(x, rank, size), aux=aux)
    y = gather_tokens(y, group)
    _finite("the sequence-parallel tokens", y)
    return tuple(y.shape)


def dp_evaluation(device, n_dp):
    """Path 4 on the ranks of the data axis; None on the others."""
    from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
    from eventful_transformer_tpu_torch.models import ViTDet
    from eventful_transformer_tpu_torch.parallel.evaluate import evaluate_vitdet_metrics_dp
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    mesh = prefix_mesh(n_dp, "data", device.type)
    if mesh is None:
        return None
    model = ViTDet(**DETECTOR, device=device, seed=4)
    set_policies(model, TokenNormTopK, k=TOP_K)
    rng = np.random.default_rng(3)
    videos = []
    for _ in range(n_dp):
        base = rng.integers(0, 255, (3, 56, 60)).astype(np.float32)
        ann = {"boxes": np.asarray([[4.0, 4.0, 40.0, 40.0]], np.float32),
               "labels": np.asarray([1], np.int32)}
        videos.append([(np.clip(base + rng.normal(0, 4, base.shape), 0, 255) / 255.0, ann)
                       for _ in range(2)])
    result = evaluate_vitdet_metrics_dp(model, videos, {"n_items": n_dp}, mesh)
    _finite("the mAP", result["metrics"]["map"])
    return result["metrics"]["map"]


def dryrun_here(device):
    """The four paths on this process's rank of the default group (made
    here where there is none) on ``device``; the same dict on every rank
    that ran each path."""
    with distributed(device):
        on = torch.device(device)
        if on.type == "cuda":
            on = torch.device("cuda", torch.cuda.current_device())
        n = dist.get_world_size()
        dp, tp, loss = train_step(on)
        return dict(
            world_size=n, backend=dist.get_backend(), dp=dp, tp=tp, loss=loss,
            pipeline=pipeline(on, min(4, n)), sequence=sequence_parallel(on, min(4, n)),
            map=dp_evaluation(on, min(2, n)),
        )


def dryrun_multichip(n_devices, device="cuda"):
    """The dry run over ``n_devices`` processes: on the card, this rank of
    a world of ``n_devices`` (torchrun's, or this process alone where
    ``n_devices`` is 1); on the CPU, ``n_devices`` spawned gloo ranks.
    Returns the first rank's summary; raises where a path fails, where the
    host has fewer GPUs than ``n_devices``, or where the world size is not
    ``n_devices``."""
    if torch.device(device).type == "cpu":
        return spawn(dryrun_here, n_devices, args=("cpu",), threads=1)[0]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) on the card needs {n_devices} GPUs, "
                           f"this host has {have}")
    world = dist.get_world_size() if dist.is_initialized() else int(os.environ.get("WORLD_SIZE",
                                                                                      1))
    if world != n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) runs in a world of {n_devices} "
                           f"processes, one a GPU (torchrun --nproc_per_node={n_devices}), "
                           f"not {world}")
    return dryrun_here("cuda")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--devices", type=int, required=True, help="processes, one a GPU")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    result = dryrun_multichip(args.devices, args.device)
    if int(os.environ.get("RANK", 0)) == 0:
        print(result, flush=True)
    return result


if __name__ == "__main__":
    main()
