#!/usr/bin/env python3
"""Counted GFLOPs per clip of the paper's eventful ViViT-B Kinetics-400
configuration and its dense twin, from the JAX package on the CPU: the
numbers ``chip_smoke.py`` holds the PyTorch port's counts to.

    python scripts/misc/count_vivit.py [--k 24] [--bench] [--gate-before-ln]
    python scripts/misc/count_vivit.py --epic --ats 0.9 --fraction 0.5

The configuration: configs/models/vivit_b_kinetics400.yml (3 spatial x 4
temporal = 12 views of 32 frames at stride 2, 224 x 224), with
configs/evaluate/vivit_kinetics400/_temporal.yml (EventfulBlock in every
spatial block, the A.V product cast to bfloat16) and TokenNormTopK(k) on
every gate (temporal_24.yml: k = 24); the dense twin is base.yml (Block
everywhere). ``--bench``: the bench's configuration instead (bench.py:
373-422: EventfulTokenwiseBlock in every spatial block, no cast, 4
temporal views of one spatial view; give ``--k 98``). ``--gate-before-ln``:
every eventful block's gates before their LN. ``--epic``: the
EPIC-Kitchens ViViT-B instead (configs/models/vivit_b_epic_kitchens.yml:
32 frames at stride 1, 320 x 320, 97 classes, 12 views); ``--ats F``:
ATS with fraction F in every spatial block of both models
(configs/evaluate/vivit_epic_kitchens/_ats.yml: the dense twin is then
ats.yml's vanilla model); ``--fraction F``: TokenNormTopFraction(F) on
every gate instead of the top k (temporal_ats_200.yml: 0.5). With a
mask-free top-k
policy every count is a shape times k / N, the same for every view and any
data, so one random view (batch 1) runs at full width and depth, and its
count is scaled by the views. The JAX package runs its unfused CPU path
(``fused_gates = False``), which counts key for key as its TPU regime,
"v2mlp" (or "v4"). Prints one JSON object.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from eventful_transformer_tpu.core.blocks import EventfulTokenwiseBlock  # noqa: E402
from eventful_transformer_tpu.core.counting import Counts, Ctx  # noqa: E402
from eventful_transformer_tpu.core.gating import TokenGate  # noqa: E402
from eventful_transformer_tpu.core.policies import (  # noqa: E402
    TokenNormTopFraction,
    TokenNormTopK,
)
from eventful_transformer_tpu.models import FactorizedViViT  # noqa: E402

FRAMES = 32


def config(eventful, bench, gate_before_ln, epic=False, ats=None):
    block = dict(dim=768, heads=12, mlp_ratio=4)
    spatial, block_class = dict(block), "Block"
    if eventful:
        spatial = dict(block, gate_before_ln=gate_before_ln)
        block_class = "EventfulTokenwiseBlock" if bench else "EventfulBlock"
        if not bench:
            spatial["matmul_2_cast"] = "bfloat16"
    if ats is not None:
        spatial["ats_fraction"] = ats
    size, stride, grid, classes = (320, 1, 20, 97) if epic else (224, 2, 14, 400)
    return dict(
        classes=classes, input_shape=[FRAMES, 3, size, size], normalize_mean=0.45,
        normalize_std=0.225, spatial_views=1, temporal_stride=stride, temporal_views=1,
        tubelet_shape=[2, 16, 16],
        spatial_config=dict(depth=12, position_encoding_size=[grid, grid],
                            block_class=block_class, block_config=spatial),
        temporal_config=dict(depth=4, position_encoding_size=[16], block_config=block),
    )


def gflops_per_clip(eventful, k, bench=False, gate_before_ln=False, epic=False, ats=None,
                    fraction=None):
    views = 4 if bench else 12  # temporal_views 4 (x spatial_views 3)
    cfg = config(eventful, bench, gate_before_ln, epic, ats)
    model = FactorizedViViT(**cfg)
    if eventful:
        for gate in model.modules_of_type(TokenGate):
            gate.policy = TokenNormTopK(k=k) if fraction is None else TokenNormTopFraction(fraction)
        for blk in model.modules_of_type(EventfulTokenwiseBlock):
            blk.fused_gates = False
    params = model.init(jax.random.PRNGKey(0))
    view = np.random.default_rng(0).standard_normal((1, 1, *cfg["input_shape"]))
    ctx = Ctx(count_mode=True)
    model.apply_views(ctx, params, jnp.asarray(view, jnp.float32))
    counts = Counts.from_device(ctx.counts)
    return views * sum(v for key, v in counts.items() if key != "policy_saturated") / 1e9


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument("--k", type=int, default=24)
    parser.add_argument("--bench", action="store_true")
    parser.add_argument("--gate-before-ln", action="store_true")
    parser.add_argument("--epic", action="store_true")
    parser.add_argument("--ats", type=float, default=None)
    parser.add_argument("--fraction", type=float, default=None)
    args = parser.parse_args()
    shape = dict(epic=args.epic, ats=args.ats)
    print(json.dumps(dict(
        k=args.k, views=4 if args.bench else 12, bench=args.bench,
        gate_before_ln=args.gate_before_ln, fraction=args.fraction, **shape,
        gflops_per_clip_dense=gflops_per_clip(False, args.k, args.bench, **shape),
        gflops_per_clip_eventful=gflops_per_clip(True, args.k, args.bench, args.gate_before_ln,
                                                 fraction=args.fraction, **shape),
    )))


if __name__ == "__main__":
    main()
