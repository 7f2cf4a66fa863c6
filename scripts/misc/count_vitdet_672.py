#!/usr/bin/env python3
"""Counted FLOPs of the ViTDet-B backbone at 672 x 672 or 1024 x 1024 per
block and stream, from the JAX package on the CPU: the constants
``chip_smoke.py`` holds the PyTorch port's counts to.

    python scripts/misc/count_vitdet_672.py [--size {672,1024}] [--config NAME] [--k K]

Runs one block of each kind at full width (N = 42 x 42 = 1764 tokens at
672, 64 x 64 = 4096 at 1024; C = 768, 12 heads, batch 1) for a flush frame
and incremental frames, in one configuration of configs/evaluate/vitdet_vid/
(k = 256 unless ``--k``; the JAX package's "v2" regime at 672, its
"blocked" regime at 1024) and base_<size>.yml:

- spatiotemporal (the default): spatiotemporal_<size>.yml, windowed
  EventfulTokenwiseBlocks, global EventfulBlocks with k/v pool 2 and the
  bfloat16 A.V cast;
- compare_ln: compare_ln_1024.yml and its twin at 672, EventfulTokenwiseBlock
  in every block with ``gate_before_ln``;
- stgt: stgt_<size>.yml, EventfulTokenwiseBlock with STGT gates (unfused);
- ablate_av: ablate_av_<size>.yml, global EventfulMatmul1Blocks with the
  cast.

Counts are shapes times the valid share of each selection, so one block
per kind gives the whole backbone: 8 windowed and 4 global blocks plus the
position encoding's add. One term depends on the data: a global
EventfulBlock's pooled index dedupe leaves a share f of its k slots valid,
and its incremental count is A + B f. Two designed frames (the k changed
tokens in k distinct 2 x 2 pool cells, f = 1; or filling k / 4 cells, f =
1/4) give A and B; without pooling B is 0. One term is counted once per
forward, whatever the batch: the pad rows' qkv bias of a padded windowed
block (JAX ``_partition_windows_resident``), 3C a frame at 1024 and 0 at 672;
running the windowed blocks at batch 2 as well gives it as
``windowed_once_per_forward``, the same in every windowed block and frame.
Prints one JSON object of per-stream FLOPs (batch 1). At 1024 a global block's (12, 4096, 4096) float32 logits
take a few GB of host memory.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from eventful_transformer_tpu.core import blocks  # noqa: E402
from eventful_transformer_tpu.core.counting import Counts, Ctx  # noqa: E402
from eventful_transformer_tpu.core.gating import TokenGate  # noqa: E402
from eventful_transformer_tpu.core.policies import TokenNormTopK  # noqa: E402

C = 768
# the JAX package's TPU regime at each size (core/blocks.py:843-875)
REGIMES = {672: "v2", 1024: "blocked"}
# per configuration: the global blocks' class and options, and the options
# of every eventful block
CONFIGS = {
    "spatiotemporal": ("EventfulBlock", dict(pool_size=2, matmul_2_cast="bfloat16"), {}),
    "compare_ln": ("EventfulTokenwiseBlock", {}, dict(gate_before_ln=True)),
    "stgt": ("EventfulTokenwiseBlock", {}, dict(stgt=True)),
    "ablate_av": ("EventfulMatmul1Block", dict(matmul_2_cast="bfloat16"), {}),
}


def total(counts):
    return float(sum(v for key, v in Counts.from_device(counts).items() if key != "policy_saturated"))


def frame_counts(blk, frames, modes, regime, k):
    blk.fused_window_attention = blk.fused_dense_mlp = True
    if hasattr(blk, "qkv_gate"):
        blk.fused_gates = regime
        for gate in blk.modules_of_type(TokenGate):
            gate.policy = TokenNormTopK(k=k)
    params = blk.init(jax.random.PRNGKey(0))
    aux = blk.precompute(params)
    state = blk.init_state(*frames[0].shape[:2])
    out = []
    for x, mode in zip(frames, modes):
        ctx = Ctx(count_mode=True)
        _, state = blk.apply(ctx, params, state, jnp.asarray(x), aux, mode=mode)
        out.append(total(ctx.counts))
    return out


def changed(base, rows):
    x = base.copy()
    x[0, rows] += 3.0 * np.random.default_rng(1).standard_normal((len(rows), C)).astype(np.float32)
    return x


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument("--size", type=int, choices=sorted(REGIMES), default=672)
    parser.add_argument("--config", choices=sorted(CONFIGS), default="spatiotemporal")
    parser.add_argument("--k", type=int, default=256)
    args = parser.parse_args()
    k, hw, regime = args.k, args.size // 16, REGIMES[args.size]
    global_class, global_options, options = CONFIGS[args.config]
    global_class = getattr(blocks, global_class)
    n = hw * hw
    block = dict(dim=C, heads=12, mlp_ratio=4, input_size=(hw, hw),
                 relative_embedding_size=[64, 64])
    base = np.random.default_rng(0).standard_normal((1, n, C)).astype(np.float32)
    cells = [(2 * cy, 2 * cx) for cy in range(hw // 2) for cx in range(hw // 2)]
    spread = [y * hw + x for y, x in cells[:k]]  # one token in each of k cells: f = 1
    packed = [(y + dy) * hw + x + dx for y, x in cells[: k // 4] for dy in (0, 1) for dx in (0, 1)]
    windowed = dict(block, window_size=[14, 14])
    global_ = dict(block, **global_options, **options)
    steps = ["flush", "incremental"]
    w = frame_counts(blocks.EventfulTokenwiseBlock(**windowed, **options),
                     [base, changed(base, spread)], steps, regime, k)
    g_spread = frame_counts(global_class(**global_), [base, changed(base, spread)], steps,
                            regime, k)
    g_packed = frame_counts(global_class(**global_), [base, changed(base, packed)], steps,
                            regime, k)
    per_frac = (g_spread[1] - g_packed[1]) / 0.75
    dense_w = frame_counts(blocks.Block(**windowed), [base], [None], regime, k)[0]
    # the windowed blocks again at batch 2: what twice batch 1 overcounts
    two = np.concatenate([base, base])
    w2 = frame_counts(blocks.EventfulTokenwiseBlock(**windowed, **options),
                      [two, changed(two, spread)], steps, regime, k)
    dense_w2 = frame_counts(blocks.Block(**windowed), [two], [None], regime, k)[0]
    once = {2 * a - b for a, b in zip(w + [dense_w], w2 + [dense_w2])}
    if len(once) != 1:
        raise AssertionError(f"windowed terms counted once per forward differ: {once}")
    result = dict(
        config=args.config, size=args.size, k=k, position_add=float(n * C),
        dense_windowed=dense_w,
        dense_global=frame_counts(blocks.Block(**block), [base], [None], regime, k)[0],
        windowed_flush=w[0], windowed_incremental=w[1],
        global_flush=g_spread[0], global_incremental_base=g_spread[1] - per_frac,
        global_incremental_per_valid_share=per_frac, windowed_once_per_forward=once.pop(),
    )
    print(json.dumps(result))


if __name__ == "__main__":
    main()
