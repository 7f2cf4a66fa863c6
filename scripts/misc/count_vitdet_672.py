#!/usr/bin/env python3
"""Counted FLOPs of the ViTDet-B backbone at 672 x 672 or 1024 x 1024 per
block and stream, from the JAX package on the CPU: the constants
``chip_smoke.py`` holds the PyTorch port's counts to.

    python scripts/misc/count_vitdet_672.py [--size {672,1024}]

Runs one block of each kind at full width (N = 42 x 42 = 1764 tokens at
672, 64 x 64 = 4096 at 1024; C = 768, 12 heads, batch 1) for a flush frame
and incremental frames, in the configuration of
configs/evaluate/vitdet_vid/spatiotemporal_<size>.yml (k = 256; the JAX
package's "v2" regime at 672, its "blocked" regime at 1024) and
base_<size>.yml. Counts are shapes times the valid share of each
selection, so one block per kind gives the whole backbone: 8 windowed and
4 global blocks plus the position encoding's add. One term depends on the
data: a global EventfulBlock's pooled index dedupe leaves a share f of its
k slots valid, and its incremental count is A + B f. Two designed frames
(the k changed tokens in k distinct 2 x 2 pool cells, f = 1; or filling
k / 4 cells, f = 1/4) give A and B. Prints one JSON object of per-stream
FLOPs. At 1024 the dense global block's (12, 4096, 4096) float32 logits
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

C, K = 768, 256
# the JAX package's TPU regime at each size (core/blocks.py:843-875)
REGIMES = {672: "v2", 1024: "blocked"}


def total(counts):
    return float(sum(v for key, v in Counts.from_device(counts).items() if key != "policy_saturated"))


def frame_counts(blk, frames, modes, regime):
    blk.fused_window_attention = blk.fused_dense_mlp = True
    if hasattr(blk, "qkv_gate"):
        blk.fused_gates = regime
        for gate in blk.modules_of_type(TokenGate):
            gate.policy = TokenNormTopK(k=K)
    params = blk.init(jax.random.PRNGKey(0))
    aux = blk.precompute(params)
    state = blk.init_state(1, frames[0].shape[1])
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
    size = parser.parse_args().size
    hw, regime = size // 16, REGIMES[size]
    n = hw * hw
    block = dict(dim=C, heads=12, mlp_ratio=4, input_size=(hw, hw),
                 relative_embedding_size=[64, 64])
    base = np.random.default_rng(0).standard_normal((1, n, C)).astype(np.float32)
    cells = [(2 * cy, 2 * cx) for cy in range(hw // 2) for cx in range(hw // 2)]
    spread = [y * hw + x for y, x in cells[:K]]  # one token in each of k cells: f = 1
    packed = [(y + dy) * hw + x + dx for y, x in cells[: K // 4] for dy in (0, 1) for dx in (0, 1)]
    windowed = dict(block, window_size=[14, 14])
    global_ = dict(block, pool_size=2, matmul_2_cast="bfloat16")
    steps = ["flush", "incremental"]
    w = frame_counts(blocks.EventfulTokenwiseBlock(**windowed), [base, changed(base, spread)],
                     steps, regime)
    g_spread = frame_counts(blocks.EventfulBlock(**global_), [base, changed(base, spread)],
                            steps, regime)
    g_packed = frame_counts(blocks.EventfulBlock(**global_), [base, changed(base, packed)],
                            steps, regime)
    per_frac = (g_spread[1] - g_packed[1]) / 0.75
    result = dict(
        position_add=float(n * C),
        dense_windowed=frame_counts(blocks.Block(**windowed), [base], [None], regime)[0],
        dense_global=frame_counts(blocks.Block(**block), [base], [None], regime)[0],
        windowed_flush=w[0], windowed_incremental=w[1],
        global_flush=g_spread[0], global_incremental_base=g_spread[1] - per_frac,
        global_incremental_per_valid_share=per_frac,
    )
    print(json.dumps(result))


if __name__ == "__main__":
    main()
