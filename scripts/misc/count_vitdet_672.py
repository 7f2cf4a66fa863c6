#!/usr/bin/env python3
"""Counted FLOPs of the ViTDet-B backbone at 672 x 672 per block and stream,
from the JAX package on the CPU: the constants ``chip_smoke.py`` holds the
PyTorch port's counts to.

    python scripts/misc/count_vitdet_672.py

Runs one block of each kind at full width (N = 42 x 42 = 1764 tokens,
C = 768, 12 heads, batch 1) for a flush frame and incremental frames, in
the configuration of configs/evaluate/vitdet_vid/spatiotemporal_672.yml
(k = 256, the JAX package's "v2" regime) and base_672.yml. Counts are
shapes times the valid share of each selection, so one block per kind
gives the whole backbone: 8 windowed and 4 global blocks plus the position
encoding's add. One term depends on the data: a global EventfulBlock's
pooled index dedupe leaves a share f of its k slots valid, and its
incremental count is A + B f. Two designed frames (the k changed tokens in
k distinct 2 x 2 pool cells, f = 1; or filling k / 4 cells, f = 1/4) give A
and B. Prints one JSON object of per-stream FLOPs.
"""

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

HW, C, K = 42, 768, 256
N = HW * HW
BLOCK = dict(dim=C, heads=12, mlp_ratio=4, input_size=(HW, HW), relative_embedding_size=[64, 64])


def total(counts):
    return float(sum(v for key, v in Counts.from_device(counts).items() if key != "policy_saturated"))


def frame_counts(blk, frames, modes):
    blk.fused_window_attention = blk.fused_dense_mlp = True
    if hasattr(blk, "qkv_gate"):
        blk.fused_gates = "v2"
        for gate in blk.modules_of_type(TokenGate):
            gate.policy = TokenNormTopK(k=K)
    params = blk.init(jax.random.PRNGKey(0))
    aux = blk.precompute(params)
    state = blk.init_state(1, N)
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
    base = np.random.default_rng(0).standard_normal((1, N, C)).astype(np.float32)
    cells = [(2 * cy, 2 * cx) for cy in range(HW // 2) for cx in range(HW // 2)]
    spread = [y * HW + x for y, x in cells[:K]]  # one token in each of k cells: f = 1
    packed = [(y + dy) * HW + x + dx for y, x in cells[: K // 4] for dy in (0, 1) for dx in (0, 1)]
    windowed = dict(BLOCK, window_size=[14, 14])
    global_ = dict(BLOCK, pool_size=2, matmul_2_cast="bfloat16")
    w = frame_counts(blocks.EventfulTokenwiseBlock(**windowed), [base, changed(base, spread)],
                     ["flush", "incremental"])
    g_spread = frame_counts(blocks.EventfulBlock(**global_), [base, changed(base, spread)],
                            ["flush", "incremental"])
    g_packed = frame_counts(blocks.EventfulBlock(**global_), [base, changed(base, packed)],
                            ["flush", "incremental"])
    per_frac = (g_spread[1] - g_packed[1]) / 0.75
    result = dict(
        position_add=float(N * C),
        dense_windowed=frame_counts(blocks.Block(**windowed), [base], [None])[0],
        dense_global=frame_counts(blocks.Block(**BLOCK), [base], [None])[0],
        windowed_flush=w[0], windowed_incremental=w[1],
        global_flush=g_spread[0], global_incremental_base=g_spread[1] - per_frac,
        global_incremental_per_valid_share=per_frac,
    )
    print(json.dumps(result))


if __name__ == "__main__":
    main()
