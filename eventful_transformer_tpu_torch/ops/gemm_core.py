"""The GEMM cores of rows 2 (``qkv_attention_group``, kernel A), 3
(``proj_group``, kernel B), 4 (``gate_group_mlp``), 5
(``dense_mlp_residual``), 7 (``gate_group_linear``), 12
(``ln_select_matmul``) and 13 (``select_linear_skip_norms``), the rule that
picks one, and the launch plans.

The cores compute ``out(m, n) = epi(m, n, sum_k A[arow(m), k] W[k, n])``
with float32 sums:

- "tc": ``csrc/gemm_tc.cuh``, bfloat16 only: wgmma fed by TMA, 128 x 128
  output tiles, K steps of 64, a ring of 3 stages, the K steps split over
  blocks where the tiles are fewer than the SMs (:func:`gemm_plan`);
- "simt": ``csrc/gemm.cuh``'s float32 tile on the CUDA cores (W by
  cp.async, A made K-major through registers, two stages), one fmaf chain
  an output in k order (no split of K), in the tile :func:`simt_plan`
  picks;
- "wmma": ``csrc/gemm.cuh``'s 64 x 64 tile of WMMA fragments, the bfloat16
  shapes "tc" refuses.

:func:`gemm_core` is the one rule; the C side refuses what the rule would
not send it, and a refused launch raises. Every float32 call stays on
"simt", so the float32 card-vs-CPU checks keep their meaning. The
wrappers of rows 2-5, 7, 12 and 13 count their launches by core
(``core_launches``).
The TMA descriptors of the "tc" core come from one cache in the library,
whose encodes :func:`tensor_map_encodes` reads.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from eventful_transformer_tpu_torch.ops import _build

CORES = ("tc", "wmma", "simt")
CORE_CODES = {"simt": 0, "wmma": 0, "tc": 1}  # csrc/gemm_tc.cuh kCoreOld, kCoreTc
TILE_M, TILE_N, TILE_K = 128, 128, 64  # csrc/gemm_tc.cuh kGemmTcBM, kGemmTcBN, kGemmTcBK
SMS = 132  # streaming multiprocessors of an H100 SXM
MIN_SPLIT_STEPS = 4  # K steps of 64 each split keeps at least
TMA_MAPS = 4096  # TMA descriptors the library's cache keeps (csrc/gemm_tc.cuh kGemmTcMaps)


def gemm_core(dtype, m, k, n, aligned=True):
    """The core a GEMM of A (m, k) and W (k, n) takes: "tc" for bfloat16
    with k a multiple of 64, n of 128 and every operand on a 16-byte
    boundary (``aligned``: TMA and the 16-byte copies need it); else
    "wmma" in bfloat16 and "simt" in float32."""
    takes = (dtype == torch.bfloat16 and m >= 1 and k >= TILE_K and k % TILE_K == 0
             and n % TILE_N == 0 and n >= TILE_N and aligned)
    if takes:
        return "tc"
    return "wmma" if dtype == torch.bfloat16 else "simt"


class GemmPlan(NamedTuple):
    """The launch of one GEMM on the "tc" core: tiles_m x tiles_n output
    tiles, each in ``split`` blocks of ``steps`` K steps; ``workspace`` the
    float32 elements of the split partials (split x m x n, 0 unsplit)."""

    m: int
    k: int
    n: int
    tiles_m: int
    tiles_n: int
    split: int
    steps: int
    workspace: int

    @property
    def blocks(self):
        return self.tiles_m * self.tiles_n * self.split


@functools.lru_cache(maxsize=256)
def gemm_plan(m, k, n):
    """The plan of a GEMM of A (m, k) and W (k, n) on the "tc" core: where
    the output tiles are fewer than the SMs, the largest split of the K
    steps that divides them into whole steps, keeps at least
    ``MIN_SPLIT_STEPS`` in each and keeps tiles x split within the SMs;
    else no split."""
    tiles_m, tiles_n = -(-m // TILE_M), -(-n // TILE_N)
    tiles = tiles_m * tiles_n
    steps = -(-k // TILE_K)
    split = 1
    if tiles < SMS:
        for s in range(steps, 1, -1):
            if steps % s == 0 and steps // s >= MIN_SPLIT_STEPS and tiles * s <= SMS:
                split = s
                break
    return GemmPlan(m, k, n, tiles_m, tiles_n, split, steps // split,
                    split * m * n if split > 1 else 0)


# The float32 tiles of csrc/gemm.cuh by code (kSimtTileLarge,
# kSimtTileSmall): (rows, columns, rows a thread; threads), each thread 8
# columns; and the relative rate of each tile's loop, which simt_plan
# weighs them by (fitted to ``scripts/misc/time_attention_bodies.py --f32
# --simt-tiles`` on an H100: at equal waves the 64 x 64 tile runs at 0.85 to
# 1.0 of the 128 x 128 tile's rate)
SIMT_TILES = ((128, 128, 8, 256), (64, 64, 4, 128))
SIMT_TILE_RATE = (1.0, 0.85)
SIMT_K_STEP, SIMT_STAGES = 32, 2  # csrc/gemm.cuh kSimtBK, kSimtStages


class SimtPlan(NamedTuple):
    """The launch of one float32 GEMM on the "simt" core: tile ``tile`` of
    SIMT_TILES, tiles_m x tiles_n blocks of it."""

    m: int
    k: int
    n: int
    tile: int
    tiles_m: int
    tiles_n: int

    @property
    def blocks(self):
        return self.tiles_m * self.tiles_n

    @property
    def shape(self):
        """(rows, columns, rows a thread, threads) of the tile."""
        return SIMT_TILES[self.tile]

    @property
    def smem_bytes(self):
        """The block's shared memory: the ring of A's and W's K steps and
        the tile's row offsets."""
        rows, cols = SIMT_TILES[self.tile][:2]
        return SIMT_STAGES * SIMT_K_STEP * (rows + cols) * 4 + rows * 8

    @property
    def cost(self):
        """The outputs the busiest SM computes (the blocks spread evenly
        over the SMs, a tile's outputs over its rate)."""
        rows, cols = SIMT_TILES[self.tile][:2]
        return -(-self.blocks // SMS) * rows * cols / SIMT_TILE_RATE[self.tile]

    workspace = 0  # no split of K


def simt_tile_plan(m, k, n, tile):
    """The plan of a float32 GEMM of A (m, k) and W (k, n) on tile ``tile``."""
    rows, cols = SIMT_TILES[tile][:2]
    return SimtPlan(m, k, n, tile, -(-m // rows), -(-n // cols))


@functools.lru_cache(maxsize=256)
def simt_plan(m, k, n):
    """The plan of a float32 GEMM of A (m, k) and W (k, n): the tile of the
    least :attr:`SimtPlan.cost`, the larger tile on a tie."""
    return min((simt_tile_plan(m, k, n, tile) for tile in range(len(SIMT_TILES))),
               key=lambda plan: plan.cost)


def _plan(core, m, k, n):
    """The plan of one GEMM on ``core``: None on "wmma"."""
    return gemm_plan(m, k, n) if core == "tc" else simt_plan(m, k, n) if core == "simt" else None


@functools.lru_cache(maxsize=256)
def gemm_launch(dtype, m, k, n, aligned):
    """(core, plan) of one GEMM of A (m, k) and W (k, n): a
    :class:`GemmPlan` on "tc", a :class:`SimtPlan` on "simt", None on
    "wmma"."""
    core = gemm_core(dtype, m, k, n, aligned)
    return core, _plan(core, m, k, n)


@functools.lru_cache(maxsize=256)
def mlp_launch(dtype, m, c, hidden, aligned):
    """(core, plan of GEMM1 (m, c) x (c, hidden), plan of GEMM2 (m, hidden)
    x (hidden, c)): both GEMMs of an MLP take one core, "tc" only where
    both shapes take it; the plans as :func:`gemm_launch`'s."""
    core = gemm_core(dtype, m, c, hidden, aligned)
    if core == "tc" and gemm_core(dtype, m, hidden, c, aligned) != "tc":
        core = "wmma"
    return core, _plan(core, m, c, hidden), _plan(core, m, hidden, c)


def workspace(plans, device):
    """The float32 workspace the larger split of ``plans`` needs, or None."""
    size = max((p.workspace for p in plans if p is not None), default=0)
    return torch.empty(size, dtype=torch.float32, device=device) if size else None


def plan_args(plans, ws):
    """The C entries' plan arguments (csrc/gemm_tc.cuh ``GemmCall``): each
    plan's code, its split of the K steps on "tc", its tile on "simt", 1 on
    "wmma", and the workspace pointer."""
    codes = (1 if p is None else p.tile if isinstance(p, SimtPlan) else p.split for p in plans)
    return (*codes, None if ws is None else ws.data_ptr())


def gemm_split_plain(a, w, split=1):
    """sum_k a[:, k] w[k, :] in float32 as the "tc" core sums a plan of
    ``split``: one float32 partial per split of the K steps, added in split
    order (a plain emulation; the epilogue follows the full sum)."""
    if a.shape[-1] % split:
        raise ValueError(f"a split of {split} does not divide K={a.shape[-1]}")
    a, w = a.float(), w.float()
    chunk = a.shape[-1] // split
    out = torch.matmul(a[..., :chunk], w[:chunk])
    for s in range(1, split):
        out = out + torch.matmul(a[..., s * chunk:(s + 1) * chunk], w[s * chunk:(s + 1) * chunk])
    return out


def tensor_map_encodes():
    """The TMA descriptors the library has encoded since it was loaded (its
    cache's misses); builds and loads the library."""
    return int(_build.load_library().etk_tensor_map_encodes())


def new_core_counts():
    """A wrapper's launches by core, all 0."""
    return dict.fromkeys(CORES, 0)


def gemm_tc(a, w, rows=None, split=None):
    """float32 (M, N) = a[rows] @ w on the "tc" core alone, no epilogue (its
    tests' entry): ``a`` (R, K) and ``w`` (K, N) bfloat16, ``rows`` None (M =
    R) or int32 (M,) row indices, -1 a zero row; ``split`` the split of the
    K steps, :func:`gemm_plan`'s by default. CPU tensors take
    :func:`gemm_split_plain`. Raises where :func:`gemm_core` would not send
    the call to "tc"."""
    m = a.shape[0] if rows is None else rows.shape[0]
    k, n = w.shape
    if split is None:
        split = gemm_plan(m, k, n).split
    if a.device.type == "cpu":
        picked = a if rows is None else torch.where(
            (rows >= 0)[:, None], a[rows.long().clamp(min=0)], torch.zeros((), dtype=a.dtype))
        return gemm_split_plain(picked, w, split)
    name = "gemm_tc"
    _build.check_operands(name, a, w=w)
    if rows is not None:
        if rows.dtype != torch.int32 or rows.device != a.device or not rows.is_contiguous():
            raise ValueError(f"{name}: rows must be contiguous int32 on {a.device}")
    if a.shape[-1] != k:
        raise ValueError(f"{name}: a has K={a.shape[-1]}, w has K={k}")
    if gemm_core(a.dtype, m, k, n, _build.aligned16(a, w)) != "tc":
        raise ValueError(f"{name}: a (R, {k}) x w ({k}, {n}) in {a.dtype} is not the tc core's")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    ws = torch.empty(split * m * n, dtype=torch.float32, device=a.device) if split > 1 else None
    _build.launch(
        "etk_gemm_tc", a.data_ptr(), None if rows is None else rows.data_ptr(), w.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(), a.shape[0], m, k, n, split,
        _build.stream_of(a),
    )
    gemm_tc.launches += 1
    return out


gemm_tc.launches = 0


def gemm_simt(a, w, rows=None, tile=None):
    """float32 (M, N) = a[rows] @ w on the "simt" core alone, no epilogue
    (its tests' entry): ``a`` (R, K) and ``w`` (K, N) float32, ``rows``
    None (M = R) or int32 (M,) row indices, -1 a zero row; ``tile`` the
    tile of SIMT_TILES, :func:`simt_plan`'s by default. CPU tensors take
    the float32 product of the gathered rows."""
    m = a.shape[0] if rows is None else rows.shape[0]
    k, n = w.shape
    if a.device.type == "cpu":
        picked = a if rows is None else torch.where(
            (rows >= 0)[:, None], a[rows.long().clamp(min=0)], torch.zeros((), dtype=a.dtype))
        return torch.matmul(picked.float(), w.float())
    name = "gemm_simt"
    _build.check_operands(name, a, w=w)
    if a.dtype != torch.float32:
        raise ValueError(f"{name}: the float32 core takes float32, not {a.dtype}")
    if rows is not None:
        if rows.dtype != torch.int32 or rows.device != a.device or not rows.is_contiguous():
            raise ValueError(f"{name}: rows must be contiguous int32 on {a.device}")
    if a.shape[-1] != k:
        raise ValueError(f"{name}: a has K={a.shape[-1]}, w has K={k}")
    if tile is None:
        tile = simt_plan(m, k, n).tile
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    _build.launch(
        "etk_gemm_simt", a.data_ptr(), None if rows is None else rows.data_ptr(), w.data_ptr(),
        out.data_ptr(), m, k, n, tile, _build.stream_of(a),
    )
    gemm_simt.launches += 1
    return out


gemm_simt.launches = 0
