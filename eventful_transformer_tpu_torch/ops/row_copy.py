"""Launch plans of the two bulk row-copy kernels: row 18's blend
(``csrc/scatter_blend.cu``) and row 20's gather (``gather_rows_kernel`` in
``csrc/scatter.cu``).

Both kernels move rows between device memory and a ring of stages in
shared memory with the bulk copy engine and do (almost) no arithmetic, so
they are bound by bytes and, at the paths' few megabytes, by how many
bytes are in flight at once. A plan sets how much one copy moves, how many
copies a block keeps in flight and how many blocks the grid has, so that
the grid fills the card's SMs where the work allows it and each stage fits
shared memory. Plain Python, so that the CPU tests hold every plan: the
kernels refuse a plan outside their limits, and take the one given.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

SMS = 132  # an H100 SXM's SMs, as gemm_core.SMS
SM_SHARED_BYTES = 233472  # shared memory of one SM (228 KB)
BLOCK_RESERVED_BYTES = 1024  # the part of it the card keeps for each block
MAX_SHARED_BYTES = 232448  # the most one block may take (227 KB)
SM_THREADS = 2048
SM_BLOCKS = 32
MAX_STAGES = 8  # csrc/async_copy.cuh kRowCopyMaxStages
COPY_ALIGN = 16  # a bulk copy moves 16-byte words between 16-byte boundaries

BLEND_THREADS = 256  # csrc/scatter_blend.cu kBlendThreads
BLEND_MAX_ROWS = 256  # kBlendMaxRows
BLEND_TILE_BYTES = 16384  # a tile: the most rows within this many bytes, one row at least
BLEND_TILES_PER_SM = 2  # ... and few enough that the tiles number this many an SM
BLEND_RING_BYTES = 32768  # a block's ring: this many bytes at least, in 2 stages at least
BLEND_STATIC_BYTES = 2 * 4 * BLEND_MAX_ROWS + 8 * MAX_STAGES  # marks and barriers

GATHER_THREADS = 32  # csrc/scatter.cu kGatherThreads
GATHER_MAX_SLOTS = 32  # kGatherMaxSlots: one lane of warp 0 a slot
GATHER_GROUP_BYTES = 32768  # a group: the most slots' rows within this many bytes
GATHER_GROUPS_PER_SM = 2  # ... and about this many groups an SM, where the slots allow it
IN_FLIGHT_BYTES = 32768  # what a block's ring should hold, in 2 stages at least
GATHER_STATIC_BYTES = 12 * MAX_STAGES  # barriers and valid-slot masks


class BlendPlan(NamedTuple):
    """``rows`` rows a tile, ``tiles`` tiles a batch row, ``grid`` blocks a
    batch row, each walking tiles blockIdx.x, + grid, ... through a ring
    of ``stages`` tiles; ``smem`` its dynamic shared memory; ``bulk``
    whether the tiles are whole 16-byte words (x and out on 16-byte
    boundaries besides), else the threads copy them."""

    rows: int
    tiles: int
    grid: int
    stages: int
    smem: int
    bulk: bool


class GatherPlan(NamedTuple):
    """``per`` slots a group, ``groups`` groups in all, ``grid`` blocks,
    each walking groups blockIdx.x, + grid, ... through a ring of
    ``stages`` groups; ``smem`` its dynamic shared memory."""

    per: int
    groups: int
    grid: int
    stages: int
    smem: int


def blocks_per_sm(smem, static, threads):
    """Blocks of ``threads`` threads and ``smem`` + ``static`` bytes of
    shared memory that fit one SM."""
    return max(1, min(SM_SHARED_BYTES // (smem + static + BLOCK_RESERVED_BYTES),
                      SM_THREADS // threads, SM_BLOCKS))


@functools.lru_cache(maxsize=256)
def blend_plan(c, itemsize, bsz, n):
    """The plan of a blend of x (bsz, n, c) with elements of ``itemsize``
    bytes: tiles of up to BLEND_TILE_BYTES, small enough that there are
    BLEND_TILES_PER_SM tiles for every SM where the rows allow it (a block
    spends a few microseconds on a tile beyond its bytes: its marks, the
    wait for its value rows, the barriers, the store); enough blocks a batch row that the
    grid fills every SM with as many blocks as fit it (or one block a
    tile); a ring of
    enough tiles to hold BLEND_RING_BYTES, no more than a block walks, 2 at
    least."""
    row = c * itemsize
    rows = max(1, min(n, BLEND_MAX_ROWS, BLEND_TILE_BYTES // row,
                      bsz * n // (BLEND_TILES_PER_SM * SMS)))
    tiles = -(-n // rows)
    stages = max(2, min(MAX_STAGES, -(-BLEND_RING_BYTES // (rows * row))))
    while True:  # fewer stages, more blocks an SM, fewer tiles a block: until none changes
        per_sm = blocks_per_sm(stages * rows * row, BLEND_STATIC_BYTES, BLEND_THREADS)
        grid = max(1, min(tiles, -(-SMS * per_sm // bsz)))
        fewer = max(2, min(stages, -(-tiles // grid)))
        if fewer == stages:
            break
        stages = fewer
    return BlendPlan(rows, tiles, grid, stages, stages * rows * row, row % COPY_ALIGN == 0)


@functools.lru_cache(maxsize=256)
def gather_plan(c, itemsize, bsz, k):
    """The plan of a gather of bsz x k rows of c elements of ``itemsize``
    bytes (a whole number of 16-byte words): groups of slots, the number
    nearest GATHER_GROUPS_PER_SM groups an SM (more groups hold more
    copies in flight, fewer make fewer stores), within GATHER_GROUP_BYTES
    and a warp's lanes; a persistent grid of
    min(groups, SMs x blocks an SM); a ring of enough groups to hold
    IN_FLIGHT_BYTES, no more than a block walks, 2 at least. None for no
    slots."""
    row, slots = c * itemsize, bsz * k
    if slots == 0:
        return None
    per = max(1, min(GATHER_MAX_SLOTS, GATHER_GROUP_BYTES // row,
                      (slots + GATHER_GROUPS_PER_SM * SMS // 2) // (GATHER_GROUPS_PER_SM * SMS)))
    groups = -(-slots // per)
    stages = max(2, min(MAX_STAGES, -(-IN_FLIGHT_BYTES // (per * row))))
    while True:  # as blend_plan's
        per_sm = blocks_per_sm(stages * per * row, GATHER_STATIC_BYTES, GATHER_THREADS)
        grid = min(groups, SMS * per_sm)
        fewer = max(2, min(stages, -(-groups // grid)))
        if fewer == stages:
            break
        stages = fewer
    return GatherPlan(per, groups, grid, stages, stages * per * row)
