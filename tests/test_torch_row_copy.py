"""The launch plans of the bulk row-copy kernels (``ops/row_copy.py``):
row 18's blend (``blend_plan``) and row 20's gather (``gather_plan``).

Plain Python on the CPU, as ``gemm_core.gemm_plan`` is tested: each plan is
walked as its kernel walks it (``csrc/scatter_blend.cu``,
``csrc/scatter.cu::gather_rows_kernel``), at every path shape and at edge
shapes (C in {128, 768, 2304, 3072, 8192}, float32 and bfloat16, B from 1
to 12, N from 1 to 60000, k from 0 to N), and checked:

- a block's shared memory, the ring and its barriers, fits the 232,448
  bytes one block may take;
- every bulk copy, load and store, moves a multiple of 16 bytes from and
  to 16-byte boundaries (the tensors' own start on one, as the kernels
  check);
- every row (the blend) or slot (the gather) is copied exactly once;
- the grid has at least 132 blocks wherever the work has that many units
  (tiles, slots); the gather's persistent grid fits the card at once, the
  blend's one wave of the blocks that fit it (one block a tile where the
  tiles are fewer);
- a block's ring holds at least 32 KB, or all the bytes the block moves;
- the plans' limits are the kernels' constants.
"""

import re
from collections import Counter
from pathlib import Path

import pytest

from eventful_transformer_tpu_torch.ops import row_copy

CSRC = Path(row_copy.__file__).resolve().parent.parent / "csrc"
WIDTHS = [128, 768, 2304, 3072, 8192]
ITEMSIZES = {"f32": 4, "bf16": 2}
# (B, N): stgt_672's buffers, ViViT's blend (2 clips x 4 views), the paper's
# ViViT (12 views), 1024's tokens, and edges
BATCHES = [(2, 1764), (8, 197), (12, 197), (2, 4096), (1, 1), (2, 24), (3, 300), (1, 60000)]
# (B, N, k): the gather's path shapes (stgt_672, the paper's ViViT) and edges
SLOTS = [(2, 1764, 256), (12, 197, 24), (2, 300, 0), (2, 300, 1), (2, 300, 24), (2, 300, 256),
         (2, 300, 300), (1, 4096, 4096)]


def _fits_the_card(grid_blocks, smem, static, threads):
    per_sm = row_copy.blocks_per_sm(smem, static, threads)
    return grid_blocks <= row_copy.SMS * per_sm


@pytest.mark.parametrize("bsz,n", BATCHES, ids=lambda v: str(v))
@pytest.mark.parametrize("itemsize", ITEMSIZES.values(), ids=list(ITEMSIZES))
@pytest.mark.parametrize("c", WIDTHS)
def test_blend_plan_covers_every_row_with_aligned_bulk_copies(c, itemsize, bsz, n):
    plan = row_copy.blend_plan(c, itemsize, bsz, n)
    row = c * itemsize
    tile = plan.rows * row
    assert plan.bulk
    assert 1 <= plan.rows <= row_copy.BLEND_MAX_ROWS <= row_copy.BLEND_THREADS
    assert 2 <= plan.stages <= row_copy.MAX_STAGES
    assert plan.smem == plan.stages * tile
    assert plan.smem + row_copy.BLEND_STATIC_BYTES <= row_copy.MAX_SHARED_BYTES
    assert plan.tiles == -(-n // plan.rows)
    covered = Counter()
    moved = Counter()
    for b in range(bsz):
        for bx in range(plan.grid):
            for i, t in enumerate(range(bx, plan.tiles, plan.grid)):
                n0, stage = t * plan.rows, i % plan.stages
                nr = min(plan.rows, n - n0)
                assert nr >= 1
                for offset in ((b * n + n0) * row, stage * tile):  # device memory, the stage
                    assert offset % row_copy.COPY_ALIGN == 0
                assert (nr * row) % row_copy.COPY_ALIGN == 0
                covered.update((b, r) for r in range(n0, n0 + nr))
                moved[(b, bx)] += nr * row
    assert covered == Counter({(b, r): 1 for b in range(bsz) for r in range(n)})
    blocks = bsz * plan.grid
    assert blocks >= min(row_copy.SMS, bsz * plan.tiles)
    # one wave: the blocks that fit the card (one a tile where the tiles are
    # fewer), rounded up to whole grids of the batch rows
    wave = row_copy.SMS * row_copy.blocks_per_sm(plan.smem, row_copy.BLEND_STATIC_BYTES,
                                                 row_copy.BLEND_THREADS)
    assert min(wave, bsz * plan.tiles) <= blocks < wave + bsz
    for bytes_moved in moved.values():
        assert plan.smem >= min(row_copy.BLEND_RING_BYTES, bytes_moved)


@pytest.mark.parametrize("bsz,n,k", SLOTS, ids=lambda v: str(v))
@pytest.mark.parametrize("itemsize", ITEMSIZES.values(), ids=list(ITEMSIZES))
@pytest.mark.parametrize("c", WIDTHS)
def test_gather_plan_covers_every_slot_with_aligned_bulk_copies(c, itemsize, bsz, n, k):
    plan = row_copy.gather_plan(c, itemsize, bsz, k)
    slots, row = bsz * k, c * itemsize
    if slots == 0:
        assert plan is None  # the wrapper launches nothing
        return
    group = plan.per * row
    assert 1 <= plan.per <= row_copy.GATHER_MAX_SLOTS
    assert 2 <= plan.stages <= row_copy.MAX_STAGES
    assert plan.smem == plan.stages * group
    assert plan.smem + row_copy.GATHER_STATIC_BYTES <= row_copy.MAX_SHARED_BYTES
    assert plan.groups == -(-slots // plan.per)
    covered = Counter()
    moved = Counter()
    for bx in range(plan.grid):
        for i, g in enumerate(range(bx, plan.groups, plan.grid)):
            stage, cnt = i % plan.stages, min(plan.per, slots - g * plan.per)
            assert cnt >= 1
            for lane in range(cnt):  # one load a slot: any source row, into its lane's place
                slot = g * plan.per + lane
                for src in (((slot // k) * n + r) * row for r in (0, n - 1)):
                    assert src % row_copy.COPY_ALIGN == 0
                assert (stage * group + lane * row) % row_copy.COPY_ALIGN == 0
                covered[slot] += 1
            assert (g * group) % row_copy.COPY_ALIGN == 0  # one store of the group
            assert (cnt * row) % row_copy.COPY_ALIGN == 0
            moved[bx] += cnt * row
    assert covered == Counter(range(slots))
    assert plan.grid >= min(row_copy.SMS, slots)
    assert _fits_the_card(plan.grid, plan.smem, row_copy.GATHER_STATIC_BYTES,
                          row_copy.GATHER_THREADS)
    for bytes_moved in moved.values():
        assert plan.smem >= min(row_copy.IN_FLIGHT_BYTES, bytes_moved)


def _constant(source, name):
    match = re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert match, (source, name)
    return int(match.group(1))


@pytest.mark.parametrize("source,name,value", [
    ("async_copy.cuh", "kRowCopyMaxStages", row_copy.MAX_STAGES),
    ("scatter_blend.cu", "kBlendThreads", row_copy.BLEND_THREADS),
    ("scatter_blend.cu", "kBlendMaxRows", row_copy.BLEND_MAX_ROWS),
    ("scatter.cu", "kGatherThreads", row_copy.GATHER_THREADS),
    ("scatter.cu", "kGatherMaxSlots", row_copy.GATHER_MAX_SLOTS),
])
def test_plan_limits_are_the_kernels_constants(source, name, value):
    assert _constant(source, name) == value


def test_plans_at_the_paths():
    """The plans the paths' shapes take, in bfloat16: stgt_672's C- and
    3C-wide buffers (one and two tiles a block), the 4C-wide one (three),
    ViViT's blend (tiles of 5 rows, 320 blocks); the gather at stgt_672's
    3C buffer (2 slots a group) and the paper's ViViT's (one)."""
    blend = {c: row_copy.blend_plan(c, 2, 2, 1764) for c in (768, 2304, 3072)}
    assert blend[768] == row_copy.BlendPlan(10, 177, 177, 2, 30720, True)
    assert blend[2304] == row_copy.BlendPlan(3, 588, 462, 2, 27648, True)
    assert blend[3072] == row_copy.BlendPlan(2, 882, 330, 3, 36864, True)
    assert row_copy.blend_plan(768, 2, 8, 197) == row_copy.BlendPlan(5, 40, 40, 2, 15360, True)
    assert row_copy.gather_plan(2304, 2, 2, 256) == row_copy.GatherPlan(2, 256, 256, 2, 18432)
    assert row_copy.gather_plan(2304, 2, 12, 24) == row_copy.GatherPlan(1, 288, 288, 2, 9216)


@pytest.mark.parametrize("c", [3, 100], ids=lambda c: f"c{c}")
def test_blend_plan_leaves_rows_off_16_byte_words_to_the_threads(c):
    """Rows that are no whole 16-byte words (C = 3, 100 in bfloat16) take no
    bulk copy: the kernel's threads blend them, in the same tiles."""
    plan = row_copy.blend_plan(c, 2, 2, 300)
    assert not plan.bulk
    assert plan.tiles * plan.rows >= 300
