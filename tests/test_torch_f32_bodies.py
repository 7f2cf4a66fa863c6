"""The float32 bodies' plans and rules on the CPU, where no card runs them:
``gemm_core.simt_plan`` (the tile ``csrc/gemm.cuh``'s float32 GEMM takes at
each float32 GEMM shape of the paths: rows 2-5, 7, 12 and 13), its shared
memory within a block's 227 KB, its codes and constants against the C
source, ``plan_args``, and the two rules that send every float32 call (and
row 8's matmul-2 cast) to the CUDA-core bodies: ``gemm_core.gemm_core`` and
``av_softmax.av_softmax_body``."""

import re
from pathlib import Path

import pytest
import torch

from eventful_transformer_tpu_torch.ops import _build, av_softmax, gemm_core

CSRC = Path(_build.CSRC_DIR)

# (M, K, N) of each float32 GEMM the paths give, with the tile it takes:
# 0 the 128 x 128 tile, 1 the 64 x 64 one (PERF.md section 6's rows)
PATH_GEMMS = {
    "4t/5m MLP 1, 12 x 197": ((2364, 768, 3072), 0),
    "4t/5m MLP 2": ((2364, 3072, 768), 0),
    "5a MLP 1, 12 x 361": ((4332, 768, 3072), 0),
    "5a MLP 2": ((4332, 3072, 768), 0),
    "5t MLP 1, 192 x 17": ((3264, 768, 3072), 0),
    "5t MLP 2": ((3264, 3072, 768), 1),
    "5p MLP 1, 1 x 1764": ((1764, 768, 3072), 0),
    "5p MLP 2": ((1764, 3072, 768), 1),
    "4v/4s MLP 1, 12 x 24": ((288, 768, 3072), 1),
    "4v/4s MLP 2": ((288, 3072, 768), 1),
    "4p MLP 1, 1 x 512": ((512, 768, 3072), 1),
    "4p MLP 2": ((512, 3072, 768), 1),
    "5s MLP 1, 12 x 17": ((204, 768, 3072), 1),
    "7p none, 1 x 512": ((512, 768, 768), 1),
    "7p post": ((512, 768, 2304), 1),
    "2 qkv / 12 post, 12 x 197": ((2364, 768, 2304), 0),
    "3 / 12 none / 13, 12 x 197": ((2364, 768, 768), 0),
    "2 qkv, 8 x 197": ((1576, 768, 2304), 0),
}


@pytest.mark.parametrize("shape,tile", PATH_GEMMS.values(), ids=list(PATH_GEMMS))
def test_simt_plan_at_the_path_shapes(shape, tile):
    """The tile each float32 path GEMM gets: the one whose busiest SM
    computes the fewest outputs over the tile's rate (the larger on a tie);
    the tiles cover M and N; shared memory within a block's 227 KB."""
    m, k, n = shape
    plan = gemm_core.simt_plan(m, k, n)
    rows, cols, per_thread, threads = plan.shape
    assert plan.tile == tile
    others = [gemm_core.simt_tile_plan(m, k, n, t) for t in range(len(gemm_core.SIMT_TILES))]
    assert plan.cost == min(other.cost for other in others)
    assert plan.tiles_m * rows >= m > (plan.tiles_m - 1) * rows
    assert plan.tiles_n * cols >= n > (plan.tiles_n - 1) * cols
    assert plan.blocks == plan.tiles_m * plan.tiles_n
    assert threads == (rows // per_thread) * (cols // 8)
    assert plan.smem_bytes <= _build.MAX_SHARED_BYTES
    assert plan.workspace == 0
    assert gemm_core.gemm_launch(torch.float32, m, k, n, True) == ("simt", plan)
    assert gemm_core.gemm_launch(torch.float32, m, k, n, False) == ("simt", plan)


@pytest.mark.parametrize("m,n", [(1, 768), (65, 3), (300, 130), (4096, 4096)])
def test_simt_plan_covers_ragged_shapes(m, n):
    plan = gemm_core.simt_plan(m, 100, n)
    rows, cols = plan.shape[:2]
    assert plan.tiles_m == -(-m // rows) and plan.tiles_n == -(-n // cols)
    assert plan.smem_bytes <= _build.MAX_SHARED_BYTES


def test_simt_tiles_match_the_c_source():
    """SIMT_TILES by code, its K step and ring against csrc/gemm.cuh: the
    tile codes' launches and the constants; the 128 x 128 tile needs more
    than the 48 KB a block has without the attribute, and both tiles fit
    the blocks an SM their 128 registers a thread allow."""
    src = (CSRC / "gemm.cuh").read_text()
    assert re.search(r"kSimtBK = (\d+), kSimtStages = (\d+)", src).groups() == (
        str(gemm_core.SIMT_K_STEP), str(gemm_core.SIMT_STAGES))
    codes = re.search(r"kSimtTileLarge = (\d+), kSimtTileSmall = (\d+)", src).groups()
    assert codes == ("0", "1")
    launched = re.findall(
        r"case kSimtTile(\w+):\s*return launch_gemm_simt_tile<(\d+), (\d+), (\d+)>", src)
    by_code = {0 if name == "Large" else 1: tuple(map(int, shape)) for name, *shape in launched}
    assert by_code == {code: tile[:3] for code, tile in enumerate(gemm_core.SIMT_TILES)}
    large, small = (gemm_core.simt_tile_plan(128, 768, 128, t) for t in (0, 1))
    assert large.smem_bytes > 48 * 1024
    assert 2 * large.smem_bytes <= 228 * 1024 and 4 * small.smem_bytes <= 228 * 1024


def test_plan_args_carry_each_cores_code():
    """The C entries' plan codes: the split on "tc", the tile on "simt", 1
    on "wmma"; the workspace pointer last."""
    simt = gemm_core.simt_plan(288, 3072, 768)
    tc = gemm_core.gemm_plan(288, 3072, 768)
    assert gemm_core.plan_args([simt, tc, None], None) == (simt.tile, tc.split, 1, None)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("shape", [s for s, _ in PATH_GEMMS.values()] + [(197, 700, 3000)])
def test_float32_gemms_take_the_simt_core(shape, aligned):
    assert gemm_core.gemm_core(torch.float32, *shape, aligned) == "simt"
    core, plan1, plan2 = gemm_core.mlp_launch(torch.float32, shape[0], 768, 3072, aligned)
    assert core == "simt" and isinstance(plan1, gemm_core.SimtPlan)
    assert (plan1, plan2) == (gemm_core.simt_plan(shape[0], 768, 3072),
                              gemm_core.simt_plan(shape[0], 3072, 768))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("d", [16, 48, 64, 128])
@pytest.mark.parametrize("sdtype", [torch.float32, torch.bfloat16], ids=["f32", "cast"])
def test_row8_float32_and_the_cast_take_the_cuda_core_body(sdtype, d, aligned):
    assert av_softmax.av_softmax_body(torch.float32, sdtype, d, aligned) == "simt"
