"""The EPIC-Kitchens shape of ViViT (``configs/models/vivit_b_epic_kitchens.yml``:
``temporal_stride: 1``, the top fraction of the tokens as the policy) in
small, through ``FactorizedViViT.apply`` on a raw uint8 video, in the port
and in the JAX package, on the same weights: ``EventfulBlock`` with the
matmul-2 cast (``configs/evaluate/vivit_epic_kitchens/_temporal.yml``) and
without it, and the tokenwise block, under ``TokenNormTopFraction(0.5)``.

The JAX model runs the configuration the port implements (see
``tests/test_torch_vivit.py``): "v2mlp" on every eventful block (the
port's "auto" under this policy), the dense kernels in interpret mode, the frame
loop split into a flush and incremental steps. Probabilities at 1e-4
(float32 summation order), 1e-2 with the cast (its A.V product in
bfloat16); every count key at rtol 1e-6."""

import jax
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.core.blocks import Block as JaxBlock
from eventful_transformer_tpu.core.blocks import EventfulBlock as JaxAVBlock
from eventful_transformer_tpu.core.blocks import EventfulTokenwiseBlock as JaxTokenwiseBlock
from eventful_transformer_tpu.core.counting import Counts, Ctx as JaxCtx
from eventful_transformer_tpu.core.policies import TokenNormTopFraction as JaxTopFraction
from eventful_transformer_tpu.models import FactorizedViViT as JaxViViT
from eventful_transformer_tpu.utils.misc import set_policies as jax_set_policies
from eventful_transformer_tpu.utils.params import fill_like
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.core.policies import TokenNormTopFraction
from eventful_transformer_tpu_torch.models import FactorizedViViT
from eventful_transformer_tpu_torch.utils.misc import set_policies
from eventful_transformer_tpu_torch.utils.params import flatten_tree, params_from_jax

FRACTION = 0.5
# (spatial block class, matmul_2_cast, the JAX regime the port's "auto" gives)
BLOCKS = {
    "evblock_cast": ("EventfulBlock", "bfloat16", "v2mlp"),
    "evblock": ("EventfulBlock", None, "v2mlp"),
    # "v4" takes exactly TokenNormTopK, so the tokenwise block runs "v2mlp" too
    "tokenwise": ("EventfulTokenwiseBlock", None, "v2mlp"),
}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _config(block_class, cast):
    """vivit_b_epic_kitchens.yml's shape at narrow widths: stride 1 over an
    8-frame clip (4 tubelet steps), 2 spatial x 2 temporal views."""
    block = dict(dim=64, heads=4, mlp_ratio=4)
    if block_class == "EventfulBlock":
        block["matmul_2_cast"] = cast
    return dict(
        classes=7, input_shape=[8, 3, 32, 32], normalize_mean=0.45, normalize_std=0.225,
        spatial_views=2, temporal_stride=1, temporal_views=2, tubelet_shape=[2, 8, 8],
        spatial_config=dict(depth=2, position_encoding_size=[4, 4], block_class=block_class,
                            block_config=block),
        temporal_config=dict(depth=1, position_encoding_size=[4],
                             block_config=dict(dim=64, heads=4, mlp_ratio=4)),
    )


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_epic_kitchens_shape_matches_jax(kind, monkeypatch):
    block_class, cast, regime = BLOCKS[kind]
    monkeypatch.setenv("EVT_UNROLL_BLOCKS", "1")
    jax_model = JaxViViT(**_config(block_class, cast))
    jax_model.split_flush = True
    for blk in jax_model.modules_of_type(JaxBlock):
        blk.fused_dense_mlp = blk.fused_global_attention = True
    for blk in jax_model.modules_of_type((JaxAVBlock, JaxTokenwiseBlock)):
        blk.fused_gates = regime
    model = FactorizedViViT(**_config(block_class, cast), device="cpu")
    jax_set_policies(jax_model, JaxTopFraction, fraction=FRACTION)
    set_policies(model, TokenNormTopFraction, fraction=FRACTION)
    assert all(blk._fused_mode(17) == regime for blk in model.spatial_model.backbone.blocks)
    like = jax_model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    flat = {
        k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
        for k, v in flatten_tree(jax.tree_util.tree_map(np.asarray, like)).items()
    }
    params_from_jax(model, flat)
    video = rng.integers(0, 256, (1, 12, 3, 40, 48), dtype=np.uint8)
    jax_ctx, ctx = JaxCtx(count_mode=True), Ctx(count_mode=True)
    ref = jax_model.apply(jax_ctx, fill_like(like, flat), video)
    with torch.no_grad():
        got = model.apply(ctx, torch.from_numpy(video))
    assert got.shape == (1, 7) and model.n_views == 4
    tol = 1e-4 if cast is None else 1e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=tol, atol=tol)
    ref_counts = Counts.from_device(jax_ctx.counts)
    assert set(ctx.counts) == set(ref_counts)
    for key in ref_counts:
        np.testing.assert_allclose(ctx.counts[key], ref_counts[key], rtol=1e-6, err_msg=key)
    assert ctx.counts["gate_flops"] > 0
