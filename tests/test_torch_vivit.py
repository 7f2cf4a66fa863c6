"""The slice as a whole: a small FactorizedViViT, eventful and its dense
twin, through ``apply_views`` in the port and in the JAX package, on the
same weights and views.

The JAX model runs the configuration the port implements, the TPU's: every
EventfulTokenwiseBlock on its "v4" kernel pipeline, every block's attention
through the global-mode window_attention kernel and the dense blocks' MLP
through dense_mlp_residual (Pallas in interpret mode), the frame loop split
into a flush and incremental steps, and the block stack unrolled so that
kernel C hands each next block its qkv-gate norms. Class probabilities at rtol/atol 1e-4 (float32, summation order
differs across four steps and two sub-models); every count key equal at
rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.core.blocks import Block as JaxBlock
from eventful_transformer_tpu.core.blocks import EventfulBlock as JaxAVBlock
from eventful_transformer_tpu.core.blocks import EventfulTokenwiseBlock as JaxEventfulBlock
from eventful_transformer_tpu.core.counting import Counts, Ctx as JaxCtx
from eventful_transformer_tpu.core.policies import TokenNormTopK as JaxTopK
from eventful_transformer_tpu.models import FactorizedViViT as JaxViViT
from eventful_transformer_tpu.utils.misc import set_policies as jax_set_policies
from eventful_transformer_tpu.utils.params import fill_like
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
from eventful_transformer_tpu_torch.models import FactorizedViViT
from eventful_transformer_tpu_torch.utils.misc import set_policies
from eventful_transformer_tpu_torch.utils.params import flatten_tree, params_from_jax

K = 8  # of N = 17 tokens (4 x 4 patches + the class token)


def _config(eventful):
    return dict(
        classes=10, input_shape=[8, 3, 32, 32], normalize_mean=0.45, normalize_std=0.225,
        spatial_views=1, temporal_stride=2, temporal_views=2, tubelet_shape=[2, 8, 8],
        spatial_config=dict(
            depth=2, position_encoding_size=[4, 4],
            block_class="EventfulTokenwiseBlock" if eventful else "Block",
            block_config=dict(dim=64, heads=4, mlp_ratio=4),
        ),
        temporal_config=dict(
            depth=1, position_encoding_size=[4],
            block_config=dict(dim=64, heads=4, mlp_ratio=4),
        ),
    )


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("eventful", [True, False], ids=["eventful", "dense"])
def test_vivit_matches_jax(eventful, monkeypatch):
    monkeypatch.setenv("EVT_UNROLL_BLOCKS", "1")
    jax_model = JaxViViT(**_config(eventful))
    jax_model.split_flush = True
    for blk in jax_model.modules_of_type(JaxBlock):
        blk.fused_dense_mlp = blk.fused_global_attention = True
    model = FactorizedViViT(**_config(eventful), device="cpu")
    if eventful:
        jax_set_policies(jax_model, JaxTopK, k=K)
        for blk in jax_model.modules_of_type(JaxEventfulBlock):
            blk.fused_gates = "v4"
            assert blk._fused_mode(17) == "v4"
        set_policies(model, TokenNormTopK, k=K)
    like = jax_model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    flat = {
        k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
        for k, v in flatten_tree(jax.tree_util.tree_map(np.asarray, like)).items()
    }
    params_from_jax(model, flat)
    views = rng.standard_normal((2, 2, 8, 3, 32, 32)).astype(np.float32)

    jax_ctx = JaxCtx(count_mode=True)
    ref = jax_model.apply_views(jax_ctx, fill_like(like, flat), jnp.asarray(views))
    ctx = Ctx(count_mode=True)
    with torch.no_grad():
        got = model.apply_views(ctx, torch.from_numpy(views))
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    ref_counts = Counts.from_device(jax_ctx.counts)
    assert set(ctx.counts) == set(ref_counts)
    for key in ref_counts:
        np.testing.assert_allclose(ctx.counts[key], ref_counts[key], rtol=1e-6, err_msg=key)
    if eventful:
        assert ctx.counts["gate_flops"] > 0


def test_eventful_handoff_feeds_next_block(monkeypatch):
    """In an incremental step only the first eventful block computes its
    qkv-gate norms with ln_norms; kernel C of each block emits the next
    block's."""
    from eventful_transformer_tpu_torch.core import blocks

    calls = {"ln_norms": 0, "emitted": []}
    ln_norms, gate_group_mlp = blocks.ln_norms, blocks.gate_group_mlp

    def ln_norms_spy(*args):
        calls["ln_norms"] += 1
        return ln_norms(*args)

    def gate_group_mlp_spy(*args, **kwargs):
        out = gate_group_mlp(*args, **kwargs)
        calls["emitted"].append(out[3] is not None)
        return out

    monkeypatch.setattr(blocks, "ln_norms", ln_norms_spy)
    monkeypatch.setattr(blocks, "gate_group_mlp", gate_group_mlp_spy)
    model = FactorizedViViT(**_config(True), device="cpu")
    set_policies(model, TokenNormTopK, k=K)
    views = np.random.default_rng(6).standard_normal((1, 2, 8, 3, 32, 32))
    with torch.no_grad():
        model.apply_views(Ctx(), torch.from_numpy(views.astype(np.float32)))
    steps = 3  # 4 tubelet steps per view, the first a flush
    assert calls["ln_norms"] == steps
    assert calls["emitted"] == [True, False] * steps


def test_vivit_defaults_to_the_card():
    """Without ``device`` the parameters go to the card; without a card
    that raises instead of falling back to the CPU."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FactorizedViViT(**_config(True))
        return
    assert FactorizedViViT(**_config(True)).classifier.kernel.device.type == "cuda"


def _apply_config(cast):
    """The paper's K400 configuration in small: EventfulBlock in every
    spatial block (the matmul-2 cast as configs/evaluate/vivit_kinetics400/
    _temporal.yml sets it, or off), 3 spatial x 2 temporal views."""
    config = _config(True)
    config.update(spatial_views=3, temporal_views=2)
    config["spatial_config"] = dict(
        config["spatial_config"], block_class="EventfulBlock",
        block_config=dict(dim=64, heads=4, mlp_ratio=4, matmul_2_cast=cast),
    )
    return config


@pytest.mark.parametrize("cast", [None, "bfloat16"], ids=["f32", "cast_bf16"])
def test_vivit_apply_matches_jax(cast, monkeypatch):
    """``FactorizedViViT.apply`` on a raw uint8 video whose short edge (40)
    is not the model's (32), so the antialiased resize runs, against the
    JAX ``apply``. The port's "auto" gives every EventfulBlock the "v2mlp"
    regime (N = 17); the JAX model runs it forced, its gate_group_mlp
    kernel and the dense blocks' kernels in interpret mode. Probabilities
    at 1e-4, 1e-2 with the cast (its A.V product in bfloat16); counts
    at rtol 1e-6."""
    monkeypatch.setenv("EVT_UNROLL_BLOCKS", "1")
    jax_model = JaxViViT(**_apply_config(cast))
    jax_model.split_flush = True
    for blk in jax_model.modules_of_type(JaxBlock):
        blk.fused_dense_mlp = blk.fused_global_attention = True
    for blk in jax_model.modules_of_type(JaxAVBlock):
        blk.fused_gates = "v2mlp"
    model = FactorizedViViT(**_apply_config(cast), device="cpu")
    jax_set_policies(jax_model, JaxTopK, k=K)
    set_policies(model, TokenNormTopK, k=K)
    assert all(blk._fused_mode(17) == "v2mlp" for blk in model.spatial_model.backbone.blocks)
    like = jax_model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    flat = {
        k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
        for k, v in flatten_tree(jax.tree_util.tree_map(np.asarray, like)).items()
    }
    params_from_jax(model, flat)
    video = rng.integers(0, 256, (1, 20, 3, 40, 56), dtype=np.uint8)
    jax_ctx, ctx = JaxCtx(count_mode=True), Ctx(count_mode=True)
    ref = jax_model.apply(jax_ctx, fill_like(like, flat), video)
    got = model.apply(ctx, torch.from_numpy(video))
    assert got.shape == (1, 10) and model.n_views == 6
    tol = 1e-4 if cast is None else 1e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=tol, atol=tol)
    ref_counts = Counts.from_device(jax_ctx.counts)
    assert set(ctx.counts) == set(ref_counts)
    for key in ref_counts:
        np.testing.assert_allclose(ctx.counts[key], ref_counts[key], rtol=1e-6, err_msg=key)
    assert ctx.counts["accumulator_flops"] > 0
