"""Slim ViTDet backbones with every gate before its LayerNorm, the
LN-placement ablation (configs/evaluate/vitdet_vid/compare_ln_1024.yml:
``EventfulTokenwiseBlock`` in every block, ``gate_before_ln: true``) at the
token counts of 1024 x 1024 frames (N = 4096, the port's "auto" gives
"blocked") and of 672 x 672 frames (N = 1764, "v2"), against the JAX
package through ``pre_backbone`` and ``apply_backbone``: 2 streams over a
flush and 2 incremental frames, outputs each frame, then every count key
and every state leaf.

The JAX reference at 4096 is its unfused CPU path with buffered groups
(``fused_gates = False``, ``recompute_buffers = False``, whose outputs and
counts equal its blocked path's); at 1764 its "v2" regime, forced, with the
Pallas kernels in interpret mode. Widths are cut (dim 64, 2 heads, depth 4,
blocks 0 and 2 windowed with 14 x 14 windows); k = 256. Tolerance 1e-4
for the backbone over several frames, as in tests/test_torch_blocked.py;
counts at rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.core.counting import Counts, Ctx as JaxCtx
from eventful_transformer_tpu.core.policies import TokenNormTopK as JaxTopK
from eventful_transformer_tpu.models.vitdet import ViTDet as JaxViTDet
from eventful_transformer_tpu.utils.misc import set_policies as jax_set_policies
from eventful_transformer_tpu.utils.params import fill_like
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
from eventful_transformer_tpu_torch.models import ViTDet
from eventful_transformer_tpu_torch.utils.misc import set_policies
from eventful_transformer_tpu_torch.utils.params import flatten_tree, params_from_jax

TOL_MODEL = 1e-4


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def slim_config(size, **block_options):
    """ViTDet at ``size`` x ``size`` frames, EventfulTokenwiseBlock in every
    block with ``block_options``, widths and depth cut."""
    block = dict(dim=64, heads=2, mlp_ratio=2, window_size=[14, 14],
                 relative_embedding_size=[64, 64], **block_options)
    backbone = dict(depth=4, position_encoding_size=[14, 14], window_indices=[0, 2],
                    block_class="EventfulTokenwiseBlock", block_config=block)
    return dict(
        backbone_config=backbone, classes=5, input_shape=[3, size, size],
        normalize_mean=[123.675, 116.28, 103.53], normalize_std=[58.395, 57.12, 57.375],
        output_channels=16, patch_size=[16, 16], scale_factors=[1.0],
    )


def run_pair(jax_model, model, size, seed):
    """Both models, the same perturbed weights, 2 streams x 3 frames: each
    frame's output, the counts and every state leaf compared (a
    window-major qkv buffer under the window permutation)."""
    flat = flatten_tree(jax.tree_util.tree_map(np.asarray, jax_model.init(jax.random.PRNGKey(0))))
    rng = np.random.default_rng(seed)
    flat = {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in flat.items()}
    params = fill_like(jax_model.init(jax.random.PRNGKey(0)), flat)
    params_from_jax(model, flat)
    n = (size // 16) ** 2
    base = rng.uniform(size=(2, 3, size, size)).astype(np.float32)
    frames = [np.clip(base + 0.1 * rng.standard_normal(base.shape), 0, 1).astype(np.float32)
              for _ in range(3)]
    jax_ctx, ctx = JaxCtx(count_mode=True), Ctx(count_mode=True)
    jax_state, state = jax_model.init_state(2), model.init_state(2)
    aux, port_aux = jax_model.precompute(params), model.precompute()
    with torch.no_grad():
        for t, frame in enumerate(frames):
            mode = "flush" if t == 0 else "incremental"
            tokens_ref = jax_model.pre_backbone(jax_ctx, params, jnp.asarray(frame))
            out_ref, jax_state = jax_model.apply_backbone(
                jax_ctx, params, jax_state, tokens_ref, aux, mode=mode
            )
            tokens = model.pre_backbone(ctx, torch.from_numpy(frame))
            out, state = model.apply_backbone(ctx, state, tokens, port_aux, mode=mode)
            assert out.shape == (2, n, 64)
            np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), rtol=TOL_MODEL,
                                       atol=TOL_MODEL)
    ref_counts = Counts.from_device(jax_ctx.counts)
    assert set(ctx.counts) == set(ref_counts)
    for key in ref_counts:
        np.testing.assert_allclose(ctx.counts[key], ref_counts[key], rtol=1e-6, err_msg=key)
    for blk, jax_s, s in zip(model.backbone.blocks, jax_state["blocks"], state["blocks"]):
        jax_s.pop("first")
        assert set(s) == set(jax_s)
        for group, leaves in jax_s.items():
            for name, ref in leaves.items():
                ref, got = np.asarray(ref), s[group][name]
                if got.shape != ref.shape:  # the port's window-major qkv buffer
                    perm, _ = blk._window_perm()
                    valid = perm < n
                    got, ref = got[:, torch.from_numpy(np.nonzero(valid)[0])], ref[:, perm[valid]]
                np.testing.assert_allclose(got.numpy(), ref, rtol=TOL_MODEL, atol=TOL_MODEL)


def test_slim_compare_ln_n4096_is_blocked_and_matches_jax(monkeypatch):
    monkeypatch.setenv("EVT_UNROLL_BLOCKS", "1")
    config = slim_config(1024, gate_before_ln=True)
    jax_model, model = JaxViTDet(**config), ViTDet(**config, device="cpu")
    jax_set_policies(jax_model, JaxTopK, k=256)
    set_policies(model, TokenNormTopK, k=256)
    for jax_blk, blk in zip(jax_model.backbone.blocks, model.backbone.blocks):
        jax_blk.fused_gates = False
        jax_blk.recompute_buffers = False
        assert blk.gate_before_ln and blk._fused_mode(4096) == "blocked"
    run_pair(jax_model, model, 1024, seed=40)


def test_slim_compare_ln_n1764_is_v2_and_matches_jax(monkeypatch):
    monkeypatch.setenv("EVT_UNROLL_BLOCKS", "1")
    config = slim_config(672, gate_before_ln=True)
    jax_model, model = JaxViTDet(**config), ViTDet(**config, device="cpu")
    jax_set_policies(jax_model, JaxTopK, k=256)
    set_policies(model, TokenNormTopK, k=256)
    for jax_blk, blk in zip(jax_model.backbone.blocks, model.backbone.blocks):
        jax_blk.fused_gates = "v2"
        assert blk._fused_mode(1764) == "v2"
    run_pair(jax_model, model, 672, seed=41)
