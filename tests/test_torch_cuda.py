"""Each CUDA kernel against its plain PyTorch version on the card, in
float32 and bfloat16, at small shapes and at ragged ones (N not a multiple
of any tile, C = 64 and 256). Marked ``cuda``: skipped where no CUDA device
is present. Run on the card with ``python -m pytest -m cuda
tests/test_torch_cuda.py``. ``chip_smoke.py`` holds the kernels against
the same plain versions at the main path's shapes."""

import copy

import pytest
import torch

from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.ops import kernel_check

pytestmark = pytest.mark.cuda

SHAPES = [(2, 24, 64, 4, 9), (3, 37, 256, 4, 11), (2, 197, 64, 2, 98)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", sorted(set(kernel_check.KERNELS) - {"nms_padded"}))
def test_kernel_matches_plain(name, shape, dtype, device):
    wrapper = kernel_check.KERNELS[name][0]
    before = wrapper.launches
    inputs = kernel_check.make_inputs(*shape, dtype, device, seed=1)
    rows = kernel_check.errors(name, inputs)
    assert [row["output"] for row in rows] == list(kernel_check.KERNELS[name][4])
    assert all(row["ok"] for row in rows), rows
    assert wrapper.launches == before + 1


def test_wrapper_rejects_mixed_dtypes(device):
    d = kernel_check.make_inputs(2, 24, 64, 4, 9, torch.bfloat16, device)
    with pytest.raises(TypeError, match="p is torch.float32"):
        kernel_check.KERNELS["ln_norms"][0](d["x"], d["p_qkv"].float(), d["ln1_s"], d["ln1_b"])


def test_small_vitdet_card_matches_cpu(device):
    """A small eventful ViTDet backbone in the "v2" regime, 2 streams x 3
    frames in float32, on the card (the kernels) against the CPU (the plain
    versions): tokens within 1e-3, every kernel of the path launched."""
    from eventful_transformer_tpu_torch.core.counting import Ctx
    from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
    from eventful_transformer_tpu_torch.models import ViTDet
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    block = dict(dim=64, heads=4, mlp_ratio=2, window_size=[3, 3],
                 relative_embedding_size=[8, 8], pool_size=2)
    model = ViTDet(
        backbone_config=dict(depth=4, position_encoding_size=[4, 4], window_indices=[0, 2],
                             block_class="EventfulBlock", windowed_class="EventfulTokenwiseBlock",
                             windowed_overrides=dict(pool_size=None), block_config=block),
        classes=5, input_shape=[3, 96, 96], normalize_mean=[0.0] * 3, normalize_std=[1.0] * 3,
        output_channels=16, patch_size=[16, 16], scale_factors=[1.0], device="cpu",
    )
    set_policies(model, TokenNormTopK, k=12)
    for blk in model.backbone.blocks:
        blk.fused_gates = "v2"
    card = copy.deepcopy(model).to(device)
    frames = torch.rand((3, 2, 3, 96, 96), generator=torch.Generator().manual_seed(0))
    wrappers = {entry[0].__name__: entry[0] for entry in kernel_check.KERNELS.values()}
    before = {name: fn.launches for name, fn in wrappers.items()}
    outs = []
    for m, x in ((card, frames.to(device)), (model, frames)):
        state = m.init_state(2, torch.float32, x.device)
        with torch.no_grad():
            for t in range(3):
                tokens = m.pre_backbone(Ctx(), x[t])
                tokens, state = m.apply_backbone(
                    Ctx(), state, tokens, mode="flush" if t == 0 else "incremental"
                )
        outs.append(tokens.cpu())
    torch.cuda.synchronize()
    launched = {name for name, fn in wrappers.items() if fn.launches > before[name]}
    assert {"window_attention", "gate_group_linear", "block_select_p", "block_scatter_rows",
            "gate_group_mlp", "ln_norms"} <= launched
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-3, atol=1e-3)


def test_softmax_select_matmul_cast_matches_plain(device):
    """The matmul-2 cast of a float32 model: float32 q, k and terms with
    bfloat16 A.V state, at an awkward N (37) and key grid (3 x 7)."""
    d = kernel_check.make_inputs(2, 37, 64, 4, 9, torch.float32, device, seed=2)
    for key in ("p_a", "p_v"):
        d[key] = d[key].to(torch.bfloat16)
    got = kernel_check.call("softmax_select_matmul", d)
    want = kernel_check.call("softmax_select_matmul", d, plain=True)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert kernel_check.compare(a, b)["ok"], kernel_check.compare(a, b)


@pytest.mark.parametrize("eventful", [True, False], ids=["eventful_blocked", "dense_padded"])
def test_small_vitdet_blocked_card_matches_cpu(eventful, device):
    """A small ViTDet backbone on an 8 x 8 grid with 3 x 3 windows (pad
    rows), eventful in the forced "blocked" regime with the A.V kernel, or
    dense through the padded windowed form; 2 streams x 3 frames in
    float32 on the card against the CPU: tokens within 1e-3, every kernel
    of the path launched."""
    from eventful_transformer_tpu_torch.core.counting import Ctx
    from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
    from eventful_transformer_tpu_torch.models import ViTDet
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    block = dict(dim=64, heads=4, mlp_ratio=2, window_size=[3, 3],
                 relative_embedding_size=[8, 8])
    backbone = dict(depth=4, position_encoding_size=[4, 4], window_indices=[0, 2],
                    block_config=block)
    if eventful:
        block["pool_size"] = 2
        backbone.update(block_class="EventfulBlock", windowed_class="EventfulTokenwiseBlock",
                        windowed_overrides=dict(pool_size=None))
    model = ViTDet(
        backbone_config=backbone, classes=5, input_shape=[3, 128, 128],
        normalize_mean=[0.0] * 3, normalize_std=[1.0] * 3, output_channels=16,
        patch_size=[16, 16], scale_factors=[1.0], device="cpu",
    )
    if eventful:
        set_policies(model, TokenNormTopK, k=12)
        for blk in model.backbone.blocks:
            blk.fused_gates = "blocked"
            if hasattr(blk, "av_kernel"):
                blk.av_kernel = True
    card = copy.deepcopy(model).to(device)
    frames = torch.rand((3, 2, 3, 128, 128), generator=torch.Generator().manual_seed(0))
    wrappers = {entry[0].__name__: entry[0] for entry in kernel_check.KERNELS.values()}
    before = {name: fn.launches for name, fn in wrappers.items()}
    outs = []
    for m, x in ((card, frames.to(device)), (model, frames)):
        state = m.init_state(2, torch.float32, x.device)
        with torch.no_grad():
            for t in range(3):
                tokens = m.pre_backbone(Ctx(), x[t])
                mode = ("flush" if t == 0 else "incremental") if eventful else None
                tokens, state = m.apply_backbone(Ctx(), state, tokens, mode=mode)
        outs.append(tokens.cpu())
    torch.cuda.synchronize()
    launched = {name for name, fn in wrappers.items() if fn.launches > before[name]}
    want = {"window_attention", "dense_mlp_residual"}
    if eventful:
        want = {"window_attention", "block_select_scatter", "softmax_select_matmul",
                "block_select_p", "block_scatter_rows", "ln_norms"}
    assert want <= launched
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("use_kernel", [True, "v2", "auto", False])
@pytest.mark.parametrize("pool", [None, (2, 2)], ids=["dense", "pooled"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_relative_position_kernel_forms_match_cpu(use_kernel, pool, dtype, device):
    """``RelativePositionEmbedding.forward`` with the kernel forms on the
    card (its pooled tables are strided views) against the
    same forms' plain versions on the CPU, within kernel_check's bounds;
    every value but True launches the v2 form."""
    from eventful_transformer_tpu_torch.core.counting import Ctx
    from eventful_transformer_tpu_torch.core.embeddings import RelativePositionEmbedding
    from eventful_transformer_tpu_torch.ops import relpos

    rp = RelativePositionEmbedding((6, 10), (6, 10), 16, pool_size=pool)
    rp.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():  # tables of unit scale, terms of a few units
        rp.y_embedding.mul_(50.0)
        rp.x_embedding.mul_(50.0)
    rp.use_kernel = use_kernel
    p = rp.pooled_size()
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 3, 60, p[0] * p[1]), generator=g).to(dtype)
    q = torch.randn((2, 3, 60, 16), generator=g).to(dtype)
    want = rp(Ctx(), x, q)
    card = copy.deepcopy(rp).to(device)
    wrapper = relpos.relpos_bias_add if use_kernel is True else relpos.relpos_bias_add_v2
    before = wrapper.launches
    with torch.no_grad():  # the tables come from parameters: the grad guard refuses them
        got = card(Ctx(), x.to(device), q.to(device))
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert kernel_check.compare(got.cpu(), want)["ok"], kernel_check.compare(got.cpu(), want)


def test_softmax_select_matmul_logits_cast_matches_plain(device):
    """The logits form with the matmul-2 cast of a float32 model: bfloat16
    logits and A.V state with float32 rel-pos terms, at an awkward N (37)
    and key grid (3 x 7)."""
    d = kernel_check.make_inputs(2, 37, 64, 4, 9, torch.float32, device, seed=3)
    for key in ("p_a", "p_v", "av_logits"):
        d[key] = d[key].to(torch.bfloat16)
    got = kernel_check.call("softmax_select_matmul_logits", d)
    want = kernel_check.call("softmax_select_matmul_logits", d, plain=True)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert kernel_check.compare(a, b)["ok"], kernel_check.compare(a, b)


def test_ln_select_matmul_rejects_other_weight_dtype(device):
    """The GEMM reads p' as stored, which is the TPU kernel's operand only
    where p has W's dtype: any other mix raises."""
    d = kernel_check.make_inputs(2, 24, 64, 4, 9, torch.bfloat16, device)
    with pytest.raises(TypeError, match="w is torch.float32"):
        kernel_check.KERNELS["ln_select_matmul_post"][0](
            d["x"], d["p_qkv"], d["cov1"], d["ln1_s"], d["ln1_b"], d["w_qkv"].float(),
            d["b_qkv"], ln_mode="post",
        )


@pytest.mark.parametrize(
    "attrs", [{}, dict(fused_gates="v1"), dict(fused_gates="v1v2"), dict(fused_gates="v3"),
              dict(recompute_product=False, av_kernel=True), dict(recompute_av=False)],
    ids=["auto", "v1", "v1v2", "v3", "cached_product", "delta_accumulator"],
)
def test_small_vivit_evblock_card_matches_cpu(attrs, device):
    """A small eventful ViViT of EventfulBlocks (the matmul-2 cast off)
    through ``FactorizedViViT.apply`` on a uint8 video, float32, on the card
    (the kernels) against the CPU (the plain versions) in each run of the
    paper's configuration: probabilities within 1e-5, the run's kernels
    launched."""
    import numpy as np

    from eventful_transformer_tpu_torch.core.counting import Ctx
    from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
    from eventful_transformer_tpu_torch.models import FactorizedViViT
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    block = dict(dim=64, heads=4, mlp_ratio=2)
    model = FactorizedViViT(
        classes=10, input_shape=[8, 3, 32, 32], normalize_mean=0.45, normalize_std=0.225,
        spatial_views=3, temporal_stride=2, temporal_views=2, tubelet_shape=[2, 8, 8],
        spatial_config=dict(depth=2, position_encoding_size=[4, 4], block_class="EventfulBlock",
                            block_config=block),
        temporal_config=dict(depth=1, position_encoding_size=[4], block_config=block),
        device="cpu",
    )
    set_policies(model, TokenNormTopK, k=6)
    for blk in model.spatial_model.backbone.blocks:
        for name, value in attrs.items():
            setattr(blk, name, value)
    card = copy.deepcopy(model).to(device)
    video = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 20, 3, 40, 56),
                                                               dtype=np.uint8))
    wrappers = {entry[0].__name__: entry[0] for entry in kernel_check.KERNELS.values()}
    before = {name: fn.launches for name, fn in wrappers.items()}
    got = card.apply(Ctx(), video.to(device))
    torch.cuda.synchronize()
    launched = {name for name, fn in wrappers.items() if fn.launches > before[name]}
    want = {
        "v1": {"ln_select_matmul", "ln_select", "ln_norms"},
        "v1v2": {"ln_select_matmul", "gate_group_mlp", "ln_norms"},
        "v3": {"ln_select_matmul", "select_linear_skip_norms", "gate_group_mlp"},
    }.get(attrs.get("fused_gates"), {"ln_norms", "gate_group_mlp"})
    if "recompute_product" in attrs:
        want = want | {"softmax_select_matmul_logits"}
    assert want | {"window_attention", "dense_mlp_residual"} <= launched
    want_probs = model.apply(Ctx(), video)
    torch.testing.assert_close(got.cpu(), want_probs, rtol=1e-5, atol=1e-5)


# -- gates before their LN (gate_before_ln) and STGT gates ------------------------

PRE_LN_FORMS = {
    "gate_group_mlp_pre", "gate_group_linear_pre", "ln_select_matmul_pre",
    "select_linear_skip_norms_noln", "ln_select_noln", "block_select_p_noln",
    "block_select_scatter_qkv_noln", "block_select_scatter_mlp_noln",
}


@pytest.mark.parametrize("name", sorted(PRE_LN_FORMS))
def test_pre_ln_form_rejects_a_view(name, device):
    """Each new form's wrapper raises on a non-contiguous view of x rather
    than reading it as if it were contiguous."""
    d = kernel_check.make_inputs(2, 24, 64, 4, 9, torch.bfloat16, device)
    key = "attn" if name.startswith("select_linear") else "x"
    d[key] = d[key].transpose(0, 1).contiguous().transpose(0, 1)
    assert not d[key].is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        kernel_check.call(name, d)


def _form_launches():
    """Each wrapper's total, then (winning where a name is both) each
    entry's count by ``kernel_check.launches``."""
    totals = {entry[0].__name__: entry[0].launches for entry in kernel_check.KERNELS.values()}
    return totals | {name: kernel_check.launches(name) for name in kernel_check.KERNELS}


def _small_vitdet(eventful_options, regime):
    from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
    from eventful_transformer_tpu_torch.models import ViTDet
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    block = dict(dim=64, heads=4, mlp_ratio=2, window_size=[3, 3],
                 relative_embedding_size=[8, 8], **eventful_options)
    model = ViTDet(
        backbone_config=dict(depth=4, position_encoding_size=[4, 4], window_indices=[0, 2],
                             block_class="EventfulTokenwiseBlock", block_config=block),
        classes=5, input_shape=[3, 128, 128], normalize_mean=[0.0] * 3,
        normalize_std=[1.0] * 3, output_channels=16, patch_size=[16, 16], scale_factors=[1.0],
        device="cpu",
    )
    set_policies(model, TokenNormTopK, k=12)
    for blk in model.backbone.blocks:
        blk.fused_gates = regime
    return model


@pytest.mark.parametrize(
    "options,regime",
    [(dict(gate_before_ln=True), "v2"), (dict(gate_before_ln=True), "blocked"),
     (dict(stgt=True), "auto")],
    ids=["compare_ln_v2", "compare_ln_blocked", "stgt"],
)
def test_small_vitdet_options_card_match_cpu(options, regime, device):
    """A small ViTDet of EventfulTokenwiseBlocks on an 8 x 8 grid with 3 x 3
    windows (pad rows), every gate before its LN ("v2" or "blocked") or
    STGT, 2 streams x 3 frames in float32 on the card against the CPU:
    tokens within 1e-3, the forms of the path launched (the STGT path
    launches no gate kernel)."""
    model = _small_vitdet(options, regime)
    card = copy.deepcopy(model).to(device)
    frames = torch.rand((3, 2, 3, 128, 128), generator=torch.Generator().manual_seed(0))
    outs = []
    for m, x in ((card, frames.to(device)), (model, frames)):
        kernel_check.reset_launches()
        state = m.init_state(2, torch.float32, x.device)
        with torch.no_grad():
            for t in range(3):
                tokens = m.pre_backbone(Ctx(), x[t])
                tokens, state = m.apply_backbone(
                    Ctx(), state, tokens, mode="flush" if t == 0 else "incremental"
                )
        outs.append(tokens.cpu())
        if m is card:
            torch.cuda.synchronize()
            counts = _form_launches()
    steps = 2
    want = {
        "v2": dict(gate_group_linear_pre=2 * steps, gate_group_mlp_pre=4 * steps,
                   block_select_p_noln=2 * steps, block_scatter_rows=2 * steps,
                   gate_group_linear=4 * steps, ln_norms=0),
        "blocked": dict(block_select_scatter_qkv_noln=10 * steps, block_select_p_noln=2 * steps,
                        block_scatter_rows=2 * steps, block_select_scatter=10 * steps,
                        ln_norms=0),
        "auto": dict(gate_group_mlp=0, gate_group_linear=0, block_select_p=0,
                     block_select_scatter=0, ln_norms=0, window_attention=2 * 3,
                     relpos_bias_add_v2=2 * 3),
    }[regime]
    for name, count in want.items():
        assert counts[name] == count, (name, counts)
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("regime", ["auto", "v1", "v1v2", "v3"])
def test_small_vivit_gate_before_ln_card_matches_cpu(regime, device):
    """A small ViViT of EventfulTokenwiseBlocks with every gate before its
    LN through ``apply_views``, float32, on the card against the CPU in
    "auto" ("v2mlp": "v4" does not take such a block) and the forced
    regimes: probabilities within 1e-5, the pre-LN forms launched."""
    from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
    from eventful_transformer_tpu_torch.models import FactorizedViViT
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    block = dict(dim=64, heads=4, mlp_ratio=2)
    model = FactorizedViViT(
        classes=10, input_shape=[8, 3, 32, 32], normalize_mean=0.45, normalize_std=0.225,
        spatial_views=1, temporal_stride=2, temporal_views=2, tubelet_shape=[2, 8, 8],
        spatial_config=dict(depth=2, position_encoding_size=[4, 4],
                            block_class="EventfulTokenwiseBlock",
                            block_config=dict(block, gate_before_ln=True)),
        temporal_config=dict(depth=1, position_encoding_size=[4], block_config=block),
        device="cpu",
    )
    set_policies(model, TokenNormTopK, k=6)
    for blk in model.spatial_model.backbone.blocks:
        blk.fused_gates = regime
    card = copy.deepcopy(model).to(device)
    views = torch.randn((1, 2, 8, 3, 32, 32), generator=torch.Generator().manual_seed(0))
    kernel_check.reset_launches()
    with torch.no_grad():
        got = card.apply_views(Ctx(), views.to(device))
    torch.cuda.synchronize()
    counts = _form_launches()
    steps = 3 * 2  # incremental steps x spatial blocks
    want = {
        "auto": dict(gate_group_mlp_pre=steps, ln_norms=0, qkv_attention_group=0),
        "v1": dict(ln_select_matmul_pre=steps, ln_select_matmul_none=steps,
                   ln_select_noln=steps, ln_norms=0),
        "v1v2": dict(ln_select_matmul_pre=steps, ln_select_matmul_none=steps,
                     gate_group_mlp_pre=steps, ln_norms=0),
        "v3": dict(ln_select_matmul_pre=steps, select_linear_skip_norms_noln=steps,
                   gate_group_mlp_pre=steps, ln_norms=0),
    }[regime]
    for name, count in want.items():
        assert counts[name] == count, (name, counts)
    with torch.no_grad():
        want_probs = model.apply_views(Ctx(), views)
    torch.testing.assert_close(got.cpu(), want_probs, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["gate_group_linear_topk", "gate_group_mlp_topk"])
def test_topk_selection_with_planted_ties_is_exact(name, dtype, device):
    """Four rows of each batch row tied at the k-th norm: the kernel's own
    selection equals the plain version's exactly (the smallest index)."""
    d = kernel_check.make_inputs(2, 197, 256, 4, 24, dtype, device, seed=3, ties=name)
    rows = kernel_check.errors(name, d)
    assert all(row["ok"] for row in rows), rows
    assert rows[-1]["output"] == "selection" and rows[-1]["selections_differing"] == 0


def test_small_vivit_in_kernel_topk_card_matches_cpu(device):
    """A small ViViT of EventfulTokenwiseBlocks forced to "v2mlp" with
    in_kernel_topk through ``apply_views``, float32, on the card against
    the CPU: the MLP group's "post_topk" form in every step, no ln_norms."""
    from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
    from eventful_transformer_tpu_torch.models import FactorizedViViT
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    block = dict(dim=64, heads=4, mlp_ratio=2)
    model = FactorizedViViT(
        classes=10, input_shape=[8, 3, 32, 32], normalize_mean=0.45, normalize_std=0.225,
        spatial_views=1, temporal_stride=2, temporal_views=2, tubelet_shape=[2, 8, 8],
        spatial_config=dict(depth=2, position_encoding_size=[4, 4],
                            block_class="EventfulTokenwiseBlock", block_config=block),
        temporal_config=dict(depth=1, position_encoding_size=[4], block_config=block),
        device="cpu",
    )
    set_policies(model, TokenNormTopK, k=6)
    for blk in model.spatial_model.backbone.blocks:
        blk.fused_gates, blk.in_kernel_topk = "v2mlp", True
    card = copy.deepcopy(model).to(device)
    views = torch.randn((1, 2, 8, 3, 32, 32), generator=torch.Generator().manual_seed(0))
    kernel_check.reset_launches()
    with torch.no_grad():
        got = card.apply_views(Ctx(), views.to(device))
    torch.cuda.synchronize()
    counts = _form_launches()
    steps = 3 * 2  # incremental steps x spatial blocks
    # by form: every MLP group selects its own rows ("post_topk"), none
    # takes a coverage ("post")
    assert counts["gate_group_mlp_topk"] == steps and counts["gate_group_mlp"] == 0, counts
    assert counts["ln_norms"] == 0
    with torch.no_grad():
        want = model.apply_views(Ctx(), views)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("share", ["auto", False], ids=["share", "no_share"])
def test_small_vitdet_in_kernel_topk_card_matches_cpu(share, device):
    """A small ViTDet of EventfulTokenwiseBlocks in "v2" with in_kernel_topk
    and sharing on or off, 2 streams x 3 frames in float32 on the card
    against the CPU. Off, every group but the windowed blocks' qkv groups
    (window-major buffers, which select outside) selects its own rows; on,
    the global qkv groups and the MLP groups take handed-over norms and a
    coverage, and only the projection groups select their own."""
    model = _small_vitdet({}, "v2")
    for blk in model.backbone.blocks:
        blk.in_kernel_topk, blk.share_gate_passes = True, share
    card = copy.deepcopy(model).to(device)
    frames = torch.rand((3, 2, 3, 128, 128), generator=torch.Generator().manual_seed(0))
    outs = []
    for m, x in ((card, frames.to(device)), (model, frames)):
        kernel_check.reset_launches()
        state = m.init_state(2, torch.float32, x.device)
        with torch.no_grad():
            for t in range(3):
                tokens = m.pre_backbone(Ctx(), x[t])
                tokens, state = m.apply_backbone(
                    Ctx(), state, tokens, mode="flush" if t == 0 else "incremental"
                )
        outs.append(tokens.cpu())
        if m is card:
            torch.cuda.synchronize()
            counts = _form_launches()
    steps = 2
    # 4 blocks, 2 windowed (window-major qkv: block_select_p + block_scatter_rows);
    # the counts by form
    own = share is False
    want = dict(gate_group_linear_post_topk=(2 if own else 0) * steps,
                gate_group_linear_post=(0 if own else 2) * steps,
                gate_group_linear_topk=4 * steps, gate_group_linear=0,
                gate_group_mlp_topk=(4 if own else 0) * steps,
                gate_group_mlp=(0 if own else 4) * steps, block_select_p=2 * steps,
                ln_norms=(2 if own else 1) * steps)
    for name, count in want.items():
        assert counts[name] == count, (name, counts)
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-3, atol=1e-3)


def test_small_vitdet_stgt_blend_card_matches_cpu(device, monkeypatch):
    """A small STGT ViTDet (dim 128, so every buffer scatter is eligible)
    with USE_PALLAS_BLEND, 2 streams x 3 frames in float32: the blend in
    every buffer of every incremental step, tokens equal to the switch-off
    run on the card and within 1e-3 of the CPU."""
    from eventful_transformer_tpu_torch.core import indexing
    from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
    from eventful_transformer_tpu_torch.models import ViTDet
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    block = dict(dim=128, heads=4, mlp_ratio=2, window_size=[3, 3],
                 relative_embedding_size=[8, 8], stgt=True)
    model = ViTDet(
        backbone_config=dict(depth=4, position_encoding_size=[4, 4], window_indices=[0, 2],
                             block_class="EventfulTokenwiseBlock", block_config=block),
        classes=5, input_shape=[3, 128, 128], normalize_mean=[0.0] * 3,
        normalize_std=[1.0] * 3, output_channels=16, patch_size=[16, 16], scale_factors=[1.0],
        device="cpu",
    )
    set_policies(model, TokenNormTopK, k=12)
    card = copy.deepcopy(model).to(device)
    frames = torch.rand((3, 2, 3, 128, 128), generator=torch.Generator().manual_seed(0))

    def run(m, x):
        state = m.init_state(2, torch.float32, x.device)
        with torch.no_grad():
            for t in range(3):
                tokens = m.pre_backbone(Ctx(), x[t])
                tokens, state = m.apply_backbone(
                    Ctx(), state, tokens, mode="flush" if t == 0 else "incremental"
                )
        return tokens.cpu()

    off = run(card, frames.to(device))
    monkeypatch.setattr(indexing, "USE_PALLAS_BLEND", True)
    kernel_check.reset_launches()
    on = run(card, frames.to(device))
    torch.cuda.synchronize()
    assert kernel_check.launches("scatter_blend") == 4 * 3 * 2  # blocks x buffers x steps
    assert torch.equal(on, off)
    torch.testing.assert_close(on, run(model, frames), rtol=1e-3, atol=1e-3)


def test_scatter_rows_writes_the_callers_buffer(device):
    """Row 19 writes into the tensor it is given, in place (the JAX
    kernel's aliased buffer), float32 values cast to its bfloat16, equal
    to put_rows bit for bit."""
    from eventful_transformer_tpu_torch.core.indexing import put_rows
    from eventful_transformer_tpu_torch.ops.scatter import scatter_rows_inplace

    d = kernel_check.make_inputs(2, 197, 256, 4, 24, torch.bfloat16, device)
    buf = d["rows_buf_qkv"].clone()
    ptr = buf.data_ptr()
    out = scatter_rows_inplace(buf, d["rows_vals_f32"], d["rows_index"], d["rows_mask"])
    assert out is buf and out.data_ptr() == ptr
    want = put_rows(d["rows_buf_qkv"], d["rows_index"], d["rows_vals_f32"], d["rows_mask"])
    assert torch.equal(buf, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_row_kernels_out_of_range_slots(dtype, device):
    """A slot naming a row outside [0, N) writes nothing (the scatter) or
    zeros (the gather) on the card as in the plain versions, for int32 and
    int64 indices."""
    from eventful_transformer_tpu_torch.ops.scatter import gather_rows, scatter_rows_inplace

    d = kernel_check.make_inputs(2, 37, 128, 4, 11, dtype, "cpu", seed=2)
    index = d["rows_index"].clone()
    index[0, 3], index[1, 0] = -1, 37
    for idx in (index, index.long()):
        want = scatter_rows_inplace(d["rows_buf"].clone(), d["rows_vals"], idx, d["rows_mask"])
        got = scatter_rows_inplace(d["rows_buf"].to(device), d["rows_vals"].to(device),
                                   idx.to(device), d["rows_mask"].to(device))
        assert torch.equal(got.cpu(), want)
        got = gather_rows(d["rows_buf"].to(device), idx.to(device))
        assert torch.equal(got.cpu(), gather_rows(d["rows_buf"], idx))


def test_fused_attention_takes_offset_views_and_refuses_strided_ones(device):
    """A batch slice (contiguous, at an offset) gives the result of its
    copy bit for bit; a slice of the last axis is refused, not misread."""
    from eventful_transformer_tpu_torch.ops.attention import fused_attention

    big = torch.randn((3, 37, 4 * 192), device=device)
    with pytest.raises(ValueError, match="contiguous"):
        fused_attention(big[1:, :, :192], heads=4, scale=4.0)
    whole = big[:, :, :192].contiguous()
    for cast in (None, torch.bfloat16):
        got = fused_attention(whole[1:], heads=4, scale=4.0, cast=cast)
        assert torch.equal(got, fused_attention(whole[1:].clone(), heads=4, scale=4.0, cast=cast))


# -- the tensor-core attention body (csrc/attention_tc.cuh) -----------------------------

TC_ENTRIES = ("window_attention", "window_attention_windowed", "window_attention_padded",
              "fused_attention", "fused_attention_cast", "qkv_attention_group")
# (entry, n): every entry at ragged token counts; the windowed form over an
# n-token window, so not at 401 (a 1 x 401 window, which no path has)
TC_CASES = [(name, n) for name in TC_ENTRIES for n in (9, 17, 196, 197, 401)
            if (name, n) != ("window_attention_windowed", 401)]


@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("name,n", TC_CASES, ids=[f"{name}-{n}" for name, n in TC_CASES])
def test_tensor_core_body_matches_plain(name, n, hd, device):
    """Each wrapper that reaches the attention kernel, in bfloat16 at ragged
    token counts and head widths 16 and 64, against its plain version; the
    windowed form over an n-token window (the most nearly square grid), the
    padded one over windows of 3 x 3 or 14 x 14; one launch, and it took
    the tensor-core body."""
    from eventful_transformer_tpu_torch.ops.window_attention import attention_body

    heads = 4
    window = kernel_check._grid(n)
    pad_window = (3, 3) if n < 196 else (14, 14)
    n_call = {"window_attention_windowed": n, "window_attention_padded": 9 if n < 196 else 196}
    d = kernel_check.make_inputs(2, n, heads * hd, heads, min(n, 8), torch.bfloat16, device,
                                 seed=2, window=window, pad_window=pad_window)
    assert attention_body(torch.bfloat16, n_call.get(name, n), hd) == "tc"
    wrapper = kernel_check.KERNELS[name][0]
    kernel_check.reset_launches()
    rows = kernel_check.errors(name, d)
    assert all(row["ok"] for row in rows), rows
    assert wrapper.launches == 1 and wrapper.body_launches == {"tc": 1, "simt": 0}


@pytest.mark.parametrize("name", TC_ENTRIES)
def test_float32_stays_on_the_cuda_core_body(name, device):
    """The same wrappers in float32: the CUDA-core body, as the rule says."""
    d = kernel_check.make_inputs(2, 197, 256, 4, 98, torch.float32, device, seed=3)
    wrapper = kernel_check.KERNELS[name][0]
    kernel_check.reset_launches()
    rows = kernel_check.errors(name, d)
    assert all(row["ok"] for row in rows), rows
    assert wrapper.body_launches == {"tc": 0, "simt": 1}


def test_tensor_core_body_on_a_misaligned_view(device):
    """bfloat16 qkv off a 16-byte boundary takes the CUDA-core body, not a
    misaligned copy, and gives the plain version's result."""
    from eventful_transformer_tpu_torch.ops.window_attention import (
        window_attention,
        window_attention_plain,
    )

    flat = torch.randn(2 * 37 * 192 + 1, device=device).to(torch.bfloat16)
    qkv = flat[1:].view(2, 37, 192)
    kernel_check.reset_launches()
    got = window_attention(qkv, heads=4, scale=4.0)
    assert window_attention.body_launches == {"tc": 0, "simt": 1}
    row = kernel_check.compare(got, window_attention_plain(qkv, heads=4, scale=4.0))
    assert row["ok"], row


def test_small_vivit_bodies_by_dtype(device):
    """A small eventful ViViT in bfloat16: every attention launch, kernel
    A's included, on the tensor-core body; in float32 every one on the
    CUDA-core body."""
    import numpy as np

    from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
    from eventful_transformer_tpu_torch.models import FactorizedViViT
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    block = dict(dim=64, heads=4, mlp_ratio=2)
    config = dict(
        classes=10, input_shape=[8, 3, 32, 32], normalize_mean=0.45, normalize_std=0.225,
        spatial_views=1, temporal_stride=2, temporal_views=1, tubelet_shape=[2, 8, 8],
        spatial_config=dict(depth=2, position_encoding_size=[4, 4],
                            block_class="EventfulTokenwiseBlock", block_config=block),
        temporal_config=dict(depth=1, position_encoding_size=[4], block_config=block),
    )
    model = FactorizedViViT(**config, device="cpu", seed=0)
    set_policies(model, TokenNormTopK, k=8)
    views = torch.from_numpy(
        np.random.default_rng(0).standard_normal((1, 1, 8, 3, 32, 32)).astype(np.float32)
    )
    for dtype, body in ((torch.bfloat16, "tc"), (torch.float32, "simt")):
        m = copy.deepcopy(model).to(device, dtype)
        kernel_check.reset_launches()
        with torch.no_grad():
            m.apply_views(Ctx(), views.to(device, dtype))
        torch.cuda.synchronize()
        counts = kernel_check.body_launches()
        assert counts["qkv_attention_group"][body] > 0 and counts["window_attention"][body] > 0
        kernel_check.check_bodies(counts, dtype, "small ViViT")


# -- row 15 on the tensor-core body, row 19's launch path -------------------------------

# (B, Hp, Wp, C, heads, window, key grid p or None (the window's), image (h,
# w) or None (the whole map), tables): the 672 map (3 x 3 windows of 14 x
# 14), 1024's padded one (64 x 64 in 5 x 5 windows, the pad positions
# holding the qkv-bias row), a small awkward map (d = 48, a 4 x 5 window
# over a 5 x 4 key grid, three batch rows, pad positions), 672 without tables
GRID_CASES = {
    "672": (2, 42, 42, 768, 12, (14, 14), None, None, True),
    "1024_padded": (2, 70, 70, 768, 12, (14, 14), None, (64, 64), True),
    "awkward_p_ne_a": (3, 8, 10, 192, 4, (4, 5), (5, 4), (7, 9), True),
    "672_no_tables": (2, 42, 42, 768, 12, (14, 14), None, None, False),
}


def _grid_inputs(case, dtype, device, seed=4):
    """The map (pad positions holding a bias row), the float32 tables (the
    wrapper rounds them to the map's dtype) and the call's keywords."""
    b, hp, wp, c, heads, window, p, image, tables = GRID_CASES[case]
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(3 * c, generator=g).expand(b, hp, wp, 3 * c).clone()
    h, w = image or (hp, wp)
    x[:, :h, :w] = torch.randn((b, h, w, 3 * c), generator=g)
    (a0, a1), (p0, p1), hd = window, p or window, c // heads
    keys = dict(heads=heads, scale=hd**0.5, window=window)
    rel = ()
    if tables:
        rel = tuple(0.3 * torch.randn(shape, generator=g).to(device)
                    for shape in ((a0, p0, hd), (a1, p1, hd)))
        keys.update(a=window, p=p)
    return x.to(device, dtype), rel, keys


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_grid_tensor_core_body_matches_plain(case, device):
    """Row 15 in bfloat16 on the tensor-core body against its plain version,
    within kernel_check's bfloat16 bounds: one launch, on that body."""
    from eventful_transformer_tpu_torch.ops.window_attention import (
        window_attention_grid,
        window_attention_grid_plain,
    )

    x, rel, keys = _grid_inputs(case, torch.bfloat16, device)
    kernel_check.reset_launches()
    got = window_attention_grid(x, *rel, **keys)
    torch.cuda.synchronize()
    assert window_attention_grid.body_launches == {"tc": 1, "simt": 0}
    row = kernel_check.compare(got, window_attention_grid_plain(x, *rel, **keys))
    assert row["ok"], row


@pytest.mark.parametrize("case", ["672", "awkward_p_ne_a"])
def test_grid_float32_and_misaligned_bfloat16_take_the_cuda_core_body(case, device):
    """Row 15 in float32, and in bfloat16 on a map off a 16-byte boundary,
    runs the CUDA-core body and gives its plain version's result; the
    launches by body follow the dtype."""
    from eventful_transformer_tpu_torch.ops.window_attention import (
        window_attention_grid,
        window_attention_grid_plain,
    )

    x32, rel, keys = _grid_inputs(case, torch.float32, device)
    flat = torch.empty(x32.numel() + 1, dtype=torch.bfloat16, device=device)
    x16 = flat[1:].view(x32.shape)
    x16.copy_(x32)
    for x in (x32, x16):
        kernel_check.reset_launches()
        got = window_attention_grid(x, *rel, **keys)
        torch.cuda.synchronize()
        assert window_attention_grid.body_launches == {"tc": 0, "simt": 1}
        row = kernel_check.compare(got, window_attention_grid_plain(x, *rel, **keys))
        assert row["ok"], row
    kernel_check.reset_launches()
    window_attention_grid(x32.to(torch.bfloat16), *rel, **keys)
    assert kernel_check.body_launches()["window_attention_grid"] == {"tc": 1, "simt": 0}


def test_scatter_rows_refusals_raise_before_the_launch(device):
    """Row 19's one-pass operand check still refuses, before any launch and
    with the buffer untouched: non-contiguous values, a buffer off a
    16-byte boundary, a mask of the wrong shape, a float index."""
    from eventful_transformer_tpu_torch.ops.scatter import scatter_rows_inplace

    d = kernel_check.make_inputs(2, 197, 256, 4, 24, torch.bfloat16, device)
    buf, values, index, mask = (d[key] for key in kernel_check.ROWS_INPUTS[
        "scatter_rows_inplace_qkv_masked"])
    flat = torch.empty(buf.numel() + 4, dtype=buf.dtype, device=device)
    misaligned = flat[4:].view(buf.shape)
    misaligned.copy_(buf)
    strided = torch.empty((values.shape[1], values.shape[0], values.shape[2]), dtype=values.dtype,
                          device=device).transpose(0, 1)
    strided.copy_(values)
    faults = [
        (ValueError, "values must be a contiguous", (buf, strided, index, mask)),
        (ValueError, "buffer must start on a 16-byte boundary", (misaligned, values, index, mask)),
        (ValueError, "mask has shape", (buf, values, index, mask[:, :-1])),
        (TypeError, "index is torch.float32", (buf, values, index.float(), mask)),
    ]
    before = scatter_rows_inplace.launches
    for error, message, (b, v, i, m) in faults:
        kept = b.clone()
        with pytest.raises(error, match=message):
            scatter_rows_inplace(b, v, i, m)
        assert torch.equal(b, kept)
    assert scatter_rows_inplace.launches == before


def test_row_kernels_launch_on_the_current_stream(device):
    """The launch path reads the current stream's raw handle: a scatter and
    a gather on a side stream, queued behind a long product there, give the
    plain versions' result once that stream is done."""
    from eventful_transformer_tpu_torch.ops.scatter import gather_rows, scatter_rows_inplace

    d = kernel_check.make_inputs(2, 197, 256, 4, 24, torch.bfloat16, device)
    buf, values, index = d["rows_buf_qkv"], d["rows_vals_qkv"], d["rows_index"]
    want = scatter_rows_inplace(buf.cpu(), values.cpu(), index.cpu())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        a = torch.randn((4096, 4096), device=device)
        for _ in range(8):
            a = a @ a / 64.0
        got = scatter_rows_inplace(buf.clone(), values, index)
        rows = gather_rows(got, index)
    side.synchronize()
    assert torch.equal(got.cpu(), want)
    assert torch.equal(rows.cpu(), gather_rows(want, index.cpu()))



# -- row 11, the window-major rows' scatter, a bulk row copy ------------------------------

ROW11_GRIDS = {"672": ((42, 42), (14, 14)), "1024": ((64, 64), (14, 14))}  # 1024: 70 x 70 rows


def _row11_inputs(grid, dtype, device, bsz=2, k=256, f=2304, seed=0):
    """The windowed qkv group's operands at ViTDet's shapes: the window-major
    buffer (bsz, NW, f) and h (bsz, k, f) on the card; on the CPU the
    selected tokens row-major in random order with the selection's marker
    N, -1, an index below -1 and one past the map among the slots, and the
    window map (N + 1,) int32."""
    from eventful_transformer_tpu_torch.core.indexing import window_row_map

    (gh, gw), window = ROW11_GRIDS[grid]
    n = gh * gw
    row_map = torch.from_numpy(window_row_map((gh, gw), window))
    nw = (gh + -gh % window[0]) * (gw + -gw % window[1])
    g = torch.Generator().manual_seed(seed)
    buf = torch.randn((bsz, nw, f), generator=g).to(device, dtype)
    h = torch.randn((bsz, k, f), generator=g).to(device, dtype)
    index = torch.stack([torch.randperm(n, generator=g)[:k] for _ in range(bsz)]).int()
    index[:, 0] = n
    index[0, 5], index[0, 7], index[-1, 9] = -1, -5, n + 3
    return buf, index, h, row_map


@pytest.mark.parametrize("mapped", [True, False], ids=["map", "no_map"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("grid", sorted(ROW11_GRIDS))
def test_block_scatter_rows_matches_plain_bit_for_bit(grid, dtype, mapped, device):
    """Row 11 at ViTDet-672's and 1024's shapes (B = 2, KP = 256, F = 2304)
    against its plain version: with the window map (row-major tokens in
    random order, the marker N, -1, -5 and an index past the map) and
    without (the window-major rows taken beforehand, with rows of NW and
    more planted); equal element for element, in place, one launch a
    call."""
    from eventful_transformer_tpu_torch.ops.gate_block import (
        block_scatter_rows,
        block_scatter_rows_plain,
    )

    buf, index, h, row_map = _row11_inputs(grid, dtype, device)
    if not mapped:
        inside = (index >= 0) & (index < row_map.numel())
        index = torch.where(inside, row_map[index.clamp(0, row_map.numel() - 1)], -1).int()
        index[0, 3], index[-1, 4] = buf.shape[1], buf.shape[1] + 7
        row_map = None
    want = block_scatter_rows_plain(buf.cpu(), index, h.cpu(), row_map)
    before = block_scatter_rows.launches
    got = block_scatter_rows(buf, index.to(device), h,
                             None if row_map is None else row_map.to(device))
    assert got is buf and block_scatter_rows.launches == before + 1
    assert torch.equal(got.cpu(), want)


def test_block_scatter_rows_refusals_raise_before_the_launch(device):
    """Row 11's one-pass operand check refuses, before any launch and with
    the buffer untouched: a non-contiguous buffer, one off a 16-byte
    boundary, an int64 index, rows that are no whole 16-byte words, h of
    another dtype, an index on the CPU and an int64 map."""
    from eventful_transformer_tpu_torch.ops.gate_block import block_scatter_rows

    buf, index, h, row_map = _row11_inputs("672", torch.bfloat16, device, k=24, f=192)
    index, row_map = index.to(device), row_map.to(device)
    flat = torch.empty(buf.numel() + 4, dtype=buf.dtype, device=device)
    misaligned = flat[4:].view(buf.shape)
    misaligned.copy_(buf)
    strided = torch.empty(buf.shape[:-1] + (2 * buf.shape[-1],), dtype=buf.dtype,
                          device=device)[..., : buf.shape[-1]]
    strided.copy_(buf)
    ragged = torch.zeros(buf.shape[:-1] + (12,), dtype=buf.dtype, device=device)
    faults = [
        (ValueError, "input must be contiguous", (strided, index, h, row_map)),
        (ValueError, "must start on a 16-byte boundary", (misaligned, index, h, row_map)),
        (TypeError, "index is torch.int64", (buf, index.long(), h, row_map)),
        (ValueError, "not whole 16-byte words", (ragged, index, h[..., :12].contiguous(), row_map)),
        (TypeError, "h is torch.float32", (buf, index, h.float(), row_map)),
        (ValueError, "index must be a contiguous tensor", (buf, index.cpu(), h, row_map)),
        (TypeError, "row_map must be a 1-D torch.int32", (buf, index, h, row_map.long())),
    ]
    before = block_scatter_rows.launches
    for error, message, (b, i, hh, m) in faults:
        kept = b.clone()
        with pytest.raises(error, match=message):
            block_scatter_rows(b, i, hh, m)
        assert torch.equal(b, kept)
    assert block_scatter_rows.launches == before

# -- the bulk row-copy kernels of rows 18 and 20 -------------------------------------------

ROW_COPY_WIDTHS = [128, 768, 2304, 3072, 8192]
ROW_COPY_SLOTS = [0, 1, 24, 256, "N"]
ROW_COPY_N = 300  # rows a batch row: no multiple of any plan's tile


def _row_copy_inputs(c, k, dtype, values_dtype, index_dtype, device, seed=0):
    """x (2, N, C), values (2, k, C), a (2, k) index naming distinct rows
    but for the planted slots: -1, N, and slot 3 naming slot 0's row (a
    duplicate); a mask of about 80 % of the slots; all on the card."""
    k = ROW_COPY_N if k == "N" else k
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((2, ROW_COPY_N, c), generator=g).to(dtype)
    values = torch.randn((2, k, c), generator=g).to(values_dtype)
    index = torch.stack([torch.randperm(ROW_COPY_N, generator=g)[:k] for _ in range(2)])
    if k > 3:
        index[0, 1], index[1, 2], index[0, 3] = -1, ROW_COPY_N, index[0, 0]
    mask = torch.rand((2, k), generator=g) < 0.8
    return x.to(device), values.to(device), index.to(device, index_dtype), mask.to(device)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("k", ROW_COPY_SLOTS, ids=lambda k: f"k{k}")
@pytest.mark.parametrize("c", ROW_COPY_WIDTHS, ids=lambda c: f"c{c}")
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                                    (torch.bfloat16, torch.float32)],
                         ids=["f32", "bf16", "bf16_f32_values"])
def test_scatter_blend_matches_plain_bit_for_bit(dtypes, c, k, masked, device):
    """Row 18 against its plain version at every width and slot count, with
    a masked slot set, indices -1 and N, a duplicated index (-x + v1 + v2)
    and float32 values into a bfloat16 x (cast in the kernel): equal
    element for element, one launch a call."""
    from eventful_transformer_tpu_torch.ops.scatter_blend import scatter_blend, scatter_blend_plain

    x, values, index, mask = _row_copy_inputs(c, k, *dtypes, torch.int64, device)
    mask = mask if masked else None
    before = scatter_blend.launches
    got = scatter_blend(x, values, index, mask)
    assert scatter_blend.launches == before + 1
    assert torch.equal(got, scatter_blend_plain(x, values, index, mask))


@pytest.mark.parametrize("k", ROW_COPY_SLOTS, ids=lambda k: f"k{k}")
@pytest.mark.parametrize("c", ROW_COPY_WIDTHS, ids=lambda c: f"c{c}")
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64], ids=["i32", "i64"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gather_rows_matches_plain_bit_for_bit(dtype, index_dtype, c, k, device):
    """Row 20 against its plain version at every width and slot count, int32
    and int64 indices, with indices -1 and N (rows of zeros): equal byte
    for byte, one launch a call (none without slots)."""
    from eventful_transformer_tpu_torch.ops.scatter import gather_rows, gather_rows_plain

    x, _, index, _ = _row_copy_inputs(c, k, dtype, dtype, index_dtype, device)
    before = gather_rows.launches
    got = gather_rows(x, index)
    assert gather_rows.launches == before + (1 if index.numel() else 0)
    assert got.shape == (2, index.shape[1], c)
    assert torch.equal(got, gather_rows_plain(x, index))


@pytest.mark.parametrize("c", [3, 100, 128], ids=lambda c: f"c{c}")
def test_scatter_blend_off_16_byte_words_matches_plain(c, device):
    """Row 18 where the bulk copies cannot go: rows that are no whole
    16-byte words (C = 3, 100 in bfloat16) and an x off a 16-byte boundary
    (a view one element into a larger tensor): the block's threads blend
    each element, equal to the plain version."""
    from eventful_transformer_tpu_torch.ops.scatter_blend import scatter_blend, scatter_blend_plain

    x, values, index, mask = _row_copy_inputs(c, 24, torch.bfloat16, torch.bfloat16, torch.int64,
                                              device)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=device)
    offset = flat[1:].view(x.shape)
    offset.copy_(x)
    for xx in (x, offset):
        assert torch.equal(scatter_blend(xx, values, index, mask),
                           scatter_blend_plain(xx, values, index, mask))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["scatter_blend", "scatter_blend_qkv", "scatter_blend_masked",
                                  "gather_rows", "gather_rows_qkv", "scatter_rows_inplace",
                                  "scatter_rows_inplace_qkv_masked", "block_scatter_rows"])
def test_row_copy_kernels_launch_once_and_allocate_their_output(name, dtype, device):
    """Rows 18 and 20 launch their one kernel once a call and allocate only
    their output; rows 11 and 19, the scatters in place, launch theirs once
    a call and allocate nothing (kernel_check.row_copy_profile)."""
    d = kernel_check.make_inputs(2, 197, 256, 4, 24, dtype, device)
    row = kernel_check.row_copy_profile(name, d, kernel_check.bound(name, d)[0])
    wrapper = kernel_check.KERNELS[name][0].__name__
    assert row["kernels_per_call"] == {kernel_check.ROW_COPY_KERNELS[wrapper]: 1}, row
    assert row["one_launch"], row
    scatters = ("scatter_rows_inplace", "block_scatter_rows")
    assert row["allocations_per_call"] == (0 if wrapper in scatters else 1), row
    assert row["device_us"] > 0 and 0 < row["bound_share"]

# -- the wgmma GEMM core of rows 4 and 5 -------------------------------------------------


def _core_operands(m, k, n, gather, device, seed=0):
    """a (R, K) and w (K, N) bfloat16 at the model's scales; for a gather,
    R = m + 5 rows and m int32 row indices with -1 slots (zero rows)."""
    g = torch.Generator().manual_seed(seed)
    rows = m + 5 if gather else m
    a = torch.randn(rows, k, generator=g).to(device, torch.bfloat16)
    w = (torch.randn(k, n, generator=g) * k**-0.5).to(device, torch.bfloat16)
    idx = None
    if gather:
        idx = torch.randint(-1, rows, (m,), generator=g, dtype=torch.int32)
        idx[::7] = -1
        idx = idx.to(device)
    return a, w, idx


def _core_want(a, w, idx, split):
    from eventful_transformer_tpu_torch.ops import gemm_core

    picked = a if idx is None else torch.where((idx >= 0)[:, None], a[idx.long().clamp(min=0)], 0)
    return gemm_core.gemm_split_plain(picked, w, split)


def _core_close(got, want):
    """float32 sums of the same bfloat16 products in other orders: 1e-4
    scaled, as kernel_check.F32_SCALED."""
    assert got.shape == want.shape
    err = float(((got - want).abs() / want.abs().clamp(min=1.0)).max())
    assert err <= kernel_check.F32_SCALED, err


@pytest.mark.parametrize("what", ["w_is_k", "w_is_n"])
def test_gemm_core_single_tile_layout(what, device):
    """One 128 x 128 tile over one K step of 64: A one-hot (row m picks k =
    m % 64) and W encoding k or n exactly, so that a wrong wgmma descriptor
    (A's rows, B's K rows or its two 64-column boxes) shows as wrong
    integers, not as a rounding error."""
    from eventful_transformer_tpu_torch.ops import gemm_core

    m, k, n = 128, 64, 128
    a = torch.zeros(m, k)
    a[torch.arange(m), torch.arange(m) % k] = 1.0
    code = torch.arange(k)[:, None].expand(k, n) if what == "w_is_k" else \
        torch.arange(n)[None, :].expand(k, n)
    w = code.float().contiguous()
    got = gemm_core.gemm_tc(a.to(device, torch.bfloat16), w.to(device, torch.bfloat16), split=1)
    want = torch.matmul(a, w)
    assert torch.equal(got.cpu(), want)


CORE_SHAPES = [(m, k, n, gather) for m in (1, 17, 136, 784, 1576)
               for k, n in ((768, 3072), (3072, 768)) for gather in (False, True)]


@pytest.mark.parametrize("m,k,n,gather", CORE_SHAPES,
                         ids=[f"{m}x{k}x{n}-{'gather' if g else 'dense'}"
                              for m, k, n, g in CORE_SHAPES])
def test_gemm_core_matches_the_split_sum(m, k, n, gather, device):
    """The core alone at ragged row counts, dense and gathered (-1 slots
    read zero rows), unsplit and on the plan's split, against the plain sum
    of the same plan."""
    from eventful_transformer_tpu_torch.ops import gemm_core

    a, w, idx = _core_operands(m, k, n, gather, device)
    before = gemm_core.gemm_tc.launches
    for split in sorted({1, gemm_core.gemm_plan(m, k, n).split}):
        _core_close(gemm_core.gemm_tc(a, w, idx, split=split).cpu(),
                    _core_want(a.cpu(), w.cpu(), None if idx is None else idx.cpu(), split))
    assert gemm_core.gemm_tc.launches > before


def test_gemm_core_on_a_side_stream(device):
    """The core launches on the current stream: on a side stream, queued
    behind a long product there, split and unsplit give the plain sum."""
    from eventful_transformer_tpu_torch.ops import gemm_core

    a, w, idx = _core_operands(784, 3072, 768, True, device, seed=1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        big = torch.randn((4096, 4096), device=device)
        for _ in range(8):
            big = big @ big / 64.0
        got = [gemm_core.gemm_tc(a, w, idx, split=s) for s in (1, 3)]
    side.synchronize()
    for split, out in zip((1, 3), got):
        _core_close(out.cpu(), _core_want(a.cpu(), w.cpu(), idx.cpu(), split))


def test_gemm_core_refuses_what_the_rule_refuses(device):
    """A view off a 16-byte boundary, N off the tile or float32: the core's
    entry raises before any launch; a split that does not divide the K
    steps is refused by the C side."""
    from eventful_transformer_tpu_torch.ops import gemm_core

    a, w, _ = _core_operands(64, 768, 3072, False, device)
    flat = torch.zeros(64 * 768 + 1, device=device, dtype=torch.bfloat16)
    before = gemm_core.gemm_tc.launches
    with pytest.raises(ValueError, match="not the tc core"):
        gemm_core.gemm_tc(flat[1:].view(64, 768), w)
    with pytest.raises(ValueError, match="not the tc core"):
        gemm_core.gemm_tc(a, w[:, :3000].contiguous())
    with pytest.raises((TypeError, ValueError)):
        gemm_core.gemm_tc(a.float(), w.float())
    with pytest.raises(RuntimeError, match="CUDA error"):
        gemm_core.gemm_tc(a, w, split=5)
    assert gemm_core.gemm_tc.launches == before


@pytest.mark.parametrize("name", ["dense_mlp_residual", "gate_group_mlp", "gate_group_mlp_pre",
                                  "gate_group_mlp_topk"])
def test_mlp_rows_take_the_core_by_dtype(name, device):
    """Rows 4 and 5 at C = 256 (hidden 1024): bfloat16 on the wgmma core,
    float32 on the CUDA-core tile, each against its plain version; at C =
    64 (GEMM2's N = 64 is off the tile) bfloat16 stays on WMMA."""
    wrapper = kernel_check.KERNELS[name][0]
    for c, dtype, core in ((256, torch.bfloat16, "tc"), (256, torch.float32, "simt"),
                           (64, torch.bfloat16, "wmma")):
        d = kernel_check.make_inputs(3, 37, c, 4, 11, dtype, device, seed=4)
        kernel_check.reset_launches()
        rows = kernel_check.errors(name, d)
        assert all(row["ok"] for row in rows), (c, dtype, rows)
        assert wrapper.core_launches == {**dict.fromkeys(("tc", "wmma", "simt"), 0), core: 1}


def test_dense_mlp_on_a_misaligned_view_takes_the_old_tile(device):
    """x off a 16-byte boundary: the rule routes the call to WMMA, which
    gives the plain version's result."""
    from eventful_transformer_tpu_torch.ops.dense_mlp import (
        dense_mlp_residual,
        dense_mlp_residual_plain,
    )

    d = kernel_check.make_inputs(2, 37, 256, 4, 11, torch.bfloat16, device, seed=5)
    flat = torch.zeros(d["x"].numel() + 1, device=device, dtype=torch.bfloat16)
    x = flat[1:].view(d["x"].shape)
    x.copy_(d["x"])
    args = [d[k] for k in ("ln2_s", "ln2_b", "w1", "b1", "w2", "b2")]
    kernel_check.reset_launches()
    got = dense_mlp_residual(x, *args)
    assert dense_mlp_residual.core_launches == {"tc": 0, "wmma": 1, "simt": 0}
    row = kernel_check.compare(got, dense_mlp_residual_plain(x, *args))
    assert row["ok"], row


def test_small_vivit_cores_by_dtype(device):
    """A small eventful ViViT at C = 128 (hidden 512) in bfloat16: every MLP
    launch, kernel C's and the temporal model's, on the wgmma core; in
    float32 every one on the CUDA-core tile."""
    import numpy as np

    from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
    from eventful_transformer_tpu_torch.models import FactorizedViViT
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    block = dict(dim=128, heads=4, mlp_ratio=4)
    config = dict(
        classes=10, input_shape=[8, 3, 32, 32], normalize_mean=0.45, normalize_std=0.225,
        spatial_views=1, temporal_stride=2, temporal_views=1, tubelet_shape=[2, 8, 8],
        spatial_config=dict(depth=2, position_encoding_size=[4, 4],
                            block_class="EventfulTokenwiseBlock", block_config=block),
        temporal_config=dict(depth=1, position_encoding_size=[4], block_config=block),
    )
    model = FactorizedViViT(**config, device="cpu", seed=0)
    set_policies(model, TokenNormTopK, k=8)
    views = torch.from_numpy(
        np.random.default_rng(0).standard_normal((1, 1, 8, 3, 32, 32)).astype(np.float32)
    )
    for dtype, core in ((torch.bfloat16, "tc"), (torch.float32, "simt")):
        m = copy.deepcopy(model).to(device, dtype)
        kernel_check.reset_launches()
        with torch.no_grad():
            m.apply_views(Ctx(), views.to(device, dtype))
        torch.cuda.synchronize()
        counts = kernel_check.core_launches()
        assert counts["gate_group_mlp"][core] > 0 and counts["dense_mlp_residual"][core] > 0
        kernel_check.check_cores(counts, dtype, "small ViViT")


@pytest.mark.parametrize("name", ["qkv_attention_group", "proj_group"])
def test_block_fused_kernels_take_the_core_by_dtype(name, device):
    """Kernels A and B against their plain versions on each core: bfloat16
    on the wgmma core at C = 768 (ViViT's width, 12 heads) and C = 128 (3C
    = 384), at ragged row counts (111 and 394 rows: a part tile), on WMMA
    at C = 64 (3C = 192 and C = 64 are off the 128-column tile); float32 on
    the CUDA-core tile."""
    wrapper = kernel_check.KERNELS[name][0]
    cases = [(c, heads, dtype, core, shape)
             for c, heads, dtype, core in ((768, 12, torch.bfloat16, "tc"),
                                           (128, 4, torch.bfloat16, "tc"),
                                           (64, 4, torch.bfloat16, "wmma"),
                                           (768, 12, torch.float32, "simt"),
                                           (128, 4, torch.float32, "simt"))
             for shape in ((3, 37, 11), (2, 197, 98))]
    for c, heads, dtype, core, (bsz, n, k) in cases:
        d = kernel_check.make_inputs(bsz, n, c, heads, k, dtype, device, seed=6)
        kernel_check.reset_launches()
        rows = kernel_check.errors(name, d)
        assert all(row["ok"] for row in rows), (c, dtype, n, rows)
        assert wrapper.core_launches == {**dict.fromkeys(("tc", "wmma", "simt"), 0), core: 1}


def test_tma_descriptors_are_cached(device):
    """A warm call of kernels A and B encodes no TMA descriptor; the cache
    keeps the most recently used ones: after more distinct weights than it
    holds, the first weight is encoded again, the last is not."""
    from eventful_transformer_tpu_torch.ops import block_fused, gemm_core

    d = kernel_check.make_inputs(2, 37, 256, 4, 11, torch.bfloat16, device, seed=7)

    def kernels():
        block_fused.qkv_attention_group(
            d["x"], d["p_qkv"], d["cov1"], d["p_proj"], d["ln1_s"], d["ln1_b"], d["w_qkv"],
            d["b_qkv"], heads=4, inv_scale=64**-0.5)
        block_fused.proj_group(d["attn"], d["p_proj"], d["cov2"], d["x"], d["p_mlp"],
                               d["w_proj"], d["b_proj"], d["ln2_s"], d["ln2_b"])

    kernels()
    before = gemm_core.tensor_map_encodes()
    for _ in range(3):
        kernels()
    assert gemm_core.tensor_map_encodes() == before

    a = torch.randn((1, 64), device=device).to(torch.bfloat16)
    ws = [torch.randn((64, 128), device=device).to(torch.bfloat16)
          for _ in range(gemm_core.TMA_MAPS + 4)]
    for w in ws:
        gemm_core.gemm_tc(a, w)
    before = gemm_core.tensor_map_encodes()
    gemm_core.gemm_tc(a, ws[-1])
    assert gemm_core.tensor_map_encodes() == before
    gemm_core.gemm_tc(a, ws[0])
    assert gemm_core.tensor_map_encodes() == before + 1
    torch.cuda.synchronize()


GATE_FUSED_FORMS = ["ln_select_matmul_post", "ln_select_matmul_none", "ln_select_matmul_pre",
                    "select_linear_skip_norms", "select_linear_skip_norms_noln"]


@pytest.mark.parametrize("name", GATE_FUSED_FORMS)
def test_gate_fused_kernels_take_the_core_by_dtype(name, device):
    """Rows 12 and 13 against their plain versions on each core: bfloat16
    on the wgmma core at C = 768 (the paths' width) and C = 128 (3C = 384),
    at ragged row counts (111 and 394 rows: a part tile), on WMMA at C = 64
    (3C = 192 and C = 64 are off the 128-column tile); float32 on the
    CUDA-core tile."""
    wrapper = kernel_check.KERNELS[name][0]
    cases = [(c, dtype, core, shape)
             for c, dtype, core in ((768, torch.bfloat16, "tc"), (128, torch.bfloat16, "tc"),
                                    (64, torch.bfloat16, "wmma"), (768, torch.float32, "simt"),
                                    (128, torch.float32, "simt"))
             for shape in ((3, 37, 11), (2, 197, 98))]
    for c, dtype, core, (bsz, n, k) in cases:
        d = kernel_check.make_inputs(bsz, n, c, 4, k, dtype, device, seed=8)
        kernel_check.reset_launches()
        rows = kernel_check.errors(name, d)
        assert all(row["ok"] for row in rows), (c, dtype, n, rows)
        assert wrapper.core_launches == {**dict.fromkeys(("tc", "wmma", "simt"), 0), core: 1}


def _gate_fused_call(fn, name, d, p):
    """Entry ``name`` of rows 12 and 13 through ``fn`` (the wrapper or its
    plain version) on ``d`` with the gate state ``p``, uncloned."""
    if name.startswith("ln_select_matmul"):
        mode = name.rsplit("_", 1)[-1]
        ln = mode != "none"
        x, w, wb = (d["x"], d["w_qkv"], d["b_qkv"]) if ln else (d["attn"], d["w_proj"], d["b_proj"])
        return fn(x, p, d["cov1" if ln else "cov2"], d["ln1_s"] if ln else None,
                  d["ln1_b"] if ln else None, w, wb, ln_mode=mode)
    next_ln = name == "select_linear_skip_norms"
    return fn(d["attn"], p, d["cov2"], d["w_proj"], d["b_proj"], d["x"], d["p_mlp"],
              d["ln2_s"] if next_ln else None, d["ln2_b"] if next_ln else None, next_ln=next_ln)


@pytest.mark.parametrize("name", ["ln_select_matmul_none", "select_linear_skip_norms"])
def test_gate_fused_on_a_misaligned_state_takes_the_old_tile(name, device):
    """The gate state p, which the GEMM reads, off a 16-byte boundary: the
    rule routes the call to WMMA, which gives the plain version's result."""
    wrapper, plain = kernel_check.KERNELS[name][:2]
    d = kernel_check.make_inputs(2, 37, 256, 4, 11, torch.bfloat16, device, seed=9)
    flat = torch.zeros(d["p_proj"].numel() + 1, device=device, dtype=torch.bfloat16)
    p = flat[1:].view(d["p_proj"].shape)
    p.copy_(d["p_proj"])
    kernel_check.reset_launches()
    got = _gate_fused_call(wrapper, name, d, p)
    want = _gate_fused_call(plain, name, d, d["p_proj"].clone())
    assert wrapper.core_launches == {"tc": 0, "wmma": 1, "simt": 0}
    for a, b in zip(got, want):
        row = kernel_check.compare(a, b)
        assert row["ok"], row


def test_gate_fused_warm_calls_encode_no_descriptor(device):
    """A warm call of each form of rows 12 and 13, "pre"'s scratch of ln(p')
    included, encodes no TMA descriptor."""
    from eventful_transformer_tpu_torch.ops import gemm_core

    d = kernel_check.make_inputs(2, 37, 256, 4, 11, torch.bfloat16, device, seed=10)

    def kernels():
        for name in GATE_FUSED_FORMS:
            p = d["p_qkv"] if name in ("ln_select_matmul_post", "ln_select_matmul_pre") else \
                d["p_proj"]
            _gate_fused_call(kernel_check.KERNELS[name][0], name, d, p)

    kernel_check.reset_launches()
    kernels()
    assert kernel_check.core_launches()["ln_select_matmul"]["tc"] == 3
    assert kernel_check.core_launches()["select_linear_skip_norms"]["tc"] == 2
    before = gemm_core.tensor_map_encodes()
    for _ in range(3):
        kernels()
    torch.cuda.synchronize()
    assert gemm_core.tensor_map_encodes() == before


GATE_GROUP_LINEAR_FORMS = ["gate_group_linear", "gate_group_linear_post", "gate_group_linear_pre",
                           "gate_group_linear_topk", "gate_group_linear_post_topk",
                           "gate_group_linear_pre_topk"]


def _recover(d, fraction, seed):
    """``d`` with both of row 7's coverages (cov1 of the qkv forms, cov2 of
    the projection) replaced by one of about ``fraction`` of the rows: more
    than kcap, or fewer (empty slots)."""
    g = torch.Generator().manual_seed(seed)
    cov = (torch.rand(d["cov1"].shape, generator=g) < fraction).float()
    return dict(d, cov1=cov.to(d["cov1"].device), cov2=cov.to(d["cov2"].device))


@pytest.mark.parametrize("name", GATE_GROUP_LINEAR_FORMS)
def test_gate_group_linear_takes_the_core_by_dtype(name, device):
    """Row 7 against its plain version on each core: bfloat16 on the wgmma
    core at C = 768 (the paths' width) and C = 128 (3C = 384), at ragged
    slot counts (33 and 196 rows, each split 3 ways, and 512 rows, the
    qkv GEMM unsplit as at 672), on WMMA at C = 64; float32 on the CUDA-core
    tile. With the coverage given, also one of more than kcap rows (the
    rows beyond kcap zeroed in b) and one of fewer (empty slots)."""
    wrapper = kernel_check.KERNELS[name][0]
    covers = (None,) if name.endswith("_topk") else (None, 0.7, 0.15)
    cases = [(c, dtype, core, shape)
             for c, dtype, core in ((768, torch.bfloat16, "tc"), (128, torch.bfloat16, "tc"),
                                    (64, torch.bfloat16, "wmma"), (768, torch.float32, "simt"))
             for shape in ((3, 37, 11), (2, 197, 98), (2, 300, 256))]
    for c, dtype, core, (bsz, n, k) in cases:
        d = kernel_check.make_inputs(bsz, n, c, 4, k, dtype, device, seed=11)
        for fraction in covers:
            dd = d if fraction is None else _recover(d, fraction, seed=c + n)
            kernel_check.reset_launches()
            rows = kernel_check.errors(name, dd)
            assert all(row["ok"] for row in rows), (c, dtype, n, fraction, rows)
            assert wrapper.core_launches == {**dict.fromkeys(("tc", "wmma", "simt"), 0), core: 1}


def test_gate_group_linear_over_kcap_rows_are_zero(device):
    """A given coverage of more than kcap rows on the wgmma core: the
    selected rows beyond kcap hold zeros in the updated buffer (the
    compaction zeroes them; the GEMM writes only the kcap slots' rows),
    and the rows not selected keep their old values bit for bit."""
    d = _recover(kernel_check.make_inputs(2, 197, 256, 4, 40, torch.bfloat16, device, seed=12),
                 0.6, seed=12)
    b = d["buf_qkv"].clone()
    gate_group_linear = kernel_check.KERNELS["gate_group_linear_post"][0]
    gate_group_linear(d["x"], d["p_qkv"].clone(), b, d["cov1"], d["ln1_s"], d["ln1_b"],
                      d["w_qkv"], d["b_qkv"], ln_mode="post", kcap=40)
    sel = d["cov1"] > 0
    beyond = sel & (torch.cumsum(sel.int(), -1) > 40)
    assert beyond.any()
    assert not b[beyond].any()
    assert torch.equal(b[~sel], d["buf_qkv"][~sel])


def test_gate_group_linear_on_a_misaligned_state_takes_the_old_tile(device):
    """The gate state p, which the GEMM gathers from, off a 16-byte
    boundary: the rule routes the call to WMMA, which gives the plain
    version's result."""
    wrapper, plain = kernel_check.KERNELS["gate_group_linear"][:2]
    d = kernel_check.make_inputs(2, 37, 256, 4, 11, torch.bfloat16, device, seed=13)
    flat = torch.zeros(d["p_proj"].numel() + 1, device=device, dtype=torch.bfloat16)
    p = flat[1:].view(d["p_proj"].shape)
    p.copy_(d["p_proj"])
    args = lambda p, b: (d["attn"], p, b, d["cov2"], None, None, d["w_proj"],  # noqa: E731
                         d["b_proj"], d["x"], d["p_mlp"], d["ln2_s"], d["ln2_b"])
    kernel_check.reset_launches()
    got = wrapper(*args(p, d["buf_proj"].clone()), ln_mode="none", kcap=11)
    want = plain(*args(d["p_proj"].clone(), d["buf_proj"].clone()), ln_mode="none", kcap=11)
    assert wrapper.core_launches == {"tc": 0, "wmma": 1, "simt": 0}
    for a, b in zip(got, want):
        row = kernel_check.compare(a, b)
        assert row["ok"], row


def test_gate_group_linear_warm_calls_encode_no_descriptor(device):
    """A warm call of each form of row 7, "pre"'s scratch of ln(p')
    included, encodes no TMA descriptor."""
    from eventful_transformer_tpu_torch.ops import gemm_core

    d = kernel_check.make_inputs(2, 197, 256, 4, 98, torch.bfloat16, device, seed=14)

    def kernels():
        for name in GATE_GROUP_LINEAR_FORMS:
            kernel_check._invoke(name, kernel_check.KERNELS[name][0], d)

    kernel_check.reset_launches()
    kernels()
    assert kernel_check.core_launches()["gate_group_linear"]["tc"] == 6
    before = gemm_core.tensor_map_encodes()
    for _ in range(3):
        kernels()
    torch.cuda.synchronize()
    assert gemm_core.tensor_map_encodes() == before


# -- the A.V kernel's tensor-core body (row 8, csrc/av_softmax_tc.cuh) ------------

# the paths' shapes: (batch, N, k, make_inputs keywords): ViTDet-1024's
# global blocks (4096 queries over 32 x 32 pooled keys), the e2e path (1764
# over 21 x 21) and the paper's ViViT's cached product (12 views, 197 over
# 197 keys)
AV_SHAPES = {
    "1024": (2, 4096, 256, dict(window=(14, 14), windows=50, pool=(32, 32), pad_window=(14, 14))),
    "e2e": (1, 1764, 256, dict(window=(14, 14), pool=(21, 21))),
    "vivit_evblock": (12, 197, 24, dict(window=(4, 6), pool=(1, 197))),
}
AV_FORMS = ("softmax_select_matmul", "softmax_select_matmul_noterms",
            "softmax_select_matmul_logits", "softmax_select_matmul_logits_noterms")
AV_COVERAGES = ("none", "all", "one", "quarter")
_AV_INPUTS = {}  # shape -> bfloat16 inputs, made once per process


def _av_inputs(shape, device):
    if shape not in _AV_INPUTS:
        _AV_INPUTS.clear()
        torch.cuda.empty_cache()
        bsz, n, k, keywords = AV_SHAPES[shape]
        _AV_INPUTS[shape] = kernel_check.make_inputs(bsz, n, 768, 12, k, torch.bfloat16, device,
                                                     seed=4, **keywords)
    return _AV_INPUTS[shape]


def _coverage(d, which):
    """The (B, Np) column coverage: none, every column, one column, or the
    inputs' random quarter."""
    cov = d["av_cov"]
    if which == "none":
        return torch.zeros_like(cov)
    if which == "all":
        return torch.ones_like(cov)
    if which == "one":
        one = torch.zeros_like(cov)
        one[:, cov.shape[1] // 3] = 1.0
        return one
    return cov


@pytest.mark.parametrize("coverage", AV_COVERAGES)
@pytest.mark.parametrize("name", AV_FORMS)
@pytest.mark.parametrize("shape", sorted(AV_SHAPES))
def test_av_tensor_core_body_matches_plain(shape, name, coverage, device):
    """Both forms, with and without rel-pos terms, at the paths' shapes in
    bfloat16: one launch of the tensor-core body, within the bounds of
    ``kernel_check`` against the plain version, and the uncovered columns
    of p_a bit for bit as they went in."""
    d = dict(_av_inputs(shape, device))
    d["av_cov"] = _coverage(d, coverage)
    wrapper = kernel_check.KERNELS[name][0]
    before = dict(wrapper.body_launches)
    rows = kernel_check.errors(name, d)
    assert all(row["ok"] for row in rows), rows
    assert wrapper.body_launches == dict(before, tc=before["tc"] + 1)
    p_a = d["p_a"].clone()
    kernel_check._invoke(name, wrapper, dict(d, p_a=p_a))
    torch.cuda.synchronize()
    kept = (d["av_cov"] <= 0)[:, None, None, :].expand_as(p_a)
    assert torch.equal(p_a[kept], d["p_a"][kept])


@pytest.mark.parametrize("name", AV_FORMS)
def test_av_float32_stays_on_the_cuda_cores(name, device):
    """float32 calls, and the matmul-2 cast (float32 q, k and terms over
    bfloat16 state), take the CUDA-core body; the logits form's cast without
    terms is bfloat16 through and through, and takes the tensor-core one."""
    d = kernel_check.make_inputs(2, 37, 64, 4, 9, torch.float32, device, seed=5)
    wrapper = kernel_check.KERNELS[name][0]
    for cast in (False, True):
        if cast:
            for key in ("p_a", "p_v", "av_logits"):
                d[key] = d[key].to(torch.bfloat16)
        body = "tc" if cast and name == "softmax_select_matmul_logits_noterms" else "simt"
        before = dict(wrapper.body_launches)
        rows = kernel_check.errors(name, d)
        assert all(row["ok"] for row in rows), rows
        assert wrapper.body_launches == dict(before, **{body: before[body] + 1})


@pytest.mark.parametrize("name", ["softmax_select_matmul", "softmax_select_matmul_logits"])
def test_av_cuda_core_body_takes_4096_keys(name, device):
    """The CUDA-core body at ViTDet-1024's unpooled global attention (4096
    keys over a 64 x 64 grid, rel-pos terms), whose logits rows fit only 8
    to a tile: float32, and the matmul-2 cast (its A.V product then on the
    CUDA cores too), within the bounds of ``kernel_check``."""
    d = kernel_check.make_inputs(1, 64, 128, 2, 16, torch.float32, device, seed=6,
                                 pool=(64, 64), relpos_keys=(8, 8))
    wrapper = kernel_check.KERNELS[name][0]
    for cast in (False, True):
        if cast:
            for key in ("p_a", "p_v", "av_logits"):
                d[key] = d[key].to(torch.bfloat16)
        before = dict(wrapper.body_launches)
        rows = kernel_check.errors(name, d)
        assert all(row["ok"] for row in rows), rows
        assert wrapper.body_launches == dict(before, simt=before["simt"] + 1)


def test_av_entries_refuse_other_bodies(device):
    """The C entries refuse a body the rule would not send them: float32 to
    the tensor-core body, bfloat16 x bfloat16 to the CUDA-core body, a head
    width beyond 64 to the tensor-core body."""
    from eventful_transformer_tpu_torch.ops import _build

    d = kernel_check.make_inputs(2, 37, 64, 4, 9, torch.bfloat16, device, seed=6)
    out = torch.empty((2, 4, 37, 16), dtype=torch.bfloat16, device=device)

    def code(body, wd, sd, d_head=16):
        t = {key: d[key] if wd else d[key].float() for key in ("p_a", "p_v", "av_q", "av_k")}
        return _build.load_library().etk_softmax_select_matmul(
            body, wd, sd, t["p_a"].data_ptr(), d["av_cov"].data_ptr(), t["p_v"].data_ptr(),
            t["av_q"].data_ptr(), t["av_k"].data_ptr(), None, out.data_ptr(), 2, 4, 37, 21,
            d_head, 0, 0, 0.25, _build.stream_of(out))

    assert code(1, 0, 0) != 0
    assert code(0, 1, 1) != 0
    assert code(1, 1, 1, d_head=128) != 0
    assert code(1, 1, 1) == 0
    torch.cuda.synchronize()


# -- the warp-per-row pass of rows 1 and 9 ----------------------------------------------

ROW_PASS_N = 77  # tokens a batch row: 2 x 77 = 154 rows, no multiple of 8 (a block's rows)


def _row_pass_inputs(c, f, kp, dtype, device, seed=0):
    """Row 9's operands over (2, ROW_PASS_N) rows at widths c and f: kp
    slots naming distinct rows in no order, slot 1 invalid as -1 and slot 2
    as N; cov marks the rows the valid slots name and one more row that no
    slot names (its b' is 0)."""
    g = torch.Generator().manual_seed(seed)
    n = ROW_PASS_N

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g) * scale + shift).to(device=device, dtype=dtype)

    index = torch.stack([torch.randperm(n, generator=g)[:kp] for _ in range(2)])
    index[:, 1], index[:, 2] = -1, n
    cov = torch.zeros((2, n))
    for b in range(2):
        cov[b, index[b][(index[b] >= 0) & (index[b] < n)]] = 1.0
        named = set(index[b].tolist())
        cov[b, next(i for i in range(n) if i not in named)] = 1.0
    return dict(
        x=randn(2, n, c), p=randn(2, n, c), b=randn(2, n, f), h=randn(2, kp, f),
        skip=randn(2, n, f), p_next=randn(2, n, f), scale=randn(c, scale=0.1, shift=1.0),
        bias=randn(c, scale=0.1), next_scale=randn(f, scale=0.1, shift=1.0),
        next_bias=randn(f, scale=0.1), cov=cov.to(device),
        index=index.to(device=device, dtype=torch.int32),
    )


def _clone(t):
    """A copy of ``t`` at the same offset from a 16-byte boundary."""
    skip = t.data_ptr() % 16 // t.element_size()
    flat = torch.empty(t.numel() + skip, dtype=t.dtype, device=t.device)
    out = flat[skip:].view(t.shape)
    out.copy_(t)
    return out


def _select_scatter(fn, d, form):
    """Row 9 in ``form`` on copies of ``d`` (at their offsets from 16-byte
    boundaries): qkv (LN, no y), proj (no LN, the skip, the next norms), mlp
    (LN, x as the residual, the next norms) and the no-LN qkv and mlp
    forms."""
    d = {key: _clone(v) for key, v in d.items()}
    ln = form in ("qkv", "mlp")
    args = [d[k] for k in ("x", "p", "b", "cov", "index", "h")]
    args += [d["scale"], d["bias"]] if ln else [None, None]
    if form == "proj":
        args += [d["skip"], d["p_next"], d["next_scale"], d["next_bias"]]
    elif form == "mlp":
        args += [None, d["p_next"], d["next_scale"], d["next_bias"]]
    return fn(*args, apply_ln=ln, residual_x=form in ("mlp", "mlp_noln"))


def _hold_select_scatter(d, form, body):
    """Row 9 against its plain version: p' and the norms within
    kernel_check's bounds, b' and y bit for bit; one launch of ``body``."""
    from eventful_transformer_tpu_torch.ops import gate_block

    wrapper = gate_block.block_select_scatter
    before = dict(wrapper.row_body_launches)
    got = _select_scatter(wrapper, d, form)
    want = _select_scatter(gate_block.block_select_scatter_plain, d, form)
    torch.cuda.synchronize()
    assert wrapper.row_body_launches == dict(before, **{body: before[body] + 1})
    names = ("p", "b", "y", "norms")[:len(want)]
    assert len(got) == len(want)
    for name, a, b in zip(names, got, want):
        row = kernel_check.compare(a, b)
        assert row["ok"], (name, row)
        if name in ("b", "y"):
            assert torch.equal(a, b), name
    index = d["index"]
    batch, slot = torch.nonzero((index >= 0) & (index < ROW_PASS_N), as_tuple=True)
    named = torch.zeros_like(d["cov"], dtype=torch.bool)
    named[batch, index[batch, slot].long()] = True
    unnamed = (d["cov"] > 0) & ~named
    assert int(unnamed.sum()) == 2 and not got[1][unnamed].any()


ROW_PASS_FORMS = [
    ("qkv", 768, 2304), ("qkv_noln", 768, 2304), ("proj", 768, 768), ("mlp", 768, 768),
    ("mlp_noln", 768, 768), ("qkv", 64, 192), ("proj", 64, 64), ("mlp", 192, 192),
    ("proj", 192, 192), ("qkv", 192, 576),
]


@pytest.mark.parametrize("kp", [40, 64], ids=lambda k: f"kp{k}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("form,c,f", ROW_PASS_FORMS, ids=lambda v: str(v))
def test_select_scatter_warp_body_matches_plain(form, c, f, dtype, kp, device):
    """Row 9's warp-per-row body in every form at the paths' widths (C =
    768, F = 768 and 2304) and slim ones (64, 192), over 154 rows (no
    multiple of 8), kp = 40 (no multiple of 32) and 64, slots -1 and N, and
    a selected row that no slot names."""
    _hold_select_scatter(_row_pass_inputs(c, f, kp, dtype, device), form, "warp")


@pytest.mark.parametrize("case", ["width", "misaligned", "too_wide"])
def test_select_scatter_off_rule_takes_the_block_body(case, device):
    """A width that is no whole number of 16-byte vectors (C = F = 100 in
    bfloat16), operands off a 16-byte boundary, or a row beyond a warp's
    registers (F = 2308 in float32) take the block-per-row body, counted,
    with the same results."""
    if case == "width":
        d = _row_pass_inputs(100, 100, 40, torch.bfloat16, device)
    elif case == "too_wide":
        d = _row_pass_inputs(64, 2308, 40, torch.float32, device)
    else:
        d = _row_pass_inputs(64, 64, 40, torch.bfloat16, device)
        for key in ("x", "b"):
            flat = torch.empty(d[key].numel() + 1, dtype=d[key].dtype, device=device)
            view = flat[1:].view(d[key].shape)
            view.copy_(d[key])
            d[key] = view
    forms = ("qkv",) if case == "too_wide" else ("qkv", "proj", "mlp")
    for form in forms:
        _hold_select_scatter(d, form, "block")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [64, 192, 768, 2304, 100], ids=lambda c: f"c{c}")
def test_ln_norms_bodies_match_plain(c, dtype, device):
    """Row 1 over 154 rows at the paths' widths (768, 2304) and slim ones
    (64, 192) on the warp-per-row body, and at C = 100 (bfloat16: no whole
    16-byte vectors) on the block body; both within kernel_check's
    bounds."""
    from eventful_transformer_tpu_torch.ops import gate_fused, row_pass

    d = _row_pass_inputs(c, c, 40, dtype, device)
    body = row_pass.row_body(dtype, (c,))
    assert body == ("block" if c == 100 and dtype == torch.bfloat16 else "warp")
    before = dict(gate_fused.ln_norms.row_body_launches)
    got = gate_fused.ln_norms(d["x"], d["p"], d["scale"], d["bias"])
    want = gate_fused.ln_norms_plain(d["x"], d["p"], d["scale"], d["bias"])
    torch.cuda.synchronize()
    assert gate_fused.ln_norms.row_body_launches == dict(before, **{body: before[body] + 1})
    row = kernel_check.compare(got, want)
    assert row["ok"], row


def test_row_pass_entries_refuse_the_warp_body_off_rule(device):
    """The C entry refuses a warp-body call that breaks the rule: a width
    of no whole 16-byte vectors, a row beyond a warp's registers, an
    operand off a 16-byte boundary."""
    from eventful_transformer_tpu_torch.ops import _build

    lib = _build.load_library()

    def code(c, dtype=torch.bfloat16, offset=0):
        x = torch.randn(8 * c + 8, device=device).to(dtype)
        out = torch.empty(8, device=device)
        return lib.etk_ln_norms(_build.dtype_code(x), 1, x.data_ptr() + offset * x.element_size(),
                                x.data_ptr(), x.data_ptr(), x.data_ptr(), out.data_ptr(), 8, c,
                                _build.stream_of(x))

    assert code(100) != 0
    assert code(2308, torch.float32) != 0
    assert code(64, offset=1) != 0
    assert code(64) == 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["ln_norms", "block_select_scatter_qkv",
                                  "block_select_scatter_proj", "block_select_scatter_mlp",
                                  "block_select_scatter_mlp_noln", "block_select_p",
                                  "block_select_p_noln", "ln_select", "ln_select_noln"])
def test_row_pass_kernels_launch_once_and_allocate_their_outputs(name, dtype, device):
    """Rows 1, 9, 10 and 14 launch their one warp-body kernel once a call
    (row 9 no slot map) and allocate only their new outputs (rows 10 and
    14: none, p is updated in place)."""
    d = kernel_check.make_inputs(2, 197, 256, 4, 24, dtype, device)
    row = kernel_check.row_copy_profile(name, d, kernel_check.bound(name, d)[0])
    wrapper = kernel_check.KERNELS[name][0].__name__
    assert row["kernels_per_call"] == {kernel_check.ROW_PASS_KERNELS[wrapper]: 1}, row
    new_outputs = [out for out in kernel_check.KERNELS[name][4] if out not in ("p", "b")]
    assert row["allocations_per_call"] == len(new_outputs), row
    assert row["device_us"] > 0 and 0 < row["bound_share"]


# -- the warp-per-row select of rows 10 and 14 and the stages that share it ---------------

# (batch, N) of every path shape of rows 10 and 14 (ViTDet-1024, 672 and the
# e2e path's one stream; the paper's ViViT's 12 views and ViViT's 8) and a
# ragged one of 154 rows
SELECT_ROWS = [(2, 4096), (2, 1764), (1, 1764), (12, 197), (8, 197), (2, ROW_PASS_N)]
SELECT_WRAPPERS = {"block_select_p": ("ops.gate_block", "block_select_p"),
                   "ln_select": ("ops.gate_fused", "ln_select")}


def _select_fns(wrapper):
    import importlib

    module, name = SELECT_WRAPPERS[wrapper]
    module = importlib.import_module(f"eventful_transformer_tpu_torch.{module}")
    return getattr(module, name), getattr(module, f"{name}_plain")


def _select_inputs(bsz, n, c, dtype, device, seed=0):
    """x, p, scale and bias at a 16-byte boundary, and three coverages of
    (bsz, n): about 10 % of the rows selected, none, and every row."""
    g = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g) * scale + shift).to(device=device, dtype=dtype)

    covs = {"mixed": (torch.rand((bsz, n), generator=g) < 0.1).float(),
            "none": torch.zeros((bsz, n)), "all": torch.ones((bsz, n))}
    return dict(x=randn(bsz, n, c), p=randn(bsz, n, c), scale=randn(c, scale=0.1, shift=1.0),
                bias=randn(c, scale=0.1)), {k: v.to(device) for k, v in covs.items()}


def _hold_select(wrapper, d, cov, apply_ln, body):
    """One call of ``wrapper`` (rows 10 or 14) on copies of ``d`` at their
    offsets from 16-byte boundaries, against its plain version: within
    kernel_check's bounds with the LN, bit for bit without it, p unchanged
    bit for bit where cov selects no row; one launch of ``body``."""
    fn, plain = _select_fns(wrapper)
    d = {key: _clone(v) for key, v in d.items()}
    scale, bias = (d["scale"], d["bias"]) if apply_ln else (None, None)
    before = dict(fn.row_body_launches)
    got = fn(d["x"], d["p"].clone(), cov, scale, bias, apply_ln=apply_ln)
    want = plain(d["x"], d["p"].clone(), cov, scale, bias, apply_ln=apply_ln)
    torch.cuda.synchronize()
    assert fn.row_body_launches == dict(before, **{body: before[body] + 1})
    if not apply_ln or not bool((cov > 0).any()):
        assert torch.equal(got, want)
    row = kernel_check.compare(got, want)
    assert row["ok"], row
    if not bool((cov > 0).any()):
        assert torch.equal(got, d["p"])


@pytest.mark.parametrize("apply_ln", [True, False], ids=["ln", "no_ln"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows", SELECT_ROWS, ids=lambda r: "x".join(map(str, r)))
@pytest.mark.parametrize("wrapper", sorted(SELECT_WRAPPERS))
def test_select_warp_body_matches_plain(wrapper, rows, dtype, apply_ln, device):
    """Rows 10 and 14 on the warp-per-row body at every path shape (C =
    768) and a ragged one, in both dtypes and both forms, with about 10 %
    of the rows selected, none, and all: the no-LN select and an empty
    coverage bit for bit."""
    d, covs = _select_inputs(*rows, 768, dtype, device)
    for cov in covs.values():
        _hold_select(wrapper, d, cov, apply_ln, "warp")


@pytest.mark.parametrize("c", [64, 192, 2304], ids=lambda c: f"c{c}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_select_warp_body_at_other_widths(c, dtype, device):
    """The slim widths of the tests (64, 192) and 2304 (K = 9 or 18 vectors
    a lane) on the warp body, both forms."""
    d, covs = _select_inputs(2, ROW_PASS_N, c, dtype, device, seed=1)
    for apply_ln in (True, False):
        for cov in covs.values():
            _hold_select("block_select_p", d, cov, apply_ln, "warp")


@pytest.mark.parametrize("case", ["width", "misaligned"])
def test_select_off_rule_takes_the_block_body(case, device):
    """A width of no whole 16-byte vectors (C = 100 in bfloat16), or x off
    a 16-byte boundary, takes the block-per-row body, counted, with the
    same results."""
    c = 100 if case == "width" else 768
    d, covs = _select_inputs(2, ROW_PASS_N, c, torch.bfloat16, device, seed=2)
    if case == "misaligned":
        flat = torch.empty(d["x"].numel() + 1, dtype=d["x"].dtype, device=device)
        view = flat[1:].view(d["x"].shape)
        view.copy_(d["x"])
        d["x"] = view
    for wrapper in sorted(SELECT_WRAPPERS):
        for apply_ln in (True, False):
            _hold_select(wrapper, d, covs["mixed"], apply_ln, "block")


def test_select_entry_refuses_the_warp_body_off_rule(device):
    """etk_block_select_p refuses a warp-body call that breaks the rule (a
    width of no whole 16-byte vectors, a row beyond a warp's registers, an
    operand off a 16-byte boundary) and a call without a coverage."""
    from eventful_transformer_tpu_torch.ops import _build

    lib = _build.load_library()
    cov = torch.ones(8, device=device)

    def code(c, dtype=torch.bfloat16, offset=0, with_cov=True):
        x = torch.randn(8 * c + 8, device=device).to(dtype)
        p = torch.empty_like(x)
        return lib.etk_block_select_p(
            _build.dtype_code(x), 1, x.data_ptr() + offset * x.element_size(), p.data_ptr(),
            cov.data_ptr() if with_cov else None, x.data_ptr(), x.data_ptr(), 8, c,
            _build.stream_of(x))

    assert code(100) != 0
    assert code(2308, torch.float32) != 0
    assert code(64, offset=1) != 0
    assert code(64, with_cov=False) != 0
    assert code(64) == 0
    torch.cuda.synchronize()


# every wrapper whose select, LN or norms stage runs a row pass, by an entry
# of kernel_check.KERNELS
ROW_PASS_STAGES = [
    "qkv_attention_group", "proj_group", "dense_mlp_residual", "gate_group_mlp",
    "gate_group_mlp_pre", "gate_group_mlp_topk", "gate_group_linear", "gate_group_linear_post",
    "gate_group_linear_pre", "gate_group_linear_topk", "gate_group_linear_post_topk",
    "ln_select_matmul_post", "ln_select_matmul_none", "ln_select_matmul_pre",
    "select_linear_skip_norms", "select_linear_skip_norms_noln", "block_select_p",
    "block_select_p_noln", "ln_select", "ln_select_noln",
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ROW_PASS_STAGES)
def test_row_pass_stages_take_the_warp_body(name, dtype, device):
    """Each wrapper with a select, LN or norms row pass (kernels A and B,
    rows 4, 5, 7, 10, 12, 13 and 14 in every form, the LN pass without a
    coverage of rows 5 and 12 "pre" among them) within kernel_check's
    bounds at C = 256, counted once as "warp"."""
    wrapper = kernel_check.KERNELS[name][0]
    d = kernel_check.make_inputs(2, 197, 256, 4, 24, dtype, device, seed=6)
    kernel_check.reset_launches()
    rows = kernel_check.errors(name, d)
    assert all(row["ok"] for row in rows), rows
    assert wrapper.row_body_launches == {"block": 0, "warp": 1}
    assert kernel_check.row_body_launches()[wrapper.__name__] == {"block": 0, "warp": 1}


def test_misaligned_stage_takes_the_block_body(device):
    """Row 5's LN pass with x off a 16-byte boundary takes the block body
    (counted), within kernel_check's bounds."""
    from eventful_transformer_tpu_torch.ops.dense_mlp import (
        dense_mlp_residual,
        dense_mlp_residual_plain,
    )

    d = kernel_check.make_inputs(2, 37, 256, 4, 11, torch.bfloat16, device, seed=5)
    flat = torch.zeros(d["x"].numel() + 1, device=device, dtype=torch.bfloat16)
    x = flat[1:].view(d["x"].shape)
    x.copy_(d["x"])
    args = [d[k] for k in ("ln2_s", "ln2_b", "w1", "b1", "w2", "b2")]
    kernel_check.reset_launches()
    got = dense_mlp_residual(x, *args)
    assert dense_mlp_residual.row_body_launches == {"block": 1, "warp": 0}
    row = kernel_check.compare(got, dense_mlp_residual_plain(x, *args))
    assert row["ok"], row


# -- the rel-pos bias add's two bodies (rows 16 and 17) -----------------------------------

RELPOS_FORMS = ("relpos_bias_add", "relpos_bias_add_v2")
# (batch, heads, query grid, key grid): the paths' grids (672 dense and
# pooled, 1024 dense and its flush keys) at the 2-stream paths' 2 x 12, and
# two ragged ones
RELPOS_GRIDS = {
    "672_dense": (2, 12, (42, 42), (42, 42)), "672_pooled": (2, 12, (42, 42), (21, 21)),
    "1024_dense": (2, 12, (64, 64), (64, 64)), "1024_flush": (2, 12, (64, 64), (32, 32)),
    "wide_2x18": (2, 2, (2, 18), (1, 9)), "pooled_6x5": (2, 2, (6, 5), (3, 5)),
}


def _relpos_inputs(bsz, a, p, dtype, device, c=64, heads=2, seed=0):
    """x ~ N(0, 1) logits over (a, p), q ~ N(0, 1), tables at 0.3: the
    scales of ``kernel_check.make_inputs``."""
    g = torch.Generator().manual_seed(seed)
    n, np_ = a[0] * a[1], p[0] * p[1]

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(device=device, dtype=dtype)

    return (randn(bsz, heads, n, np_), randn(bsz, heads, n, c), randn(a[0], p[0], c, scale=0.3),
            randn(a[1], p[1], c, scale=0.3))


def _relpos_check(form, args, a, p, body):
    """One call of ``form`` on the card against its plain version on the
    same inputs: within ``kernel_check``'s bounds, one launch counted, of
    ``body``."""
    from eventful_transformer_tpu_torch.ops import relpos

    wrapper, plain = getattr(relpos, form), getattr(relpos, form + "_plain")
    before = dict(wrapper.body_launches)
    got = wrapper(*args, a=a, p=p)
    want = plain(*args, a=a, p=p)
    torch.cuda.synchronize()
    assert wrapper.body_launches == dict(before, **{body: before[body] + 1})
    result = kernel_check.compare(got, want)
    assert result["ok"], result
    return got


@pytest.mark.parametrize("grid", sorted(RELPOS_GRIDS))
@pytest.mark.parametrize("form", RELPOS_FORMS)
def test_relpos_tiled_body_matches_plain(form, grid, device):
    """bfloat16 at the paths' grids and at ragged ones (key rows of 9 and
    5: p1 < 8 takes the one-element path) on the tiled body, within
    ``kernel_check``'s bounds of the plain version."""
    bsz, heads, a, p = RELPOS_GRIDS[grid]
    _relpos_check(form, _relpos_inputs(bsz, a, p, torch.bfloat16, device, heads=heads), a, p,
                  "tile")
    torch.cuda.empty_cache()


@pytest.mark.parametrize("c", [16, 40])
@pytest.mark.parametrize("form", RELPOS_FORMS)
def test_relpos_tiled_body_at_other_head_widths(form, c, device):
    """c = 16 and 40 (a width of no 32-byte multiple) on the tiled body."""
    a, p = (42, 42), (21, 21)
    _relpos_check(form, _relpos_inputs(1, a, p, torch.bfloat16, device, c=c, heads=3), a, p,
                  "tile")


@pytest.mark.parametrize("form", RELPOS_FORMS)
def test_relpos_float32_and_misaligned_stay_on_the_cuda_cores(form, device):
    """float32, and a bfloat16 q or x_rel 2 bytes off its 16-byte boundary,
    take the CUDA-core body, within the bounds of the plain version."""
    a, p = (6, 10), (3, 5)
    _relpos_check(form, _relpos_inputs(2, a, p, torch.float32, device), a, p, "simt")
    x, q, y_rel, x_rel = _relpos_inputs(2, a, p, torch.bfloat16, device)

    def shifted(t):
        out = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)[1:].view(t.shape)
        out.copy_(t)
        assert out.data_ptr() % 16 and out.is_contiguous()
        return out

    _relpos_check(form, (x, shifted(q), y_rel, x_rel), a, p, "simt")
    _relpos_check(form, (x, q, y_rel, shifted(x_rel)), a, p, "simt")


def test_relpos_other_rounding_fails_the_bounds(device):
    """At the 672 pooled shape each form's tiled output fails
    ``kernel_check``'s bounds against the other form's plain version: the
    check tells the two rounding rules apart on the card."""
    from eventful_transformer_tpu_torch.ops import relpos

    a, p = (42, 42), (21, 21)
    args = _relpos_inputs(1, a, p, torch.bfloat16, device, seed=2)
    v1 = _relpos_check("relpos_bias_add", args, a, p, "tile")
    v2 = _relpos_check("relpos_bias_add_v2", args, a, p, "tile")
    assert not kernel_check.compare(v1, relpos.relpos_bias_add_v2_plain(*args, a=a, p=p))["ok"]
    assert not kernel_check.compare(v2, relpos.relpos_bias_add_plain(*args, a=a, p=p))["ok"]


@pytest.mark.parametrize("form", RELPOS_FORMS)
def test_relpos_launches_once_and_allocates_its_output(form, device):
    """A bfloat16 call at the 672 pooled shape launches the tiled kernel
    once and allocates only its output."""
    from eventful_transformer_tpu_torch.ops import relpos

    a, p = (42, 42), (21, 21)
    args = _relpos_inputs(1, a, p, torch.bfloat16, device)
    call = lambda: getattr(relpos, form)(*args, a=a, p=p)  # noqa: E731
    us, kernels = kernel_check.device_us(call)
    assert kernels == {"relpos_bias_add_tile_kernel": 1} and us > 0, kernels
    assert kernel_check.allocations(call) == 1


def test_relpos_entry_refuses_off_rule_calls(device):
    """The C entry refuses a tiled call the rule would not send it (float32,
    q off 16 bytes, a head width of no 16-byte rows, a tile that does not
    divide the grid or is wider than 16) and a CUDA-core call with x off 16
    bytes, or of an unknown body."""
    from eventful_transformer_tpu_torch.ops import _build

    a, p = (2, 18), (1, 9)
    x, q, y_rel, x_rel = _relpos_inputs(2, a, p, torch.bfloat16, device)
    out = torch.empty_like(x)
    lib = _build.load_library()

    def code(body, dtype=1, c=64, q_off=0, x_off=0, rows=2, cols=9):
        return lib.etk_relpos_bias_add(
            body, dtype, 1, x.data_ptr() + 2 * x_off, q.data_ptr() + 2 * q_off,
            y_rel.data_ptr(), x_rel.data_ptr(), out.data_ptr(), 4, a[0], a[1], p[0], p[1], c,
            rows, cols, _build.stream_of(x))

    assert code(1, dtype=0) != 0
    assert code(1, q_off=1) != 0
    assert code(1, c=60) != 0
    assert code(1, cols=4) != 0
    assert code(1, cols=18) != 0
    assert code(0, x_off=1) != 0
    assert code(2) != 0
    assert code(1) == 0 and code(1, rows=1, cols=6) == 0 and code(0) == 0
    torch.cuda.synchronize()


ATS_MLP_ROWS = (361, 292, 111)  # EPIC-Kitchens ViViT-B's MLP tokens under ATS 0.9


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", ATS_MLP_ROWS)
def test_dense_mlp_at_the_ats_token_counts(n, dtype, device):
    """Row 5 on 12 views of an ATS block's reduced token count (the first,
    third and last spatial block's MLP at EPIC-Kitchens ViViT-B)."""
    wrapper = kernel_check.KERNELS["dense_mlp_residual"][0]
    before = wrapper.launches
    inputs = kernel_check.make_inputs(12, n, 768, 12, n, dtype, device, seed=2)
    rows = kernel_check.errors("dense_mlp_residual", inputs)
    assert all(row["ok"] for row in rows), rows
    assert wrapper.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ats_indices_on_the_card_equal_the_cpu_on_planted_ties(dtype, device):
    """ATS on the card samples the CPU's tokens where the scores tie
    exactly at the k-th (ties to the smallest index, as lax.top_k): 4 tied
    tokens straddle the cut of 9 of 17, in every view and head."""
    from eventful_transformer_tpu_torch.core.blocks import Block

    g = torch.Generator().manual_seed(0)
    n, heads, d, b = 17, 4, 16, 6
    column = torch.tensor([0.5] + [0.9 - 0.05 * i for i in range(6)] + [0.25] * 4
                          + [0.1 - 0.01 * i for i in range(6)])
    perm = torch.cat([torch.zeros(1, dtype=torch.long), 1 + torch.randperm(n - 1, generator=g)])
    column = column[perm]
    a = torch.rand((b, heads, n, n), generator=g)
    a[..., 0] = column
    v = torch.randn((b, heads, n, d), generator=g)
    v = v / v.norm(dim=-1, keepdim=True)
    tied = (column == 0.25).nonzero()[:, 0]
    v[..., tied, :] = v[..., tied[:1], :]
    blk = Block(dim=64, heads=heads, mlp_ratio=2, input_size=(4, 4), ats_fraction=0.5)
    got = {}
    for where in ("cpu", device):
        state = blk.init_state(b, n, None, where)
        for _ in range(2):  # the second call stabilises against the first
            _, index, state = blk._adaptive_token_sampling(
                state, a.to(where, dtype), v.to(where, dtype))
            got.setdefault(str(where), []).append(index.cpu())
    for cpu, card in zip(got["cpu"], got[str(device)]):
        assert torch.equal(cpu, card)
    kept = set(got["cpu"][0][0].tolist())
    assert set(tied[:2].tolist()) <= kept and not set(tied[2:].tolist()) & kept


@pytest.mark.parametrize("helper", ["time_jitted", "time_jitted_pair", "time_repeated"])
def test_timers_wait_for_a_card_callable_given_host_arguments(helper, device):
    """A callable that moves its host argument to the card and keeps the
    card busy for about 20 ms is timed to the end of that work."""
    from eventful_transformer_tpu_torch.utils import timing

    cycles_per_ms = torch.cuda.get_device_properties(device).clock_rate  # kHz

    def busy(x):
        y = x.to(device)
        torch.cuda._sleep(20 * cycles_per_ms)
        return y + 1

    args = (torch.zeros(4),)
    if helper == "time_jitted":
        seconds = timing.time_jitted(busy, args, iters=3)
    elif helper == "time_jitted_pair":
        seconds = timing.time_jitted_pair(busy, args, busy, args, iters=3)[1]
    else:
        seconds = timing.time_repeated(busy, args, repeat=2, iters=3)
    assert seconds > 0.015, seconds


# -- the grad guard, a training step and the COCO heads on the card ------------------


def test_grad_guard_refuses_operands_that_require_grad(device):
    """In grad mode every card path's operand check refuses an operand that
    requires grad (no kernel has a backward): ``check_operands`` (row 5),
    the one-pass checks of rows 10 and 14 (``gate_block.select_args``), 11,
    19 and 20 (``scatter.cuda_operands``) and 18 (``scatter_blend``). Under
    ``torch.no_grad()`` the same call launches."""
    from eventful_transformer_tpu_torch.ops import gate_block, scatter
    from eventful_transformer_tpu_torch.ops.dense_mlp import dense_mlp_residual
    from eventful_transformer_tpu_torch.ops.scatter_blend import scatter_blend

    d = kernel_check.make_inputs(2, 24, 64, 4, 9, torch.float32, device, seed=2)
    w1 = d["w1"].clone().requires_grad_()
    args = (d["x"], d["ln2_s"], d["ln2_b"], w1, d["b1"], d["w2"], d["b2"])
    with pytest.raises(RuntimeError, match="requires grad"):
        dense_mlp_residual(*args)
    before = dense_mlp_residual.launches
    with torch.no_grad():
        dense_mlp_residual(*args)
    assert dense_mlp_residual.launches == before + 1
    scale = d["ln1_s"].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="requires grad"):
        gate_block.block_select_p(d["x"], d["p_qkv"], d["cov1"], scale, d["ln1_b"], apply_ln=True)
    buffer = torch.randn(2, 24, 128, device=device, requires_grad=True)
    index = torch.randint(0, 24, (2, 5), device=device, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="requires grad"):
        scatter.gather_rows(buffer, index)
    with pytest.raises(RuntimeError, match="requires grad"):
        scatter_blend(buffer, torch.randn(2, 5, 128, device=device), index)


TRAIN_BLOCKS = {
    "Block": dict(),
    "EventfulTokenwiseBlock": dict(fused_gates="v4"),
    "EventfulBlock": dict(fused_gates="v2mlp", av_kernel=True),
}


@pytest.mark.parametrize("name", sorted(TRAIN_BLOCKS))
def test_training_block_on_the_card_backpropagates(name, device):
    """A block under ``Ctx(training=True)`` on the card (a flush and two
    incremental steps for the eventful ones, forced to a kernel regime):
    no kernel launched, ``loss.backward()`` reaches every parameter, and
    the gradients equal the CPU's within 1e-4 of each one's largest
    magnitude (float32, TF32 off)."""
    from eventful_transformer_tpu_torch.core import blocks
    from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    torch.backends.cudnn.allow_tf32 = False
    block = blocks.BLOCK_CLASSES[name](dim=64, heads=4, mlp_ratio=2, input_size=(4, 5))
    for module in block.modules():
        if hasattr(module, "reset_parameters"):
            module.reset_parameters(torch.Generator().manual_seed(3))
    for key, value in TRAIN_BLOCKS[name].items():
        setattr(block, key, value)
    eventful = name != "Block"
    if eventful:
        set_policies(block, TokenNormTopK, k=6)
    xs = torch.randn(3, 2, 20, 64, generator=torch.Generator().manual_seed(4))
    grads = {}
    for where, blk in (("cpu", block), ("card", copy.deepcopy(block).to(device))):
        kernel_check.reset_launches()
        ctx = Ctx(training=True, generator=torch.Generator(device=where if where == "cpu" else device))
        state = blk.init_state(2, 20, torch.float32, xs.device if where == "cpu" else device)
        ys = []
        for t in range(3 if eventful else 1):
            mode = ("flush" if t == 0 else "incremental") if eventful else None
            y, state, _ = blk(ctx, state, xs[t].to(next(blk.parameters()).device), mode=mode)
            ys.append(y)
        torch.stack(ys).square().mean().backward()
        grads[where] = {n: p.grad.cpu() for n, p in blk.named_parameters()}
        assert all(fn.launches == 0 for fn, *_ in kernel_check.KERNELS.values())
    for n, want in grads["cpu"].items():
        got = grads["card"][n]
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), n


def _coco_heads(with_mask=True):
    from eventful_transformer_tpu_torch.detection.roi_heads import CascadeROIHeads

    heads = CascadeROIHeads(num_classes=80, in_channels=256, with_mask=with_mask)
    generator = torch.Generator().manual_seed(5)
    for module in heads.modules():
        if hasattr(module, "reset_parameters"):
            module.reset_parameters(generator)
    with torch.no_grad():
        for stage in heads.stages:
            stage.cls_score.kernel.mul_(30.0)
        if with_mask:
            heads.mask_head.predictor.kernel.mul_(300.0)
    return heads


def _coco_features(seed=6):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((1, 1024 // s, 1024 // s, 256), generator=g) for s in (4, 8, 16, 32)]


def test_cascade_and_mask_heads_on_the_card_match_the_cpu(device):
    """The COCO heads at their sizes (80 classes, 256 channels, p2-p5 of a
    1024 x 1024 image, 300 proposals, 100 detections of 28 x 28 masks) in
    float32 on the card against the CPU, cuDNN without TF32: detections
    matched by ``chip_smoke.match_masks`` (boxes, scores, labels and the
    masks of the matched ones)."""
    import chip_smoke

    torch.backends.cudnn.allow_tf32 = False
    heads = _coco_heads()
    feats = _coco_features()
    g = torch.Generator().manual_seed(7)
    corner = torch.rand((300, 2), generator=g) * 900
    props = torch.cat([corner, corner + 16 + torch.rand((300, 2), generator=g) * 300], 1)
    props = props.clamp(max=1024.0)
    mask = torch.rand(300, generator=g) < 0.9
    with torch.no_grad():
        want = heads.inference(feats, props, mask, (1024, 1024))
        card = copy.deepcopy(heads).to(device)
        got = card.inference([f.to(device) for f in feats], props.to(device), mask.to(device),
                             (1024, 1024))
    assert got["masks"].shape == (100, 28, 28)
    match = chip_smoke.match_masks(got, want)
    assert match["ok"] and match["matched"] > 50, match


def test_mask_head_on_the_card_matches_the_cpu(device):
    """MaskHead alone at the COCO sizes on the same boxes and labels: the
    masks within 1e-4 (float32, cuDNN without TF32)."""
    torch.backends.cudnn.allow_tf32 = False
    head = _coco_heads().mask_head
    feats = _coco_features(seed=8)
    g = torch.Generator().manual_seed(9)
    corner = torch.rand((100, 2), generator=g) * 800
    boxes = torch.cat([corner, corner + 8 + torch.rand((100, 2), generator=g) * 200], 1)
    labels = torch.randint(0, 80, (100,), generator=g, dtype=torch.int32)
    with torch.no_grad():
        want = head.inference(feats, boxes, labels)
        got = copy.deepcopy(head).to(device).inference([f.to(device) for f in feats],
                                                      boxes.to(device), labels.to(device))
    assert float(want.std()) > 0.05
    assert float((got.cpu() - want).abs().max()) <= 1e-4


def _loss_boxes(g, n, size=(8.0, 40.0)):
    corner = torch.rand((n, 2), generator=g) * 200
    return torch.cat([corner, corner + size[0] + torch.rand((n, 2), generator=g) * size[1]], 1)


def test_detection_losses_on_the_card_match_the_cpu(device):
    """rpn_losses, sample_proposals and fast_rcnn_losses on the card and on
    the CPU with the same uniforms: the samples equal, the losses and their
    gradients within 1e-5 relative."""
    from eventful_transformer_tpu_torch.detection import training

    g = torch.Generator().manual_seed(11)
    anchors, proposals = _loss_boxes(g, 2000), _loss_boxes(g, 300)
    gt = torch.cat([proposals[:6] + 2.0, torch.zeros(2, 4)])
    gt_mask = torch.arange(8) < 6
    gt_classes = torch.randint(0, 30, (8,), generator=g, dtype=torch.int32)
    logits, deltas = torch.randn(2000, generator=g), torch.randn(2000, 4, generator=g)
    scores, boxes = torch.randn(308, 31, generator=g), _loss_boxes(g, 308)
    u_rpn = (torch.rand(2000, generator=g), torch.rand(2000, generator=g))
    u_roi = (torch.rand(308, generator=g), torch.rand(308, generator=g))

    def run(on):
        leaves = [t.to(on).requires_grad_() for t in (logits, deltas, scores, boxes)]
        out = training.rpn_losses(u_rpn, anchors.to(on), leaves[0], leaves[1], gt.to(on),
                                  gt_mask.to(on))
        samples = training.sample_proposals(u_roi, proposals.to(on), torch.ones(300, dtype=bool,
                                            device=on), gt.to(on), gt_classes.to(on),
                                            gt_mask.to(on), num_classes=30)
        out.update(training.fast_rcnn_losses(leaves[2], leaves[3], samples[1], samples[2],
                                             samples[3], 30))
        sum(out.values()).backward()
        return ({k: float(v.detach()) for k, v in out.items()}, [s.cpu() for s in samples],
                [t.grad.cpu() for t in leaves])

    card, card_samples, card_grads = run(device)
    cpu, cpu_samples, cpu_grads = run(torch.device("cpu"))
    for a, b in zip(card_samples, cpu_samples):
        assert torch.equal(a, b)
    for key, value in cpu.items():
        assert abs(card[key] - value) <= 1e-5 * abs(value), key
    for a, b in zip(card_grads, cpu_grads):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_training_apply_views_on_the_card_launches_no_kernel(device):
    """A tiny dense ViViT on the card: under Ctx(training=True) apply_views
    follows the caller's grad mode (a gradient reaches every parameter) and
    launches no kernel; in serving it runs under no_grad and launches rows
    5 and 6."""
    from eventful_transformer_tpu_torch.models import FactorizedViViT
    from eventful_transformer_tpu_torch.parallel.dryrun import TRAIN_MODEL

    spatial = dict(TRAIN_MODEL["spatial_config"])
    spatial["block_config"] = dict(spatial["block_config"], drop_path_rate=0.0)
    model = FactorizedViViT(**dict(TRAIN_MODEL, dropout_rate=0.0, spatial_config=spatial),
                            device=device)
    views = torch.randn(2, 2, 8, 3, 32, 32, device=device)
    kernel_check.reset_launches()
    probs = model.apply_views(Ctx(training=True, generator=torch.Generator(device=device)),
                              views)
    probs.sum().backward()
    assert all(p.grad is not None for p in model.parameters())
    launched = {name: entry[0].launches for name, entry in kernel_check.KERNELS.items()}
    assert not any(launched.values()), launched
    served = model.apply_views(Ctx(), views)
    assert not served.requires_grad
    assert kernel_check.KERNELS["dense_mlp_residual"][0].launches > 0
    assert kernel_check.KERNELS["window_attention"][0].launches > 0
    torch.testing.assert_close(served, probs.detach(), rtol=1e-4, atol=1e-6)


# -- the float32 bodies: csrc/gemm.cuh's CUDA-core tile and row 8's CUDA-core body --

SIMT_EDGES = [(1, 768, 768, False), (197, 384, 2304, True), (300, 3072, 3072, True),
              (197, 770, 768, False), (130, 768, 100, True), (64, 100, 130, False)]


def _simt_operands(m, k, n, gather, device, seed=0):
    """float32 A, W and (gathered) int32 rows of the tile's tests: a third of
    the slots -1 (zero rows)."""
    g = torch.Generator().manual_seed(seed)
    a = torch.randn((m + 5, k), generator=g)
    w = torch.randn((k, n), generator=g) * k ** -0.5
    idx = None
    if gather:
        idx = torch.randint(0, m + 5, (m,), generator=g, dtype=torch.int32)
        idx[::3] = -1
    to = lambda t: None if t is None else t.to(device)  # noqa: E731
    return to(a if gather else a[:m].contiguous()), to(w), to(idx)


@pytest.mark.parametrize("m,k,n,gather", SIMT_EDGES,
                         ids=[f"{m}x{k}x{n}-{'gather' if g else 'dense'}"
                              for m, k, n, g in SIMT_EDGES])
def test_float32_tile_matches_the_product_and_every_tile_alike(m, k, n, gather, device):
    """The float32 tile alone at its edges (M = 1, M and N off the tile, K
    not a multiple of 4, gathered rows with -1 slots): within float32
    summation error of the float64 product, and the same bits from each tile
    of SIMT_TILES and from an operand off a 16-byte boundary (the scalar
    copies): one fmaf chain an output, in k order, whatever the tile."""
    from eventful_transformer_tpu_torch.ops import gemm_core

    a, w, idx = _simt_operands(m, k, n, gather, device)
    rows = a if idx is None else torch.where((idx >= 0)[:, None], a[idx.long().clamp(min=0)], 0)
    want = torch.matmul(rows.double(), w.double())
    before = gemm_core.gemm_simt.launches
    outs = [gemm_core.gemm_simt(a, w, idx, tile=t) for t in range(len(gemm_core.SIMT_TILES))]
    flat = torch.zeros(a.numel() + 1, device=device)
    flat[1:] = a.reshape(-1)
    outs.append(gemm_core.gemm_simt(flat[1:].view(a.shape), w, idx))
    torch.cuda.synchronize()
    assert gemm_core.gemm_simt.launches == before + len(outs)
    err = float(((outs[0].double() - want).abs() / want.abs().clamp(min=1.0)).max())
    assert err <= 1e-5, err
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


def test_float32_tile_refuses_an_unknown_tile(device):
    from eventful_transformer_tpu_torch.ops import gemm_core

    a, w, _ = _simt_operands(8, 64, 64, False, device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        gemm_core.gemm_simt(a, w, tile=len(gemm_core.SIMT_TILES))


SIMT_ROWS = ["dense_mlp_residual", "gate_group_mlp", "gate_group_mlp_pre", "gate_group_mlp_topk",
             "gate_group_mlp_threshold", "gate_group_linear", "gate_group_linear_post",
             "gate_group_linear_pre", "gate_group_linear_threshold", "qkv_attention_group",
             "proj_group", "ln_select_matmul_post", "ln_select_matmul_none",
             "ln_select_matmul_pre", "select_linear_skip_norms", "select_linear_skip_norms_noln"]


@pytest.mark.parametrize("shape", [(1, 1, 64, 2, 1), (3, 37, 96, 2, 11)],
                         ids=["m1", "n96"])
@pytest.mark.parametrize("name", SIMT_ROWS)
def test_float32_gemm_rows_at_the_edges(name, shape, device):
    """Every epilogue of rows 2-5, 7, 12 and 13 on the float32 tile at one
    row and at N = 96 (off both tiles), within kernel_check's bounds, every
    GEMM launch on "simt"."""
    wrapper = kernel_check.KERNELS[name][0]
    d = kernel_check.make_inputs(*shape, torch.float32, device, seed=3)
    before = dict(wrapper.core_launches)
    rows = kernel_check.errors(name, d)
    assert all(row["ok"] for row in rows), rows
    after = wrapper.core_launches
    assert after["simt"] > before["simt"]
    assert {core: after[core] - before[core] for core in after if core != "simt"} == {
        "tc": 0, "wmma": 0}


AV_KEY_GRIDS = {1: (1, 1), 17: (1, 17), 197: (1, 197), 441: (21, 21), 1024: (32, 32),
                4096: (64, 64)}


@pytest.mark.parametrize("coverage", ["all", "none", "quarter"])
@pytest.mark.parametrize("d", [48, 64])
@pytest.mark.parametrize("np_", sorted(AV_KEY_GRIDS))
def test_av_cuda_core_body_at_every_key_count(np_, d, coverage, device):
    """Row 8's CUDA-core body at Np = 1, 17, 197, 441, 1024 and 4096 keys,
    head widths 48 and 64, coverage all, none and a quarter: both forms with
    and without rel-pos terms, in float32 and under the matmul-2 cast
    (bfloat16 state), each one "simt" launch within kernel_check's bounds,
    and the uncovered columns of p_a bit for bit as they went in."""
    d_in = kernel_check.make_inputs(1, 70, 2 * d, 2, 9, torch.float32, device, seed=7,
                                    pool=AV_KEY_GRIDS[np_])
    d_in["av_cov"] = _coverage(d_in, "one" if coverage == "quarter" and np_ == 1 else coverage)
    for cast in (False, True):
        dd = dict(d_in)
        if cast:
            for key in ("p_a", "p_v", "av_logits"):
                dd[key] = dd[key].to(torch.bfloat16)
        for name in AV_FORMS:
            if cast and name == "softmax_select_matmul_logits_noterms":
                continue  # bfloat16 through and through: the tensor-core body
            wrapper = kernel_check.KERNELS[name][0]
            before = dict(wrapper.body_launches)
            rows = kernel_check.errors(name, dd)
            assert all(row["ok"] for row in rows), (name, cast, rows)
            assert wrapper.body_launches == dict(before, simt=before["simt"] + 1)
            p_a = dd["p_a"].clone()
            kernel_check._invoke(name, wrapper, dict(dd, p_a=p_a))
            torch.cuda.synchronize()
            kept = (dd["av_cov"] <= 0)[:, None, None, :].expand_as(p_a)
            assert torch.equal(p_a[kept], dd["p_a"][kept])


# -- the captured steps (utils/graphs.py) ------------------------------------------------


def _graph_vivit(device, dtype):
    from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
    from eventful_transformer_tpu_torch.models import FactorizedViViT
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    block = dict(dim=64, heads=4, mlp_ratio=4)
    model = FactorizedViViT(
        classes=10, input_shape=[8, 3, 32, 32], normalize_mean=0.45, normalize_std=0.225,
        spatial_views=1, temporal_stride=2, temporal_views=2, tubelet_shape=[2, 8, 8],
        spatial_config=dict(depth=2, position_encoding_size=[4, 4],
                            block_class="EventfulTokenwiseBlock", block_config=block),
        temporal_config=dict(depth=1, position_encoding_size=[4], block_config=block),
        device=device,
    ).to(dtype)
    set_policies(model, TokenNormTopK, k=8)
    views = torch.randn((1, 2, 8, 3, 32, 32), generator=torch.Generator().manual_seed(3))
    return model, views.to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_graph_vivit_step_equals_the_eager_step(dtype, device):
    """A small eventful ViViT through make_vivit_step captured and eager:
    probabilities bit for bit (a flush and 3 incremental steps a view),
    counts and launches equal, replays alike; another k captures a second
    graph."""
    from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
    from eventful_transformer_tpu_torch.utils.evaluate import make_vivit_step
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    model, views = _graph_vivit(device, dtype)
    eager, graph = make_vivit_step(model, graph=False), make_vivit_step(model)
    assert eager.graph is None and graph.graph is not None
    want, want_counts = eager(views)
    kernel_check.reset_launches()
    eager(views)
    want_launches = {k: e[0].launches for k, e in kernel_check.KERNELS.items()}
    got, counts = graph(views)
    kernel_check.reset_launches()
    again, _ = graph(views)
    launches = {k: e[0].launches for k, e in kernel_check.KERNELS.items()}
    assert torch.equal(got, want) and torch.equal(again, want)
    assert counts == want_counts and launches == want_launches
    assert graph.graph.captures == 1
    set_policies(model, TokenNormTopK, k=4)
    got, counts = graph(views)
    assert graph.graph.captures == 2
    want, want_counts = eager(views)
    assert torch.equal(got, want) and counts == want_counts


@pytest.mark.parametrize("regime", ["v2", "blocked"])
def test_graph_vitdet_backbone_equals_the_eager_backbone(regime, device):
    """A small eventful ViTDet backbone (2 streams) through its captured
    step and its eager step, a flush and 3 incremental frames, twice (the
    second video's fresh state copied into the static state): tokens and
    the final state bit for bit, counts equal; one graph a mode."""
    from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
    from eventful_transformer_tpu_torch.models import ViTDet
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    block = dict(dim=64, heads=4, mlp_ratio=2, window_size=[3, 3],
                 relative_embedding_size=[8, 8], pool_size=2)
    model = ViTDet(
        backbone_config=dict(depth=4, position_encoding_size=[4, 4], window_indices=[0, 2],
                             block_class="EventfulBlock", windowed_class="EventfulTokenwiseBlock",
                             windowed_overrides=dict(pool_size=None), block_config=block),
        classes=5, input_shape=[3, 96, 96], normalize_mean=[0.0] * 3, normalize_std=[1.0] * 3,
        output_channels=16, patch_size=[16, 16], scale_factors=[1.0], device=device,
    )
    set_policies(model, TokenNormTopK, k=12)
    for blk in model.backbone.blocks:
        blk.fused_gates = regime
    aux = model.precompute()
    eager, graph = model.backbone_step(aux, graph=False), model.backbone_step(aux)
    frames = torch.rand((4, 2, 3, 96, 96), generator=torch.Generator().manual_seed(0)).to(device)
    with torch.no_grad():
        for _ in range(2):
            states = [model.init_state(2, torch.float32, device) for _ in range(2)]
            for t in range(4):
                x = model.pre_backbone(Ctx(), frames[t])
                mode = "flush" if t == 0 else "incremental"
                want, states[0], want_counts = eager(states[0], x, mode=mode)
                got, states[1], counts = graph(states[1], x, mode=mode)
                assert torch.equal(got, want), t
                assert counts == want_counts, t
            for (_, a), (_, b) in zip(_state_leaves(states[0]), _state_leaves(states[1])):
                assert torch.equal(a, b)
    assert graph.captures == 2
    assert {w["mode"] for w in graph.write_back_summary()} == {"flush", "incremental"}


def _state_leaves(state):
    from eventful_transformer_tpu_torch.utils.graphs import leaves

    return list(leaves(state))


def test_graph_capture_launches_on_the_capture_stream(device):
    """Inside a capture the wrappers' stream (ops/_build.py: the raw
    current stream) is the capture stream, not the stream of the caller."""
    from eventful_transformer_tpu_torch.ops import _build
    from eventful_transformer_tpu_torch.utils.graphs import GraphStep

    model, views = _graph_vivit(device, torch.float32)
    seen = []

    def fn(ctx, v):
        seen.append((_build.stream_on(v.get_device()), torch.cuda.current_stream().cuda_stream))
        return model.apply_views(ctx, v)

    step = GraphStep(model, fn)
    with torch.no_grad():
        step(views)
    (warm, warm_current), (captured, current) = seen
    assert warm == warm_current and captured == current
    assert captured != torch.cuda.default_stream().cuda_stream


def test_graph_capture_meeting_a_host_sync_raises(device, monkeypatch):
    """A host synchronisation inside the step (planted in the "v4" step's
    top-k coverage) fails the capture with the line of the port it came
    through; the step is not run eagerly, and the card serves the next
    capture."""
    from eventful_transformer_tpu_torch.core import blocks
    from eventful_transformer_tpu_torch.utils.evaluate import make_vivit_step
    from eventful_transformer_tpu_torch.utils.graphs import CaptureError

    model, views = _graph_vivit(device, torch.float32)
    want, _ = make_vivit_step(model, graph=False)(views)
    coverage = blocks.coverage_from_norms

    def syncing(norms, k):
        float(norms.sum())
        return coverage(norms, k)

    monkeypatch.setattr(blocks, "coverage_from_norms", syncing)
    step = make_vivit_step(model)
    with pytest.raises(CaptureError, match="capture failed at eventful_transformer_tpu_torch/core"):
        step(views)
    assert step.graph.captures == 0
    monkeypatch.setattr(blocks, "coverage_from_norms", coverage)
    got, _ = make_vivit_step(model)(views)
    assert torch.equal(got, want)


# -- row 22: NMS on the card (csrc/nms.cu) -------------------------------------------------

NMS_CASES = ["random", "ties", "threshold", "chains", "all_invalid", "few_valid", "sorted",
             "signed_zeros"]
NMS_SHAPES = [(900, 64, 0.5), (900, 1000, 0.7), (4096, 100, 0.5), (4096, 300, 0.7),
              (4096, 1000, 0.7), (5, 3, 0.7), (70, 100, 0.5), (1025, 300, 0.7)]


def _nms_check(boxes, scores, threshold, max_out):
    """The kernel through ``detection/nms.py::nms_padded`` against the plain
    version and the Python model of its design (``torch_nms_contract.walk``),
    index for index, the masked slots included: one launch a call, no host
    read. Returns the model's stats."""
    from eventful_transformer_tpu_torch.detection import nms
    from eventful_transformer_tpu_torch.ops import nms as nms_kernel
    from torch_nms_contract import walk

    launches, syncs = nms_kernel.nms_padded.launches, nms.host_syncs
    got = nms.nms_padded(boxes, scores, threshold, max_out)
    assert (nms_kernel.nms_padded.launches, nms.host_syncs) == (launches + 1, syncs)
    want = nms.nms_padded_plain(boxes, scores, threshold, max_out)
    walk_idx, walk_mask, count, stats = walk(boxes.cpu(), scores.cpu(), threshold, max_out)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and torch.equal(a, w), (a, w)
    assert torch.equal(got[0].cpu(), walk_idx) and torch.equal(got[1].cpu(), walk_mask)
    assert int(got[1].sum()) == count
    return stats


@pytest.mark.parametrize("case", NMS_CASES)
@pytest.mark.parametrize("n,max_out,threshold", NMS_SHAPES,
                         ids=lambda v: str(v) if not isinstance(v, float) else f"t{v}")
def test_nms_kernel_matches_plain(n, max_out, threshold, case, device):
    """The kernel against the plain version (the fixpoint form below 1025
    boxes, the blocked form above) and the Python model of its design,
    index for index, the masked slots included; one launch a call, no host
    read. "sorted" takes the in-order path, the others the sort."""
    boxes, scores = kernel_check.nms_inputs(n, max_out, threshold, device, seed=n + max_out,
                                            case=case)
    stats = _nms_check(boxes, scores, threshold, max_out)
    if case == "sorted":
        assert stats["in_order"]


@pytest.mark.parametrize("case", ["ties", "sorted", "signed_zeros", "random"])
@pytest.mark.parametrize("n,max_out,threshold", [(900, 64, 0.5), (4096, 300, 0.7),
                                                 (4096, 1000, 0.7)],
                         ids=lambda v: str(v) if not isinstance(v, float) else f"t{v}")
def test_nms_kernel_bf16_scores(n, max_out, threshold, case, device):
    """bfloat16 scores (ties on every few boxes, +-0.0, in order and out of
    order) with float32 boxes, as the heads hand them over: the kernel
    equal to the plain version and the model, one launch a call."""
    boxes, scores = kernel_check.nms_inputs(n, max_out, threshold, device, seed=n + max_out,
                                            case=case)
    _nms_check(boxes, scores.bfloat16(), threshold, max_out)


def test_nms_kernel_keys_in_scratch(device):
    """Past the shared-memory budget the sort's keys go to a device scratch:
    20000 boxes out of order (32768 keys), equal to the plain version."""
    from eventful_transformer_tpu_torch.ops import nms as nms_kernel

    assert nms_kernel.scratch_bytes(20000, 300) == 8 * 32768
    boxes, scores = kernel_check.nms_inputs(20000, 300, 0.7, device, seed=11)
    assert not _nms_check(boxes, scores, 0.7, 300)["in_order"]


def test_nms_kernel_one_launch_under_the_profiler(device):
    """One call is one kernel on the card, on the sort path and the in-order
    path alike: the profiler sees ``nms_kernel`` once a call and nothing
    else (``kernel_check.device_us``, which takes a trace again where the
    profiler caught no device event)."""
    from eventful_transformer_tpu_torch.detection import nms

    for case in ("random", "sorted"):
        boxes, scores = kernel_check.nms_inputs(4096, 300, 0.7, device, seed=1, case=case)
        us, kernels = kernel_check.device_us(lambda: nms.nms_padded(boxes, scores, 0.7, 300))
        assert kernels == {"nms_kernel": 1} and us > 0, (case, kernels)


def test_nms_kernel_in_batched_nms_and_bf16(device):
    """``batched_nms`` routes to the kernel (the coordinate offsets and the
    top candidates on the card), bfloat16 boxes and scores too, equal to the
    plain version on the same tensors."""
    from eventful_transformer_tpu_torch.detection import nms

    for dtype in (torch.float32, torch.bfloat16):
        boxes, scores = kernel_check.nms_inputs(6000, 300, 0.7, device, seed=3, dtype=dtype)
        groups = torch.randint(0, 5, (6000,), generator=torch.Generator().manual_seed(4)).to(device)
        syncs = nms.host_syncs
        got = nms.batched_nms(boxes, scores, groups, 0.7, 300)
        assert nms.host_syncs == syncs
        previous = nms.nms_padded
        try:
            nms.nms_padded = nms.nms_padded_plain
            want = nms.batched_nms(boxes, scores, groups, 0.7, 300)
        finally:
            nms.nms_padded = previous
        assert all(torch.equal(a, w) for a, w in zip(got, want))


def test_nms_kernel_under_capture(device):
    """The kernel inside a CUDA graph: captured once, replayed on new boxes
    copied into the static input, equal to the plain version each time."""
    from eventful_transformer_tpu_torch.detection import nms

    boxes, scores = kernel_check.nms_inputs(4096, 300, 0.7, device, seed=5)
    static_b, static_s = boxes.clone(), scores.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        nms.nms_padded(static_b, static_s, 0.7, 300)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = nms.nms_padded(static_b, static_s, 0.7, 300)
    for seed in (6, 7):
        b, s = kernel_check.nms_inputs(4096, 300, 0.7, device, seed=seed)
        static_b.copy_(b)
        static_s.copy_(s)
        graph.replay()
        want = nms.nms_padded_plain(b, s, 0.7, 300)
        torch.cuda.synchronize()
        assert all(torch.equal(a, w) for a, w in zip(out, want))


# -- the whole ViTDet frame as one graph ------------------------------------------------------


@pytest.mark.parametrize("size", [672, 1024])
def test_frame_graph_equals_the_eager_step(size, device):
    """ViTDet-B spatiotemporal_<size> (k = 256, bfloat16, random weights,
    the class scorer scaled as chip_smoke.py scales it) through
    ``make_vitdet_step`` captured and eager, two videos of a flush and 2
    incremental frames: the backbone's tokens, the detections, the final
    state and the counts bit for bit, one graph a mode; then the frame step
    without counts replayed under ``torch.cuda.set_sync_debug_mode("error")``
    around each call (no host read in the copies in, the replay or the
    copies out), its outputs the eager ones."""
    import chip_smoke
    from eventful_transformer_tpu_torch.detection import nms
    from eventful_transformer_tpu_torch.utils.evaluate import make_vitdet_step

    model = chip_smoke.e2e_model(True, device, torch.bfloat16, size=size)
    graph = make_vitdet_step(model, keep_tokens=True)
    eager = make_vitdet_step(model, graph=False, keep_tokens=True)
    frames = chip_smoke.vitdet_frames(3, 1, device, torch.bfloat16, size)
    hw = torch.tensor([size - 64, size], dtype=torch.int32, device=device)
    syncs = nms.host_syncs
    with torch.no_grad():
        for _ in range(2):
            states = [model.init_state(1, torch.bfloat16, device) for _ in range(2)]
            for t in range(3):
                want, states[0], want_counts = eager(states[0], frames[t], hw, t == 0)
                got, states[1], counts = graph(states[1], frames[t], hw, t == 0)
                assert set(got) == {"boxes", "scores", "labels", "mask", "tokens"}
                assert all(torch.equal(got[k], want[k]) for k in want), t
                assert counts == want_counts, t
            for (_, a), (_, b) in zip(_state_leaves(states[0]), _state_leaves(states[1])):
                assert torch.equal(a, b)
    assert graph.graph.captures == 2 and nms.host_syncs == syncs
    quiet = model.frame_step(count_mode=False)
    with torch.no_grad():
        state = model.init_state(1, torch.bfloat16, device)
        for t in range(3):  # the warm-ups and captures
            _, state, _ = quiet(state, frames[t], hw, mode="flush" if t == 0 else "incremental")
        state = model.init_state(1, torch.bfloat16, device)
        eager_state = model.init_state(1, torch.bfloat16, device)
        for t in range(3):
            want, eager_state, _ = eager(eager_state, frames[t], hw, t == 0)
            torch.cuda.synchronize()
            previous = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got, state, _ = quiet(state, frames[t], hw,
                                      mode="flush" if t == 0 else "incremental")
            finally:
                torch.cuda.set_sync_debug_mode(previous)
            torch.cuda.synchronize()
            assert all(torch.equal(got[k], want[k]) for k in got), t
    assert quiet.captures == 2
