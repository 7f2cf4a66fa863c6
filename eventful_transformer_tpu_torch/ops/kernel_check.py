"""Hold each CUDA kernel against its plain PyTorch version on one set of
inputs, and time both. ``chip_smoke.py`` runs this at the main path's
shapes; ``tests/test_torch_cuda.py`` at small ones. Both sides get clones
of the same tensors (the kernels update gate state in place) and the same
coverages, computed once, so they select the same tokens. A group that
selects its own rows (``cov=None``) is held in two parts: its selection
against :func:`~.gate_group.topk_coverage_plain` on the same inputs, and
its outputs against the plain version given the kernel's selection.
"""

from __future__ import annotations

import time

import torch

from eventful_transformer_tpu_torch.core.indexing import coverage_from_norms, window_row_map
from eventful_transformer_tpu_torch.core.policies import vector_norm
from eventful_transformer_tpu_torch.detection import nms as detection_nms
from eventful_transformer_tpu_torch.detection.boxes import iou_matrix
from eventful_transformer_tpu_torch.ops import (
    attention,
    av_softmax,
    block_fused,
    dense_mlp,
    gate_block,
    gate_fused,
    gate_group,
    nms,
    relpos,
    scatter,
    scatter_blend,
    window_attention,
)
from eventful_transformer_tpu_torch.ops.common import ln_f32

# (wrapper, plain version, CUDA source, the TPU kernel it replaces, names
# of the outputs in the order the wrapper returns them). A kernel with two
# forms on the main paths has an entry per form.
_GG = "eventful_transformer_tpu/ops/pallas/gate_group.py"
_GF = "eventful_transformer_tpu/ops/pallas/gate_fused.py"
_GB = "eventful_transformer_tpu/ops/pallas/gate_block.py"
_SC = "eventful_transformer_tpu/ops/pallas/scatter.py"
_WA = "eventful_transformer_tpu/ops/pallas/window_attention.py"
NMS_REPLACES = "eventful_transformer_tpu/detection/nms.py:58 (XLA while_loops, no Pallas kernel)"
KERNELS = {
    "ln_norms": (
        gate_fused.ln_norms, gate_fused.ln_norms_plain,
        "eventful_transformer_tpu_torch/csrc/ln_norms.cu",
        "eventful_transformer_tpu/ops/pallas/gate_fused.py:39", ("norms",),
    ),
    "qkv_attention_group": (
        block_fused.qkv_attention_group, block_fused.qkv_attention_group_plain,
        "eventful_transformer_tpu_torch/csrc/block_fused.cu",
        "eventful_transformer_tpu/ops/pallas/block_fused.py:134", ("p_qkv", "attn", "norms"),
    ),
    "proj_group": (
        block_fused.proj_group, block_fused.proj_group_plain,
        "eventful_transformer_tpu_torch/csrc/block_fused.cu",
        "eventful_transformer_tpu/ops/pallas/block_fused.py:219", ("p_proj", "y1", "norms"),
    ),
    "gate_group_mlp": (
        gate_group.gate_group_mlp, gate_group.gate_group_mlp_plain,
        "eventful_transformer_tpu_torch/csrc/gate_group.cu",
        "eventful_transformer_tpu/ops/pallas/gate_group.py:421", ("p", "b", "y", "next_norms"),
    ),
    "dense_mlp_residual": (
        dense_mlp.dense_mlp_residual, dense_mlp.dense_mlp_residual_plain,
        "eventful_transformer_tpu_torch/csrc/dense_mlp.cu",
        "eventful_transformer_tpu/ops/pallas/dense_mlp.py:47", ("y",),
    ),
    "window_attention": (
        window_attention.window_attention, window_attention.window_attention_plain,
        "eventful_transformer_tpu_torch/csrc/window_attention.cu",
        "eventful_transformer_tpu/ops/pallas/window_attention.py:281", ("out",),
    ),
    "window_attention_windowed": (
        window_attention.window_attention, window_attention.window_attention_plain,
        "eventful_transformer_tpu_torch/csrc/window_attention.cu",
        "eventful_transformer_tpu/ops/pallas/window_attention.py:281", ("out",),
    ),
    "gate_group_linear": (
        gate_group.gate_group_linear, gate_group.gate_group_linear_plain,
        "eventful_transformer_tpu_torch/csrc/gate_group.cu",
        "eventful_transformer_tpu/ops/pallas/gate_group.py:244", ("p", "b", "y", "next_norms"),
    ),
    "gate_group_linear_post": (
        gate_group.gate_group_linear, gate_group.gate_group_linear_plain,
        "eventful_transformer_tpu_torch/csrc/gate_group.cu",
        "eventful_transformer_tpu/ops/pallas/gate_group.py:244", ("p", "b"),
    ),
    "block_select_p": (
        gate_block.block_select_p, gate_block.block_select_p_plain,
        "eventful_transformer_tpu_torch/csrc/gate_block.cu",
        "eventful_transformer_tpu/ops/pallas/gate_block.py:303", ("p",),
    ),
    "block_scatter_rows": (
        gate_block.block_scatter_rows, gate_block.block_scatter_rows_plain,
        "eventful_transformer_tpu_torch/csrc/gate_block.cu",
        "eventful_transformer_tpu/ops/pallas/gate_block.py:368", ("b",),
    ),
    "block_select_scatter_qkv": (
        gate_block.block_select_scatter, gate_block.block_select_scatter_plain,
        "eventful_transformer_tpu_torch/csrc/gate_block.cu",
        "eventful_transformer_tpu/ops/pallas/gate_block.py:141", ("p", "b"),
    ),
    "block_select_scatter_proj": (
        gate_block.block_select_scatter, gate_block.block_select_scatter_plain,
        "eventful_transformer_tpu_torch/csrc/gate_block.cu",
        "eventful_transformer_tpu/ops/pallas/gate_block.py:141", ("p", "b", "y", "next_norms"),
    ),
    "block_select_scatter_mlp": (
        gate_block.block_select_scatter, gate_block.block_select_scatter_plain,
        "eventful_transformer_tpu_torch/csrc/gate_block.cu",
        "eventful_transformer_tpu/ops/pallas/gate_block.py:141", ("p", "b", "y", "next_norms"),
    ),
    "softmax_select_matmul": (
        av_softmax.softmax_select_matmul, av_softmax.softmax_select_matmul_plain,
        "eventful_transformer_tpu_torch/csrc/av_softmax.cu",
        "eventful_transformer_tpu/ops/pallas/av_softmax.py:125", ("p_a", "out"),
    ),
    "softmax_select_matmul_noterms": (
        av_softmax.softmax_select_matmul, av_softmax.softmax_select_matmul_plain,
        "eventful_transformer_tpu_torch/csrc/av_softmax.cu",
        "eventful_transformer_tpu/ops/pallas/av_softmax.py:125", ("p_a", "out"),
    ),
    "window_attention_padded": (
        window_attention.window_attention, window_attention.window_attention_plain,
        "eventful_transformer_tpu_torch/csrc/window_attention.cu",
        "eventful_transformer_tpu/ops/pallas/window_attention.py:281", ("out",),
    ),
    "relpos_bias_add": (
        relpos.relpos_bias_add, relpos.relpos_bias_add_plain,
        "eventful_transformer_tpu_torch/csrc/relpos.cu",
        "eventful_transformer_tpu/ops/pallas/relpos.py:62", ("out",),
    ),
    "relpos_bias_add_v2": (
        relpos.relpos_bias_add_v2, relpos.relpos_bias_add_v2_plain,
        "eventful_transformer_tpu_torch/csrc/relpos.cu",
        "eventful_transformer_tpu/ops/pallas/relpos.py:202", ("out",),
    ),
    "ln_select_matmul_post": (
        gate_fused.ln_select_matmul, gate_fused.ln_select_matmul_plain,
        "eventful_transformer_tpu_torch/csrc/gate_fused.cu",
        "eventful_transformer_tpu/ops/pallas/gate_fused.py:98", ("p", "y"),
    ),
    "ln_select_matmul_none": (
        gate_fused.ln_select_matmul, gate_fused.ln_select_matmul_plain,
        "eventful_transformer_tpu_torch/csrc/gate_fused.cu",
        "eventful_transformer_tpu/ops/pallas/gate_fused.py:98", ("p", "y"),
    ),
    "select_linear_skip_norms": (
        gate_fused.select_linear_skip_norms, gate_fused.select_linear_skip_norms_plain,
        "eventful_transformer_tpu_torch/csrc/gate_fused.cu",
        "eventful_transformer_tpu/ops/pallas/gate_fused.py:186", ("p", "y", "norms"),
    ),
    "ln_select": (
        gate_fused.ln_select, gate_fused.ln_select_plain,
        "eventful_transformer_tpu_torch/csrc/gate_block.cu",
        "eventful_transformer_tpu/ops/pallas/gate_fused.py:273", ("p",),
    ),
    "softmax_select_matmul_logits": (
        av_softmax.softmax_select_matmul_logits, av_softmax.softmax_select_matmul_logits_plain,
        "eventful_transformer_tpu_torch/csrc/av_softmax.cu",
        "eventful_transformer_tpu/ops/pallas/av_softmax.py:125", ("p_a", "out"),
    ),
    "softmax_select_matmul_logits_noterms": (
        av_softmax.softmax_select_matmul_logits, av_softmax.softmax_select_matmul_logits_plain,
        "eventful_transformer_tpu_torch/csrc/av_softmax.cu",
        "eventful_transformer_tpu/ops/pallas/av_softmax.py:125", ("p_a", "out"),
    ),
    # the forms of gates before their LN (gate_before_ln)
    "gate_group_mlp_pre": (
        gate_group.gate_group_mlp, gate_group.gate_group_mlp_plain,
        "eventful_transformer_tpu_torch/csrc/gate_group.cu", f"{_GG}:421", ("p", "b", "y"),
    ),
    "gate_group_linear_pre": (
        gate_group.gate_group_linear, gate_group.gate_group_linear_plain,
        "eventful_transformer_tpu_torch/csrc/gate_group.cu", f"{_GG}:244", ("p", "b"),
    ),
    "ln_select_matmul_pre": (
        gate_fused.ln_select_matmul, gate_fused.ln_select_matmul_plain,
        "eventful_transformer_tpu_torch/csrc/gate_fused.cu", f"{_GF}:98", ("p", "y"),
    ),
    "select_linear_skip_norms_noln": (
        gate_fused.select_linear_skip_norms, gate_fused.select_linear_skip_norms_plain,
        "eventful_transformer_tpu_torch/csrc/gate_fused.cu", f"{_GF}:186", ("p", "y", "norms"),
    ),
    "ln_select_noln": (
        gate_fused.ln_select, gate_fused.ln_select_plain,
        "eventful_transformer_tpu_torch/csrc/gate_block.cu", f"{_GF}:273", ("p",),
    ),
    "block_select_p_noln": (
        gate_block.block_select_p, gate_block.block_select_p_plain,
        "eventful_transformer_tpu_torch/csrc/gate_block.cu", f"{_GB}:303", ("p",),
    ),
    "block_select_scatter_qkv_noln": (
        gate_block.block_select_scatter, gate_block.block_select_scatter_plain,
        "eventful_transformer_tpu_torch/csrc/gate_block.cu", f"{_GB}:141", ("p", "b"),
    ),
    "block_select_scatter_mlp_noln": (
        gate_block.block_select_scatter, gate_block.block_select_scatter_plain,
        "eventful_transformer_tpu_torch/csrc/gate_block.cu", f"{_GB}:141", ("p", "b", "y"),
    ),
    # the groups that select their own rows (cov=None): the MLP group, the
    # projection group ("none", skip and the MLP gate's norms) and the qkv
    # group ("post", "pre"; F = 3C); the last output is the selection
    "gate_group_mlp_topk": (
        gate_group.gate_group_mlp, gate_group.gate_group_mlp_plain,
        "eventful_transformer_tpu_torch/csrc/gate_group.cu", f"{_GG}:421",
        ("p", "b", "y", "selection"),
    ),
    "gate_group_mlp_pre_topk": (
        gate_group.gate_group_mlp, gate_group.gate_group_mlp_plain,
        "eventful_transformer_tpu_torch/csrc/gate_group.cu", f"{_GG}:421",
        ("p", "b", "y", "selection"),
    ),
    "gate_group_linear_topk": (
        gate_group.gate_group_linear, gate_group.gate_group_linear_plain,
        "eventful_transformer_tpu_torch/csrc/gate_group.cu", f"{_GG}:244",
        ("p", "b", "y", "next_norms", "selection"),
    ),
    "gate_group_linear_post_topk": (
        gate_group.gate_group_linear, gate_group.gate_group_linear_plain,
        "eventful_transformer_tpu_torch/csrc/gate_group.cu", f"{_GG}:244",
        ("p", "b", "selection"),
    ),
    "gate_group_linear_pre_topk": (
        gate_group.gate_group_linear, gate_group.gate_group_linear_plain,
        "eventful_transformer_tpu_torch/csrc/gate_group.cu", f"{_GG}:244",
        ("p", "b", "selection"),
    ),
    # put_rows as the one-hot blend (USE_PALLAS_BLEND): the projection /
    # MLP buffer width C, with a mask, the qkv buffer's 3C, 4C, and a
    # duplicated index (-x + v1 + v2)
    "scatter_blend": (
        scatter_blend.scatter_blend, scatter_blend.scatter_blend_plain,
        "eventful_transformer_tpu_torch/csrc/scatter_blend.cu",
        "eventful_transformer_tpu/ops/pallas/scatter_blend.py:45", ("out",),
    ),
    "scatter_blend_masked": (
        scatter_blend.scatter_blend, scatter_blend.scatter_blend_plain,
        "eventful_transformer_tpu_torch/csrc/scatter_blend.cu",
        "eventful_transformer_tpu/ops/pallas/scatter_blend.py:45", ("out",),
    ),
    "scatter_blend_qkv": (
        scatter_blend.scatter_blend, scatter_blend.scatter_blend_plain,
        "eventful_transformer_tpu_torch/csrc/scatter_blend.cu",
        "eventful_transformer_tpu/ops/pallas/scatter_blend.py:45", ("out",),
    ),
    "scatter_blend_wide": (
        scatter_blend.scatter_blend, scatter_blend.scatter_blend_plain,
        "eventful_transformer_tpu_torch/csrc/scatter_blend.cu",
        "eventful_transformer_tpu/ops/pallas/scatter_blend.py:45", ("out",),
    ),
    "scatter_blend_duplicate": (
        scatter_blend.scatter_blend, scatter_blend.scatter_blend_plain,
        "eventful_transformer_tpu_torch/csrc/scatter_blend.cu",
        "eventful_transformer_tpu/ops/pallas/scatter_blend.py:45", ("out",),
    ),
    # the kernels no path of the JAX package calls: the row scatter (the
    # buffer it writes in place) and gather at a C- and a 3C-wide buffer,
    # with and without a mask, float32 values into the buffer's dtype; the
    # fused attention without and with the matmul-2 cast; the grid form of
    # the windowed attention with and without the rel-pos tables
    **{
        name: (scatter.scatter_rows_inplace, scatter.scatter_rows_inplace_plain,
               "eventful_transformer_tpu_torch/csrc/scatter.cu", f"{_SC}:48", ("buffer",))
        for name in ("scatter_rows_inplace", "scatter_rows_inplace_masked",
                     "scatter_rows_inplace_qkv", "scatter_rows_inplace_qkv_masked",
                     "scatter_rows_inplace_cast")
    },
    **{
        name: (scatter.gather_rows, scatter.gather_rows_plain,
               "eventful_transformer_tpu_torch/csrc/scatter.cu", f"{_SC}:93", ("rows",))
        for name in ("gather_rows", "gather_rows_qkv")
    },
    **{
        name: (attention.fused_attention, attention.fused_attention_plain,
               "eventful_transformer_tpu_torch/csrc/fused_attention.cu",
               "eventful_transformer_tpu/ops/pallas/attention.py:62", ("out",))
        for name in ("fused_attention", "fused_attention_cast")
    },
    **{
        name: (window_attention.window_attention_grid,
               window_attention.window_attention_grid_plain,
               "eventful_transformer_tpu_torch/csrc/window_attention.cu", f"{_WA}:348", ("out",))
        for name in ("window_attention_grid", "window_attention_grid_noterms")
    },
    # row 22, greedy NMS with no host read, one launch (the order, the
    # walk over a kept set in shared memory, the padded slots): no Pallas
    # counterpart, the JAX package runs it in XLA (two lax.while_loops); its
    # plain version is the port's fixpoint and blocked loops
    "nms_padded": (
        nms.nms_padded, detection_nms.nms_padded_plain,
        "eventful_transformer_tpu_torch/csrc/nms.cu", NMS_REPLACES, ("indices", "mask"),
    ),
}
# the row scatter and gather entries' (buffer, values, index, mask) keys
ROWS_INPUTS = {
    "scatter_rows_inplace": ("rows_buf", "rows_vals", "rows_index", None),
    "scatter_rows_inplace_masked": ("rows_buf", "rows_vals", "rows_index", "rows_mask"),
    "scatter_rows_inplace_qkv": ("rows_buf_qkv", "rows_vals_qkv", "rows_index", None),
    "scatter_rows_inplace_qkv_masked": ("rows_buf_qkv", "rows_vals_qkv", "rows_index", "rows_mask"),
    "scatter_rows_inplace_cast": ("rows_buf_qkv", "rows_vals_f32", "rows_index", "rows_mask"),
    "gather_rows": ("rows_buf", None, "rows_index", None),
    "gather_rows_qkv": ("rows_buf_qkv", None, "rows_index", None),
}
# The forms a threshold policy gives the kernels (TokenNormThreshold, whose
# selection may hold fewer valid rows than its capacity): each entry is its
# base entry's call with the inputs named here in place of the base's. Rows
# 4 and 7 on a coverage of fewer than kcap rows (the last batch row none),
# so that some compaction slots stay empty; row 8 on key columns of which
# the first batch row covers none; row 9 with the masked-off slots keyed to
# the marker N beside -1; row 10 on fewer selected rows; row 11 with half
# the slots the marker N.
THRESHOLD = {
    "gate_group_mlp_threshold": ("gate_group_mlp", {"cov3": "cov3_thr"}),
    "gate_group_linear_threshold": ("gate_group_linear", {"cov2": "cov2_thr"}),
    "gate_group_linear_post_threshold": ("gate_group_linear_post", {"cov1": "cov1_thr"}),
    "softmax_select_matmul_threshold": ("softmax_select_matmul", {"av_cov": "av_cov_thr"}),
    "block_select_scatter_qkv_threshold": (
        "block_select_scatter_qkv", {"w_index": "w_index_thr", "cov_sel": "cov_sel_thr"}),
    "block_select_scatter_proj_threshold": (
        "block_select_scatter_proj", {"w_index": "w_index_thr", "cov_sel": "cov_sel_thr"}),
    "block_select_scatter_mlp_threshold": (
        "block_select_scatter_mlp", {"w_index": "w_index_thr", "cov_sel": "cov_sel_thr"}),
    "block_select_p_threshold": ("block_select_p", {"cov1": "cov1_thr"}),
    "block_scatter_rows_threshold": ("block_scatter_rows", {"sel_index": "sel_index_thr"}),
}
KERNELS.update({name: KERNELS[base] for name, (base, _) in THRESHOLD.items()})


def resolve(name, d):
    """(the entry whose call ``name`` makes, the inputs it makes it on): a
    THRESHOLD entry is its base entry on its own inputs; any other entry is
    itself on ``d``."""
    if name not in THRESHOLD:
        return name, d
    base, inputs = THRESHOLD[name]
    return base, dict(d, **{key: d[alias] for key, alias in inputs.items()})


# the entries whose group selects its own rows: (x, gate state, LN scale
# and bias or None, LN mode) keys
TOPK = {
    "gate_group_mlp_topk": ("x", "p_mlp", "ln2_s", "ln2_b", "post"),
    "gate_group_mlp_pre_topk": ("x", "p_mlp", "ln2_s", "ln2_b", "pre"),
    "gate_group_linear_topk": ("attn", "p_proj", None, None, "none"),
    "gate_group_linear_post_topk": ("x", "p_qkv", "ln1_s", "ln1_b", "post"),
    "gate_group_linear_pre_topk": ("x", "p_qkv", "ln1_s", "ln1_b", "pre"),
}

# The form of each entry whose wrapper counts launches by form
# (``form_launches``); the other entries report the wrapper's total.
FORMS = {
    "gate_group_mlp": "post", "gate_group_mlp_pre": "pre",
    "gate_group_linear": "none", "gate_group_linear_post": "post", "gate_group_linear_pre": "pre",
    "ln_select_matmul_post": "post", "ln_select_matmul_none": "none",
    "ln_select_matmul_pre": "pre",
    "select_linear_skip_norms": "next_ln", "select_linear_skip_norms_noln": "no_ln",
    "ln_select": "ln", "ln_select_noln": "no_ln",
    "block_select_p": "ln", "block_select_p_noln": "no_ln",
    "block_select_scatter_qkv": "ln", "block_select_scatter_mlp": "ln",
    "block_select_scatter_proj": "no_ln", "block_select_scatter_qkv_noln": "no_ln",
    "block_select_scatter_mlp_noln": "no_ln",
    **{name: f"{entry[4]}_topk" for name, entry in TOPK.items()},
    "fused_attention": "no_cast", "fused_attention_cast": "cast",
    "window_attention_grid": "terms", "window_attention_grid_noterms": "no_terms",
}


def launches(name):
    """The launches counted for entry ``name``: its form's count where its
    wrapper counts by form, else the wrapper's total."""
    wrapper = KERNELS[name][0]
    name = THRESHOLD.get(name, (name,))[0]
    if name in FORMS:
        return wrapper.form_launches[FORMS[name]]
    return wrapper.launches


def reset_launches():
    """Every wrapper's counts to 0, by form, by body, by GEMM core and by
    row body too."""
    for entry in KERNELS.values():
        wrapper = entry[0]
        wrapper.launches = 0
        for attr in ("form_launches", "body_launches", "core_launches", "row_body_launches"):
            counts = getattr(wrapper, attr, {})
            for key in counts:
                counts[key] = 0


def body_launches():
    """{wrapper name: {"tc" or "tile": n, "simt": n}} of the wrappers that count their
    launches by body: those that reach the attention kernel, the A.V
    kernel's two and the rel-pos bias add's two."""
    return {entry[0].__name__: dict(entry[0].body_launches) for entry in KERNELS.values()
            if hasattr(entry[0], "body_launches")}


def check_bodies(counts, dtype, where):
    """Raise unless every launch in ``counts`` (:func:`body_launches` after
    a run in ``dtype``) took the body ``window_attention.attention_body``,
    ``av_softmax.av_softmax_body`` and ``relpos.relpos_body`` give the
    paths' shapes: in bfloat16 the wrapper's other body than "simt" (the
    tensor-core one, the rel-pos add's tiled one), in float32 the CUDA-core
    one, "simt" (the A.V kernel's matmul-2 cast included)."""
    bf16 = dtype == torch.bfloat16
    stray = {name: c for name, c in counts.items()
             if any(n for body, n in c.items() if (body == "simt") == bf16)}
    if stray:
        want = "the tensor-core or tiled" if bf16 else "the simt"
        raise AssertionError(f"{where}: {dtype} launches left {want} body: {stray}")


def row_body_launches():
    """{wrapper name: {"warp": n, "block": n}} of the wrappers that launch
    a row pass of ``csrc/row_pass.cuh`` (rows 1, 9, 10 and 14, and the
    select, LN and norms stages of rows 2-5, 7, 12 and 13), by the body
    ``row_pass.row_body`` gave each launch."""
    return {entry[0].__name__: dict(entry[0].row_body_launches) for entry in KERNELS.values()
            if hasattr(entry[0], "row_body_launches")}


def check_row_bodies(counts, where):
    """Raise unless every launch in ``counts`` (:func:`row_body_launches`
    after a run) took the warp-per-row body, as every model path's shapes
    do in both dtypes."""
    stray = {name: c for name, c in counts.items() if c["block"]}
    if stray:
        raise AssertionError(f"{where}: row passes took the block-per-row body: {stray}")


def core_launches():
    """{wrapper name: {"tc": n, "wmma": n, "simt": n}} of the wrappers whose
    GEMMs take a core by ``gemm_core.gemm_core`` (rows 2-5, 7, 12, 13), which
    count their launches by core."""
    return {entry[0].__name__: dict(entry[0].core_launches) for entry in KERNELS.values()
            if hasattr(entry[0], "core_launches")}


def check_cores(counts, dtype, where):
    """Raise unless every launch in ``counts`` (:func:`core_launches` after a
    run in ``dtype``) took the core ``gemm_core.gemm_core`` gives the paths'
    shapes: the wgmma core ("tc") in bfloat16, the CUDA-core tile ("simt")
    in float32."""
    want = "tc" if dtype == torch.bfloat16 else "simt"
    stray = {name: c for name, c in counts.items()
             if any(n for core, n in c.items() if core != want)}
    if stray:
        raise AssertionError(f"{where}: {dtype} GEMM launches left the {want} core: {stray}")

# Bounds on each output of a kernel against its plain version. With
# "scaled error" |kernel - plain| / max(1, |plain|):
#   float32 outputs, in either run (the norms in a bfloat16 run too): both
#     sides sum in float32 in other orders; scaled error <= 1e-4 covers
#     C- and N-long sums and the softmax behind the attention output, and
#     fails a norm that lost the LN bias (1.2e-2 when planted in ln_norms).
#   bfloat16 outputs: the two sides make the same roundings, so an element
#     differs only where a float32 sum lies within its summation error of a
#     bfloat16 rounding boundary, or takes such a flip from an intermediate
#     (qkv into the softmax, the hidden into GEMM2, the projection into the
#     skip add). At the main path's shapes up to 2.2 % of an output's
#     elements differ (kernel A's attention output), and 0.42 % by more
#     than one ulp of the plain value; a dropped rounding point, planted
#     once in each kernel, made 26-68 % differ and 5-34 % by more than one
#     ulp. Bounded:
#       - the share of elements that differ at all, <= 5 %;
#       - the share off by more than one ulp, <= 1 %;
#       - the scaled error, <= 2e-2: one ulp of an intermediate below 4 in
#         magnitude is 2**-6 = 1.6e-2.
#     The largest gap in ulps is reported, not bounded: a value near zero
#     that lands on the other side of it is thousands of its own ulps away
#     while its error is below 1e-4.
F32_SCALED = 1e-4
BF16_BOUNDS = dict(scaled=2e-2, differ_share=5e-2, far_share=1e-2)
# float32 outputs behind a bfloat16 rounding point (the fused attention's
# matmul-2 cast in a float32 model): a probability that the two sides'
# float32 sums put on either side of a bfloat16 rounding boundary moves its
# row of the output by one bfloat16 ulp of it. Emulated on the CPU at
# ViViT's shape (q's scale one float32 ulp off): 0.03 % of the elements
# beyond F32_SCALED, the largest 8.0e-4 scaled; with the cast dropped
# 69-88 %. Bounded: that share <= far_share, the scaled error <= the
# bfloat16 outputs' bound.
BF16_ROUNDED = ("fused_attention_cast",)


def _grid(n):
    """The most nearly square (h, w) with h * w == n."""
    h = max(i for i in range(1, int(n**0.5) + 1) if n % i == 0)
    return h, n // h


def make_inputs(
    bsz, n, c, heads, k, dtype, device, seed=0, window=(4, 6), windows=None, pool=(3, 7),
    pad_window=(3, 4), relpos_keys=None, ties=None,
):
    """Random activations, gate states, weights and one coverage per gate,
    at the scales of the model (LN-domain states ~ N(0, 1), weights
    ~ C^-1/2); window rows (``windows`` windows of T = window[0] *
    window[1] tokens, by default bsz * n // T, at least one) with rel-pos
    terms; a qkv buffer, k
    rows for it and their target rows in random order, the last slot of
    each batch row invalid (-1), and the coverage of the valid ones; the
    A.V state over a ``pool`` grid of keys with q, k, terms, logits ~ N(0, 1)
    and a column coverage; and the windows of the n tokens laid out as the most nearly
    square grid, zero-padded to ``pad_window`` windows, with their
    geometry, a pad-bias row and pad terms; and logits over that grid of
    queries and a ``relpos_keys`` grid of keys (by default ``pool``) with
    unscaled q and the two rel-pos tables; for the scatter-blend, a mask
    over the qkv buffer's slots, distinct valid rows for k slots, the index
    with slot 1 naming slot 0's row, a 4C-wide buffer and its values; for
    the row scatter and gather, C- and 3C-wide buffers of whole 128-lane
    rows (C rounded up), values for them, float32 values, distinct valid
    rows for k slots and a mask of about half of them; for the grid form,
    the padded token map itself (the pad positions holding the pad-bias
    row) and rel-pos tables over the pad window; for row 11, the window map
    of that grid of tokens in windows of ``window``, a window-major qkv
    buffer over its padded grid and k selected tokens in random order, the
    last slot the marker n; and the inputs of the forms a threshold policy
    gives (THRESHOLD, :func:`_threshold_inputs`).
    ``ties``: a TOPK entry whose inputs get exact ties at the k-th norm
    (:func:`plant_ties`)."""
    g = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=1.0, shift=0.0):
        t = torch.randn(shape, generator=g) * scale + shift
        return t.to(device=device, dtype=dtype)

    d = dict(
        x=randn(bsz, n, c), attn=randn(bsz, n, c), p_qkv=randn(bsz, n, c),
        p_proj=randn(bsz, n, c), p_mlp=randn(bsz, n, c), b_mlp=randn(bsz, n, c),
        p_next=randn(bsz, n, c), qkv=randn(bsz, n, 3 * c),
        ln1_s=randn(c, scale=0.1, shift=1.0), ln1_b=randn(c, scale=0.1),
        ln2_s=randn(c, scale=0.1, shift=1.0), ln2_b=randn(c, scale=0.1),
        w_qkv=randn(c, 3 * c, scale=c**-0.5), b_qkv=randn(3 * c, scale=0.1),
        w_proj=randn(c, c, scale=c**-0.5), b_proj=randn(c, scale=0.1),
        w1=randn(c, 4 * c, scale=c**-0.5), b1=randn(4 * c, scale=0.1),
        w2=randn(4 * c, c, scale=(4 * c) ** -0.5), b2=randn(c, scale=0.1),
    )
    for name in ("cov1", "cov2", "cov3"):
        norms = torch.rand((bsz, n), generator=g).to(device)
        d[name] = coverage_from_norms(norms, k)
    t = window[0] * window[1]
    n_win = windows or max(1, bsz * n // t)
    d.update(
        qkv_win=randn(n_win, t, 3 * c), terms=randn(n_win, heads, t, window[0] + window[1]),
        buf_qkv=randn(bsz, n, 3 * c), buf_proj=randn(bsz, n, c), h_rows=randn(bsz, k, 3 * c),
    )
    rows = torch.stack([torch.randperm(n, generator=g)[:k] for _ in range(bsz)])
    if k > 1:
        rows[:, -1] = -1
    d["w_index"] = rows.to(device=device, dtype=torch.int32)
    cov_sel = torch.zeros((bsz, n))
    for b in range(bsz):
        cov_sel[b, rows[b][rows[b] >= 0]] = 1.0
    d.update(cov_sel=cov_sel.to(device), h_c=randn(bsz, k, c))
    # the A.V state: probabilities ~ 1 / Np, a quarter of the columns refreshed
    hd, np_ = c // heads, pool[0] * pool[1]
    p_a = torch.rand((bsz, heads, n, np_), generator=g) * (2.0 / np_)
    av_logits = torch.randn(p_a.shape, device=device,
                            generator=torch.Generator(device=device).manual_seed(seed + 1))
    d.update(
        p_a=p_a.to(device=device, dtype=dtype), p_v=randn(bsz, heads, np_, hd),
        av_logits=av_logits.to(dtype),
        av_q=randn(bsz, heads, n, hd), av_k=randn(bsz, heads, np_, hd),
        av_terms=randn(bsz, heads, n, pool[0] + pool[1], scale=0.3),
        av_cov=(torch.rand((bsz, np_), generator=g) < 0.25).float().to(device),
    )
    # windows of the zero-padded token map
    (h, w), (a0, a1) = _grid(n), pad_window
    nh, nw = -(-h // a0), -(-w // a1)
    grid = torch.zeros((bsz, nh * a0, nw * a1, 3 * c), dtype=dtype, device=device)
    grid[:, :h, :w] = d["qkv"].reshape(bsz, h, w, 3 * c)
    grid = grid.reshape(bsz, nh, a0, nw, a1, 3 * c).permute(0, 1, 3, 2, 4, 5)
    d.update(
        qkv_pad=grid.reshape(-1, a0 * a1, 3 * c).contiguous(),
        terms_pad=randn(bsz * nh * nw, heads, a0 * a1, a0 + a1, scale=0.3),
        pad_bias=randn(3 * c), pad_terms=randn(heads, a0 * a1, a0 + a1, scale=0.3),
        geom=(nh, nw, h, w),
    )
    # the rel-pos bias add: logits ~ N(0, 1), made on the device (up to 400 M
    # of them), terms of a few units
    rp_p = tuple(relpos_keys or pool)
    logits = torch.randn((bsz, heads, n, rp_p[0] * rp_p[1]), device=device,
                         generator=torch.Generator(device=device).manual_seed(seed))
    d.update(
        rp_x=logits.to(dtype), rp_q=randn(bsz, heads, n, hd),
        rp_y=randn(h, rp_p[0], hd, scale=0.3), rp_xr=randn(w, rp_p[1], hd, scale=0.3),
    )
    d["heads"], d["k"], d["window"] = heads, k, tuple(window)
    d["pool"], d["pad_window"] = tuple(pool), tuple(pad_window)
    d["rp_a"], d["rp_p"] = (h, w), rp_p
    # the scatter-blend
    d["blend_mask"] = (torch.rand((bsz, k), generator=g) < 0.8).to(device)
    d["blend_index"] = torch.stack(
        [torch.randperm(n, generator=g)[:k] for _ in range(bsz)]
    ).to(device=device, dtype=torch.int32)
    dup = d["w_index"].clone()
    dup[:, min(1, k - 1)] = dup[:, 0]
    d["w_dup"] = dup
    d["buf_wide"] = torch.cat([d["buf_qkv"], d["buf_proj"]], -1)
    d["h_wide"] = torch.cat([d["h_rows"], d["h_c"]], -1)
    # the row scatter and gather (the JAX kernels take whole 128-lane rows)
    lanes = -(-c // 128) * 128
    if lanes == c:
        d.update(rows_buf=d["buf_proj"], rows_buf_qkv=d["buf_qkv"], rows_vals=d["h_c"],
                 rows_vals_qkv=d["h_rows"])
    else:
        d.update(rows_buf=randn(bsz, n, lanes), rows_buf_qkv=randn(bsz, n, 3 * lanes),
                 rows_vals=randn(bsz, k, lanes), rows_vals_qkv=randn(bsz, k, 3 * lanes))
    d["rows_vals_f32"] = torch.randn((bsz, k, 3 * lanes), generator=g).to(device)
    d["rows_index"] = torch.stack(
        [torch.randperm(n, generator=g)[:k] for _ in range(bsz)]
    ).to(device=device, dtype=torch.int32)
    d["rows_mask"] = (torch.rand((bsz, k), generator=g) < 0.5).to(device)
    # the grid form: the padded map, and tables (a0, a0, hd) and (a1, a1, hd)
    qkv_map = d["pad_bias"].expand(bsz, nh * a0, nw * a1, 3 * c).clone()
    qkv_map[:, :h, :w] = d["qkv"].reshape(bsz, h, w, 3 * c)
    d.update(qkv_map=qkv_map, rel_y=randn(a0, a0, hd, scale=0.3),
             rel_x=randn(a1, a1, hd, scale=0.3))
    # row 11 on the window-major qkv buffer: the window map of the token grid
    # in windows of ``window`` (padded to whole windows), the selected tokens
    # row-major in random order, the last slot the selection's marker n
    window_map = torch.from_numpy(window_row_map((h, w), window))
    sel = torch.stack([torch.randperm(n, generator=g)[:k] for _ in range(bsz)])
    if k > 1:
        sel[:, -1] = n
    nw_rows = (h + -h % window[0]) * (w + -w % window[1])
    d.update(window_map=window_map.to(device), sel_index=sel.to(device=device, dtype=torch.int32),
             buf_win=randn(bsz, nw_rows, 3 * c))
    _threshold_inputs(d, bsz, n, device, seed)
    if ties is not None:
        plant_ties(d, ties)
    return d


def _threshold_inputs(d, bsz, n, device, seed):
    """The inputs of the THRESHOLD entries, drawn from a generator of their
    own (the other inputs stay as they were): coverages keeping about half
    of each gate's selected rows, the last batch row none; the A.V key
    columns with the first batch row covering none; row 9's index with
    about half its valid slots keyed to the marker n, and the coverage of
    the rest; row 11's selection with about half its slots the marker n."""
    g = torch.Generator().manual_seed(seed + 1000)

    def half(shape):
        return (torch.rand(shape, generator=g) < 0.5).to(device)

    for name in ("cov1", "cov2", "cov3"):
        cov = d[name] * half(d[name].shape)
        if bsz > 1:
            cov[-1] = 0.0
        d[f"{name}_thr"] = cov
    av_cov = d["av_cov"].clone()
    av_cov[0] = 0.0
    d["av_cov_thr"] = av_cov
    index = d["w_index"]
    index = torch.where(half(index.shape) & (index >= 0), n, index)
    valid = (index >= 0) & (index < n)
    cov_sel = torch.zeros((bsz, n + 1), device=device)
    cov_sel.scatter_(1, torch.where(valid, index, n).long(), 1.0)
    d.update(w_index_thr=index, cov_sel_thr=cov_sel[:, :n].contiguous())
    sel = d["sel_index"]
    d["sel_index_thr"] = torch.where(half(sel.shape), n, sel)


def plant_ties(d, name, count=4):
    """Tie ``count`` rows of each batch row at the k-th largest norm that
    TOPK entry ``name`` selects on: the (x, gate state) rows of the k-th
    largest norm are copied into the ``count - 1`` rows that follow it in
    norm order, so that one of the ``count`` equal norms is selected, the
    one of the smallest index."""
    xk, pk, sk, bk, mode = TOPK[name]
    norms = gate_group.topk_norms_plain(d[xk], d[pk], d.get(sk), d.get(bk), mode)
    order = norms.argsort(dim=-1, descending=True).cpu()
    k = d["k"]
    for b in range(order.shape[0]):
        src = int(order[b, k - 1])
        for dst in order[b, k : k + count - 1].tolist():
            d[xk][b, dst] = d[xk][b, src]
            d[pk][b, dst] = d[pk][b, src]
    d["ties"] = True


def nms_inputs(n, max_out, iou_threshold, device="cpu", seed=0, case="random", dtype=None):
    """Boxes (n, 4) and scores (n,) for row 22's checks, made on the CPU
    from ``seed`` and moved to ``device``:

    * "random": boxes in a few dozen clusters (IoUs above and below the
      threshold), a tenth of the scores -inf, about a fifth of the rest
      tied in pairs;
    * "ties": every score one of 8 values;
    * "threshold": pairs of boxes at IoU exactly the float32 threshold and
      one float32 ulp either side;
    * "chains": chains of 12 boxes, each overlapping the next above the
      threshold and the one after below it, scores descending along the
      chain (greedy keeps every other box; depth 12);
    * "all_invalid": every score -inf;
    * "few_valid": max_out // 2 valid boxes, the rest -inf;
    * "sorted": "random" in descending score order, as ``batched_nms``'s
      stable top-k hands the boxes over (the kernel's in-order path);
    * "signed_zeros": every score one of +0.0, -0.0, 0.25, -0.25 and -inf
      (the order must take -0.0 == +0.0, ties by index).
    """
    g = torch.Generator().manual_seed(seed)
    if case == "chains":
        links = 12
        chains = -(-n // links)
        x0 = torch.arange(chains, dtype=torch.float32).repeat_interleave(links) * 400.0
        step = torch.arange(links, dtype=torch.float32).repeat(chains)
        # width 100, shift s: IoU (100 - s) / (100 + s); s = 10 -> 0.818, 20 -> 0.667
        shift = 100.0 * (1 - iou_threshold) / (1 + iou_threshold) * 0.7
        x1 = x0 + step * shift
        boxes = torch.stack([x1, torch.zeros_like(x1), x1 + 100.0, torch.full_like(x1, 50.0)],
                            1)[:n]
        scores = 1.0 - torch.arange(n, dtype=torch.float32) / (2 * n)
        return _nms_place(boxes, scores, device, dtype)
    centers = torch.rand((max(n // 20, 1), 2), generator=g) * 800.0
    which = torch.randint(0, centers.shape[0], (n,), generator=g)
    ctr = centers[which] + torch.randn((n, 2), generator=g) * 6.0
    size = 40.0 + torch.rand((n, 2), generator=g) * 60.0
    boxes = torch.cat([ctr - size / 2, ctr + size / 2], 1)
    scores = torch.rand(n, generator=g)
    if case in ("random", "sorted"):
        pairs = torch.randperm(n, generator=g)[: n // 5]
        scores[pairs[1::2]] = scores[pairs[0::2][: pairs[1::2].shape[0]]]
        scores[torch.rand(n, generator=g) < 0.1] = -float("inf")
        if case == "sorted":
            order = torch.sort(scores, descending=True, stable=True).indices
            boxes, scores = boxes[order], scores[order]
    elif case == "signed_zeros":
        values = torch.tensor([0.0, -0.0, 0.25, -0.25, -float("inf")])
        scores = values[torch.randint(0, 5, (n,), generator=g)]
    elif case == "ties":
        scores = torch.randint(0, 8, (n,), generator=g).float() / 8
    elif case == "threshold":
        boxes, scores = _threshold_pairs(n, iou_threshold, g)
    elif case == "all_invalid":
        scores[:] = -float("inf")
    elif case == "few_valid":
        scores[torch.randperm(n, generator=g)[max_out // 2:]] = -float("inf")
    else:
        raise ValueError(f"unknown NMS case {case!r}")
    return _nms_place(boxes, scores, device, dtype)


def _threshold_pairs(n, t, g):
    """Pairs of side by side boxes of height 1 with integer corners, whose
    IoU p / q (every intermediate exact in float32, so the division rounds
    the rational once) is the float32 threshold, or the float32 value one
    ulp above or below it, in turns; each pair on a row of its own, scores
    descending within a pair."""
    fractions = _iou_fractions(t)
    boxes = []
    for i in range(-(-n // 2)):
        p, q = fractions[i % 3]
        y = 4.0 * i
        # [0, p + 1] and [1, q]: inter p, union (p + 1) + (q - 1) - p = q
        boxes.append([0.0, y, p + 1.0, y + 1])
        boxes.append([1.0, y, float(q), y + 1])
    boxes = torch.tensor(boxes[:n], dtype=torch.float32)
    scores = torch.rand(n, generator=g).sort(descending=True).values
    return boxes, scores


def _iou_fractions(t):
    """The simplest (p, q) whose rational lies strictly inside the rounding
    interval of the float32 ``t``, of the float32 above it and of the one
    below it, each checked through ``iou_matrix``."""
    from fractions import Fraction

    import numpy as np

    def simplest(lo, hi):  # the simplest fraction in (lo, hi); hi None: infinity
        whole = lo.numerator // lo.denominator
        if hi is None or whole + 1 < hi:
            return Fraction(whole + 1)
        rest = lo - whole
        return whole + 1 / simplest(1 / (hi - whole), 1 / rest if rest else None)

    t32 = np.float32(t)
    found = []
    for target in (t32, np.nextafter(t32, np.float32(1)), np.nextafter(t32, np.float32(0))):
        below, above = (Fraction(float(np.nextafter(target, np.float32(v)))) for v in (0, 1))
        f = simplest((below + Fraction(float(target))) / 2, (Fraction(float(target)) + above) / 2)
        p, q = f.numerator, f.denominator
        pair = torch.tensor([[0.0, 0.0, p + 1.0, 1.0], [1.0, 0.0, float(q), 1.0]])
        if iou_matrix(pair[1:], pair[:1]).item() != float(target):
            raise ValueError(f"{p} / {q} does not give the IoU {target!r} in float32")
        found.append((p, q))
    return found


def _nms_place(boxes, scores, device, dtype):
    dtype = dtype or torch.float32
    return boxes.to(device=device, dtype=dtype), scores.to(device=device, dtype=dtype)


def call(name, d, plain=False):
    """Run kernel ``name`` (or its plain version) on clones of ``d``.
    Returns its outputs as a tuple of tensors; a group that selects its own
    rows (a TOPK entry without ``d["topk_cov"]``) adds its selection."""
    fn = KERNELS[name][1 if plain else 0]
    d = {key: v.clone() if torch.is_tensor(v) else v for key, v in d.items()}
    if name not in TOPK:
        return _invoke(name, fn, d)
    picked = []
    previous, gate_group.record_selection = gate_group.record_selection, picked.append
    try:
        out = _invoke(name, fn, d)
    finally:
        gate_group.record_selection = previous
    return tuple(out) + tuple(picked)


def _invoke(name, fn, d):
    name, d = resolve(name, d)
    if name == "nms_padded":
        return fn(d["nms_boxes"], d["nms_scores"], d["nms_threshold"], d["nms_max_out"],
                  detection_nms.BLOCK)
    if name in TOPK:
        return _invoke_topk(name, fn, d, d.get("topk_cov"))
    if name.startswith("scatter_blend"):
        x, values, index, mask = BLEND_INPUTS[name]
        return (fn(d[x], d[values], d[index], None if mask is None else d[mask]),)
    if name in ROWS_INPUTS:
        buf, values, index, mask = ROWS_INPUTS[name]
        if values is None:
            return (fn(d[buf], d[index]),)
        return (fn(d[buf], d[values], d[index], None if mask is None else d[mask]),)
    if name.startswith("fused_attention"):
        c = d["x"].shape[-1]
        cast = torch.bfloat16 if name.endswith("_cast") else None
        return (fn(d["qkv"], heads=d["heads"], scale=(c // d["heads"]) ** 0.5, cast=cast),)
    if name.startswith("window_attention_grid"):
        c = d["x"].shape[-1]
        tables = () if name.endswith("_noterms") else (d["rel_y"], d["rel_x"])
        return (fn(d["qkv_map"], *tables, heads=d["heads"], scale=(c // d["heads"]) ** 0.5,
                   window=d["pad_window"], a=d["pad_window"]),)
    if name == "ln_norms":
        return (fn(d["x"], d["p_qkv"], d["ln1_s"], d["ln1_b"]),)
    if name == "qkv_attention_group":
        c = d["x"].shape[-1]
        return fn(
            d["x"], d["p_qkv"], d["cov1"], d["p_proj"], d["ln1_s"], d["ln1_b"],
            d["w_qkv"], d["b_qkv"], heads=d["heads"], inv_scale=(c // d["heads"]) ** -0.5,
        )
    if name == "proj_group":
        return fn(
            d["attn"], d["p_proj"], d["cov2"], d["x"], d["p_mlp"], d["w_proj"],
            d["b_proj"], d["ln2_s"], d["ln2_b"],
        )
    if name == "dense_mlp_residual":
        return (fn(d["x"], d["ln2_s"], d["ln2_b"], d["w1"], d["b1"], d["w2"], d["b2"]),)
    if name == "window_attention":
        c = d["x"].shape[-1]
        return (fn(d["qkv"], heads=d["heads"], scale=(c // d["heads"]) ** 0.5),)
    if name == "window_attention_windowed":
        c = d["x"].shape[-1]
        return (fn(d["qkv_win"], d["terms"], heads=d["heads"], scale=(c // d["heads"]) ** 0.5,
                   p=d["window"]),)
    if name == "gate_group_linear":
        return fn(
            d["attn"], d["p_proj"], d["buf_proj"], d["cov2"], None, None, d["w_proj"],
            d["b_proj"], d["x"], d["p_mlp"], d["ln2_s"], d["ln2_b"], ln_mode="none",
            kcap=d["k"],
        )
    if name == "gate_group_linear_post":
        return fn(
            d["x"], d["p_qkv"], d["buf_qkv"], d["cov1"], d["ln1_s"], d["ln1_b"], d["w_qkv"],
            d["b_qkv"], ln_mode="post", kcap=d["k"],
        )[:2]
    if name == "block_select_p":
        return (fn(d["x"], d["p_qkv"], d["cov1"], d["ln1_s"], d["ln1_b"], apply_ln=True),)
    if name == "block_scatter_rows":
        return (fn(d["buf_win"], d["sel_index"], d["h_rows"], d["window_map"]),)
    if name == "block_select_scatter_qkv":
        return fn(
            d["x"], d["p_qkv"], d["buf_qkv"], d["cov_sel"], d["w_index"], d["h_rows"],
            d["ln1_s"], d["ln1_b"], apply_ln=True,
        )
    if name == "block_select_scatter_proj":
        return fn(
            d["attn"], d["p_proj"], d["buf_proj"], d["cov_sel"], d["w_index"], d["h_c"], None,
            None, d["x"], d["p_mlp"], d["ln2_s"], d["ln2_b"], apply_ln=False,
        )
    if name == "block_select_scatter_mlp":
        return fn(
            d["x"], d["p_mlp"], d["b_mlp"], d["cov_sel"], d["w_index"], d["h_c"], d["ln2_s"],
            d["ln2_b"], None, d["p_next"], d["ln1_s"], d["ln1_b"], apply_ln=True,
            residual_x=True,
        )
    if name.startswith("softmax_select_matmul_logits"):
        terms = None if name.endswith("_noterms") else d["av_terms"]
        return fn(d["av_logits"], d["p_a"], d["av_cov"], d["p_v"], terms, p=d["pool"])
    if name.startswith("softmax_select_matmul"):
        c = d["x"].shape[-1]
        terms = None if name.endswith("_noterms") else d["av_terms"]
        return fn(
            d["p_a"], d["av_cov"], d["p_v"], d["av_q"], d["av_k"], terms,
            inv_scale=(c // d["heads"]) ** -0.5, p=d["pool"],
        )
    if name.startswith("relpos_bias_add"):
        return (fn(d["rp_x"], d["rp_q"], d["rp_y"], d["rp_xr"], a=d["rp_a"], p=d["rp_p"]),)
    if name == "ln_select_matmul_post":
        return fn(d["x"], d["p_qkv"], d["cov1"], d["ln1_s"], d["ln1_b"], d["w_qkv"], d["b_qkv"],
                  ln_mode="post")
    if name == "ln_select_matmul_none":
        return fn(d["attn"], d["p_proj"], d["cov2"], None, None, d["w_proj"], d["b_proj"],
                  ln_mode="none")
    if name == "select_linear_skip_norms":
        return fn(d["attn"], d["p_proj"], d["cov2"], d["w_proj"], d["b_proj"], d["x"], d["p_mlp"],
                  d["ln2_s"], d["ln2_b"])
    if name == "ln_select":
        return (fn(d["x"], d["p_mlp"], d["cov3"], d["ln2_s"], d["ln2_b"]),)
    if name == "gate_group_mlp_pre":
        return fn(
            d["x"], d["p_mlp"], d["b_mlp"], d["cov3"], d["ln2_s"], d["ln2_b"], d["w1"], d["b1"],
            d["w2"], d["b2"], ln_mode="pre", kcap=d["k"],
        )[:3]
    if name == "gate_group_linear_pre":
        return fn(
            d["x"], d["p_qkv"], d["buf_qkv"], d["cov1"], d["ln1_s"], d["ln1_b"], d["w_qkv"],
            d["b_qkv"], ln_mode="pre", kcap=d["k"],
        )[:2]
    if name == "ln_select_matmul_pre":
        return fn(d["x"], d["p_qkv"], d["cov1"], d["ln1_s"], d["ln1_b"], d["w_qkv"], d["b_qkv"],
                  ln_mode="pre")
    if name == "select_linear_skip_norms_noln":
        return fn(d["attn"], d["p_proj"], d["cov2"], d["w_proj"], d["b_proj"], d["x"], d["p_mlp"],
                  None, None, next_ln=False)
    if name == "ln_select_noln":
        return (fn(d["x"], d["p_mlp"], d["cov3"], None, None, apply_ln=False),)
    if name == "block_select_p_noln":
        return (fn(d["x"], d["p_qkv"], d["cov1"], None, None, apply_ln=False),)
    if name == "block_select_scatter_qkv_noln":
        return fn(d["x"], d["p_qkv"], d["buf_qkv"], d["cov_sel"], d["w_index"], d["h_rows"], None,
                  None, apply_ln=False)
    if name == "block_select_scatter_mlp_noln":
        return fn(d["x"], d["p_mlp"], d["b_mlp"], d["cov_sel"], d["w_index"], d["h_c"], None,
                  None, apply_ln=False, residual_x=True)
    if name == "window_attention_padded":
        c = d["x"].shape[-1]
        return (fn(d["qkv_pad"], d["terms_pad"], d["pad_bias"], d["pad_terms"],
                   heads=d["heads"], scale=(c // d["heads"]) ** 0.5, p=d["pad_window"],
                   a=d["pad_window"], geom=d["geom"]),)
    out = fn(
        d["x"], d["p_mlp"], d["b_mlp"], d["cov3"], d["ln2_s"], d["ln2_b"], d["w1"],
        d["b1"], d["w2"], d["b2"], d["p_next"], d["ln1_s"], d["ln1_b"], kcap=d["k"],
    )
    return tuple(out)


def _invoke_topk(name, fn, d, cov):
    """A TOPK entry: the group selects its own rows where ``cov`` is None."""
    mode = TOPK[name][4]
    if name.startswith("gate_group_mlp"):
        return fn(
            d["x"], d["p_mlp"], d["b_mlp"], cov, d["ln2_s"], d["ln2_b"], d["w1"], d["b1"],
            d["w2"], d["b2"], ln_mode=mode, kcap=d["k"],
        )[:3]
    if mode == "none":
        return fn(
            d["attn"], d["p_proj"], d["buf_proj"], cov, None, None, d["w_proj"], d["b_proj"],
            d["x"], d["p_mlp"], d["ln2_s"], d["ln2_b"], ln_mode="none", kcap=d["k"],
        )
    return fn(
        d["x"], d["p_qkv"], d["buf_qkv"], cov, d["ln1_s"], d["ln1_b"], d["w_qkv"], d["b_qkv"],
        ln_mode=mode, kcap=d["k"],
    )[:2]


# the scatter-blend entries' (x, values, index, mask) keys
BLEND_INPUTS = {
    "scatter_blend": ("buf_proj", "h_c", "blend_index", None),
    "scatter_blend_masked": ("buf_proj", "h_c", "w_index", "blend_mask"),
    "scatter_blend_qkv": ("buf_qkv", "h_rows", "blend_index", None),
    "scatter_blend_wide": ("buf_wide", "h_wide", "w_index", "blend_mask"),
    "scatter_blend_duplicate": ("buf_proj", "h_c", "w_dup", None),
}


def _ulp_order(t):
    """bfloat16 values as integers in the order of the values, so that the
    difference of two is their distance in ulps (+0 and -0 both 0)."""
    bits = t.contiguous().view(torch.int16).to(torch.int32)
    return torch.where(bits < 0, -(bits + 32768), bits)


def compare(got, want):
    """Stats of one output against the plain version's, and whether they
    are within the bounds above."""
    diff = (got.float() - want.float()).abs()
    row = dict(
        dtype=str(got.dtype).split(".")[-1], max_abs_err=float(diff.max()),
        max_scaled_err=float((diff / want.float().abs().clamp(min=1.0)).max()),
    )
    if got.dtype == torch.bfloat16:
        gap = (_ulp_order(got) - _ulp_order(want)).abs()
        row.update(
            differ_share=float((gap > 0).float().mean()),
            far_share=float((gap > 1).float().mean()), max_ulp_gap=int(gap.max()),
        )
        row["ok"] = all(row[key] <= bound for key, bound in (
            ("max_scaled_err", BF16_BOUNDS["scaled"]),
            ("differ_share", BF16_BOUNDS["differ_share"]),
            ("far_share", BF16_BOUNDS["far_share"]),
        ))
    else:
        row["ok"] = row["max_scaled_err"] <= F32_SCALED
    return row


def compare_exact(got, want):
    """:func:`compare`, ok only where the two are equal element for
    element (the scatter-blend: one rounding of the same float32 sum; the
    row scatter and gather: copies)."""
    row = compare(got, want)
    row["ok"] = row["ok"] and row["max_abs_err"] == 0.0
    return row


def compare_rounded(got, want):
    """:func:`compare`, with a float32 output held to the bound of
    BF16_ROUNDED above."""
    row = compare(got, want)
    if got.dtype == torch.float32:
        diff = (got - want).abs() / want.abs().clamp(min=1.0)
        row["beyond_share"] = float((diff > F32_SCALED).float().mean())
        row["ok"] = (row["max_scaled_err"] <= BF16_BOUNDS["scaled"]
                     and row["beyond_share"] <= BF16_BOUNDS["far_share"])
    return row


def comparison(name):
    """The comparison that holds entry ``name`` to its plain version."""
    name = THRESHOLD.get(name, (name,))[0]
    if name.startswith(("scatter_", "gather_rows", "nms")):
        return compare_exact
    return compare_rounded if name in BF16_ROUNDED else compare


# Outputs held bit for bit beside :func:`comparison`'s: row 9's token buffer
# (h's rows copied, or b kept) and y (one rounding of the same float32 sum)
EXACT_OUTPUTS = {"block_select_scatter": ("b", "y")}


def errors(name, d):
    """Run the kernel (once) and its plain version on clones of ``d``.
    Returns one :func:`compare` row per output, the in-place gate state
    included, each with the output's name. A TOPK entry's outputs are held
    against the plain version given the kernel's selection, and the
    selection against :func:`selection_check`'s; each output is held by
    :func:`comparison` (bit for bit for the scatter-blend, the row scatter
    and the gather, and for EXACT_OUTPUTS)."""
    got = call(name, d)
    selection = None
    if name in TOPK:
        *got, picked = got
        want = call(name, dict(d, topk_cov=picked), plain=True)
        selection = selection_check(name, d, picked)
    else:
        want = call(name, d, plain=True)
    torch.cuda.synchronize()
    exact = EXACT_OUTPUTS.get(KERNELS[name][0].__name__, ())
    rows = [dict(output=out, **(compare_exact if out in exact else comparison(name))(a, b))
            for out, a, b in zip(KERNELS[name][4], got, want)]
    if selection is not None:
        rows.append(dict(output="selection", **selection))
    return rows


# A selection of a cov=None group may differ from the plain version's only
# where the two sides' norms, float32 sums of C terms in other orders, lie
# within this share of the k-th largest of each other; with planted ties
# (``d["ties"]``) not at all.
NEAR_TIE = 1e-5


def selection_check(name, d, got):
    """The kernel's selection ``got`` (B, N) against the plain version's on
    the inputs of ``d``: the same count per row and no difference beyond a
    near tie (NEAR_TIE)."""
    xk, pk, sk, bk, mode = TOPK[name]
    norms = gate_group.topk_norms_plain(d[xk], d[pk], d.get(sk), d.get(bk), mode)
    k = d["k"]
    want = coverage_from_norms(norms, k)
    kth = torch.topk(norms, k, dim=-1).values[..., -1:]
    differ = got != want
    near = (norms - kth).abs() <= NEAR_TIE * kth
    ok = torch.equal(got.sum(-1), want.sum(-1)) and bool((~differ | near).all())
    if d.get("ties"):
        ok = ok and not bool(differ.any())
    return dict(
        dtype="float32", max_abs_err=float(differ.any()), max_scaled_err=float(differ.any()),
        selections=int(want.sum()), selections_differing=int(differ.sum()) // 2, ok=ok,
    )


# The card's peaks (NVIDIA H100 SXM data sheet, dense, at 700 W): memory
# bytes/s, and matrix-product operations/s by the operands' type (bf16 on
# the tensor cores; float32 products run on the CUDA cores, as float32
# parity requires).
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def _matmul_ops(name, d):
    """The multiply-add operations (2 per product term) of kernel ``name``
    on ``d``: its matrix products, at the selected rows where the work
    depends on the data; the row passes count none."""
    name, d = resolve(name, d)
    bsz, n, c = d["x"].shape
    heads = d["heads"]
    if name == "qkv_attention_group":
        return 2.0 * bsz * n * c * 3 * c + 4.0 * bsz * n * n * c
    if name == "proj_group":
        return 2.0 * bsz * n * c * c
    if name in ("gate_group_mlp", "gate_group_mlp_pre", "gate_group_mlp_topk",
                "gate_group_mlp_pre_topk"):
        return 4.0 * float(d["cov3"].sum()) * c * d["w1"].shape[1]
    if name == "dense_mlp_residual":
        return 4.0 * bsz * n * c * d["w1"].shape[1]
    if name == "window_attention":
        return 4.0 * bsz * n * n * c
    if name == "window_attention_windowed":
        nw, t, _ = d["qkv_win"].shape
        return 4.0 * nw * t * t * c
    if name == "window_attention_padded":
        nw, t, _ = d["qkv_pad"].shape
        return 4.0 * nw * t * t * c
    if name in ("gate_group_linear", "gate_group_linear_topk"):
        return 2.0 * float(d["cov2"].sum()) * c * c
    if name in ("gate_group_linear_post", "gate_group_linear_pre", "gate_group_linear_post_topk",
                "gate_group_linear_pre_topk"):
        return 2.0 * float(d["cov1"].sum()) * c * 3 * c
    if name.startswith("softmax_select_matmul_logits"):
        return 2.0 * bsz * n * d["p_a"].shape[-1] * c  # A.V only
    if name.startswith("softmax_select_matmul"):
        return 4.0 * bsz * n * d["p_a"].shape[-1] * c
    if name in ("ln_select_matmul_post", "ln_select_matmul_pre"):
        return 2.0 * bsz * n * c * d["w_qkv"].shape[1]
    if name in ("ln_select_matmul_none", "select_linear_skip_norms",
                "select_linear_skip_norms_noln"):
        return 2.0 * bsz * n * c * c
    if name.startswith("relpos_bias_add"):
        p = d["rp_p"]
        return 2.0 * bsz * heads * n * (p[0] + p[1]) * d["rp_q"].shape[-1]
    if name.startswith("fused_attention"):
        return 4.0 * bsz * n * n * c
    if name.startswith("window_attention_grid"):  # tokens x window keys, + the terms' products
        b, hp, wp, _ = d["qkv_map"].shape
        a0, a1 = d["pad_window"]
        terms = 0.0 if name.endswith("_noterms") else 2.0 * b * hp * wp * (a0 + a1) * c
        return 4.0 * b * hp * wp * a0 * a1 * c + terms
    return 0.0


def _nbytes(t):
    return t.numel() * t.element_size()


def _window_targets(d):
    """Row 11's slots on ``d``: (whether each index lies in the window map,
    the window-major row its map entry names, -1 where it lies outside)."""
    index, window_map = d["sel_index"].long(), d["window_map"].long()
    inside = (index >= 0) & (index < window_map.numel())
    return inside, torch.where(inside, window_map[index.clamp(0, window_map.numel() - 1)], -1)


def io_bytes(name, d):
    """The bytes kernel ``name`` must move on ``d``: each tensor it is
    given read once and each new output written once; a gate state it
    updates in place is written only at the rows (the A.V state: the key
    columns) its coverage selects, and read whole only where the function
    uses its old values (a dense product or a residual add over it)."""
    name, d = resolve(name, d)
    bsz, n, c = d["x"].shape
    tokens = _nbytes(d["x"])  # one (B, N, C) output in the working dtype
    norms = bsz * n * 4  # one (B, N) float32 norm vector

    def read(*keys):
        return sum(_nbytes(d[key]) for key in keys)

    def rows(state, cov):
        t = d[state]
        return float(d[cov].sum()) * (t.numel() // d[cov].numel()) * t.element_size()

    if name == "ln_norms":
        return read("x", "p_qkv", "ln1_s", "ln1_b") + norms
    if name == "qkv_attention_group":
        return (read("x", "p_qkv", "cov1", "p_proj", "ln1_s", "ln1_b", "w_qkv", "b_qkv")
                + rows("p_qkv", "cov1") + tokens + norms)
    if name == "proj_group":
        return (read("attn", "p_proj", "cov2", "x", "p_mlp", "w_proj", "b_proj", "ln2_s", "ln2_b")
                + rows("p_proj", "cov2") + tokens + norms)
    if name == "gate_group_mlp":
        return (read("x", "b_mlp", "cov3", "ln2_s", "ln2_b", "w1", "b1", "w2", "b2", "p_next",
                     "ln1_s", "ln1_b")
                + rows("p_mlp", "cov3") + rows("b_mlp", "cov3") + tokens + norms)
    if name == "gate_group_mlp_pre":  # no next-gate norms before the LN
        return (read("x", "b_mlp", "cov3", "ln2_s", "ln2_b", "w1", "b1", "w2", "b2")
                + rows("p_mlp", "cov3") + rows("b_mlp", "cov3") + tokens)
    if name == "dense_mlp_residual":
        return read("x", "ln2_s", "ln2_b", "w1", "b1", "w2", "b2") + tokens
    if name == "window_attention":
        return read("qkv") + tokens
    if name == "window_attention_windowed":
        return read("qkv_win", "terms") + _nbytes(d["qkv_win"]) // 3
    if name == "window_attention_padded":
        return (read("qkv_pad", "terms_pad", "pad_bias", "pad_terms")
                + _nbytes(d["qkv_pad"]) // 3)
    if name == "gate_group_linear":
        return (read("attn", "buf_proj", "cov2", "w_proj", "b_proj", "x", "p_mlp", "ln2_s",
                     "ln2_b")
                + rows("p_proj", "cov2") + rows("buf_proj", "cov2") + tokens + norms)
    if name in ("gate_group_linear_post", "gate_group_linear_pre"):
        return (read("x", "cov1", "ln1_s", "ln1_b", "w_qkv", "b_qkv")
                + rows("p_qkv", "cov1") + rows("buf_qkv", "cov1"))
    # rows 10 and 14: x is read, and p' written, at the selected rows only
    if name == "block_select_p":
        return read("cov1", "ln1_s", "ln1_b") + rows("x", "cov1") + rows("p_qkv", "cov1")
    if name == "block_select_p_noln":
        return read("cov1") + rows("x", "cov1") + rows("p_qkv", "cov1")
    # row 11: the index, the map's entry of each slot whose index lies in the
    # map, and h's row read and b's written at each slot whose entry names a row
    if name == "block_scatter_rows":
        inside, target = _window_targets(d)
        valid = int(((target >= 0) & (target < d["buf_win"].shape[1])).sum())
        row = d["h_rows"].shape[-1] * d["h_rows"].element_size()
        return read("sel_index") + 4 * int(inside.sum()) + 2 * valid * row
    # row 9: x is read whole only where y adds it (the MLP forms), else at the
    # selected rows, as h is at the valid slots (the rows cov_sel marks); b is
    # written at the selected rows and, where y adds its old rows (not the
    # qkv forms), read at the others: its bytes once
    if name.startswith("block_select_scatter"):
        h = "h_rows" if "_qkv" in name else "h_c"
        valid = float(d["cov_sel"].sum()) * d[h].shape[-1] * d[h].element_size()
        sel = read("cov_sel", "w_index") + valid
    if name == "block_select_scatter_qkv":
        return (sel + read("ln1_s", "ln1_b") + rows("x", "cov_sel") + rows("p_qkv", "cov_sel")
                + rows("buf_qkv", "cov_sel"))
    if name == "block_select_scatter_qkv_noln":
        return sel + rows("x", "cov_sel") + rows("p_qkv", "cov_sel") + rows("buf_qkv", "cov_sel")
    if name == "block_select_scatter_mlp_noln":
        return sel + read("x", "b_mlp") + rows("p_mlp", "cov_sel") + tokens
    if name == "block_select_scatter_proj":
        return (sel + read("buf_proj", "x", "p_mlp", "ln2_s", "ln2_b") + rows("attn", "cov_sel")
                + rows("p_proj", "cov_sel") + tokens + norms)
    if name == "block_select_scatter_mlp":
        return (sel + read("x", "b_mlp", "ln2_s", "ln2_b", "p_next", "ln1_s", "ln1_b")
                + rows("p_mlp", "cov_sel") + tokens + norms)
    if name.startswith("softmax_select_matmul"):
        terms = () if name.endswith("_noterms") else ("av_terms",)
        inputs = ("av_logits",) if "_logits" in name else ("av_q", "av_k")
        return (read("p_a", "av_cov", "p_v", *inputs, *terms)
                + rows("p_a", "av_cov") + _nbytes(d["av_q"]))
    # the dense recomputes read the whole gate state, whose old rows they use
    if name in ("ln_select_matmul_post", "ln_select_matmul_pre"):
        return (read("x", "p_qkv", "cov1", "ln1_s", "ln1_b", "w_qkv", "b_qkv")
                + rows("p_qkv", "cov1") + 3 * tokens)
    if name == "ln_select_matmul_none":
        return read("attn", "p_proj", "cov2", "w_proj", "b_proj") + rows("p_proj", "cov2") + tokens
    if name == "select_linear_skip_norms":
        return (read("attn", "p_proj", "cov2", "w_proj", "b_proj", "x", "p_mlp", "ln2_s", "ln2_b")
                + rows("p_proj", "cov2") + tokens + norms)
    if name == "select_linear_skip_norms_noln":
        return (read("attn", "p_proj", "cov2", "w_proj", "b_proj", "x", "p_mlp")
                + rows("p_proj", "cov2") + tokens + norms)
    if name == "ln_select":
        return read("cov3", "ln2_s", "ln2_b") + rows("x", "cov3") + rows("p_mlp", "cov3")
    if name == "ln_select_noln":
        return read("cov3") + rows("x", "cov3") + rows("p_mlp", "cov3")
    if name.startswith("relpos_bias_add"):
        return read("rp_x", "rp_q", "rp_y", "rp_xr") + _nbytes(d["rp_x"])
    # the groups that select their own rows read the whole gate state
    if name in ("gate_group_mlp_topk", "gate_group_mlp_pre_topk"):
        return (read("x", "p_mlp", "b_mlp", "ln2_s", "ln2_b", "w1", "b1", "w2", "b2")
                + rows("p_mlp", "cov3") + rows("b_mlp", "cov3") + tokens)
    if name == "gate_group_linear_topk":
        return (read("attn", "p_proj", "buf_proj", "w_proj", "b_proj", "x", "p_mlp", "ln2_s",
                     "ln2_b")
                + rows("p_proj", "cov2") + rows("buf_proj", "cov2") + tokens + norms)
    if name in ("gate_group_linear_post_topk", "gate_group_linear_pre_topk"):
        return (read("x", "p_qkv", "ln1_s", "ln1_b", "w_qkv", "b_qkv")
                + rows("p_qkv", "cov1") + rows("buf_qkv", "cov1"))
    if name.startswith("scatter_blend"):  # x, the indices and the valid slots' values
        x, values, index, mask = BLEND_INPUTS[name]
        valid = (d[index] >= 0) & (d[index] < n)
        if mask is not None:
            valid = valid & d[mask]
        value_row = d[values].shape[-1] * d[values].element_size()
        return (read(x, index, *(() if mask is None else (mask,))) + _nbytes(d[x])
                + float(valid.sum()) * value_row)
    if name in ROWS_INPUTS:  # the rows of the valid slots, read once and written once
        buf, values, index, mask = ROWS_INPUTS[name]
        slots = d[index].numel() if mask is None else float(d[mask].sum())
        row = d[buf].shape[-1] * d[buf].element_size()
        value_row = row if values is None else d[values].shape[-1] * d[values].element_size()
        return read(index, *(() if mask is None else (mask,))) + slots * (row + value_row)
    if name.startswith("fused_attention"):
        return read("qkv") + tokens
    if name.startswith("window_attention_grid"):
        tables = () if name.endswith("_noterms") else ("rel_y", "rel_x")
        return read("qkv_map", *tables) + _nbytes(d["qkv_map"]) // 3
    raise KeyError(name)


def bound(name, d):
    """(ms, "bytes" or "operations"): the least time the card could take
    for kernel ``name`` on ``d``, the larger of its bytes over the memory
    rate and its product operations over the peak rate of their type."""
    if name == "nms_padded":
        by_bytes = nms_bytes(d) / PEAK_BYTES * 1e3
        by_ops = NMS_IOU_OPS * nms_ious(d) / PEAK_OPS[torch.float32] * 1e3
    else:
        by_bytes = io_bytes(name, d) / PEAK_BYTES * 1e3
        by_ops = _matmul_ops(name, d) / PEAK_OPS[d["x"].dtype] * 1e3
    return (by_ops, "operations") if by_ops > by_bytes else (by_bytes, "bytes")


NMS_IOU_OPS = 15  # float32 steps an IoU: 2 max, 2 min, 2 sub, 2 clamps, mul, add, sub, div, compare


def nms_bytes(d):
    """Row 22's bytes on ``d``: the boxes and scores read once, the indices
    and mask written once. The kernel's shared memory and scratch
    (``nms_design_bytes``) are the design's own, not the function's."""
    boxes, scores = d["nms_boxes"], d["nms_scores"]
    n, max_out = boxes.shape[0], d["nms_max_out"]
    return (_nbytes(boxes) + _nbytes(scores) + 4 * nms.out_len(n, max_out, detection_nms.BLOCK)
            + max_out)


def nms_design_bytes(d):
    """(shared memory, device scratch) bytes of ``csrc/nms.cu`` on ``d``:
    the kept set and the sort's keys, and the keys where they do not fit
    shared memory. A reading of the design, not part of the bound."""
    n, max_out = d["nms_boxes"].shape[0], d["nms_max_out"]
    return nms.smem_bytes(n, max_out), nms.scratch_bytes(n, max_out)


def nms_ious(d):
    """The IoUs a greedy walk needs on ``d`` at least, from the plain
    version's result: each kept box against every box kept before it, each
    valid box it suppresses against one of those, up to the last kept box
    once ``max_out`` are kept (the walk stops there), else over all boxes."""
    boxes, scores, max_out = d["nms_boxes"], d["nms_scores"], d["nms_max_out"]
    n = boxes.shape[0]
    if n == 0 or max_out == 0:
        return 0
    indices, mask = detection_nms.nms_padded_plain(boxes, scores, d["nms_threshold"], max_out)
    order = torch.sort(-scores, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=order.device)
    kept = torch.zeros(n, dtype=torch.long, device=order.device)
    kept_pos = rank[indices[mask[: indices.shape[0]]].long()]
    kept[kept_pos] = 1
    stop = int(kept_pos.max()) + 1 if kept_pos.shape[0] == max_out else n
    before = (kept.cumsum(0) - kept)[:stop]
    valid = (scores[order] > -float("inf"))[:stop]
    suppressed = valid & (kept[:stop] == 0)
    return int((before * kept[:stop]).sum()) + int(suppressed.sum())


def library_call(name, d):
    """One PyTorch call that computes kernel ``name``'s function on ``d``,
    where there is one (a yardstick; the port never calls it), else None:
    ``scaled_dot_product_attention`` for attention (the windowed forms'
    rel-pos terms expanded to a float ``attn_mask`` beforehand, the padded
    form's pad rows substituted beforehand; the grid form with the
    partition of the map and its inverse, the copies it does without),
    ``Tensor.scatter`` for the blend on distinct valid indices,
    ``Tensor.scatter_`` for the row scatter without a mask or a cast,
    ``torch.gather`` for the gather, ``torch.where`` for the selects
    without the LN, ``Tensor.index_put_`` for the windowed rows' scatter
    (its valid (batch row, window-major row) pairs mapped and gathered
    beforehand: the marker's slots write nothing); the fused attention's
    cast (bfloat16 probabilities) SDPA on
    q, k and v cast to bfloat16 beforehand, which keeps its probabilities
    in bfloat16 too. The GEMM rows have no one call; their yardstick is cuBLAS on the
    operands of their GEMMs, prepared beforehand (the selects, the LN, the
    gather): rows 4 and 5 the two GEMMs of the MLP, ``torch.addmm`` with
    the first bias then with the second, on the LN output (row 4: its k
    compacted rows); row 2 ``torch.addmm`` over the B.N rows of the selected
    gate state, then SDPA on the qkv it gives: GEMM and attention only; row
    3 and the dense recomputes of rows 12 and 13 ``torch.addmm`` over the
    B.N rows of their selected gate state; row 7 ``torch.addmm`` on its k
    rows (the LN output of the selected rows in its "post" and "pre" forms);
    each without the row passes, the norms, the skip add and the scatter."""
    name, d = resolve(name, d)
    if name == "nms_padded":
        return None  # no finished NMS kernel on the card's machine (no torchvision)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    heads = d["heads"]
    if name == "dense_mlp_residual" or name.startswith("gate_group_mlp"):
        return _mlp_gemms_call(name, d)
    if name in GEMM_OPERANDS:
        return _gemm_call(name, d, sdpa)
    if name in ("ln_select_noln", "block_select_p_noln"):
        cov, p = ("cov3", "p_mlp") if name == "ln_select_noln" else ("cov1", "p_qkv")
        selected = (d[cov] > 0)[..., None]
        return lambda: torch.where(selected, d["x"], d[p])
    if name == "block_scatter_rows":
        b = d["buf_win"].clone()
        target = _window_targets(d)[1]
        rows, slots = torch.nonzero(target >= 0, as_tuple=True)
        index, values = (rows, target[rows, slots]), d["h_rows"][rows, slots]
        return lambda: b.index_put_(index, values)
    if name in ROWS_INPUTS:
        buf, values, index, mask = ROWS_INPUTS[name]
        if mask is not None or name.endswith("_cast"):
            return None
        x = d[buf].clone()
        index = d[index].long()[..., None].expand(*d[index].shape, x.shape[-1])
        if values is None:
            return lambda: torch.gather(x, 1, index)
        return lambda: x.scatter_(1, index, d[values])
    if name in ("fused_attention", "fused_attention_cast"):
        bsz, n, c3 = d["qkv"].shape
        qkv = d["qkv"] if name == "fused_attention" else d["qkv"].to(torch.bfloat16)
        q, k, v = qkv.reshape(bsz, n, 3, heads, c3 // (3 * heads)).permute(2, 0, 3, 1, 4)
        return lambda: sdpa(q, k, v, scale=1.0 / (c3 // (3 * heads)) ** 0.5)
    if name.startswith("window_attention_grid"):
        return _grid_library_call(name, d, sdpa)
    if name.startswith("window_attention"):
        key = {"window_attention": "qkv", "window_attention_windowed": "qkv_win",
               "window_attention_padded": "qkv_pad"}[name]
        qkv, terms, p = d[key], None, None
        if name == "window_attention_windowed":
            terms, p = d["terms"], d["window"]
        if name == "window_attention_padded":
            valid = window_attention.window_valid(qkv.shape[0], d["geom"], d["pad_window"],
                                                  qkv.device)
            qkv = torch.where(valid[..., None], qkv, d["pad_bias"])
            terms = torch.where(valid[:, None, :, None], d["terms_pad"], d["pad_terms"])
            p = d["pad_window"]
        bsz, n, c3 = qkv.shape
        q, k, v = qkv.reshape(bsz, n, 3, heads, c3 // (3 * heads)).permute(2, 0, 3, 1, 4)
        if terms is None:
            return lambda: sdpa(q, k, v)
        mask = window_attention.expand_terms(terms, p).to(qkv.dtype)
        return lambda: sdpa(q, k, v, attn_mask=mask)
    if name in ("scatter_blend", "scatter_blend_qkv"):
        x, values, index = (d[key] for key in BLEND_INPUTS[name][:3])
        index = index.long()[..., None].expand(values.shape)
        return lambda: x.scatter(1, index, values)
    return None


def _mlp_gemms_call(name, d):
    """The two cuBLAS GEMMs of an MLP entry on its LN output: every row for
    row 5, the rows the MLP gate's coverage selects for row 4."""
    xl = ln_f32(d["x"], d["ln2_s"], d["ln2_b"]).to(d["x"].dtype)
    if name != "dense_mlp_residual":
        xl = xl[d["cov3"] > 0]
    xl = xl.reshape(-1, xl.shape[-1]).contiguous()
    w1, b1, w2, b2 = d["w1"], d["b1"], d["w2"], d["b2"]
    return lambda: torch.addmm(b2, torch.addmm(b1, xl, w1), w2)


# The GEMM entries of rows 2, 3, 7, 12 and 13: (input, gate state, coverage,
# the LN's scale and bias or None, weight, bias, which rows). The GEMM's A
# is where(coverage, ln(input) or input, gate state) over every row
# ("dense"), or ln(input) or input at the covered rows ("gathered").
GEMM_OPERANDS = {
    "qkv_attention_group": ("x", "p_qkv", "cov1", "ln1_s", "ln1_b", "w_qkv", "b_qkv", "dense"),
    "proj_group": ("attn", "p_proj", "cov2", None, None, "w_proj", "b_proj", "dense"),
    **{name: ("x", "p_qkv", "cov1", "ln1_s", "ln1_b", "w_qkv", "b_qkv", "dense")
       for name in ("ln_select_matmul_post", "ln_select_matmul_pre")},
    **{name: ("attn", "p_proj", "cov2", None, None, "w_proj", "b_proj", "dense")
       for name in ("ln_select_matmul_none", "select_linear_skip_norms",
                    "select_linear_skip_norms_noln")},
    **{name: ("attn", "p_proj", "cov2", None, None, "w_proj", "b_proj", "gathered")
       for name in ("gate_group_linear", "gate_group_linear_topk")},
    **{name: ("x", "p_qkv", "cov1", "ln1_s", "ln1_b", "w_qkv", "b_qkv", "gathered")
       for name in ("gate_group_linear_post", "gate_group_linear_pre",
                    "gate_group_linear_post_topk", "gate_group_linear_pre_topk")},
}


def _gemm_call(name, d, sdpa):
    """cuBLAS on the operands of a GEMM entry's product (``GEMM_OPERANDS``),
    and for row 2 SDPA on the qkv it gives."""
    xk, pk, covk, sk, bk, wk, wbk, rows = GEMM_OPERANDS[name]
    x = d[xk] if sk is None else ln_f32(d[xk], d[sk], d[bk]).to(d[xk].dtype)
    cov = d[covk] > 0
    a = torch.where(cov[..., None], x, d[pk]) if rows == "dense" else x[cov]
    a = a.reshape(-1, a.shape[-1]).contiguous()
    w, wb = d[wk], d[wbk]
    if name != "qkv_attention_group":
        return lambda: torch.addmm(wb, a, w)
    bsz, n, c = d["x"].shape
    heads = d["heads"]

    def run():
        qkv = torch.addmm(wb, a, w).view(bsz, n, 3, heads, c // heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        return sdpa(q, k, v)

    return run


def _grid_library_call(name, d, sdpa):
    """The grid form as the partition of the map, SDPA over the windows
    (the rel-pos terms of the map's q against the tables expanded to a
    float mask beforehand) and the inverse partition."""
    x, heads = d["qkv_map"], d["heads"]
    b, hp, wp, c3 = x.shape
    (a0, a1), c = d["pad_window"], c3 // 3

    def partition():
        win = x.reshape(b, hp // a0, a0, wp // a1, a1, c3).permute(0, 1, 3, 2, 4, 5)
        return win.reshape(-1, a0 * a1, c3)

    mask = None
    if not name.endswith("_noterms"):
        tab = torch.cat([d["rel_y"].repeat_interleave(a1, dim=0), d["rel_x"].repeat(a0, 1, 1)], 1)
        terms = window_attention.window_bias_terms(partition(), tab, heads)
        mask = window_attention.expand_terms(terms, (a0, a1)).to(x.dtype)

    def run():
        win = partition()
        q, k, v = win.reshape(win.shape[0], a0 * a1, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
        out = sdpa(q, k, v, attn_mask=mask, scale=1.0 / (c // heads) ** 0.5)
        out = out.transpose(1, 2).reshape(b, hp // a0, wp // a1, a0, a1, c)
        return out.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)

    return run


def two_phase_call(name, d):
    """For a TOPK entry, the same group in two phases, as the blocks run it
    with the switch off (the comparison core/blocks.py:1400-1412 of the JAX
    package records on the TPU): the error norms (``ln_norms`` after the
    LN, the difference norm in x's dtype before it), ``coverage_from_norms``,
    then the group given that coverage; else None."""
    if name not in TOPK:
        return None
    xk, pk, sk, bk, mode = TOPK[name]
    fn = KERNELS[name][0]
    d = {key: v.clone() if torch.is_tensor(v) else v for key, v in d.items()}

    def run():
        x, p = d[xk], d[pk]
        if mode == "post":
            norms = gate_fused.ln_norms(x, p, d[sk], d[bk])
        else:
            norms = vector_norm(x - p, -1, 2)
        return _invoke_topk(name, fn, d, coverage_from_norms(norms, d["k"]))

    return run


def time_call(fn, iters=20, warmup=3):
    """Mean milliseconds of ``fn()`` over ``iters`` back-to-back calls,
    timed with CUDA events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters=200, warmup=3):
    """Mean microseconds of host time of one ``fn()`` call over ``iters``
    back-to-back calls (``time.perf_counter_ns``), the card left to run
    behind: what a call costs the calling thread. Where the host is the
    slower side, as for the small kernels, :func:`time_call`'s CUDA-event
    time reads about the same."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter_ns()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter_ns() - start
    torch.cuda.synchronize()
    return elapsed / iters / 1e3


# The kernel each row-copy wrapper launches once a call (rows 11 and 18-20),
# by the name the profiler gives it, cut as :func:`device_us` cuts it.
ROW_COPY_KERNELS = {
    "block_scatter_rows": "block_scatter_rows_kernel",
    "scatter_blend": "scatter_blend_kernel",
    "scatter_rows_inplace": "scatter_rows_kernel",
    "gather_rows": "gather_rows_kernel",
}
# The same for rows 1, 9, 10 and 14 in the warp-per-row body (csrc/row_pass.cuh)
ROW_PASS_KERNELS = {
    "ln_norms": "ln_norms_kernel",
    "block_select_scatter": "select_scatter_kernel",
    "block_select_p": "select_warp_kernel",
    "ln_select": "select_warp_kernel",
}


def device_us(fn, calls=20):
    """(device microseconds of one ``fn()`` call, {kernel: launches a
    call}) from :func:`device_us_by_kernel`, the kernels' times summed."""
    by = device_us_by_kernel(fn, calls)
    return sum(us for _, us in by.values()), {short: n for short, (n, _) in by.items()}


def device_us_by_kernel(fn, calls=20):
    """{kernel: (launches a call, device microseconds a call)} of ``fn()``
    under ``torch.profiler`` over ``calls`` calls, each kernel by its name
    cut to the function's own (``void etk::gather_rows_kernel(...)`` ->
    ``gather_rows_kernel``): its launches a call, its events' count over
    the calls rounded (the profiler may drop an event of the first or last
    call), and its mean time an event times those launches. A trace that
    caught no device event at all is taken again, twice at most."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    kernels = {}  # name -> [events, microseconds]
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if not str(getattr(e, "device_type", "")).endswith("CUDA"):
                continue
            short = e.name.split("(")[0].split("<")[0].split("::")[-1].strip().split(" ")[-1]
            seen = kernels.setdefault(short, [0, 0.0])
            seen[0] += 1
            seen[1] += e.time_range.elapsed_us()
        if kernels:
            break
    launches = {short: round(count / calls) for short, (count, _) in kernels.items()}
    return {short: (launches[short], t / count * launches[short])
            for short, (count, t) in kernels.items() if launches[short]}


def queued_device_us(fn, calls=20, sleep_cycles=20_000_000):
    """Device microseconds of one ``fn()`` call from CUDA events around
    ``calls`` calls queued behind a kernel that sleeps ``sleep_cycles``
    cycles (about 10 ms), so that the card runs them back to back whatever
    the host's pace: the kernels' times and the gaps between launches."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / calls


def allocations(fn, calls=20):
    """Device allocations one ``fn()`` call makes (the caching allocator's
    count, reused blocks included)."""
    fn()
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (torch.cuda.memory_stats()["allocation.all.allocated"] - before) / calls


def row_copy_profile(name, d, bound_ms):
    """Entry ``name`` of rows 11 and 18-20, or of rows 1, 9, 10 and 14, on ``d`` profiled:
    its device microseconds a call (:func:`device_us`; where the profiler
    caught no device event, :func:`queued_device_us`, as ``device_us_by``
    says), the share of the card's bound ``bound_ms`` they reach, the
    kernels a call launches, its device allocations a call, and whether it
    launches exactly its own kernel once a call (None where the profiler
    caught nothing)."""
    fn = KERNELS[name][0]
    d = {key: v.clone() if torch.is_tensor(v) else v for key, v in d.items()}
    call = lambda: _invoke(name, fn, d)  # noqa: E731
    us, kernels = device_us(call)
    by = "profiler"
    if not kernels:
        us, by = queued_device_us(call), "events behind a sleep"
    return dict(
        device_us=us, device_us_by=by, bound_share=bound_ms * 1e3 / us,
        kernels_per_call=kernels or None, allocations_per_call=allocations(call),
        one_launch=kernels == {{**ROW_COPY_KERNELS, **ROW_PASS_KERNELS}[fn.__name__]: 1}
        if kernels else None,
    )


def kernel_host_us(name, d, iters=200, warmup=3):
    """:func:`host_us` of one call of kernel ``name``'s wrapper on ``d``,
    the call :func:`time_ms` times (this module's dispatch on ``name``
    included)."""
    d = {key: v.clone() if torch.is_tensor(v) else v for key, v in d.items()}
    fn = KERNELS[name][0]
    return host_us(lambda: _invoke(name, fn, d), iters, warmup)


def time_ms(name, d, plain=False, iters=20, warmup=3):
    """Mean milliseconds of one call over ``iters`` back-to-back calls,
    timed with CUDA events after ``warmup`` calls."""
    fn = KERNELS[name][1 if plain else 0]
    d = {key: v.clone() if torch.is_tensor(v) else v for key, v in d.items()}
    return time_call(lambda: _invoke(name, fn, d), iters, warmup)
