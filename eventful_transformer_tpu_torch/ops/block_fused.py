"""Kernels A and B of the eventful block step (port of
``eventful_transformer_tpu/ops/pallas/block_fused.py``).

One incremental block step is a pipeline split at the three top-k
boundaries: kernel A (qkv gate select, dense qkv recompute from the gate
state, attention, projection-gate norms), kernel B (projection gate select,
projection recompute, skip add, MLP-gate norms), then kernel C
(``ops/gate_group.py``). Between them only (B, N) norm vectors and the
coverage computed from them cross.

Both kernels update their gate state ``p`` in place, as the TPU kernels
alias it (``input_output_aliases``), and so do the plain versions. Every
rounding to the working dtype of the TPU kernels is kept: bf16 results
depend on them. The CUDA kernels are ``csrc/block_fused.cu``; see its
header for the launch structure and what bounds it. Each kernel's GEMM
takes the core ``ops/gemm_core.py::gemm_core`` picks (bfloat16 at the
paths' widths: the wgmma core), counted in ``core_launches``; its row passes
(the select, the difference or LN norms) the body ``ops/row_pass.py::
row_body`` picks, counted in ``row_body_launches``.
"""

from __future__ import annotations

import torch

from eventful_transformer_tpu_torch.ops import _build, gemm_core, row_pass
from eventful_transformer_tpu_torch.ops.common import ln_f32, row_norms
from eventful_transformer_tpu_torch.ops.window_attention import (
    BODY_CODES,
    attention_body,
    attention_plain,
    attention_smem_bytes,
)


def _mm(a, w):
    """a @ w with float32 accumulation, rounded to the working dtype."""
    return torch.matmul(a.float(), w.float()).to(a.dtype)


def _select(cov, new, p):
    return torch.where(cov[..., None] > 0, new, p.float())


def qkv_attention_group_plain(
    x, p_qkv, cov, p_proj, ln1_scale, ln1_bias, w_qkv, b_qkv, *, heads, inv_scale
):
    """x (B, N, C) working dtype; p_qkv gate state (post-LN domain), updated
    in place; cov (B, N) float32 qkv-gate coverage; p_proj the projection
    gate state, read for the norms. Returns (p_qkv, attn, proj_norms)."""
    wd = x.dtype
    p1 = _select(cov, ln_f32(x, ln1_scale, ln1_bias), p_qkv)
    p_qkv.copy_(p1.to(p_qkv.dtype))
    qkv = _mm(p1.to(wd), w_qkv) + b_qkv.to(wd)
    out = attention_plain(qkv, heads, inv_scale)
    norms = row_norms(out.float() - p_proj.float())
    return p_qkv, out, norms


def qkv_attention_group(
    x, p_qkv, cov, p_proj, ln1_scale, ln1_bias, w_qkv, b_qkv, *, heads, inv_scale
):
    """Kernel A; the wrapper of :func:`qkv_attention_group_plain`, which CPU
    tensors take. CUDA tensors launch the kernels of csrc/block_fused.cu;
    the attention stage's body (``window_attention.attention_body``) is
    counted in ``body_launches``, the GEMM's core in ``core_launches``, the
    body of the select and norms passes (``row_pass.row_body``) in
    ``row_body_launches``."""
    if x.device.type == "cpu":
        return qkv_attention_group_plain(
            x, p_qkv, cov, p_proj, ln1_scale, ln1_bias, w_qkv, b_qkv,
            heads=heads, inv_scale=inv_scale,
        )
    name = "qkv_attention_group"
    _build.check_operands(
        name, x, ("cov",), p_qkv=p_qkv, cov=cov, p_proj=p_proj,
        ln1_scale=ln1_scale, ln1_bias=ln1_bias, w_qkv=w_qkv, b_qkv=b_qkv,
    )
    bsz, n, c = x.shape
    if c % heads:
        raise ValueError(f"{name}: {heads} heads do not divide C={c}")
    for key, t, shape in (
        ("p_qkv", p_qkv, x.shape), ("p_proj", p_proj, x.shape), ("cov", cov, (bsz, n)),
        ("ln1_scale", ln1_scale, (c,)), ("ln1_bias", ln1_bias, (c,)),
        ("w_qkv", w_qkv, (c, 3 * c)), ("b_qkv", b_qkv, (3 * c,)),
    ):
        _build.check_shape(name, key, t, shape)
    body = attention_body(x.dtype, n, c // heads)  # qkv: a fresh scratch, aligned
    attention_smem_bytes(name, n, c // heads, body=body)
    core, plan = gemm_core.gemm_launch(x.dtype, bsz * n, c, 3 * c,
                                       _build.aligned16(p_qkv, w_qkv))
    ws = gemm_core.workspace([plan], x.device)
    row_body = row_pass.row_body(x.dtype, (c,),
                                 _build.aligned16(x, p_qkv, ln1_scale, ln1_bias, p_proj))
    qkv = torch.empty((bsz, n, 3 * c), dtype=x.dtype, device=x.device)
    attn = torch.empty_like(x)
    norms = torch.empty((bsz, n), dtype=torch.float32, device=x.device)
    _build.launch(
        "etk_qkv_attention_group", _build.dtype_code(x), BODY_CODES[body],
        row_pass.ROW_BODY_CODES[row_body], x.data_ptr(),
        p_qkv.data_ptr(), cov.data_ptr(), p_proj.data_ptr(), ln1_scale.data_ptr(),
        ln1_bias.data_ptr(), w_qkv.data_ptr(), b_qkv.data_ptr(), qkv.data_ptr(),
        attn.data_ptr(), norms.data_ptr(), bsz, n, c, heads, float(inv_scale),
        gemm_core.CORE_CODES[core], *gemm_core.split_args([plan], ws), _build.stream_of(x),
    )
    qkv_attention_group.launches += 1
    qkv_attention_group.body_launches[body] += 1
    qkv_attention_group.core_launches[core] += 1
    qkv_attention_group.row_body_launches[row_body] += 1
    return p_qkv, attn, norms


qkv_attention_group.launches = 0
qkv_attention_group.body_launches = {"tc": 0, "simt": 0}
qkv_attention_group.core_launches = gemm_core.new_core_counts()
qkv_attention_group.row_body_launches = row_pass.new_body_counts()


def proj_group_plain(attn, p_proj, cov, skip, p_mlp, w_proj, b_proj, ln2_scale, ln2_bias):
    """attn, skip (B, N, C) working dtype; p_proj updated in place; p_mlp
    the MLP gate state (post-LN domain), read for the norms. Returns
    (p_proj, y1, mlp_norms)."""
    wd = attn.dtype
    p2 = _select(cov, attn.float(), p_proj)
    p_proj.copy_(p2.to(p_proj.dtype))
    proj = _mm(p2.to(wd), w_proj) + b_proj.to(wd)
    y1 = proj + skip
    norms = row_norms(ln_f32(y1, ln2_scale, ln2_bias) - p_mlp.float())
    return p_proj, y1, norms


def proj_group(attn, p_proj, cov, skip, p_mlp, w_proj, b_proj, ln2_scale, ln2_bias):
    """Kernel B; the wrapper of :func:`proj_group_plain`, which CPU tensors
    take. CUDA tensors launch the kernels of csrc/block_fused.cu; the
    GEMM's core is counted in ``core_launches``, the body of the select and
    the MLP gate's norms (``row_pass.row_body``) in ``row_body_launches``."""
    if attn.device.type == "cpu":
        return proj_group_plain(
            attn, p_proj, cov, skip, p_mlp, w_proj, b_proj, ln2_scale, ln2_bias
        )
    name = "proj_group"
    _build.check_operands(
        name, attn, ("cov",), p_proj=p_proj, cov=cov, skip=skip, p_mlp=p_mlp,
        w_proj=w_proj, b_proj=b_proj, ln2_scale=ln2_scale, ln2_bias=ln2_bias,
    )
    bsz, n, c = attn.shape
    for key, t, shape in (
        ("p_proj", p_proj, attn.shape), ("skip", skip, attn.shape),
        ("p_mlp", p_mlp, attn.shape), ("cov", cov, (bsz, n)),
        ("w_proj", w_proj, (c, c)), ("b_proj", b_proj, (c,)),
        ("ln2_scale", ln2_scale, (c,)), ("ln2_bias", ln2_bias, (c,)),
    ):
        _build.check_shape(name, key, t, shape)
    core, plan = gemm_core.gemm_launch(attn.dtype, bsz * n, c, c,
                                       _build.aligned16(p_proj, w_proj))
    ws = gemm_core.workspace([plan], attn.device)
    y1 = torch.empty_like(attn)
    norms = torch.empty((bsz, n), dtype=torch.float32, device=attn.device)
    body = row_pass.row_body(attn.dtype, (c,),
                             _build.aligned16(attn, p_proj, p_mlp, ln2_scale, ln2_bias))
    _build.launch(
        "etk_proj_group", _build.dtype_code(attn), row_pass.ROW_BODY_CODES[body], attn.data_ptr(),
        p_proj.data_ptr(), cov.data_ptr(), skip.data_ptr(), p_mlp.data_ptr(),
        w_proj.data_ptr(), b_proj.data_ptr(), ln2_scale.data_ptr(),
        ln2_bias.data_ptr(), y1.data_ptr(), norms.data_ptr(), bsz, n, c,
        gemm_core.CORE_CODES[core], *gemm_core.split_args([plan], ws), _build.stream_of(attn),
    )
    proj_group.launches += 1
    proj_group.core_launches[core] += 1
    proj_group.row_body_launches[body] += 1
    return p_proj, y1, norms


proj_group.launches = 0
proj_group.core_launches = gemm_core.new_core_counts()
proj_group.row_body_launches = row_pass.new_body_counts()
