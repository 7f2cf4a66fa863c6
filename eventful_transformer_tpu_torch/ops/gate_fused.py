"""The fused gate kernels (port of ``ln_norms``, ``ln_select_matmul``,
``select_linear_skip_norms`` and ``ln_select`` from
``eventful_transformer_tpu/ops/pallas/gate_fused.py``).

``ln_norms`` gives the first block of each incremental step its qkv-gate
selection norms; later blocks receive theirs from the previous block's
kernel C. The other three run in the forced gate-fusion regimes "v1",
"v1v2" and "v3" of ``EventfulTokenwiseBlock``:

- ``ln_select_matmul``: p' = where(cov, ln(x) | x, p) in place, then the
  op's linear recomputed over every row of p' (qkv: "post", projection:
  "none"), or over every row of ln(p') for a qkv gate before its LN
  ("pre");
- ``select_linear_skip_norms``: the projection group of "v3", p' =
  where(cov, x, p), y = rnd(rnd(p' W + b) + skip), and the MLP gate's norms
  ||ln(y) - p_next|| of the rounded y (``next_ln=False``: ||y - p_next||,
  for an MLP gate before its LN);
- ``ln_select``: p' = where(cov, ln(x), p) alone (the MLP gate of "v1"), or
  where(cov, x, p) (``apply_ln=False``).

Each wrapper takes its plain version for CPU tensors and launches its CUDA
kernels for CUDA tensors: ``csrc/ln_norms.cu``, ``csrc/gate_fused.cu``, and
for ``ln_select`` the select row pass of ``csrc/gate_block.cu``, which
computes the same function as ``block_select_p`` and shares its launch path
(``gate_block.select_args``). See the sources' headers for what bounds
them. Each counts its launches in ``launches`` and, by form, in
``form_launches``. The GEMM of ``ln_select_matmul`` and
``select_linear_skip_norms`` takes the core ``ops/gemm_core.py::gemm_core``
picks (bfloat16 at the paths' widths: the wgmma core), counted in
``core_launches``. Each counts the body its row passes take
(``ops/row_pass.py::row_body``: the select, the LN and the norms passes of
``csrc/row_pass.cuh``, "warp", or the block-per-row body) in
``row_body_launches``.
"""

from __future__ import annotations

import torch

from eventful_transformer_tpu_torch.ops import _build, gate_block, gemm_core, row_pass
from eventful_transformer_tpu_torch.ops.common import LN_MODES, ln_f32, row_norms


def ln_norms_plain(x, p, scale, bias):
    """||ln(x) * scale + bias - p|| per token in float32. x, p (B, N, C)."""
    return row_norms(ln_f32(x, scale, bias) - p.float())


def ln_norms(x, p, scale, bias):
    """Kernel wrapper of :func:`ln_norms_plain`: returns norms (B, N) float32.
    CPU tensors take the plain version; CUDA tensors launch the kernel in
    the body ``row_pass.row_body`` picks, counted in ``row_body_launches``."""
    if x.device.type == "cpu":
        return ln_norms_plain(x, p, scale, bias)
    name = "ln_norms"
    _build.check_operands(name, x, p=p, scale=scale, bias=bias)
    c = x.shape[-1]
    _build.check_shape(name, "p", p, x.shape)
    _build.check_shape(name, "scale", scale, (c,))
    _build.check_shape(name, "bias", bias, (c,))
    body = row_pass.row_body(x.dtype, (c,), _build.aligned16(x, p, scale, bias))
    out = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    _build.launch(
        "etk_ln_norms", _build.dtype_code(x), row_pass.ROW_BODY_CODES[body], x.data_ptr(),
        p.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), x.numel() // c, c,
        _build.stream_of(x),
    )
    ln_norms.launches += 1
    ln_norms.row_body_launches[body] += 1
    return out


ln_norms.launches = 0
ln_norms.row_body_launches = row_pass.new_body_counts()


def _select_f32(x, p, cov, scale, bias, apply_ln):
    """where(cov, ln(x) | x, p) in float32."""
    new = ln_f32(x, scale, bias) if apply_ln else x.float()
    return torch.where(cov[..., None] > 0, new, p.float())


def _linear_f32(p_new, w, wb):
    """p' cast to W's dtype, times W with float32 sums, plus the bias in
    float32 (gate_fused.py:86-91)."""
    return torch.matmul(p_new.to(w.dtype).float(), w.float()) + wb.float()


def ln_select_matmul_plain(x, p, cov, scale, bias, w, wb, *, ln_mode):
    """x, p (B, N, C); cov (B, N) float32 (> 0 = selected); w (C, F), wb
    (F,). ``ln_mode`` "post": p' = where(cov, ln(x), p), y = rnd(p' W + wb);
    "pre": p' = where(cov, x, p), y = rnd(ln(p') W + wb); "none": p' =
    where(cov, x, p), y = rnd(p' W + wb) (scale and bias unused). p' is
    written into p in p's dtype; y over every row, in x's dtype. Returns
    (p, y)."""
    if ln_mode not in LN_MODES:
        raise ValueError(f"ln_mode must be one of {tuple(LN_MODES)}, got {ln_mode!r}")
    p_new = _select_f32(x, p, cov, scale, bias, ln_mode == "post")
    p.copy_(p_new.to(p.dtype))
    mm_in = ln_f32(p_new, scale, bias) if ln_mode == "pre" else p_new
    return p, _linear_f32(mm_in, w, wb).to(x.dtype)


def _check_rows(name, x, cov, **vectors):
    """The operands shared by the row-pass wrappers: x (B, N, C), cov (B, N)
    float32, and (C,) or (F,) vectors by keyword."""
    _build.check_shape(name, "cov", cov, x.shape[:-1])
    for key, (t, width) in vectors.items():
        _build.check_shape(name, key, t, (width,))


def ln_select_matmul(x, p, cov, scale, bias, w, wb, *, ln_mode):
    """The wrapper of :func:`ln_select_matmul_plain`, which CPU tensors
    take. CUDA tensors launch the kernels of csrc/gate_fused.cu; every
    operand but cov in x's dtype, cov float32. So the GEMM reads p' as the
    TPU kernel feeds it, p' cast to W's dtype; and for "pre", where x and p
    share one dtype, the float32 p' that the TPU kernel normalises is the
    stored p', which the kernel's LN pass reads back into a scratch that
    the GEMM reads. The GEMM's core is counted in ``core_launches``, the
    body of the select and LN passes (``row_pass.row_body``) in
    ``row_body_launches``."""
    if x.device.type == "cpu":
        return ln_select_matmul_plain(x, p, cov, scale, bias, w, wb, ln_mode=ln_mode)
    name = "ln_select_matmul"
    if ln_mode not in LN_MODES:
        raise ValueError(f"{name}: ln_mode must be one of {tuple(LN_MODES)}, got {ln_mode!r}")
    c, f = x.shape[-1], w.shape[-1]
    ln = ln_mode != "none"
    operands = dict(p=p, cov=cov, w=w, wb=wb)
    vectors = dict(wb=(wb, f))
    if ln:
        operands.update(scale=scale, bias=bias)
        vectors.update(scale=(scale, c), bias=(bias, c))
    _build.check_operands(name, x, ("cov",), **operands)
    _build.check_shape(name, "p", p, x.shape)
    _build.check_shape(name, "w", w, (c, f))
    _check_rows(name, x, cov, **vectors)
    rows = x.numel() // c
    y = torch.empty(x.shape[:-1] + (f,), dtype=x.dtype, device=x.device)
    # "pre": the scratch for ln(p') over every row, which the GEMM reads
    a = torch.empty_like(x) if ln_mode == "pre" else None
    core, plan = gemm_core.gemm_launch(x.dtype, rows, c, f,
                                       _build.aligned16(p if a is None else a, w))
    ws = gemm_core.workspace([plan], x.device)
    body = row_pass.row_body(x.dtype, (c,), _build.aligned16(x, p, scale, bias))
    _build.launch(
        "etk_ln_select_matmul", _build.dtype_code(x), row_pass.ROW_BODY_CODES[body],
        x.data_ptr(), p.data_ptr(),
        cov.data_ptr(), scale.data_ptr() if ln else None, bias.data_ptr() if ln else None,
        w.data_ptr(), wb.data_ptr(), y.data_ptr(), None if a is None else a.data_ptr(),
        rows, c, f, LN_MODES[ln_mode], gemm_core.CORE_CODES[core],
        *gemm_core.split_args([plan], ws), _build.stream_of(x),
    )
    ln_select_matmul.launches += 1
    ln_select_matmul.form_launches[ln_mode] += 1
    ln_select_matmul.core_launches[core] += 1
    ln_select_matmul.row_body_launches[body] += 1
    return p, y


ln_select_matmul.launches = 0
ln_select_matmul.form_launches = dict.fromkeys(LN_MODES, 0)
ln_select_matmul.core_launches = gemm_core.new_core_counts()
ln_select_matmul.row_body_launches = row_pass.new_body_counts()


def select_linear_skip_norms_plain(
    x, p, cov, w, wb, skip, p_next, scale, bias, *, next_ln=True
):
    """x, p (B, N, C); cov (B, N) float32; w (C, F), wb (F,); skip and
    p_next (B, N, F); scale, bias (F,) the next gate's LN (unused without
    ``next_ln``). p' = where(cov, x, p) into p in place; y = rnd(rnd(p' W +
    wb) + skip) over every row; norms = ||ln(y) * scale + bias - p_next||,
    or ||y - p_next|| without ``next_ln``, of the rounded y, float32.
    Returns (p, y, norms)."""
    p_new = _select_f32(x, p, cov, None, None, False)
    p.copy_(p_new.to(p.dtype))
    y = _linear_f32(p_new, w, wb).to(x.dtype)
    y = (y.float() + skip.float()).to(x.dtype)
    yn = ln_f32(y, scale, bias) if next_ln else y.float()
    return p, y, row_norms(yn - p_next.float())


def select_linear_skip_norms(x, p, cov, w, wb, skip, p_next, scale, bias, *, next_ln=True):
    """The wrapper of :func:`select_linear_skip_norms_plain`, which CPU
    tensors take. CUDA tensors launch the kernels of csrc/gate_fused.cu;
    every operand but cov in x's dtype, cov float32. The GEMM's core is
    counted in ``core_launches``, the body of the select and norms passes
    (``row_pass.row_body``) in ``row_body_launches``."""
    if x.device.type == "cpu":
        return select_linear_skip_norms_plain(
            x, p, cov, w, wb, skip, p_next, scale, bias, next_ln=next_ln
        )
    name = "select_linear_skip_norms"
    c, f = x.shape[-1], w.shape[-1]
    operands = dict(p=p, cov=cov, w=w, wb=wb, skip=skip, p_next=p_next)
    vectors = dict(wb=(wb, f))
    if next_ln:
        operands.update(scale=scale, bias=bias)
        vectors.update(scale=(scale, f), bias=(bias, f))
    _build.check_operands(name, x, ("cov",), **operands)
    _build.check_shape(name, "p", p, x.shape)
    _build.check_shape(name, "w", w, (c, f))
    for key, t in (("skip", skip), ("p_next", p_next)):
        _build.check_shape(name, key, t, x.shape[:-1] + (f,))
    _check_rows(name, x, cov, **vectors)
    rows = x.numel() // c
    core, plan = gemm_core.gemm_launch(x.dtype, rows, c, f, _build.aligned16(p, w))
    ws = gemm_core.workspace([plan], x.device)
    y = torch.empty(x.shape[:-1] + (f,), dtype=x.dtype, device=x.device)
    norms = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    body = row_pass.row_body(x.dtype, (c, f), _build.aligned16(x, p, p_next, scale, bias))
    _build.launch(
        "etk_select_linear_skip_norms", _build.dtype_code(x), row_pass.ROW_BODY_CODES[body],
        x.data_ptr(), p.data_ptr(),
        cov.data_ptr(), w.data_ptr(), wb.data_ptr(), skip.data_ptr(), p_next.data_ptr(),
        scale.data_ptr() if next_ln else None, bias.data_ptr() if next_ln else None,
        y.data_ptr(), norms.data_ptr(), rows, c, f, int(next_ln), gemm_core.CORE_CODES[core],
        *gemm_core.split_args([plan], ws), _build.stream_of(x),
    )
    select_linear_skip_norms.launches += 1
    select_linear_skip_norms.form_launches["next_ln" if next_ln else "no_ln"] += 1
    select_linear_skip_norms.core_launches[core] += 1
    select_linear_skip_norms.row_body_launches[body] += 1
    return p, y, norms


select_linear_skip_norms.launches = 0
select_linear_skip_norms.form_launches = dict.fromkeys(("next_ln", "no_ln"), 0)
select_linear_skip_norms.core_launches = gemm_core.new_core_counts()
select_linear_skip_norms.row_body_launches = row_pass.new_body_counts()


def ln_select_plain(x, p, cov, scale, bias, *, apply_ln=True):
    """p' = where(cov, ln(x) * scale + bias, p), or where(cov, x, p)
    without ``apply_ln`` (scale and bias unused), rounded to p's dtype, in
    place. x, p (B, N, C); cov (B, N) float32 (> 0 = selected)."""
    p.copy_(_select_f32(x, p, cov, scale, bias, apply_ln).to(p.dtype))
    return p


def ln_select(x, p, cov, scale, bias, *, apply_ln=True):
    """The wrapper of :func:`ln_select_plain`, which CPU tensors take. CUDA
    tensors launch the select row pass of csrc/gate_block.cu in the body
    ``row_pass.row_body`` picks (``gate_block.select_args``)."""
    if x.is_cpu:
        return ln_select_plain(x, p, cov, scale, bias, apply_ln=apply_ln)
    body, args = gate_block.select_args("ln_select", x, p, cov, scale, bias, apply_ln)
    _build.launch("etk_block_select_p", *args)
    ln_select.launches += 1
    ln_select.form_launches["ln" if apply_ln else "no_ln"] += 1
    ln_select.row_body_launches[body] += 1
    return p


ln_select.launches = 0
ln_select.form_launches = dict.fromkeys(("ln", "no_ln"), 0)
ln_select.row_body_launches = row_pass.new_body_counts()
