"""The blocked gate kernels of large token counts (port of
``block_select_scatter``, ``block_select_p`` and ``block_scatter_rows`` from
``eventful_transformer_tpu/ops/pallas/gate_block.py``).

The "blocked" regime (N > 2048, ViTDet-1024) selects the rows and runs the
gated op on the k selected rows outside any kernel; ``block_select_scatter``
then makes the one pass over the full-size state: the gate-state select,
the scatter-blend of the op's k rows into the token buffer, the skip (or
x) add and the next gate's norms. A windowed eventful block keeps its qkv
buffer in the window-major layout that windowed attention reads, so its
qkv group splits that pass in two: the gate-state select over the
row-major tokens (``block_select_p``) and the buffer update over
window-major rows (``block_scatter_rows``), whose kernel maps each
selected token to its window-major row through the static window
permutation itself. All three update their state in place, as the TPU
kernels alias it. Index lists name rows in any order, and valid indices
must be distinct, as a top-k selection makes them. An invalid slot holds
-1 (the port's convention) or the JAX package's marker N; a slot whose
index lies outside the rows (or the map) writes nothing, in the plain
versions and the kernels alike. The CUDA kernels are
``csrc/gate_block.cu`` (``block_scatter_rows`` a bulk row copy); see its
header for what bounds them.
``block_select_p`` and ``block_select_scatter`` count their launches in
``launches``, by whether the gate takes ln(x) or x (``apply_ln``) in
``form_launches``, and by the row body ``ops/row_pass.py::row_body`` picks
in ``row_body_launches``. ``block_select_p``'s launch path,
:func:`select_args`, is also that of ``gate_fused.ln_select`` (row 14).
"""

from __future__ import annotations

import functools

import torch

from eventful_transformer_tpu_torch.ops import _build, row_pass, scatter
from eventful_transformer_tpu_torch.ops.common import ln_f32, row_norms


def _ptr(t):
    return None if t is None else t.data_ptr()


def block_select_scatter_plain(
    x, p, b, cov, index, h, scale, bias, skip=None, p_next=None, next_scale=None,
    next_bias=None, *, apply_ln, residual_x=False
):
    """x (B, N, C) group input; p (B, N, C) gate state and b (B, N, F) token
    buffer, both updated in place; cov (B, N) float32 (> 0 = selected);
    index (B, KP) the selected rows in any order, -1 in an invalid slot; h
    (B, KP, F), row j the op's output for token index[j]; skip (B, N, F)
    optional residual, or ``residual_x`` to add x itself (F == C).

    p' = where(cov, ln(x) | x, p); b' = where(cov, h[slot], b), 0 for a
    selected row that no slot names; y = rnd(b' + skip | x); with
    ``p_next``, the next gate's norms ||ln(y) * s + b - p_next|| of the
    rounded y. Returns (p, b), (p, b, y) or (p, b, y, norms), as the JAX
    kernel does."""
    sel = cov[..., None] > 0
    new = ln_f32(x, scale, bias) if apply_ln else x.float()
    p.copy_(torch.where(sel, new, p.float()).to(p.dtype))
    valid = (index >= 0) & (index < x.shape[-2])
    rows, slots = torch.nonzero(valid, as_tuple=True)
    scattered = torch.zeros_like(b)
    scattered[rows, index[rows, slots].long()] = h[rows, slots].to(b.dtype)
    b.copy_(torch.where(sel, scattered, b))
    if skip is None and not residual_x:
        return p, b
    y = (b.float() + (x if residual_x else skip).float()).to(x.dtype)
    if p_next is None:
        return p, b, y
    return p, b, y, row_norms(ln_f32(y, next_scale, next_bias) - p_next.float())


def block_select_scatter(
    x, p, b, cov, index, h, scale, bias, skip=None, p_next=None, next_scale=None,
    next_bias=None, *, apply_ln, residual_x=False
):
    """The wrapper of :func:`block_select_scatter_plain`, which CPU tensors
    take. CUDA tensors launch the one kernel of csrc/gate_block.cu, in the
    body ``row_pass.row_body`` picks (each selected row finds its slot in
    ``index`` itself); ``index`` is int32 there. Valid indices must be
    distinct: a duplicated one is undefined. It allocates its outputs
    alone."""
    if x.device.type == "cpu":
        return block_select_scatter_plain(
            x, p, b, cov, index, h, scale, bias, skip, p_next, next_scale, next_bias,
            apply_ln=apply_ln, residual_x=residual_x,
        )
    name = "block_select_scatter"
    if skip is not None and residual_x:
        raise ValueError(f"{name}: give skip or residual_x, not both")
    if p_next is not None and skip is None and not residual_x:
        raise ValueError(f"{name}: the next gate's norms need the y output")
    bsz, n, c = x.shape
    f, kp = b.shape[-1], index.shape[-1]
    shapes = dict(p=x.shape, b=(bsz, n, f), cov=(bsz, n), h=(bsz, kp, f))
    operands = dict(p=p, b=b, cov=cov, h=h)
    if apply_ln:
        shapes.update(scale=(c,), bias=(c,))
        operands.update(scale=scale, bias=bias)
    if skip is not None:
        shapes["skip"] = (bsz, n, f)
        operands["skip"] = skip
    if residual_x and f != c:
        raise ValueError(f"{name}: residual_x needs F == C, got F={f}, C={c}")
    if p_next is not None:
        shapes.update(p_next=(bsz, n, f), next_scale=(f,), next_bias=(f,))
        operands.update(p_next=p_next, next_scale=next_scale, next_bias=next_bias)
    _build.check_operands(name, x, ("cov",), **operands)
    for key, shape in shapes.items():
        _build.check_shape(name, key, operands[key], shape)
    if index.dtype != torch.int32 or index.device != x.device or not index.is_contiguous():
        raise TypeError(f"{name}: index must be a contiguous int32 tensor on {x.device}")
    _build.check_shape(name, "index", index, (bsz, kp))
    if f > _build.MAX_ROW_WIDTH:
        raise ValueError(f"{name}: F={f} exceeds {_build.MAX_ROW_WIDTH}")
    vectors = [x, p, b, h, skip, p_next, next_scale, next_bias]  # moved as 16-byte vectors
    if apply_ln:
        vectors += [scale, bias]
    body = row_pass.row_body(x.dtype, (c, f), _build.aligned16(*vectors))
    with_y = skip is not None or residual_x
    y = torch.empty((bsz, n, f), dtype=x.dtype, device=x.device) if with_y else None
    norms = None
    if p_next is not None:
        norms = torch.empty((bsz, n), dtype=torch.float32, device=x.device)
    _build.launch(
        "etk_block_select_scatter", _build.dtype_code(x), row_pass.ROW_BODY_CODES[body],
        x.data_ptr(), p.data_ptr(), b.data_ptr(), cov.data_ptr(), index.data_ptr(),
        h.data_ptr(), _ptr(scale) if apply_ln else None, _ptr(bias) if apply_ln else None,
        _ptr(skip), int(residual_x), _ptr(p_next), _ptr(next_scale), _ptr(next_bias), _ptr(y),
        _ptr(norms), bsz, n, c, f, kp, _build.stream_of(x),
    )
    block_select_scatter.launches += 1
    block_select_scatter.form_launches["ln" if apply_ln else "no_ln"] += 1
    block_select_scatter.row_body_launches[body] += 1
    if y is None:
        return p, b
    return (p, b, y) if norms is None else (p, b, y, norms)


block_select_scatter.launches = 0
block_select_scatter.form_launches = dict.fromkeys(("ln", "no_ln"), 0)
block_select_scatter.row_body_launches = row_pass.new_body_counts()


def block_select_p_plain(x, p, cov, scale, bias, *, apply_ln):
    """p' = where(cov, ln(x) | x, p) rounded to p's dtype, in place.
    x, p (B, N, C); cov (B, N) float32 (> 0 = selected)."""
    new = ln_f32(x, scale, bias) if apply_ln else x.float()
    p.copy_(torch.where(cov[..., None] > 0, new, p.float()).to(p.dtype))
    return p


def block_select_p(x, p, cov, scale, bias, *, apply_ln):
    """The wrapper of :func:`block_select_p_plain`, which CPU tensors take.
    CUDA tensors launch the select of csrc/gate_block.cu in the body
    ``row_pass.row_body`` picks (:func:`select_args`)."""
    if x.is_cpu:
        return block_select_p_plain(x, p, cov, scale, bias, apply_ln=apply_ln)
    body, args = select_args("block_select_p", x, p, cov, scale, bias, apply_ln)
    _build.launch("etk_block_select_p", *args)
    block_select_p.launches += 1
    block_select_p.form_launches["ln" if apply_ln else "no_ln"] += 1
    block_select_p.row_body_launches[body] += 1
    return p


block_select_p.launches = 0
block_select_p.form_launches = dict.fromkeys(("ln", "no_ln"), 0)
block_select_p.row_body_launches = row_pass.new_body_counts()


@functools.cache
def _select_body(dtype, c, aligned):
    """``row_pass.row_body`` of a select over rows of ``c`` values, kept
    by its arguments: it costs more host time than the lookup."""
    return row_pass.row_body(dtype, (c,), aligned)


def _operand(name, key, t, index, dtype, shape):
    """``t``'s data pointer, after the checks of ``_build.check_operands``
    and ``_build.check_shape``: on cuda:``index``, of ``dtype``,
    contiguous, of ``shape``."""
    if t.get_device() != index:
        raise ValueError(f"{name}: {key} on {t.device}, expected cuda:{index}")
    if t.dtype is not dtype:
        raise TypeError(f"{name}: {key} is {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {key} must be contiguous")
    if t.shape != shape:
        raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    return t.data_ptr()


def select_args(name, x, p, cov, scale, bias, apply_ln):
    """(body, arguments) of the C entry ``etk_block_select_p`` for p' =
    where(cov, ln(x) | x, p) in place on CUDA tensors, rows 10 and 14: the
    body ``row_pass.row_body`` picks. The operands are checked as
    ``_build.check_operands`` and ``_build.check_shape`` check them (none
    requiring grad in grad mode; x a contiguous CUDA tensor of a kernel dtype, C <= MAX_ROW_WIDTH; p of x's
    shape and cov (B, N) float32 and, with ``apply_ln``, scale and bias
    (C,), each on x's device, contiguous, in x's dtype but cov), reading
    each tensor's attributes once and building no dict per call: a call's
    host time is most of its time. scale and bias go across only with
    ``apply_ln`` (null: the kernel copies x)."""
    index = x.get_device()  # -1 off the card
    if index < 0:
        raise ValueError(f"{name}: expected CUDA or CPU tensors, got {x.device}")
    _build.check_no_grad(name, x, p, cov, scale, bias)
    dtype, shape = x.dtype, x.shape
    code = _build.DTYPE_CODES.get(dtype)
    if code is None:
        raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    c = shape[-1]
    if c > _build.MAX_ROW_WIDTH:
        raise ValueError(f"{name}: C={c} exceeds {_build.MAX_ROW_WIDTH}")
    xp = x.data_ptr()
    pp = _operand(name, "p", p, index, dtype, shape)
    cp = _operand(name, "cov", cov, index, torch.float32, shape[:-1])
    sp = bp = None
    aligned = xp % 16 == 0 and pp % 16 == 0
    if apply_ln:
        sp = _operand(name, "scale", scale, index, dtype, (c,))
        bp = _operand(name, "bias", bias, index, dtype, (c,))
        aligned = aligned and sp % 16 == 0 and bp % 16 == 0
    body = _select_body(dtype, c, aligned)
    return body, (code, row_pass.ROW_BODY_CODES[body], xp, pp, cp, sp, bp, x.numel() // c, c,
                  _build.stream_on(index))


def block_scatter_rows_plain(b, index, h, row_map=None):
    """b'[i] = h[j] where target[j] == i, else b[i], in place. b (B, NW, F);
    index (B, KP) in any order; h (B, KP, F). The target of slot j is
    ``index[j]`` or, with ``row_map`` (M,) int32, ``row_map[index[j]]``. A
    slot writes nothing where its index is -1, lies outside [0, NW) or,
    with a map, outside [0, M), or where its map entry lies outside [0,
    NW), as the JAX kernel's one-hot matches no row there. Valid targets
    must be distinct. Without a map this is the JAX kernel's function; with
    one, that of the kernel on ``jnp.take(row_map, index)``."""
    target = index.long()
    if row_map is not None:
        m = row_map.shape[0]
        inside = (target >= 0) & (target < m)
        target = torch.where(inside, row_map.long()[target.clamp(0, max(m - 1, 0))], -1)
    valid = (target >= 0) & (target < b.shape[1])
    rows, slots = torch.nonzero(valid, as_tuple=True)
    b[rows, target[rows, slots]] = h[rows, slots].to(b.dtype)
    return b


def block_scatter_rows(b, index, h, row_map=None):
    """The wrapper of :func:`block_scatter_rows_plain`, which CPU tensors
    take. CUDA tensors launch the bulk row copy of csrc/gate_block.cu: one
    launch, each slot's index and map entry read in the kernel, nothing
    allocated. ``index`` and ``row_map`` are int32 there, h of b's dtype,
    rows of F values whole 16-byte words on 16-byte boundaries. The
    operands are checked in one pass (``scatter.cuda_operands``), as rows
    19 and 20's are."""
    if b.is_cpu:
        return block_scatter_rows_plain(b, index, h, row_map)
    name = "block_scatter_rows"
    shape = b.shape
    if len(shape) != 3:
        raise ValueError(f"{name}: b {tuple(shape)} is not (B, NW, F)")
    bsz, nw, f = shape
    kp = index.shape[-1]
    if index.shape != (bsz, kp):
        _build.check_shape(name, "index", index, (bsz, kp))
    if h.shape != (bsz, kp, f):
        _build.check_shape(name, "h", h, (bsz, kp, f))
    if h.dtype is not b.dtype:
        raise TypeError(f"{name}: h is {h.dtype}, expected {b.dtype}")
    if index.dtype is not torch.int32:
        raise TypeError(f"{name}: index is {index.dtype}, expected torch.int32")
    m = 0
    if row_map is not None:
        if row_map.dtype is not torch.int32 or row_map.dim() != 1:
            raise TypeError(f"{name}: row_map must be a 1-D torch.int32 tensor")
        m = row_map.shape[0]
    (code, _), (b_ptr, h_ptr, index_ptr, _, map_ptr), device = scatter.cuda_operands(
        name, b, h, index, None, row_map
    )
    _build.launch(
        "etk_block_scatter_rows", code, b_ptr, index_ptr, h_ptr, map_ptr, m, bsz, nw, kp, f,
        _build.stream_on(device),
    )
    block_scatter_rows.launches += 1
    return b


block_scatter_rows.launches = 0
