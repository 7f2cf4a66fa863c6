"""The whole-group gate kernels (port of ``gate_group_mlp`` and
``gate_group_linear`` from ``eventful_transformer_tpu/ops/pallas/gate_group.py``).

``gate_group_mlp`` (kernel C of the eventful block step): gate-state
select, the MLP on the k selected rows only, scatter-blend into the token
buffer, the residual, and optionally the next block's qkv-gate norms.
``gate_group_linear``: the same group around one linear, with an optional
skip add and next-gate norms; ViTDet's "v2" regime runs it for the global
blocks' qkv group (``ln_mode="post"``) and every block's projection group
(``ln_mode="none"`` with the skip and the MLP gate's norms). Both take
``ln_mode="pre"``, the group of a gate before its LN: the gate state takes
x itself, and the compacted rows (the stored p', in p's dtype) are
normalised before the op.

With ``cov=None`` the group selects its own rows (``select_topk`` in the TPU
kernels, ``_topk_cov``): the exact top-``kcap`` set of the error norms
``||new - p||`` in float32, ``new`` = ln(x) for "post" and x itself for
"pre" and "none", ties at the kcap-th norm to the smallest index. These
are not the two-phase path's norms before the LN, which subtract in x's
dtype (``core/blocks.py::_select``); in bfloat16 the two sets may differ.
Each wrapper counts its launches in ``launches`` and, by form, in
``form_launches``: ``ln_mode``, with ``_topk`` appended where the group
selects its own rows. The GEMMs of both take the core
``ops/gemm_core.py::gemm_core`` picks (bfloat16 at the paths' widths: the
wgmma core), counted in ``core_launches``; ``gate_group_linear``'s GEMM
writes the token buffer at the selected rows itself. The select row pass,
and the norms pass of a group that selects its own rows (``ln_norms``' for
"post", the difference norm otherwise), take the body
``ops/row_pass.py::row_body`` picks, counted in ``row_body_launches``. Where
``record_selection`` is a callable, each coverage a ``cov=None`` form
selects is handed to it.

``p`` and ``b`` are updated in place, as the TPU kernels alias them. The
selected rows are compacted in index order, as the TPU kernels' one-hot
compaction orders them. The CUDA kernels are ``csrc/gate_group.cu``; see
its header for the launch structure and what bounds it.
"""

from __future__ import annotations

import torch

from eventful_transformer_tpu_torch.core.indexing import coverage_from_norms
from eventful_transformer_tpu_torch.ops import _build, gemm_core, row_pass
from eventful_transformer_tpu_torch.ops.common import LN_MODES, gelu_exact, ln_f32, row_norms

# A callable handed every (B, N) float32 coverage that a cov=None form
# selects, on the group's device (for a caller that compares selections),
# or None.
record_selection = None


def _ptr(t):
    return None if t is None else t.data_ptr()


def _forms(modes):
    """Form names of a wrapper's ``form_launches``: each LN mode with the
    coverage given, and with ``_topk`` where the group selects."""
    return dict.fromkeys([*modes, *(f"{m}_topk" for m in modes)], 0)


def _record(cov):
    if record_selection is not None:
        record_selection(cov)
    return cov


def topk_norms_plain(x, p, scale, bias, ln_mode):
    """The error norms a cov=None group selects on (gate_group.py:119-121,
    :155-158): (B, N) float32 ||new - p.f32||, new = ln(x) in float32 for
    "post", x.f32 for "pre" and "none"."""
    new = ln_f32(x, scale, bias) if ln_mode == "post" else x.float()
    return row_norms(new - p.float())


def topk_coverage_plain(x, p, scale, bias, ln_mode, kcap):
    """The selection of a cov=None group (gate_group.py:94-152): coverage
    (B, N) float32 of the kcap largest :func:`topk_norms_plain`, ties at the
    kcap-th norm to the smallest index (``coverage_from_norms``)."""
    return _record(coverage_from_norms(topk_norms_plain(x, p, scale, bias, ln_mode), kcap))


def _slots(cov, kcap):
    """(pos, idx): each row's slot among the selected rows of its batch row
    (index order; -1 if unselected) and each slot's row (-1 if empty)."""
    sel = cov > 0
    pos = torch.where(sel, torch.cumsum(sel.to(torch.int64), dim=-1) - 1, -1)
    idx = torch.full((cov.shape[0], kcap), -1, dtype=torch.int64, device=cov.device)
    b, i = torch.nonzero(sel & (pos < kcap), as_tuple=True)
    idx[b, pos[b, i]] = i
    return pos, idx


def _scatter(h, pos, kcap, n):
    """Row i of batch row b takes h[b, pos[b, i]]; 0 where the slot is
    beyond kcap (rows not selected are masked by the caller)."""
    bsz, _, f = h.shape
    rows = torch.gather(h, 1, pos.clamp(0, kcap - 1)[..., None].expand(bsz, n, f))
    return torch.where((pos < kcap)[..., None], rows, 0.0)


def _select_compact(x, p, cov, scale, bias, ln_mode, kcap):
    """p' = where(cov, ln(x) | x, p) into p in place; returns (pos, the
    compacted rows of p' in p's dtype, normalised in float32 for "pre",
    zero in an empty slot)."""
    bsz, _, c = x.shape
    new = ln_f32(x, scale, bias) if ln_mode == "post" else x.float()
    p.copy_(torch.where(cov[..., None] > 0, new, p.float()).to(p.dtype))
    pos, idx = _slots(cov, kcap)
    rows = torch.gather(p, 1, idx.clamp(min=0)[..., None].expand(bsz, kcap, c))
    rows = torch.where(idx[..., None] >= 0, rows, 0.0)
    if ln_mode == "pre":
        rows = ln_f32(rows, scale, bias)
    return pos, rows


def _check_ln_mode(name, ln_mode, modes):
    if ln_mode not in modes:
        raise ValueError(f"{name}: ln_mode must be one of {modes}, got {ln_mode!r}")


def gate_group_linear_plain(
    x, p, b, cov, scale, bias, w, wb, skip=None, p_next=None, next_scale=None,
    next_bias=None, *, ln_mode, kcap
):
    """x (B, N, C) group input; p (B, N, C) gate state and b (B, N, F) token
    buffer, both updated in place; cov (B, N) float32 coverage, or None to
    select the top ``kcap`` rows here (:func:`topk_coverage_plain`); w (C,
    F), wb (F,); skip (B, N, F) optional residual. ``ln_mode``: "post" (p in
    the LN domain), "pre" (p in x's domain, the compacted rows normalised)
    or "none" (p in x's domain; scale and bias unused). Returns (p, b, y,
    next_norms): y None without ``skip``, next_norms None without
    ``p_next``."""
    _check_ln_mode("gate_group_linear", ln_mode, tuple(LN_MODES))
    n = x.shape[1]
    if cov is None:
        cov = topk_coverage_plain(x, p, scale, bias, ln_mode, kcap)
    pos, rows = _select_compact(x, p, cov, scale, bias, ln_mode, kcap)
    h = (torch.matmul(rows.to(w.dtype).float(), w.float()) + wb.float()).to(b.dtype)
    b.copy_(torch.where(cov[..., None] > 0, _scatter(h, pos, kcap, n), b))
    y = next_norms = None
    if skip is not None:
        y = (b.float() + skip.float()).to(x.dtype)
        if p_next is not None:
            next_norms = row_norms(ln_f32(y, next_scale, next_bias) - p_next.float())
    return p, b, y, next_norms


def gate_group_linear(
    x, p, b, cov, scale, bias, w, wb, skip=None, p_next=None, next_scale=None,
    next_bias=None, *, ln_mode, kcap
):
    """The wrapper of :func:`gate_group_linear_plain`, which CPU tensors
    take. CUDA tensors launch the kernels of csrc/gate_group.cu: the GEMM's
    epilogue writes b' at the selected rows, and only a form with ``skip``
    runs a row pass after it. The GEMM's core is counted in
    ``core_launches``."""
    if x.device.type == "cpu":
        return gate_group_linear_plain(
            x, p, b, cov, scale, bias, w, wb, skip, p_next, next_scale, next_bias,
            ln_mode=ln_mode, kcap=kcap,
        )
    name = "gate_group_linear"
    _check_ln_mode(name, ln_mode, tuple(LN_MODES))
    if p_next is not None and skip is None:
        raise ValueError(f"{name}: the next gate's norms need the skip output")
    bsz, n, c = x.shape
    f = w.shape[-1]
    shapes = dict(p=x.shape, b=(bsz, n, f), cov=(bsz, n), w=(c, f), wb=(f,))
    operands = dict(p=p, b=b, cov=cov, w=w, wb=wb)
    ln = ln_mode != "none"
    if ln:
        shapes.update(scale=(c,), bias=(c,))
        operands.update(scale=scale, bias=bias)
    if skip is not None:
        shapes["skip"] = (bsz, n, f)
        operands["skip"] = skip
    if p_next is not None:
        shapes.update(p_next=(bsz, n, f), next_scale=(f,), next_bias=(f,))
        operands.update(p_next=p_next, next_scale=next_scale, next_bias=next_bias)
    _build.check_operands(name, x, ("cov",), **operands)
    for key, shape in shapes.items():
        _build.check_shape(name, key, operands[key], shape)
    if not 1 <= kcap <= n:
        raise ValueError(f"{name}: kcap={kcap} outside [1, N={n}]")
    form = ln_mode if cov is not None else f"{ln_mode}_topk"
    cov, topk_norms = _coverage_scratch(x, cov)
    y = torch.empty((bsz, n, f), dtype=x.dtype, device=x.device) if skip is not None else None
    norms = None
    if p_next is not None:
        norms = torch.empty((bsz, n), dtype=torch.float32, device=x.device)
    idx = torch.empty((bsz, kcap), dtype=torch.int32, device=x.device)
    rows = _normalised_rows(x, ln_mode, kcap)
    core, plan = gemm_core.gemm_launch(x.dtype, bsz * kcap, c, f,
                                       _build.aligned16(p if rows is None else rows, w))
    ws = gemm_core.workspace([plan], x.device)
    body = _row_body(x, p, scale, bias)
    _build.launch(
        "etk_gate_group_linear", _build.dtype_code(x), row_pass.ROW_BODY_CODES[body],
        x.data_ptr(), p.data_ptr(),
        b.data_ptr(), cov.data_ptr(), _ptr(topk_norms), _ptr(scale) if ln else None,
        _ptr(bias) if ln else None, w.data_ptr(), wb.data_ptr(), _ptr(skip),
        _ptr(p_next), _ptr(next_scale), _ptr(next_bias), _ptr(y), _ptr(norms),
        idx.data_ptr(), _ptr(rows), bsz, n, c, f, kcap, LN_MODES[ln_mode],
        gemm_core.CORE_CODES[core], *gemm_core.split_args([plan], ws), _build.stream_of(x),
    )
    gate_group_linear.launches += 1
    gate_group_linear.form_launches[form] += 1
    gate_group_linear.core_launches[core] += 1
    gate_group_linear.row_body_launches[body] += 1
    if topk_norms is not None:
        _record(cov)
    return p, b, y, norms


gate_group_linear.launches = 0
gate_group_linear.form_launches = _forms(LN_MODES)
gate_group_linear.core_launches = gemm_core.new_core_counts()
gate_group_linear.row_body_launches = row_pass.new_body_counts()


def _coverage_scratch(x, cov):
    """(cov, topk_norms): the given coverage and None, or, for a group that
    selects its own rows, the (B, N) float32 scratch its selection pass
    writes the coverage into and the one for the error norms."""
    if cov is not None:
        return cov, None
    shape = x.shape[:2]
    return (torch.empty(shape, dtype=torch.float32, device=x.device),
            torch.empty(shape, dtype=torch.float32, device=x.device))


def _row_body(x, p, scale, bias):
    """The row body (``row_pass.row_body``) of a group's select pass and
    norms pass."""
    return row_pass.row_body(x.dtype, (x.shape[-1],), _build.aligned16(x, p, scale, bias))


def _normalised_rows(x, ln_mode, kcap):
    """The scratch (B, kcap, C) in x's dtype for the "pre" form's
    normalised compacted rows, or None."""
    if ln_mode != "pre":
        return None
    return torch.empty((x.shape[0], kcap, x.shape[-1]), dtype=x.dtype, device=x.device)


def gate_group_mlp_plain(
    x, p, b, cov, scale, bias, w1, b1, w2, b2, p_next=None, next_scale=None,
    next_bias=None, *, ln_mode="post", kcap
):
    """x (B, N, C) group input, doubling as the residual; p gate state and
    b token buffer, both updated in place; cov (B, N) float32 coverage, or
    None to select the top ``kcap`` rows here.
    ``ln_mode``: "post" (p in the LN domain) or "pre" (p in x's domain, the
    compacted rows normalised). Returns (p, b, y, next_norms), next_norms
    None unless ``p_next`` is given."""
    _check_ln_mode("gate_group_mlp", ln_mode, ("post", "pre"))
    wd = x.dtype
    n = x.shape[1]
    if cov is None:
        cov = topk_coverage_plain(x, p, scale, bias, ln_mode, kcap)
    pos, rows = _select_compact(x, p, cov, scale, bias, ln_mode, kcap)
    h = torch.matmul(rows.to(w1.dtype).float(), w1.float()) + b1.float()
    h = gelu_exact(h).to(wd)
    h2 = (torch.matmul(h.to(w2.dtype).float(), w2.float()) + b2.float()).to(b.dtype)
    b.copy_(torch.where(cov[..., None] > 0, _scatter(h2, pos, kcap, n), b))
    y = (b.float() + x.float()).to(wd)
    next_norms = None
    if p_next is not None:
        next_norms = row_norms(ln_f32(y, next_scale, next_bias) - p_next.float())
    return p, b, y, next_norms


def gate_group_mlp(
    x, p, b, cov, scale, bias, w1, b1, w2, b2, p_next=None, next_scale=None,
    next_bias=None, *, ln_mode="post", kcap
):
    """Kernel C; the wrapper of :func:`gate_group_mlp_plain`, which CPU
    tensors take. CUDA tensors launch the kernels of csrc/gate_group.cu."""
    if x.device.type == "cpu":
        return gate_group_mlp_plain(
            x, p, b, cov, scale, bias, w1, b1, w2, b2, p_next, next_scale,
            next_bias, ln_mode=ln_mode, kcap=kcap,
        )
    name = "gate_group_mlp"
    _check_ln_mode(name, ln_mode, ("post", "pre"))
    bsz, n, c = x.shape
    hidden = w1.shape[-1]
    shapes = dict(
        p=x.shape, b=x.shape, cov=(bsz, n), scale=(c,), bias=(c,), w1=(c, hidden),
        b1=(hidden,), w2=(hidden, c), b2=(c,),
    )
    operands = dict(p=p, b=b, cov=cov, scale=scale, bias=bias, w1=w1, b1=b1, w2=w2, b2=b2)
    emit = p_next is not None
    if emit:
        shapes.update(p_next=x.shape, next_scale=(c,), next_bias=(c,))
        operands.update(p_next=p_next, next_scale=next_scale, next_bias=next_bias)
    _build.check_operands(name, x, ("cov",), **operands)
    for key, shape in shapes.items():
        _build.check_shape(name, key, operands[key], shape)
    if not 1 <= kcap <= n:
        raise ValueError(f"{name}: kcap={kcap} outside [1, N={n}]")
    form = ln_mode if cov is not None else f"{ln_mode}_topk"
    cov, topk_norms = _coverage_scratch(x, cov)
    y = torch.empty_like(x)
    norms = torch.empty((bsz, n), dtype=torch.float32, device=x.device) if emit else None
    pos = torch.empty((bsz, n), dtype=torch.int32, device=x.device)
    idx = torch.empty((bsz, kcap), dtype=torch.int32, device=x.device)
    h = torch.empty((bsz, kcap, hidden), dtype=x.dtype, device=x.device)
    h2 = torch.empty((bsz, kcap, c), dtype=x.dtype, device=x.device)
    rows = _normalised_rows(x, ln_mode, kcap)
    core, *plans = gemm_core.mlp_launch(x.dtype, bsz * kcap, c, hidden,
                                        _build.aligned16(p, w1, w2))
    ws = gemm_core.workspace(plans, x.device)
    body = _row_body(x, p, scale, bias)
    _build.launch(
        "etk_gate_group_mlp", _build.dtype_code(x), row_pass.ROW_BODY_CODES[body],
        x.data_ptr(), p.data_ptr(),
        b.data_ptr(), cov.data_ptr(), _ptr(topk_norms), scale.data_ptr(), bias.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), _ptr(p_next),
        _ptr(next_scale), _ptr(next_bias), y.data_ptr(), _ptr(norms), pos.data_ptr(),
        idx.data_ptr(), h.data_ptr(), h2.data_ptr(), _ptr(rows), bsz, n, c, hidden, kcap,
        LN_MODES[ln_mode], gemm_core.CORE_CODES[core], *gemm_core.split_args(plans, ws),
        _build.stream_of(x),
    )
    gate_group_mlp.launches += 1
    gate_group_mlp.form_launches[form] += 1
    gate_group_mlp.core_launches[core] += 1
    gate_group_mlp.row_body_launches[body] += 1
    if topk_norms is not None:
        _record(cov)
    return p, b, y, norms


gate_group_mlp.launches = 0
gate_group_mlp.form_launches = _forms(("post", "pre"))
gate_group_mlp.core_launches = gemm_core.new_core_counts()
gate_group_mlp.row_body_launches = row_pass.new_body_counts()
