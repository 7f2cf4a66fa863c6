"""The split select/scatter pair of the window-resident qkv buffer (port of
``block_select_p`` and ``block_scatter_rows`` from
``eventful_transformer_tpu/ops/pallas/gate_block.py``).

A windowed eventful block keeps its qkv buffer in the window-major layout
that windowed attention reads, so the gate-state select runs over the
row-major tokens and the buffer update over window-major rows, with the
selected indices remapped through the static window permutation. Both
update their state in place, as the TPU kernels alias it. The combined
``block_select_scatter`` (ViTDet-1024's blocked mode) is not ported yet
(ROADMAP.md, "TPU kernels to port"). The CUDA kernels are
``csrc/gate_block.cu``; see its header for what bounds them.
"""

from __future__ import annotations

import torch

from eventful_transformer_tpu_torch.ops import _build
from eventful_transformer_tpu_torch.ops.common import ln_f32


def block_select_p_plain(x, p, cov, scale, bias, *, apply_ln):
    """p' = where(cov, ln(x) | x, p) rounded to p's dtype, in place.
    x, p (B, N, C); cov (B, N) float32 (> 0 = selected)."""
    new = ln_f32(x, scale, bias) if apply_ln else x.float()
    p.copy_(torch.where(cov[..., None] > 0, new, p.float()).to(p.dtype))
    return p


def block_select_p(x, p, cov, scale, bias, *, apply_ln):
    """The wrapper of :func:`block_select_p_plain`, which CPU tensors take.
    CUDA tensors launch the kernel of csrc/gate_block.cu."""
    if x.device.type == "cpu":
        return block_select_p_plain(x, p, cov, scale, bias, apply_ln=apply_ln)
    name = "block_select_p"
    c = x.shape[-1]
    operands = dict(p=p, cov=cov)
    if apply_ln:
        operands.update(scale=scale, bias=bias)
    _build.check_operands(name, x, ("cov",), **operands)
    _build.check_shape(name, "p", p, x.shape)
    _build.check_shape(name, "cov", cov, x.shape[:-1])
    if apply_ln:
        _build.check_shape(name, "scale", scale, (c,))
        _build.check_shape(name, "bias", bias, (c,))
    _build.launch(
        "etk_block_select_p", _build.dtype_code(x), x.data_ptr(), p.data_ptr(),
        cov.data_ptr(), scale.data_ptr() if apply_ln else None,
        bias.data_ptr() if apply_ln else None, int(apply_ln), x.numel() // c, c,
        _build.stream_of(x),
    )
    block_select_p.launches += 1
    return p


block_select_p.launches = 0


def block_scatter_rows_plain(b, index, h):
    """b'[i] = h[j] where index[j] == i, else b[i], in place. b (B, NW, F);
    index (B, KP) row positions in any order, -1 in an invalid slot (never
    matches); h (B, KP, F). Valid indices must be distinct."""
    valid = index >= 0
    rows, slots = torch.nonzero(valid, as_tuple=True)
    b[rows, index[rows, slots].long()] = h[rows, slots].to(b.dtype)
    return b


def block_scatter_rows(b, index, h):
    """The wrapper of :func:`block_scatter_rows_plain`, which CPU tensors
    take. CUDA tensors launch the kernel of csrc/gate_block.cu; ``index``
    is int32 there."""
    if b.device.type == "cpu":
        return block_scatter_rows_plain(b, index, h)
    name = "block_scatter_rows"
    bsz, nw, f = b.shape
    kp = index.shape[-1]
    _build.check_operands(name, b, h=h)
    _build.check_shape(name, "h", h, (bsz, kp, f))
    if index.dtype != torch.int32 or index.device != b.device or not index.is_contiguous():
        raise TypeError(f"{name}: index must be a contiguous int32 tensor on {b.device}")
    _build.check_shape(name, "index", index, (bsz, kp))
    _build.launch(
        "etk_block_scatter_rows", _build.dtype_code(b), b.data_ptr(), index.data_ptr(),
        h.data_ptr(), bsz, nw, kp, f, _build.stream_of(b),
    )
    block_scatter_rows.launches += 1
    return b


block_scatter_rows.launches = 0
