"""The decomposed rel-pos bias add (port of ``relpos_bias_add`` and
``relpos_bias_add_v2`` from ``eventful_transformer_tpu/ops/pallas/relpos.py``).

For logits x (B, H, N, Np) over an (a0, a1) query grid and a (p0, p1) key
grid, unscaled q (B, H, N, c) and the resized, pooled tables y_rel
(a0, p0, c) and x_rel (a1, p1, c)::

    out[n, k] = x[n, k] + ty[n, k // p1] + tx[n, k % p1]
    ty[n] = q[n] . y_rel[n // a1]^T,   tx[n] = q[n] . x_rel[n % a1]^T

with the dot products summed in float32 over the tables cast to x's dtype.
The two TPU kernels differ only in where they round to x's dtype:
``relpos_bias_add`` sums ty and tx in float32 and rounds the sum once;
``relpos_bias_add_v2`` rounds each term, then their sum. Both add the
rounded bias to x in x's dtype. In float32 they differ by summation order
alone. The CUDA kernel is ``csrc/relpos.cu`` (one source, templated on the
rounding rule); see its header for what bounds it.
"""

from __future__ import annotations

import torch

from eventful_transformer_tpu_torch.ops import _build


def relpos_terms(q, y_rel, x_rel, a, dtype):
    """float32 (B, H, N, p0) and (B, H, N, p1) terms of unscaled q, the
    tables cast to ``dtype`` first."""
    bsz, heads, n, c = q.shape
    q5 = q.float().reshape(bsz, heads, a[0], a[1], c)
    ty = torch.einsum("bhywc,ykc->bhywk", q5, y_rel.to(dtype).float())
    tx = torch.einsum("bhywc,wkc->bhywk", q5, x_rel.to(dtype).float())
    return ty.reshape(bsz, heads, n, -1), tx.reshape(bsz, heads, n, -1)


def expand_bias(ty, tx, p):
    """(B, H, N, p0 * p1) bias ty[..., k // p1] + tx[..., k % p1]."""
    k = torch.arange(p[0] * p[1], device=ty.device)
    return ty[..., k // p[1]] + tx[..., k % p[1]]


def relpos_bias_add_plain(x, q, y_rel, x_rel, *, a, p):
    """Row 16's rounding: the float32 sum of the terms rounded once."""
    ty, tx = relpos_terms(q, y_rel, x_rel, a, x.dtype)
    return x + expand_bias(ty, tx, p).to(x.dtype)


def relpos_bias_add_v2_plain(x, q, y_rel, x_rel, *, a, p):
    """Row 17's rounding: each term rounded, then their sum."""
    dt = x.dtype
    ty, tx = relpos_terms(q, y_rel, x_rel, a, dt)
    return x + expand_bias(ty.to(dt).float(), tx.to(dt).float(), p).to(dt)


def _launch(name, round_each, x, q, y_rel, x_rel, a, p):
    bsz, heads, n, np_ = x.shape
    c = q.shape[-1]
    if n != a[0] * a[1] or np_ != p[0] * p[1]:
        raise ValueError(f"{name}: logits {tuple(x.shape)} are not over grids {a} x {p}")
    if c % 8:
        raise ValueError(f"{name}: head width {c} is not a multiple of 8")
    _build.check_operands(name, x, q=q, y_rel=y_rel, x_rel=x_rel)
    _build.check_shape(name, "q", q, (bsz, heads, n, c))
    _build.check_shape(name, "y_rel", y_rel, (a[0], p[0], c))
    _build.check_shape(name, "x_rel", x_rel, (a[1], p[1], c))
    for key, t in dict(x=x, q=q, y_rel=y_rel, x_rel=x_rel).items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")
    out = torch.empty_like(x)
    _build.launch(
        "etk_relpos_bias_add", _build.dtype_code(x), round_each, x.data_ptr(), q.data_ptr(),
        y_rel.data_ptr(), x_rel.data_ptr(), out.data_ptr(), bsz * heads, a[0], a[1], p[0],
        p[1], c, _build.stream_of(x),
    )
    return out


def relpos_bias_add(x, q, y_rel, x_rel, *, a, p):
    """The wrapper of :func:`relpos_bias_add_plain`, which CPU tensors take.
    CUDA tensors launch the kernel of csrc/relpos.cu: x, q and the tables
    in one dtype (float32 or bfloat16), contiguous, a head width that is a
    multiple of 8 (the launch raises where a block's shared memory cannot
    hold the table slice). Returns a new tensor."""
    if x.device.type == "cpu":
        return relpos_bias_add_plain(x, q, y_rel, x_rel, a=a, p=p)
    out = _launch("relpos_bias_add", 0, x, q, y_rel, x_rel, a, p)
    relpos_bias_add.launches += 1
    return out


def relpos_bias_add_v2(x, q, y_rel, x_rel, *, a, p):
    """The wrapper of :func:`relpos_bias_add_v2_plain`, as
    :func:`relpos_bias_add`."""
    if x.device.type == "cpu":
        return relpos_bias_add_v2_plain(x, q, y_rel, x_rel, a=a, p=p)
    out = _launch("relpos_bias_add_v2", 1, x, q, y_rel, x_rel, a, p)
    relpos_bias_add_v2.launches += 1
    return out


relpos_bias_add.launches = 0
relpos_bias_add_v2.launches = 0
