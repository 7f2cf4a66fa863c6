"""The dense block's MLP half (port of ``dense_mlp_residual`` from
``eventful_transformer_tpu/ops/pallas/dense_mlp.py``):
``y = x + W2 gelu(W1 ln(x) + b1) + b2``.

The dense ``Block`` (the dense twin's spatial stack and the temporal model)
runs its MLP through it; the eventful blocks use the gated form, kernel C
(``ops/gate_group.py``). The CUDA kernels are ``csrc/dense_mlp.cu``; see
its header for the launch structure and what bounds it. Its two GEMMs take
the core ``ops/gemm_core.py::gemm_core`` picks (bfloat16 at the paths'
widths: the wgmma core), counted in ``core_launches``; its LN pass the body
``ops/row_pass.py::row_body`` picks, counted in ``row_body_launches``.
"""

from __future__ import annotations

import torch

from eventful_transformer_tpu_torch.ops import _build, gemm_core, row_pass
from eventful_transformer_tpu_torch.ops.common import gelu_exact, ln_f32


def dense_mlp_residual_plain(x, scale, bias, w1, b1, w2, b2):
    """x (B, N, C) working dtype -> (B, N, C). LN, sums, biases and GELU in
    float32; the LN output, the hidden, the MLP output and y rounded to the
    working dtype, as the TPU kernel rounds them."""
    wd = x.dtype
    xl = ln_f32(x, scale, bias).to(w1.dtype)
    h = gelu_exact(torch.matmul(xl.float(), w1.float()) + b1.float()).to(wd)
    h2 = (torch.matmul(h.to(w2.dtype).float(), w2.float()) + b2.float()).to(wd)
    return (h2.float() + x.float()).to(wd)


def dense_mlp_residual(x, scale, bias, w1, b1, w2, b2):
    """The wrapper of :func:`dense_mlp_residual_plain`, which CPU tensors
    take. CUDA tensors launch the kernels of csrc/dense_mlp.cu; the LN
    pass's body (``row_pass.row_body``) is counted in
    ``row_body_launches``."""
    if x.device.type == "cpu":
        return dense_mlp_residual_plain(x, scale, bias, w1, b1, w2, b2)
    name = "dense_mlp_residual"
    _build.check_operands(name, x, scale=scale, bias=bias, w1=w1, b1=b1, w2=w2, b2=b2)
    c = x.shape[-1]
    hidden = w1.shape[-1]
    for key, t, shape in (
        ("scale", scale, (c,)), ("bias", bias, (c,)), ("w1", w1, (c, hidden)),
        ("b1", b1, (hidden,)), ("w2", w2, (hidden, c)), ("b2", b2, (c,)),
    ):
        _build.check_shape(name, key, t, shape)
    rows = x.numel() // c
    core, *plans = gemm_core.mlp_launch(x.dtype, rows, c, hidden, _build.aligned16(x, w1, w2))
    ws = gemm_core.workspace(plans, x.device)
    body = row_pass.row_body(x.dtype, (c,), _build.aligned16(x, scale, bias))
    y = torch.empty_like(x)
    xl = torch.empty_like(x)
    h = torch.empty((rows, hidden), dtype=x.dtype, device=x.device)
    _build.launch(
        "etk_dense_mlp_residual", _build.dtype_code(x), row_pass.ROW_BODY_CODES[body],
        x.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        y.data_ptr(), xl.data_ptr(), h.data_ptr(), rows, c, hidden,
        gemm_core.CORE_CODES[core], *gemm_core.plan_args(plans, ws), _build.stream_of(x),
    )
    dense_mlp_residual.launches += 1
    dense_mlp_residual.core_launches[core] += 1
    dense_mlp_residual.row_body_launches[body] += 1
    return y


dense_mlp_residual.launches = 0
dense_mlp_residual.core_launches = gemm_core.new_core_counts()
dense_mlp_residual.row_body_launches = row_pass.new_body_counts()
