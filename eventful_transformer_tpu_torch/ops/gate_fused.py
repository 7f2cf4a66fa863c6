"""Gate-norm kernel (port of ``ln_norms`` from
``eventful_transformer_tpu/ops/pallas/gate_fused.py``).

``ln_norms`` gives the first block of each incremental step its qkv-gate
selection norms; later blocks receive theirs from the previous block's
kernel C. The CUDA kernel is ``csrc/ln_norms.cu``: one 256-thread block per
token row, bound by the bytes of x and p it reads once.
"""

from __future__ import annotations

import torch

from eventful_transformer_tpu_torch.ops import _build
from eventful_transformer_tpu_torch.ops.common import ln_f32, row_norms


def ln_norms_plain(x, p, scale, bias):
    """||ln(x) * scale + bias - p|| per token in float32. x, p (B, N, C)."""
    return row_norms(ln_f32(x, scale, bias) - p.float())


def ln_norms(x, p, scale, bias):
    """Kernel wrapper of :func:`ln_norms_plain`: returns norms (B, N) float32.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return ln_norms_plain(x, p, scale, bias)
    name = "ln_norms"
    _build.check_operands(name, x, p=p, scale=scale, bias=bias)
    c = x.shape[-1]
    _build.check_shape(name, "p", p, x.shape)
    _build.check_shape(name, "scale", scale, (c,))
    _build.check_shape(name, "bias", bias, (c,))
    out = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    _build.launch(
        "etk_ln_norms", _build.dtype_code(x), x.data_ptr(), p.data_ptr(),
        scale.data_ptr(), bias.data_ptr(), out.data_ptr(), x.numel() // c, c,
        _build.stream_of(x),
    )
    ln_norms.launches += 1
    return out


ln_norms.launches = 0
