"""Global multi-head attention of packed qkv (port of ``window_attention``
from ``eventful_transformer_tpu/ops/pallas/window_attention.py``, in its
global mode: no window geometry, no rel-pos terms, the whole sequence one
window per batch row).

The dense ``Block``, the eventful block's flush step and the temporal model
run their attention through it. The windowed forms (rel-pos terms, padded
windows) and ``window_attention_grid`` wait (ROADMAP.md, "TPU kernels to
port"). The CUDA kernel is ``csrc/window_attention.cu``, which launches the
attention kernel of ``csrc/attention.cuh``; kernel A shares it.
"""

from __future__ import annotations

import torch

from eventful_transformer_tpu_torch.ops import _build


def attention_plain(qkv, heads, inv_scale):
    """qkv (B, N, 3C) packed [q | k | v] rows in the working dtype -> (B, N,
    C). q is scaled by ``inv_scale`` in the working dtype; logits and
    softmax in float32; probabilities and the output rounded to the working
    dtype. Kernel A's plain version shares it."""
    wd = qkv.dtype
    bsz, n, c3 = qkv.shape
    c = c3 // 3
    qkv = qkv.reshape(bsz, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # (B, H, N, d)
    q = q * torch.tensor(inv_scale, dtype=wd)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    attn = (e / e.sum(dim=-1, keepdim=True)).to(wd)
    out = torch.matmul(attn.float(), v.float()).to(wd)
    return out.transpose(1, 2).reshape(bsz, n, c)


def window_attention_plain(qkv, *, heads, scale):
    """Global attention of qkv (B, N, 3C) -> (B, N, C), logits scaled by
    1/scale as the TPU kernel scales them."""
    return attention_plain(qkv, heads, 1.0 / scale)


def attention_smem_bytes(name, n, d):
    """Shared memory of the attention kernel at N tokens of head width d;
    raises if one block cannot hold it."""
    smem = _build.load_library().etk_attention_smem_bytes(n, d)
    if smem > _build.MAX_SHARED_BYTES:
        raise ValueError(f"{name}: N={n} needs {smem} B of shared memory per block")
    return smem


def window_attention(qkv, *, heads, scale):
    """The wrapper of :func:`window_attention_plain`, which CPU tensors
    take. CUDA tensors launch the kernel of csrc/window_attention.cu."""
    if qkv.device.type == "cpu":
        return window_attention_plain(qkv, heads=heads, scale=scale)
    name = "window_attention"
    _build.check_operands(name, qkv)
    bsz, n, c3 = qkv.shape
    if c3 % (3 * heads):
        raise ValueError(f"{name}: last axis {c3} is not 3 x {heads} heads wide")
    c = c3 // 3
    attention_smem_bytes(name, n, c // heads)
    out = torch.empty((bsz, n, c), dtype=qkv.dtype, device=qkv.device)
    _build.launch(
        "etk_window_attention", _build.dtype_code(qkv), qkv.data_ptr(), out.data_ptr(),
        bsz, n, c, heads, float(1.0 / scale), _build.stream_of(qkv),
    )
    window_attention.launches += 1
    return out


window_attention.launches = 0
