"""Multi-head attention of packed qkv rows with the matmul-2 cast as an
option (port of ``fused_attention`` from
``eventful_transformer_tpu/ops/pallas/attention.py``).

    out[b, i, h] = rnd(sum_j p_ij v_j),  p_ij = softmax_j((q_i * f32(1/scale)) . k_j)

for qkv (B, N, 3C) laid out [q | k | v], C = heads x d, with that kernel's
rounding points (attention.py:33-58), which are not those of the port's
``window_attention``: q and k are taken to float32 and q is scaled there,
with no rounding to the working dtype; the softmax runs in float32; without
``cast`` the probabilities stay float32 and multiply v as it is; with
``cast=torch.bfloat16`` (the reference's ``matmul_2_cast``) the
probabilities and v are rounded to bfloat16 first; the output is rounded
to the working dtype once.

No path of the JAX package calls this kernel (its blocks run
``window_attention``); ``chip_smoke.py`` holds it against its plain version
and, in float32, against the global ``window_attention``. The CUDA kernel
is ``csrc/fused_attention.cu``, attention.cuh's body in its kAttnF32Probs
and kAttnBf16Probs forms: in bfloat16 the tensor-core body, which splits
q, and without the cast the probabilities, into two bfloat16 parts; in
float32 the CUDA-core body (``window_attention.attention_body``). The
wrapper counts its launches in ``launches``, by form (``"no_cast"``,
``"cast"``) in ``form_launches`` and by body in ``body_launches``.
"""

from __future__ import annotations

import torch

from eventful_transformer_tpu_torch.ops import _build
from eventful_transformer_tpu_torch.ops.window_attention import (
    BODY_CODES,
    aligned16,
    attention_body,
    attention_smem_bytes,
)

CASTS = (None, torch.float32, torch.bfloat16)  # float32 rounds nothing: the same as None


def _heads(name, qkv, heads, cast):
    """(B, H, N, d) views of q, k and v; raise on a shape or a cast the
    kernel does not take."""
    if cast not in CASTS:
        raise ValueError(f"{name}: cast must be one of {CASTS}, got {cast}")
    bsz, n, c3 = qkv.shape
    if c3 % (3 * heads):
        raise ValueError(f"{name}: last axis {c3} is not 3 x {heads} heads wide")
    return qkv.reshape(bsz, n, 3, heads, c3 // (3 * heads)).permute(2, 0, 3, 1, 4)


def fused_attention_plain(qkv, *, heads, scale, cast=None):
    """qkv (B, N, 3C) -> (B, N, C) in qkv's dtype, rounded as above."""
    q, k, v = _heads("fused_attention", qkv, heads, cast)
    q = q.float() * torch.tensor(1.0 / scale, dtype=torch.float32)
    logits = torch.matmul(q, k.float().transpose(-1, -2))
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    attn = e / e.sum(dim=-1, keepdim=True)
    if cast is torch.bfloat16:
        attn, v = attn.to(cast), v.to(cast)
    out = torch.matmul(attn.float(), v.float()).to(qkv.dtype)
    bsz, n, c3 = qkv.shape
    return out.transpose(1, 2).reshape(bsz, n, c3 // 3)


def fused_attention(qkv, *, heads, scale, cast=None):
    """The wrapper of :func:`fused_attention_plain`, which CPU tensors
    take. CUDA tensors launch the kernel of csrc/fused_attention.cu."""
    if qkv.device.type == "cpu":
        return fused_attention_plain(qkv, heads=heads, scale=scale, cast=cast)
    name = "fused_attention"
    _heads(name, qkv, heads, cast)
    _build.check_operands(name, qkv)
    bsz, n, c3 = qkv.shape
    c = c3 // 3
    with_cast = cast is torch.bfloat16
    form = "bf16_probs" if with_cast else "f32_probs"
    body = attention_body(qkv.dtype, n, c // heads, form, aligned=aligned16(qkv))
    attention_smem_bytes(name, n, c // heads, body=body)
    out = torch.empty((bsz, n, c), dtype=qkv.dtype, device=qkv.device)
    _build.launch(
        "etk_fused_attention", _build.dtype_code(qkv), BODY_CODES[body], qkv.data_ptr(),
        out.data_ptr(), bsz, n, c, heads, float(1.0 / scale), int(with_cast),
        _build.stream_of(qkv),
    )
    fused_attention.launches += 1
    fused_attention.form_launches["cast" if with_cast else "no_cast"] += 1
    fused_attention.body_launches[body] += 1
    return out


fused_attention.launches = 0
fused_attention.form_launches = {"no_cast": 0, "cast": 0}
fused_attention.body_launches = {"tc": 0, "simt": 0}
