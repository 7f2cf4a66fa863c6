"""The fused A.V step of ``EventfulBlock`` (port of ``softmax_select_matmul``
from ``eventful_transformer_tpu/ops/pallas/av_softmax.py``).

With ``recompute_av`` the eventful A.V product is ``p_a' @ p_v`` where
``p_a' = where(cov, softmax(logits), p_a)`` keeps the stale columns of the
keys no gate selected. The kernel computes the logits from q and the
pooled k itself (the fused matmul-1 form), adds the rel-pos terms, takes
the softmax, selects the columns into the state in place and multiplies by
p_v, so the (B, H, N, Np) logits and softmax never reach device memory.
Its logits form (``softmax_select_matmul_logits``) reads the logits
instead, where matmul-1 runs outside the kernel: the reference's cached
q.kT product (``recompute_product = False``) or ``fuse_matmul_1 =
False``. Both forms are ``csrc/av_softmax.cu``, in two bodies that
:func:`av_softmax_body` picks: every bfloat16 call on the tensor cores
(``csrc/av_softmax_tc.cuh``), float32 and the matmul-2 cast on the CUDA
cores; see the two headers for what bounds them. The wrappers count their
launches in total and by body (``body_launches``).
"""

from __future__ import annotations

import torch

from eventful_transformer_tpu_torch.ops import _build
from eventful_transformer_tpu_torch.ops.window_attention import BODY_CODES, expand_terms

TC_MAX_HEAD_DIM = 64  # csrc/av_softmax_tc.cuh kAvTcMaxHeadDim


def av_softmax_body(wdtype, sdtype, d, aligned=True):
    """The body of the A.V kernel that a call takes: "tc", the tensor-core
    body, where the working dtype ``wdtype`` (q, k and the terms; in the
    logits form the terms', or the logits' without terms) and the state's
    ``sdtype`` (p_a, p_v, the logits) are both bfloat16, the head width
    ``d`` is a multiple of 16 up to 64 and k and p_v start on 16-byte
    boundaries (``aligned``); "simt", the CUDA-core body, for everything
    else: float32, and float32 with the bfloat16 matmul-2 cast, so that the
    float32 card-vs-CPU checks keep their meaning. Neither the token count
    nor the key count enters: every shape the paths give takes the same
    body. csrc/av_softmax.cu refuses what this sends it otherwise
    (``av_softmax_tc_takes`` and the alignment test of
    ``launch_av_softmax_tc``)."""
    takes = (
        wdtype == sdtype == torch.bfloat16 and d % 16 == 0 and 16 <= d <= TC_MAX_HEAD_DIM
        and aligned
    )
    return "tc" if takes else "simt"


def softmax_select_matmul_plain(p_a, cov, p_v, q, k, terms=None, *, inv_scale, p=None):
    """p_a (B, H, N, Np) attention state in S, updated in place; cov (B, Np)
    float32 (> 0 = refresh the column); p_v (B, H, Np, d) value state in S;
    q (B, H, N, d) and the pooled k (B, H, Np, d) in the working dtype W;
    terms (B, H, N, p0 + p1) the per-axis rel-pos terms in W over the
    (p0, p1) key grid ``p``. q is scaled by ``inv_scale`` in W; the logits,
    the bias (the two terms summed in float32) and the softmax in float32;
    the probabilities rounded to S; the product summed in float32 and
    rounded to S. Returns (p_a, p_a' @ p_v)."""
    qs = q * torch.tensor(inv_scale, dtype=q.dtype)
    logits = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    return _softmax_select_matmul_f32(logits, p_a, cov, p_v, terms, p)


def softmax_select_matmul(p_a, cov, p_v, q, k, terms=None, *, inv_scale, p=None):
    """The wrapper of :func:`softmax_select_matmul_plain`, which CPU tensors
    take. CUDA tensors launch the kernel of csrc/av_softmax.cu in the body
    :func:`av_softmax_body` picks; it takes W and S both float32, both
    bfloat16, or float32 with bfloat16 state (the matmul-2 cast), and a head
    width that is a multiple of 16 up to 128 (up to 64 in bfloat16)."""
    if q.device.type == "cpu":
        return softmax_select_matmul_plain(p_a, cov, p_v, q, k, terms, inv_scale=inv_scale, p=p)
    name = "softmax_select_matmul"
    bsz, heads, n, d = q.shape
    np_ = p_a.shape[-1]
    wd, sd = _build.dtype_code(q), _build.dtype_code(p_a)
    if (wd, sd) == (1, 0):
        raise TypeError(f"{name}: bfloat16 q with float32 state is not a kernel form")
    if d % 16 or d > 128:
        raise ValueError(f"{name}: head width {d} is not a multiple of 16 up to 128")
    working = dict(k=k, cov=cov) if terms is None else dict(k=k, cov=cov, terms=terms)
    _build.check_operands(name, q, ("cov",), **working)
    _build.check_operands(name, p_a, p_v=p_v)
    shapes = dict(p_a=(bsz, heads, n, np_), cov=(bsz, np_), p_v=(bsz, heads, np_, d),
                  k=(bsz, heads, np_, d))
    operands = dict(p_a=p_a, cov=cov, p_v=p_v, k=k)
    p0 = p1 = 0
    if terms is not None:
        p0, p1 = p
        if p0 * p1 != np_:
            raise ValueError(f"{name}: key grid {p} does not hold the {np_} pooled keys")
        shapes["terms"] = (bsz, heads, n, p0 + p1)
        operands["terms"] = terms
    for key, shape in shapes.items():
        _build.check_shape(name, key, operands[key], shape)
    for key in ("k", "p_v"):  # staged with 16-byte loads
        if operands[key].dtype == torch.bfloat16 and operands[key].data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")
    body = _body(name, q.dtype, p_a.dtype, d, _build.aligned16(k, p_v))
    out = torch.empty((bsz, heads, n, d), dtype=p_a.dtype, device=q.device)
    _build.launch(
        "etk_softmax_select_matmul", BODY_CODES[body], wd, sd, p_a.data_ptr(), cov.data_ptr(),
        p_v.data_ptr(), q.data_ptr(), k.data_ptr(), None if terms is None else terms.data_ptr(),
        out.data_ptr(), bsz, heads, n, np_, d, p0, p1, float(inv_scale), _build.stream_of(q),
    )
    softmax_select_matmul.launches += 1
    softmax_select_matmul.body_launches[body] += 1
    return p_a, out


softmax_select_matmul.launches = 0
softmax_select_matmul.body_launches = {"tc": 0, "simt": 0}


def _body(name, wdtype, sdtype, d, aligned):
    """:func:`av_softmax_body` of a call the wrappers' checks passed;
    raises where it is bfloat16 x bfloat16 and yet not "tc", which no body
    takes (a head width beyond 64)."""
    body = av_softmax_body(wdtype, sdtype, d, aligned)
    if body == "simt" and wdtype == sdtype == torch.bfloat16:
        raise ValueError(f"{name}: bfloat16 takes the tensor-core body, which takes a head "
                         f"width that is a multiple of 16 up to {TC_MAX_HEAD_DIM}, not {d}")
    return body


def _softmax_select_matmul_f32(logits, p_a, cov, p_v, terms, p):
    """float32 logits (+ the terms summed in float32) -> softmax rounded to
    S -> column select into p_a in place -> p_a' @ p_v with float32 sums,
    rounded to S."""
    if terms is not None:
        logits = logits + expand_terms(terms, p)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    a = (e / e.sum(dim=-1, keepdim=True)).to(p_a.dtype)
    p_a.copy_(torch.where(cov[:, None, None, :] > 0, a, p_a))
    return p_a, torch.matmul(p_a.float(), p_v.float()).to(p_a.dtype)


def softmax_select_matmul_logits_plain(logits, p_a, cov, p_v, terms=None, *, p=None):
    """logits and p_a (B, H, N, Np) in S, p_a updated in place; cov (B, Np)
    float32; p_v (B, H, Np, d) in S; terms (B, H, N, p0 + p1) over the (p0,
    p1) key grid ``p``, in the working dtype. The logits in float32, the
    bias, softmax and product as :func:`softmax_select_matmul_plain`.
    Returns (p_a, p_a' @ p_v)."""
    return _softmax_select_matmul_f32(logits.float(), p_a, cov, p_v, terms, p)


def softmax_select_matmul_logits(logits, p_a, cov, p_v, terms=None, *, p=None):
    """The wrapper of :func:`softmax_select_matmul_logits_plain`, which CPU
    tensors take. CUDA tensors launch the logits form of the kernel of
    csrc/av_softmax.cu in the body :func:`av_softmax_body` picks: logits,
    p_a and p_v in one dtype S, terms in S or (with S bfloat16) float32, a
    head width that is a multiple of 16 up to 128 (up to 64 in
    bfloat16)."""
    if logits.device.type == "cpu":
        return softmax_select_matmul_logits_plain(logits, p_a, cov, p_v, terms, p=p)
    name = "softmax_select_matmul_logits"
    bsz, heads, n, np_ = logits.shape
    d = p_v.shape[-1]
    sd = _build.dtype_code(logits)
    wd = sd if terms is None else _build.dtype_code(terms)
    if (wd, sd) == (1, 0):
        raise TypeError(f"{name}: bfloat16 terms with float32 logits is not a kernel form")
    if d % 16 or d > 128:
        raise ValueError(f"{name}: head width {d} is not a multiple of 16 up to 128")
    _build.check_operands(name, logits, ("cov",), p_a=p_a, cov=cov, p_v=p_v)
    shapes = dict(p_a=(bsz, heads, n, np_), cov=(bsz, np_), p_v=(bsz, heads, np_, d))
    operands = dict(p_a=p_a, cov=cov, p_v=p_v)
    p0 = p1 = 0
    if terms is not None:
        _build.check_operands(name, terms)
        p0, p1 = p
        if p0 * p1 != np_:
            raise ValueError(f"{name}: key grid {p} does not hold the {np_} pooled keys")
        shapes["terms"] = (bsz, heads, n, p0 + p1)
        operands["terms"] = terms
    for key, shape in shapes.items():
        _build.check_shape(name, key, operands[key], shape)
    if p_v.dtype == torch.bfloat16 and p_v.data_ptr() % 16:  # staged with 16-byte loads
        raise ValueError(f"{name}: p_v must be 16-byte aligned")
    wdtype = logits.dtype if terms is None else terms.dtype
    body = _body(name, wdtype, logits.dtype, d, _build.aligned16(p_v))
    out = torch.empty((bsz, heads, n, d), dtype=p_a.dtype, device=logits.device)
    _build.launch(
        "etk_softmax_select_matmul_logits", BODY_CODES[body], wd, sd, p_a.data_ptr(),
        cov.data_ptr(), p_v.data_ptr(), logits.data_ptr(),
        None if terms is None else terms.data_ptr(), out.data_ptr(), bsz, heads, n, np_, d, p0,
        p1, _build.stream_of(logits),
    )
    softmax_select_matmul_logits.launches += 1
    softmax_select_matmul_logits.body_launches[body] += 1
    return p_a, out


softmax_select_matmul_logits.launches = 0
softmax_select_matmul_logits.body_launches = {"tc": 0, "simt": 0}
