"""Multi-head attention of packed qkv rows, global or per window with
decomposed rel-pos bias terms (port of ``window_attention`` from
``eventful_transformer_tpu/ops/pallas/window_attention.py``).

Global mode (no ``terms``): the whole sequence of each batch row is one
window; the dense ``Block``, the eventful flush step and ViViT's temporal
model run their plain attention through it. Windowed form: ``qkv`` holds
one window per batch row (Bw, T, 3C) and ``terms`` (Bw, H, T, p0 + p1) are
the per-axis rel-pos terms of :func:`window_bias_terms`; the kernel adds
``terms[n, m // p1] + terms[n, p0 + m % p1]`` to the float32 logits.
Padded form (``geom``): the windows come from a token map zero-padded to
the window grid, and the kernel substitutes the qkv-bias row ``pad_bias``
for the q, k and v of every out-of-image token and ``pad_terms``
(:func:`window_bias_pad_terms`) for its terms. The CUDA kernel is
``csrc/window_attention.cu``, which launches the attention kernel of
``csrc/attention.cuh``; kernel A shares it. That kernel has two bodies, and
:func:`attention_body` says which one a call takes: bfloat16 calls the
tensor-core body of ``csrc/attention_tc.cuh``, float32 calls the CUDA-core
one. The wrappers that reach it (this one, :func:`window_attention_grid`,
``fused_attention`` and kernel A's ``qkv_attention_group``) count their
launches by body in ``body_launches``.

``window_attention_grid`` takes the windows from the padded (B, Hp, Wp, 3C)
qkv map itself and writes a (B, Hp, Wp, C) map, with the rel-pos terms
computed from the two tables inside the kernel and the rounding points of
the JAX kernel's ``_attend`` (window_attention.py:78-96), not those of
:func:`attention_plain`. No path of the JAX package calls it (its ``Block``
partitions in XLA and runs ``window_attention``); ``chip_smoke.py`` holds it
against its plain version and, in float32, against the windowed and padded
forms above over the partition of the same map. It takes the same two
bodies by the same rule: in bfloat16 the tensor-core one, which computes
the terms on the tensor cores from the unscaled q; in float32 the CUDA-core
one.
"""

from __future__ import annotations

import torch

from eventful_transformer_tpu_torch.ops import _build
from eventful_transformer_tpu_torch.ops._build import aligned16


def expand_terms(terms, p):
    """(…, T, p0 + p1) terms -> (…, T, p0 * p1) float32 bias: the sum of
    the y term of key row m // p1 and the x term of key column m % p1."""
    p0, p1 = p
    m = torch.arange(p0 * p1, device=terms.device)
    return terms[..., m // p1].float() + terms[..., p0 + m % p1].float()


def attention_plain(qkv, heads, inv_scale, terms=None, p=None):
    """qkv (B, N, 3C) packed [q | k | v] rows in the working dtype -> (B, N,
    C). q is scaled by ``inv_scale`` in the working dtype; logits, the
    rel-pos bias (``terms`` (B, H, N, p0 + p1), summed in float32) and the
    softmax in float32; probabilities and the output rounded to the working
    dtype. Kernel A's plain version shares it."""
    wd = qkv.dtype
    bsz, n, c3 = qkv.shape
    c = c3 // 3
    qkv = qkv.reshape(bsz, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # (B, H, N, d)
    q = q * torch.tensor(inv_scale, dtype=wd)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if terms is not None:
        logits = logits + expand_terms(terms, p)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    attn = (e / e.sum(dim=-1, keepdim=True)).to(wd)
    out = torch.matmul(attn.float(), v.float()).to(wd)
    return out.transpose(1, 2).reshape(bsz, n, c)


def window_valid(bw, geom, a, device):
    """(Bw, T) bool: whether each token of each window lies inside the
    image. ``geom`` = (nh, nw, vh, vw): the window grid and the image's
    token extents; ``a`` = (a0, a1) the window. Window i sits at grid row
    (i % (nh * nw)) // nw and column i % nw, as the windows of
    ``Block._partition_windows_zero`` are laid out."""
    nh, nw, vh, vw = geom
    a0, a1 = a
    win = torch.arange(bw, device=device)[:, None]
    idx = torch.arange(a0 * a1, device=device)[None, :]
    rows = idx // a1 + (win % (nh * nw)) // nw * a0
    cols = idx % a1 + win % nw * a1
    return (rows < vh) & (cols < vw)


def window_attention_plain(
    qkv, terms=None, pad_bias=None, pad_terms=None, *, heads, scale, p=None, a=None, geom=None
):
    """Attention of qkv (Bw, T, 3C) -> (Bw, T, C), logits scaled by 1/scale
    as the TPU kernel scales them; with ``terms``, the windowed rel-pos
    form over a (p0, p1) key grid (T == p0 * p1). With ``geom``, the padded
    form over windows ``a``: out-of-image tokens take ``pad_bias`` (3C,) as
    their qkv row and ``pad_terms`` (H, T, p0 + p1) as their terms."""
    if geom is not None:
        valid = window_valid(qkv.shape[0], geom, a, qkv.device)
        qkv = torch.where(valid[..., None], qkv, pad_bias.to(qkv.dtype))
        if terms is not None:
            terms = torch.where(valid[:, None, :, None], terms, pad_terms.to(terms.dtype))
    return attention_plain(qkv, heads, 1.0 / scale, terms, p)


def window_bias_terms(qkv, tab, heads):
    """(Bw, H, T, p0 + p1) rel-pos terms of the UNSCALED q lanes of packed
    window rows (Bw, T, 3C), against the per-token table ``tab`` (T, p0 +
    p1, c) of ``RelativePositionEmbedding.window_tab``, in qkv's dtype:
    the terms are rounded to the working dtype before the kernel adds
    them, as in the JAX package."""
    bw, t, c3 = qkv.shape
    c = c3 // 3
    q = qkv[..., :c].reshape(bw, t, heads, c // heads)
    return torch.einsum("bthc,tpc->bhtp", q, tab.to(qkv.dtype)).contiguous()


def window_bias_pad_terms(pad_bias, tab, heads):
    """(H, T, p0 + p1) terms of the qkv-bias row (3C,), the value every pad
    token takes, against the per-token table ``tab``, in tab's dtype: the
    padded form substitutes them at pad rows, so the pad rows' outputs
    match those of windows whose pad rows hold the bias row."""
    c = pad_bias.shape[-1] // 3
    qb = pad_bias[:c].reshape(heads, c // heads).to(tab.dtype)
    return torch.einsum("hc,tpc->htp", qb, tab).contiguous()


# The attention kernel's forms (csrc/attention.cuh AttnForm): q and the
# probabilities rounded to the working dtype (rows 2, 6); row 21's, q scaled
# in float32 with float32 or (cast) bfloat16 probabilities; row 15's grid.
ATTENTION_FORMS = ("rounded", "f32_probs", "bf16_probs", "grid")
# The body codes of the C entries (csrc/attention.cuh AttnBody).
BODY_CODES = {"simt": 0, "tc": 1}
TC_MAX_TOKENS = 512  # every global attention of the paths (core/blocks.py GLOBAL_ATTN_MAX_TOKENS)
TC_MAX_HEAD_DIM = 128


def attention_body(dtype, n, d, form="rounded", aligned=True):
    """The body of the attention kernel that a call takes: "tc", the
    tensor-core body, for bfloat16 in every form, with a head width ``d``
    that is a multiple of 16 up to 128, ``n`` <= 512 tokens and qkv (and a
    pad-bias row, or the grid form's tables) on 16-byte boundaries
    (``aligned``); "simt", the CUDA-core body, for everything else (float32
    in every form, so that the float32 card-vs-CPU checks keep their
    meaning). csrc/attention_tc.cuh refuses what this sends it otherwise
    (``attention_tc_takes`` and the alignment test of
    ``launch_attention_tc``)."""
    if form not in ATTENTION_FORMS:
        raise ValueError(f"attention form must be one of {ATTENTION_FORMS}, got {form!r}")
    takes = (
        dtype == torch.bfloat16 and d % 16 == 0 and 16 <= d <= TC_MAX_HEAD_DIM
        and 1 <= n <= TC_MAX_TOKENS and aligned
    )
    return "tc" if takes else "simt"


def attention_smem_bytes(name, n, d, n_terms=0, body="simt", grid=(0, 0)):
    """Shared memory of ``body`` of the attention kernel at N tokens of head
    width d with ``n_terms`` rel-pos terms per query (``grid`` = (a1, p1):
    the grid form's tables over an a1-wide window, which the tensor-core
    body stages); raises if one block cannot hold it."""
    smem = _build.load_library().etk_attention_smem_bytes(
        BODY_CODES[body], n, d, n_terms, *grid
    )
    if smem > _build.MAX_SHARED_BYTES:
        raise ValueError(f"{name}: N={n} needs {smem} B of shared memory per block")
    return smem


def window_attention(
    qkv, terms=None, pad_bias=None, pad_terms=None, *, heads, scale, p=None, a=None, geom=None
):
    """The wrapper of :func:`window_attention_plain`, which CPU tensors
    take. CUDA tensors launch the kernel of csrc/window_attention.cu, in
    the body :func:`attention_body` picks; launches are counted in total
    and by body."""
    if qkv.device.type == "cpu":
        return window_attention_plain(
            qkv, terms, pad_bias, pad_terms, heads=heads, scale=scale, p=p, a=a, geom=geom
        )
    name = "window_attention"
    bsz, n, c3 = qkv.shape
    if c3 % (3 * heads):
        raise ValueError(f"{name}: last axis {c3} is not 3 x {heads} heads wide")
    c = c3 // 3
    p0 = p1 = 0
    if terms is None:
        _build.check_operands(name, qkv)
    else:
        _build.check_operands(name, qkv, terms=terms)
        p0, p1 = p
        if p0 * p1 != n:
            raise ValueError(f"{name}: key grid {p} does not hold the {n} tokens of a window")
        _build.check_shape(name, "terms", terms, (bsz, heads, n, p0 + p1))
    nh = nw = a0 = a1 = 1
    vh = vw = 0
    if geom is not None:
        nh, nw, vh, vw = geom
        a0, a1 = a
        if a0 * a1 != n or bsz % (nh * nw):
            raise ValueError(f"{name}: {bsz} windows of {n} tokens do not fill {nh} x {nw} of {a}")
        pads = dict(pad_bias=pad_bias)
        if terms is not None:
            pads["pad_terms"] = pad_terms
            _build.check_shape(name, "pad_terms", pad_terms, (heads, n, p0 + p1))
        _build.check_operands(name, qkv, **pads)
        _build.check_shape(name, "pad_bias", pad_bias, (c3,))
    aligned = aligned16(qkv, None if geom is None else pad_bias)
    body = attention_body(qkv.dtype, n, c // heads, aligned=aligned)
    attention_smem_bytes(name, n, c // heads, p0 + p1, body)
    out = torch.empty((bsz, n, c), dtype=qkv.dtype, device=qkv.device)
    _build.launch(
        "etk_window_attention", _build.dtype_code(qkv), BODY_CODES[body], qkv.data_ptr(),
        None if terms is None else terms.data_ptr(), out.data_ptr(), bsz, n, c, heads,
        float(1.0 / scale), p0, p1, None if geom is None else pad_bias.data_ptr(),
        None if geom is None or terms is None else pad_terms.data_ptr(), nh, nw, vh, vw, a0, a1,
        _build.stream_of(qkv),
    )
    window_attention.launches += 1
    window_attention.body_launches[body] += 1
    return out


window_attention.launches = 0
window_attention.body_launches = {"tc": 0, "simt": 0}


MAX_GRID_HEAD_DIM = 256  # the CUDA-core body holds a query's head in registers (kMaxHeadDim)


def _grid_geometry(name, x, y_rel, window, a, p):
    """(a0, a1, p0, p1) of a grid call, checked as the JAX kernel's: with
    tables the window is ``a`` (``window`` where None) and the key grid
    ``p`` (``a`` where None), with p0 * p1 == a0 * a1; the map's extents
    multiples of the window."""
    if x.ndim != 4 or x.shape[-1] % 3:
        raise ValueError(f"{name}: x {tuple(x.shape)} is not a (B, Hp, Wp, 3C) map")
    if y_rel is None:
        (a0, a1), (p0, p1) = window, (0, 0)
    else:
        a0, a1 = a if a is not None else window
        p0, p1 = p if p is not None else (a0, a1)
        if p0 * p1 != a0 * a1:
            raise ValueError(f"{name}: key grid {(p0, p1)} does not hold a {(a0, a1)} window")
    if x.shape[1] % a0 or x.shape[2] % a1:
        raise ValueError(f"{name}: map {tuple(x.shape[1:3])} is not a multiple of {(a0, a1)}")
    return a0, a1, p0, p1


def window_attention_grid_plain(
    x, y_rel=None, x_rel=None, *, heads, scale, window, a=None, p=None
):
    """x (B, Hp, Wp, 3C) -> (B, Hp, Wp, C): the windows of the map
    partitioned, attended as the JAX kernel's ``_attend`` does, and put
    back. q in float32, scaled by the float32 1/scale; with the tables
    y_rel (a0, p0, hd) and x_rel (a1, p1, hd), rounded to x's dtype, the
    terms q . y_rel[i // a1] and q . x_rel[i % a1] of the UNSCALED float32
    q added to the float32 logits one after the other; probabilities and
    output rounded to x's dtype."""
    a0, a1, p0, p1 = _grid_geometry("window_attention_grid", x, y_rel, window, a, p)
    wd = x.dtype
    b, hp, wp, c3 = x.shape
    c = c3 // 3
    t = a0 * a1
    win = x.reshape(b, hp // a0, a0, wp // a1, a1, c3).permute(0, 1, 3, 2, 4, 5)
    win = win.reshape(-1, t, 3, heads, c // heads).permute(2, 0, 3, 1, 4)  # (3, Bw, H, T, d)
    q, k, v = win[0].float(), win[1].float(), win[2]
    logits = torch.matmul(q * torch.tensor(1.0 / scale, dtype=torch.float32), k.transpose(-1, -2))
    if y_rel is not None:
        idx = torch.arange(t, device=x.device)  # queries, and keys on the p0 x p1 grid
        term_y = torch.einsum("bhtd,tpd->bhtp", q, y_rel.to(wd).float()[idx // a1])
        term_x = torch.einsum("bhtd,tpd->bhtp", q, x_rel.to(wd).float()[idx % a1])
        logits = logits + term_y[..., idx // p1]
        logits = logits + term_x[..., idx % p1]
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    attn = (e / e.sum(dim=-1, keepdim=True)).to(wd)
    out = torch.matmul(attn.float(), v.float()).to(wd)  # (Bw, H, T, d)
    out = out.transpose(1, 2).reshape(b, hp // a0, wp // a1, a0, a1, c)
    return out.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)


def window_attention_grid(
    x, y_rel=None, x_rel=None, *, heads, scale, window, a=None, p=None
):
    """The wrapper of :func:`window_attention_grid_plain`, which CPU tensors
    take. CUDA tensors launch the grid entry of csrc/window_attention.cu, in
    the body :func:`attention_body` picks (the tables rounded to x's dtype
    first); launches are counted by form, ``"terms"`` or ``"no_terms"``,
    and by body."""
    if x.device.type == "cpu":
        return window_attention_grid_plain(
            x, y_rel, x_rel, heads=heads, scale=scale, window=window, a=a, p=p
        )
    name = "window_attention_grid"
    a0, a1, p0, p1 = _grid_geometry(name, x, y_rel, window, a, p)
    b, hp, wp, c3 = x.shape
    c = c3 // 3
    if c % heads:
        raise ValueError(f"{name}: last axis {c3} is not 3 x {heads} heads wide")
    hd = c // heads
    if hd > MAX_GRID_HEAD_DIM:
        raise ValueError(f"{name}: head width {hd} exceeds {MAX_GRID_HEAD_DIM}")
    tables = {}
    if y_rel is not None:
        tables = dict(y_rel=y_rel.to(x.dtype).contiguous(), x_rel=x_rel.to(x.dtype).contiguous())
        _build.check_shape(name, "y_rel", tables["y_rel"], (a0, p0, hd))
        _build.check_shape(name, "x_rel", tables["x_rel"], (a1, p1, hd))
    _build.check_operands(name, x, **tables)
    body = attention_body(x.dtype, a0 * a1, hd, "grid", aligned16(x, *tables.values()))
    attention_smem_bytes(name, a0 * a1, hd, p0 + p1, body, (a1, p1) if tables else (0, 0))
    out = torch.empty((b, hp, wp, c), dtype=x.dtype, device=x.device)
    _build.launch(
        "etk_window_attention_grid", _build.dtype_code(x), BODY_CODES[body], x.data_ptr(),
        tables["y_rel"].data_ptr() if tables else None,
        tables["x_rel"].data_ptr() if tables else None, out.data_ptr(), b, hp // a0, wp // a1,
        a0, a1, c, heads, float(1.0 / scale), p0, p1, _build.stream_of(x),
    )
    window_attention_grid.launches += 1
    window_attention_grid.form_launches["terms" if tables else "no_terms"] += 1
    window_attention_grid.body_launches[body] += 1
    return out


window_attention_grid.launches = 0
window_attention_grid.form_launches = {"terms": 0, "no_terms": 0}
window_attention_grid.body_launches = {"tc": 0, "simt": 0}
