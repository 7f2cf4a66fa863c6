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
alone. The CUDA kernel is ``csrc/relpos.cu``, templated on the rounding
rule, in two bodies that :func:`relpos_body` picks: bfloat16 calls with q
and the tables on 16-byte boundaries take the tiled body
(``csrc/relpos_tile.cuh``: 2-D tiles of query tokens from
:func:`relpos_plan`), everything else, float32 included, the CUDA-core
body; see the two headers for what bounds them. Both sum each term in the
same order (k ascending, one fmaf a step), the plain version's order on the
card. The wrappers count their launches in total and by body
(``body_launches``).
"""

from __future__ import annotations

import functools

import torch

from eventful_transformer_tpu_torch.ops import _build

BODY_CODES = {"simt": 0, "tile": 1}
TILE_MAX_SIDE = 16  # csrc/relpos_tile.cuh kRelposTileMaxSide
# csrc/relpos_tile.cuh RelposTileShape, by whether p1 is a multiple of 8:
# (shared memory a block may take, blocks the card holds at once)
TILE_SHAPES = {True: (113 * 1024, 2 * 132), False: (75 * 1024, 3 * 132)}
# The tile plan's model of a call: rounds of resident blocks' tiles, each
# round as long as one tile's bytes (the logits it reads and writes, the
# table rows it stages) plus PLAN_TILE_OVERHEAD, a tile's fixed latency in
# bytes; a tile's logits at most PLAN_TILE_BYTES where every vector lies in
# one key row (p1 a multiple of 8) and elsewhere, where a tile's terms and
# bias rows weigh more against its logits. Fitted to the tiles measured
# fastest on the card at every path form (scripts/misc/
# time_attention_bodies.py --tiles).
PLAN_TILE_BYTES = {True: 256 * 1024, False: 128 * 1024}
PLAN_TILE_OVERHEAD = 32 * 1024


def relpos_body(dtype, aligned=True):
    """The body of the rel-pos kernel that a call takes: "tile", the tiled
    body, for bfloat16 with q and both tables on 16-byte boundaries
    (``aligned``: it stages them by 16-byte copies); "simt", the CUDA-core
    body, for everything else: every float32 call (so the float32
    card-vs-CPU checks keep their meaning) and misaligned operands. Neither
    the head width (a multiple of 8, as both bodies take) nor the grids
    enter: the tiled body takes any (a, p). csrc/relpos.cu refuses a tiled
    call off this rule."""
    return "tile" if dtype == torch.bfloat16 and aligned else "simt"


def _tile_smem(r, s, p, c):
    """Shared memory of an r x s tile (csrc/relpos_tile.cuh
    relpos_tile_smem): the float32 terms (tx' with its bank padding), then
    the larger of the staged operands (bfloat16 table rows of c + 8
    elements, float32 q rows of c + 4) and, where p1 is no multiple of 8,
    the segments' bfloat16 bias rows."""
    tokens, np_ = r * s, p[0] * p[1]
    ty_len = (tokens * p[0] + 3) & ~3
    tx_n = tokens * p[1]
    tx_len = (tx_n + ((tx_n >> 5) << 2) + 3) & ~3
    staged = (r * p[0] + s * p[1]) * (c + 8) * 2 + tokens * (c + 4) * 4
    bias = r * ((s * np_ + 15) & ~7) * 2 if p[1] % 8 else 0
    return (ty_len + tx_len) * 4 + max(staged, bias)


@functools.lru_cache(maxsize=None)
def relpos_plan(bh, a, p, c, itemsize=2):
    """(r, s): the tiled body's tile of r query rows x s query columns for
    ``bh`` (batch, head) pairs over an (a0, a1) query grid, a (p0, p1) key
    grid and head width ``c``. r divides a0 and s divides a1 (no ragged
    tile), each at most TILE_MAX_SIDE, the tile's shared memory within its
    block shape's (TILE_SHAPES) and its logits within PLAN_TILE_BYTES (the
    smallest tile where none is). Of those, the least time by the plan's
    model (rounds of the blocks the card holds at once, each the bytes of
    one tile and PLAN_TILE_OVERHEAD), ties to the longer contiguous
    segments (s). None where no tile fits."""
    max_shared, resident = TILE_SHAPES[p[1] % 8 == 0]
    sides = [[d for d in range(1, min(n, TILE_MAX_SIDE) + 1) if n % d == 0] for n in a]
    options = [(r, s) for r in sides[0] for s in sides[1]
               if _tile_smem(r, s, p, c) <= max_shared]
    if not options:
        return None
    tile_bytes = lambda o: 2 * o[0] * o[1] * p[0] * p[1] * itemsize  # noqa: E731
    limit = PLAN_TILE_BYTES[p[1] % 8 == 0]
    small = [o for o in options if tile_bytes(o) <= limit] or [min(options, key=tile_bytes)]

    def cost(o):
        rounds = -(-bh * (a[0] // o[0]) * (a[1] // o[1]) // resident)
        staged = (o[0] * p[0] + o[1] * p[1]) * c * itemsize
        return rounds * (PLAN_TILE_OVERHEAD + tile_bytes(o) + staged), -o[1]

    return min(small, key=cost)


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


def _launch(wrapper, round_each, x, q, y_rel, x_rel, a, p):
    name = wrapper.__name__
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
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be 16-byte aligned")
    body = relpos_body(x.dtype, _build.aligned16(q, y_rel, x_rel))
    rows = cols = 0
    if body == "tile":
        plan = relpos_plan(bsz * heads, tuple(a), tuple(p), c)
        if plan is None:
            raise ValueError(f"{name}: no tile of the {a} grid holds the terms of {p} keys")
        rows, cols = plan
    out = torch.empty_like(x)
    _build.launch(
        "etk_relpos_bias_add", BODY_CODES[body], _build.dtype_code(x), round_each, x.data_ptr(),
        q.data_ptr(), y_rel.data_ptr(), x_rel.data_ptr(), out.data_ptr(), bsz * heads, a[0],
        a[1], p[0], p[1], c, rows, cols, _build.stream_of(x),
    )
    wrapper.launches += 1
    wrapper.body_launches[body] += 1
    return out


def relpos_bias_add(x, q, y_rel, x_rel, *, a, p):
    """The wrapper of :func:`relpos_bias_add_plain`, which CPU tensors take.
    CUDA tensors launch the kernel of csrc/relpos.cu in the body
    :func:`relpos_body` picks: x, q and the tables in one dtype (float32 or
    bfloat16), contiguous, a head width that is a multiple of 8, x on a
    16-byte boundary (the launch raises where a block's shared memory cannot
    hold its terms or table slice). Returns a new tensor."""
    if x.device.type == "cpu":
        return relpos_bias_add_plain(x, q, y_rel, x_rel, a=a, p=p)
    return _launch(relpos_bias_add, 0, x, q, y_rel, x_rel, a, p)


def relpos_bias_add_v2(x, q, y_rel, x_rel, *, a, p):
    """The wrapper of :func:`relpos_bias_add_v2_plain`, as
    :func:`relpos_bias_add`."""
    if x.device.type == "cpu":
        return relpos_bias_add_v2_plain(x, q, y_rel, x_rel, a=a, p=p)
    return _launch(relpos_bias_add_v2, 1, x, q, y_rel, x_rel, a, p)


relpos_bias_add.launches = 0
relpos_bias_add.body_launches = {"tile": 0, "simt": 0}
relpos_bias_add_v2.launches = 0
relpos_bias_add_v2.body_launches = {"tile": 0, "simt": 0}
