"""The rule that picks the body of the row passes.

The row passes run in one of two bodies: "warp", the warp-per-row pass of
``csrc/row_pass.cuh`` (one warp a token row, the row in registers by
16-byte loads, reductions by warp shuffles), or "block", the block-per-row
pass of ``csrc/common.cuh`` (one 256-thread block a row, the row in shared
memory). They are ``ln_norms`` (row 1, also the norms stage of kernel B, of
the groups that select their own rows in their "post" form and of
``select_linear_skip_norms`` with ``next_ln``), ``block_select_scatter``
(row 9), the select of ``block_select_p`` and ``ln_select`` (rows 10 and
14), and the select, LN and difference-norm stages of kernels A and B,
``dense_mlp_residual``, ``gate_group_mlp``, ``gate_group_linear``,
``ln_select_matmul`` and ``select_linear_skip_norms`` (rows 2-5, 7, 12
and 13). :func:`row_body` picks by the call's shapes, as
``window_attention.attention_body`` does for attention: every shape of the
model paths (C = 768, F = 768 or 2304, float32 and bfloat16) takes "warp".
The wrappers count their launches by body in ``row_body_launches``
(:func:`new_body_counts`), one a call for all the row passes it makes, and
the C entries refuse a "warp" call that breaks the rule.
"""

from __future__ import annotations

ROW_BODY_CODES = {"block": 0, "warp": 1}  # csrc/row_pass.cuh kRowBlock, kRowWarp
MAX_ROW_VECS = 18  # csrc/row_pass.cuh kMaxRowVecs: 16-byte vectors a lane holds


def row_body(dtype, widths, aligned=True):
    """"warp" where every row width in ``widths`` is a whole number of
    16-byte vectors of ``dtype`` and at most 32 x MAX_ROW_VECS of them (a
    warp's 32 lanes, MAX_ROW_VECS vectors each: 2304 float32 or 4608
    bfloat16 values), and every row operand starts on a 16-byte boundary
    (``aligned``); "block" otherwise. The rows of a contiguous operand then
    start on 16-byte boundaries too."""
    elems = 16 // dtype.itemsize  # values a 16-byte vector holds: 4 float32, 8 bfloat16
    limit = 32 * MAX_ROW_VECS * elems
    takes = aligned and all(0 < w <= limit and w % elems == 0 for w in widths)
    return "warp" if takes else "block"


def new_body_counts():
    """Launch counts by row body, all 0."""
    return dict.fromkeys(ROW_BODY_CODES, 0)
