"""Transformer blocks (port of ``eventful_transformer_tpu/core/blocks.py``):
the dense ``Block``, ``EventfulTokenwiseBlock``, ``EventfulMatmul1Block``
and ``EventfulBlock``.

``Block`` is the dense pre-LN ViT block with global or windowed attention,
relative position embeddings, k/v pooling and the matmul-2 cast. LN and
the qkv and projection linears run in plain PyTorch; the attention runs
through ``window_attention`` where the JAX package runs its kernel there
(global attention without pooling, rel-pos or cast at N <= 512; windowed
attention without pooling or cast, with its rel-pos terms, over a
zero-padded token map whose pad rows the kernel fills), else in plain
PyTorch, as the JAX package runs it in XLA; the MLP half runs through
``dense_mlp_residual``.

The eventful blocks flush densely (``mode="flush"``) and then step
incrementally (``mode="incremental"``) in the regime ``_fused_mode``
picks, as the JAX package dispatches on the TPU ("auto"), or in the one
``fused_gates`` forces:

- "v4" (N <= 512, a plain tokenwise block with order-2 top-k gates):
  ``ln_norms`` (first block of a step only), kernel A, kernel B and
  kernel C, with the top-k coverage computed between them;
- "v2mlp" (N <= 512, a block "v4" does not take, such as an
  ``EventfulBlock``): the qkv and projection gates in PyTorch with both
  linears recomputed densely from the gate states, and the MLP group
  through ``ln_norms`` and ``gate_group_mlp``;
- "v2" (512 < N <= 2048): the whole-group kernels. The qkv
  group of a windowed block keeps its buffer window-major and runs
  ``block_select_p`` and ``block_scatter_rows`` around a k-row qkv
  linear; other qkv groups and every projection group run
  ``gate_group_linear``; the MLP group runs ``gate_group_mlp``;
- "blocked" (N > 2048): each group lists its selected rows,
  runs its op (LN and linear, or the MLP) on those k rows in PyTorch, and
  makes one ``block_select_scatter`` pass over the full-size state; the
  windowed qkv group runs as in "v2";
- "v1", "v1v2", "v3" (forced only): the qkv group through ``ln_norms`` and
  ``ln_select_matmul``; the projection group through ``ln_select_matmul``
  ("v1", "v1v2") or ``select_linear_skip_norms`` ("v3", which also emits
  the MLP gate's norms); the MLP group through ``ln_norms``, ``ln_select``
  and the MLP on the gathered rows ("v1") or ``gate_group_mlp``;
- False: the unfused path the JAX package runs on the CPU and in
  training, every gate and buffer in plain PyTorch (``core/gating.py``),
  no kernel. STGT gates (``stgt=True``) always run it, as in the JAX
  package.

``in_kernel_topk`` (JAX ``EventfulTokenwiseBlock.in_kernel_topk``) lets the
"v2", "v2mlp", "v1v2" groups of ``gate_group_linear`` and ``gate_group_mlp``
select their own rows (``cov=None``) where the policy allows it, no norms
were handed over and the caller needs no index: no norms pass and no
top-k between the gate and the group. ``share_gate_passes`` False stops
the norms handoff, within a block (projection group to MLP gate) and
across blocks (``core/backbones.py``), as in the JAX package.

With ``gate_before_ln`` the qkv and MLP gates sit before their LayerNorm:
they hold x rather than ln(x), select on input-domain error norms, and the
LN runs on the selected rows (or on the whole new gate state, where the op
is recomputed from it): the "pre" forms of ``gate_group_mlp``,
``gate_group_linear`` and ``ln_select_matmul``, ``apply_ln=False`` in
``block_select_p``, ``block_select_scatter`` and ``ln_select``, and
``select_linear_skip_norms`` with ``next_ln=False``.

``EventfulBlock``'s incremental A.V step runs ``softmax_select_matmul``
(matmul-1, rel-pos bias, softmax, column select and A.V in one kernel)
where the JAX package's TPU rule takes its A.V kernel (at least 512 pooled
keys, or one stream), or its logits form where q.kT is not fused into it
(``fuse_matmul_1 = False``, or the reference's cached product,
``recompute_product = False``); ``recompute_av = False`` runs the
reference's delta-accumulated product instead.

Every regime takes the masked selections of ``TokenNormThreshold`` (and of
a top-k policy that saves its status) as the JAX package does: the
coverage holds only the valid candidates, so the group kernels may cover
fewer than kcap rows; the blocked kernels get the masked-off slots keyed to
the marker N, which writes nothing; and each count of the selected work is
scaled by the valid share (``valid_fraction``). Such a policy takes neither
"v4" nor the groups' own top-k.

Not ported: ATS, drop-path and sequence parallelism. Asking for one
raises ``NotImplementedError`` naming the ROADMAP.md item that holds it.
"""

from __future__ import annotations

from math import prod, sqrt

import torch
from torch import nn

from eventful_transformer_tpu_torch.core.embeddings import RelativePositionEmbedding
from eventful_transformer_tpu_torch.core.gating import (
    MatmulBuffer,
    MatmulDeltaAccumulator,
    SimpleSTGTGate,
    TokenBuffer,
    TokenDeltaGate,
    TokenGate,
)
from eventful_transformer_tpu_torch.core.indexing import (
    coverage,
    coverage_from_norms,
    index_from_coverage,
    select_cols,
    select_rows,
    take_rows,
    valid_fraction,
    window_permutation,
    window_row_map,
)
from eventful_transformer_tpu_torch.core.nn import (
    LayerNorm,
    Linear,
    counted_add,
    counted_matmul,
    gelu,
    layer_norm,
    not_ported,
)
from eventful_transformer_tpu_torch.core.policies import (
    check_kernel_policy,
    in_kernel_topk_eligible,
    topk_coverage_ok,
    vector_norm,
)
from eventful_transformer_tpu_torch.ops.av_softmax import (
    softmax_select_matmul,
    softmax_select_matmul_logits,
)
from eventful_transformer_tpu_torch.ops.block_fused import proj_group, qkv_attention_group
from eventful_transformer_tpu_torch.ops.dense_mlp import dense_mlp_residual
from eventful_transformer_tpu_torch.ops.gate_block import (
    block_scatter_rows,
    block_select_p,
    block_select_scatter,
)
from eventful_transformer_tpu_torch.ops.gate_fused import (
    ln_norms,
    ln_select,
    ln_select_matmul,
    select_linear_skip_norms,
)
from eventful_transformer_tpu_torch.ops.gate_group import gate_group_linear, gate_group_mlp
from eventful_transformer_tpu_torch.ops.window_attention import (
    window_attention,
    window_bias_pad_terms,
    window_bias_terms,
)

_CAST_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16}


def _pair(x):
    return (x, x) if isinstance(x, int) else tuple(x)


class Block(nn.Module):
    """Dense pre-LN Transformer block."""

    # the JAX package's auto limit for the global attention kernel
    GLOBAL_ATTN_MAX_TOKENS = 512

    def __init__(
        self,
        dim,
        heads,
        input_size,
        mlp_ratio,
        ats_fraction=None,
        drop_path_rate=0.0,
        relative_embedding_size=None,
        matmul_2_cast=None,
        pool_size=None,
        window_size=None,
        sequence_parallel=None,
    ):
        super().__init__()
        if ats_fraction is not None:
            raise not_ported("ATS", 10)
        if sequence_parallel is not None:
            raise not_ported("sequence parallelism", 17)
        if drop_path_rate != 0.0:
            raise not_ported("drop-path (training)", 12)
        if matmul_2_cast not in (None, *_CAST_DTYPES):
            raise ValueError(f"matmul_2_cast must be None, float16 or bfloat16, got {matmul_2_cast!r}")
        if dim % heads:
            raise ValueError(f"{heads} heads do not divide dim {dim}")
        self.dim = dim
        self.heads = heads
        self.input_size = tuple(input_size)
        self.matmul_2_cast = matmul_2_cast
        self.pool_size = None if pool_size is None else _pair(pool_size)
        if window_size is None:
            self.window_size = None
            attention_size = self.input_size
        else:
            self.window_size = _pair(window_size)
            attention_size = self.window_size
            if relative_embedding_size is not None:
                relative_embedding_size = self.window_size
        self.scale = sqrt(dim // heads)
        self.qkv = Linear(dim, dim * 3)
        self.projection = Linear(dim, dim)
        self.mlp_1 = Linear(dim, dim * mlp_ratio)
        self.mlp_2 = Linear(dim * mlp_ratio, dim)
        self.input_layer_norm = LayerNorm(dim)
        self.mlp_layer_norm = LayerNorm(dim)
        self.relative_position = None
        if relative_embedding_size is not None:
            self.relative_position = RelativePositionEmbedding(
                attention_size, relative_embedding_size, dim // heads, pool_size=self.pool_size
            )
        self._window_perm_cache = None

    def init_state(self, batch, n_tokens, dtype, device):
        del batch, n_tokens, dtype, device
        return {}

    def precompute(self):
        """Loop-invariant derived tensors: the rel-pos tables and, for a
        windowed block whose grid pads, the pad rows' terms."""
        if self.relative_position is None:
            return {}
        rp = self.relative_position
        aux = {"relative": rp.precompute()}
        if self.window_size is not None and any(self._window_padding()):
            bias = self.qkv.bias
            tab = rp.window_tab(aux["relative"], bias.dtype)
            aux["window_pad_terms"] = window_bias_pad_terms(bias, tab, self.heads)
        return aux

    def forward(self, ctx, state, x, mode=None, qkv_norms=None, next_gate=None, aux=None):
        """Returns (y, state, None); ``mode`` and the gate-norm handoff
        arguments only mean something to eventful blocks. ``aux``: this
        block's :meth:`precompute`, computed here when not given."""
        del mode, qkv_norms, next_gate
        skip_1 = x
        x = layer_norm(x, self.input_layer_norm)
        x = self.qkv(ctx, x)
        x = self._forward_attention(ctx, x, aux)
        x = self.projection(ctx, x)
        x = counted_add(ctx, x, skip_1)
        ln = self.mlp_layer_norm
        y = dense_mlp_residual(
            x, ln.scale, ln.bias, self.mlp_1.kernel, self.mlp_1.bias, self.mlp_2.kernel,
            self.mlp_2.bias,
        )
        # the plain path's counts: the two linears, their biases, the residual
        rows = float(x.numel() // x.shape[-1])
        hidden = self.mlp_1.out_features
        ctx.add("linear_flops", float(x.numel() * hidden))
        ctx.add("bias_flops", rows * hidden)
        ctx.add("linear_flops", rows * hidden * self.mlp_2.out_features)
        ctx.add("bias_flops", rows * self.mlp_2.out_features)
        ctx.add("add_flops", float(y.numel()))
        return y, state, None

    def _mlp(self, ctx, x):
        return self.mlp_2(ctx, gelu(self.mlp_1(ctx, x)))

    # -- attention -------------------------------------------------------------

    def _window_kernel_ok(self):
        return self.window_size is not None and self.pool_size is None and self.matmul_2_cast is None

    def _global_kernel_ok(self, n):
        return (
            self.window_size is None
            and self.pool_size is None
            and self.matmul_2_cast is None
            and self.relative_position is None
            and n <= self.GLOBAL_ATTN_MAX_TOKENS
        )

    def _forward_attention(self, ctx, x, aux, pre_partitioned=False):
        """Multi-head attention of packed qkv (B, N, 3C) -> (B, N, C). With
        ``pre_partitioned`` x is the window-major resident buffer (B, NW,
        3C), whose pad rows already hold the qkv bias row."""
        if pre_partitioned:
            x = x.reshape(-1, prod(self.window_size), x.shape[-1])
            if any(self._window_padding()):
                # the pad-bias map, counted once as the partitioning paths count it
                self.qkv.apply_bias(ctx, x.new_zeros((1, 1, 1, x.shape[-1])))
        if self._window_kernel_ok():
            pad_bias = geom = None
            if not pre_partitioned:
                x, pad_bias, geom = self._partition_windows_zero(ctx, x)
            return self._recombine_windows(self._fused_attention(ctx, x, aux, pad_bias, geom))
        if not pre_partitioned and self._global_kernel_ok(x.shape[-2]):
            return self._fused_attention(ctx, x, aux)
        if not pre_partitioned:
            x = self._partition_windows(ctx, x)
        q, k, v = self._partition_heads(x)
        k = self._pool_tokens(k)
        v = self._pool_tokens(v)
        a = counted_matmul(ctx, q / self.scale, k.transpose(-2, -1))
        if self.relative_position is not None:
            a = self.relative_position(ctx, a, q, self._derived(aux))
        a = torch.softmax(a, dim=-1)
        a, v, old_dtype = self._cast_matmul_2(a, v)
        x = counted_matmul(ctx, a, v)
        x = self._recombine_windows(self._recombine_heads(x))
        return self._uncast_matmul_2(x, old_dtype)

    def _derived(self, aux):
        derived = (aux or {}).get("relative")
        return derived if derived is not None else self.relative_position.precompute()

    def _fused_attention(self, ctx, x, aux, pad_bias=None, geom=None):
        """x (Bw, T, 3C), one window (or the whole sequence) per row, through
        ``window_attention``; with ``geom``, the windows of a zero-padded
        map, whose pad rows the kernel fills with ``pad_bias`` and the pad
        terms. Counted as the plain path counts (matmul-1, matmul-2 and,
        with rel-pos, the term einsums and the two adds)."""
        bw, t, _ = x.shape
        d = self.dim // self.heads
        a = self.window_size
        if self.relative_position is not None:
            rp = self.relative_position
            p = rp.pooled_size()
            tab = rp.window_tab(self._derived(aux), x.dtype)
            terms = window_bias_terms(x, tab, self.heads)
            pad_terms = None
            if geom is not None:
                pad_terms = (aux or {}).get("window_pad_terms")
                if pad_terms is None:
                    pad_terms = window_bias_pad_terms(pad_bias, tab, self.heads)
                pad_terms = pad_terms.to(x.dtype)
            out = window_attention(
                x, terms, pad_bias, pad_terms, heads=self.heads, scale=self.scale, p=p, a=a,
                geom=geom,
            )
            ctx.add("einsum_flops", float(bw * self.heads * t * (p[0] + p[1]) * d))
            ctx.add("add_flops", 2.0 * bw * self.heads * t * t)
        else:
            out = window_attention(
                x, None, pad_bias, heads=self.heads, scale=self.scale, a=a, geom=geom
            )
        ctx.add("matmul_flops", 2.0 * bw * self.heads * t * t * d)
        return out

    def _partition_heads(self, x):
        b, n = x.shape[:2]
        x = x.reshape(b, n, 3, self.heads, x.shape[-1] // (3 * self.heads))
        q, k, v = x.permute(2, 0, 3, 1, 4)
        return q, k, v

    @staticmethod
    def _recombine_heads(x):
        b, h, n, c = x.shape
        return x.transpose(1, 2).reshape(b, n, h * c)

    # -- windows ---------------------------------------------------------------

    def _window_padding(self):
        return (
            -self.input_size[0] % self.window_size[0],
            -self.input_size[1] % self.window_size[1],
        )

    def _window_major(self, x, pad_vec):
        """(B, N, C) row-major tokens -> (B, NW, C) window-major rows of the
        window grid, pad positions filled with ``pad_vec`` (C,)."""
        p = self._window_padding()
        d = self.window_size
        b, _, c = x.shape
        h, w = self.input_size
        x = x.reshape(b, h, w, c)
        if any(p):
            padded = pad_vec.expand(b, h + p[0], w + p[1], c).clone()
            padded[:, :h, :w] = x
            x = padded
            h, w = h + p[0], w + p[1]
        x = x.reshape(b, h // d[0], d[0], w // d[1], d[1], c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, h * w, c)

    def _partition_windows_zero(self, ctx, x):
        """qkv (B, N, 3C) -> (windows (B * nh * nw, T, 3C) of the map padded
        with zeros, pad_bias, geom): the windowed kernel fills the pad rows
        with ``pad_bias`` = qkv(0), the qkv bias row (counted as
        :meth:`_partition_windows` counts it), at the tokens outside the
        image that ``geom`` = (nh, nw, h, w) gives. Both are None when the
        grid does not pad."""
        p = self._window_padding()
        d = self.window_size
        c = x.shape[-1]
        pad_bias = geom = None
        if any(p):
            pad_bias = self.qkv.apply_bias(ctx, x.new_zeros((1, 1, 1, c))).reshape(c)
            h, w = self.input_size
            geom = ((h + p[0]) // d[0], (w + p[1]) // d[1], h, w)
        windows = self._window_major(x, x.new_zeros(c)).reshape(-1, prod(d), c)
        return windows, pad_bias, geom

    def _partition_windows(self, ctx, x):
        """qkv (B, N, 3C) -> (B * windows, T, 3C); pad tokens equal the qkv
        bias row, qkv(0) (reference blocks.py:269-287), counted. The plain
        path's partition."""
        if self.window_size is None:
            return x
        c = x.shape[-1]
        pad_vec = None
        if any(self._window_padding()):
            pad_vec = self.qkv.apply_bias(ctx, x.new_zeros((1, 1, 1, c))).reshape(c)
        return self._window_major(x, pad_vec).reshape(-1, prod(self.window_size), c)

    def _recombine_windows(self, x):
        if self.window_size is None:
            return x
        p = self._window_padding()
        d = self.window_size
        s = self.input_size
        c = x.shape[-1]
        total_h, total_w = s[0] + p[0], s[1] + p[1]
        x = x.reshape(-1, total_h // d[0], total_w // d[1], d[0], d[1], c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, total_h, total_w, c)
        if any(p):
            x = x[:, : s[0], : s[1]]
        return x.reshape(x.shape[0], s[0] * s[1], c)

    def _window_perm(self):
        """(perm, inv) numpy int32 maps between row-major tokens and
        window-major positions: perm holds the row-major token of each
        window-major position (pad positions -> h * w); inv the
        window-major position of each row-major token."""
        if self._window_perm_cache is None:
            self._window_perm_cache = window_permutation(self.input_size, self.window_size)
        return self._window_perm_cache

    # -- pooling and the matmul-2 cast ------------------------------------------

    def _pool_tokens(self, x):
        """Average-pool k or v (B, H, N, d) over the token grid."""
        if self.pool_size is None:
            return x
        w = self.input_size if self.window_size is None else self.window_size
        b, h, _, c = x.shape
        ph, pw = self.pool_size
        y = x.reshape(-1, w[0] // ph, ph, w[1] // pw, pw, c).mean(dim=(2, 4))
        return y.reshape(b, h, -1, c)

    def _cast_matmul_2(self, a, v):
        if self.matmul_2_cast is None:
            return a, v, None
        dtype = _CAST_DTYPES[self.matmul_2_cast]
        return a.to(dtype), v.to(dtype), a.dtype

    @staticmethod
    def _uncast_matmul_2(x, old_dtype):
        return x if old_dtype is None else x.to(old_dtype)


class EventfulTokenwiseBlock(Block):
    """Gates the token-wise ops: qkv, projection and MLP each sit behind a
    token gate. Step 0 runs dense (``mode="flush"``); later steps
    (``mode="incremental"``) run the regime of :meth:`_fused_mode`.

    ``fused_gates`` mirrors the JAX attribute: "auto" (the JAX package's
    TPU dispatch by token count) or a forced regime, "v4", "v2mlp", "v2",
    "blocked", "v1", "v1v2", "v3", or False (unfused). ``gate_before_ln``
    puts the qkv and MLP gates before their LN; ``stgt`` makes every gate a
    ``SimpleSTGTGate``, which runs unfused. ``recompute_buffers`` (the JAX
    attribute, False under STGT) lets the regimes below
    RECOMPUTE_MAX_TOKENS recompute the qkv and projection outputs from the
    gate states instead of keeping buffers."""

    V2MLP_MAX_TOKENS = 512
    V2_MAX_TOKENS = 2048
    # above it the unfused regimes keep qkv and projection buffers and
    # gather, where they recompute both from the gate states below it
    # (with recompute_buffers)
    RECOMPUTE_MAX_TOKENS = 2048
    FORCED_MODES = ("v4", "v2mlp", "v2", "blocked", "v1", "v1v2", "v3")
    # whether _attention_incremental consumes the qkv gate's indices
    _attention_uses_index = False
    # The group kernels' own selection (core/blocks.py:1400-1433 of the JAX
    # package): False off (the default), True wherever it applies, any
    # other value where it applies on the card at N <= TOPK_MAX_TOKENS.
    in_kernel_topk = False
    TOPK_MAX_TOKENS = 512

    def __init__(self, gate_before_ln=False, stgt=False, **block_kwargs):
        super().__init__(**block_kwargs)
        self.gate_before_ln = gate_before_ln
        self.stgt = stgt
        self.fused_gates = "auto"
        # False: no gate takes norms another kernel emitted (the JAX
        # package's A/B switch of its gate-pass sharing)
        self.share_gate_passes = "auto"
        # a STGT gate's state is the whole last input, not each token's
        # last update, so no op can be recomputed from it
        self.recompute_buffers = not stgt
        self._window_index_cache = {}
        gate_class = SimpleSTGTGate if stgt else TokenGate
        self.qkv_gate = gate_class()
        self.qkv_accumulator = TokenBuffer()
        self.projection_gate = gate_class()
        self.projection_accumulator = TokenBuffer()
        self.mlp_gate = gate_class()
        self.mlp_accumulator = TokenBuffer()

    @property
    def gates(self):
        return [self.qkv_gate, self.projection_gate, self.mlp_gate]

    def _fused_mode(self, n_tokens):
        """The incremental regime (core/blocks.py:847-875 of the JAX
        package, with its TPU thresholds under "auto"). STGT gates run
        unfused in every mode."""
        mode = self.fused_gates
        if self.stgt or mode is False:
            return False
        if mode == "v1":
            return "v1" if self.recompute_buffers else False
        if mode == "v4":
            return "v4" if self._v4_eligible() else "v2mlp"
        if mode in self.FORCED_MODES:
            return mode
        if mode != "auto":
            raise ValueError(
                f"fused_gates must be 'auto', False or one of {self.FORCED_MODES}, got {mode!r}"
            )
        if n_tokens <= self.V2MLP_MAX_TOKENS:
            return "v4" if self._v4_eligible() else "v2mlp"
        if n_tokens <= self.V2_MAX_TOKENS:
            return "v2"
        return "blocked"

    def _v4_eligible(self):
        """The whole-block "v4" step takes a plain tokenwise block (global
        attention, no pooling, rel-pos or cast, index-free attention, gates
        after LN, recomputed buffers, no STGT) with an order-2
        ``TokenNormTopK`` that saves no status on every gate. The JAX
        package's TPU tiling condition on the head width is not part of the
        port's rule."""
        if (
            self.stgt
            or not self.recompute_buffers
            or self.gate_before_ln
            or self._attention_uses_index
            or self.window_size is not None
            or self.pool_size is not None
            or self.relative_position is not None
            or self.matmul_2_cast is not None
        ):
            return False
        return all(in_kernel_topk_eligible(g.policy) for g in self.gates)

    def _recompute(self, n_tokens):
        """Whether the buffer-free regimes recompute the qkv and projection
        outputs from the gate states (JAX ``_recompute``)."""
        return self.recompute_buffers and n_tokens <= self.RECOMPUTE_MAX_TOKENS

    @property
    def _ln_mode(self):
        """The qkv and MLP gates' domain: "pre" (before LN) or "post"."""
        return "pre" if self.gate_before_ln else "post"

    def _resident_qkv(self, n_tokens):
        """Whether the qkv buffer lives window-major (the JAX package's
        ``window_resident_qkv`` default)."""
        return (
            self.window_size is not None
            and self.pool_size is None
            and self._fused_mode(n_tokens) in ("v2", "blocked")
        )

    def _resident_rows(self):
        p = self._window_padding()
        return (self.input_size[0] + p[0]) * (self.input_size[1] + p[1])

    def _window_index(self, device):
        """(N + 1,) int32 map of row-major token -> window-major row, with
        the out-of-range marker N -> -1, on ``device``."""
        if device not in self._window_index_cache:
            ext = window_row_map(self.input_size, self.window_size)
            self._window_index_cache[device] = torch.from_numpy(ext).to(device)
        return self._window_index_cache[device]

    def init_state(self, batch, n_tokens, dtype, device):
        shape = (batch, n_tokens, self.dim)
        state = {
            "qkv_gate": self.qkv_gate.init_state(shape, dtype, device),
            "projection_gate": self.projection_gate.init_state(shape, dtype, device),
            "mlp_gate": self.mlp_gate.init_state(shape, dtype, device),
            "mlp_accumulator": self.mlp_accumulator.init_state(shape, dtype, device),
        }
        # qkv and projection buffers where the regime gathers ("v2",
        # "blocked", or any regime that does not recompute); the others
        # recompute both from the gate states
        if not self._recompute(n_tokens) or self._fused_mode(n_tokens) in ("v2", "blocked"):
            rows = self._resident_rows() if self._resident_qkv(n_tokens) else n_tokens
            state["qkv_accumulator"] = self.qkv_accumulator.init_state(
                (batch, rows, 3 * self.dim), dtype, device
            )
            state["projection_accumulator"] = self.projection_accumulator.init_state(
                shape, dtype, device
            )
        return state

    def forward(self, ctx, state, x, mode=None, qkv_norms=None, next_gate=None, aux=None):
        """``mode``: "flush" or "incremental". ``qkv_norms``: this block's
        qkv-gate norms from the previous block's last kernel. ``next_gate``:
        the next block's (p_qkv, ln_scale, ln_bias), whose norms this
        block's last kernel then emits. Returns (y, state, next_norms); the
        kernels update the state tensors in place."""
        if mode == "flush":
            y, state = self._flush(ctx, state, x, aux)
            return y, state, None
        if mode == "incremental":
            return self._incremental(ctx, state, x, qkv_norms, next_gate, aux)
        raise ValueError(f"mode must be 'flush' or 'incremental', got {mode!r}")

    # -- flush -----------------------------------------------------------------

    def _flush(self, ctx, state, x, aux):
        state = dict(state)
        skip_1 = x
        x, state["qkv_gate"] = self._gate_flush(
            self.qkv_gate, state["qkv_gate"], x, self.input_layer_norm
        )
        x = self.qkv(ctx, x)
        if "qkv_accumulator" in state and self._resident_qkv(x.shape[-2]):
            # pad rows hold the qkv bias row, uncounted: the attention entry
            # counts the pad-bias map once
            x = self._window_major(x, self.qkv.bias.to(x.dtype))
            x, state["qkv_accumulator"] = self.qkv_accumulator.flush(state["qkv_accumulator"], x)
            x = self._forward_attention(ctx, x, aux, pre_partitioned=True)
        else:
            if "qkv_accumulator" in state:
                x, state["qkv_accumulator"] = self.qkv_accumulator.flush(
                    state["qkv_accumulator"], x
                )
            x, state = self._attention_flush(ctx, state, x, aux)
        _, state["projection_gate"] = self.projection_gate.flush(state["projection_gate"], x)
        x = self.projection(ctx, x)
        if "projection_accumulator" in state:
            x, state["projection_accumulator"] = self.projection_accumulator.flush(
                state["projection_accumulator"], x
            )
        x = counted_add(ctx, x, skip_1)
        skip_2 = x
        x, state["mlp_gate"] = self._gate_flush(
            self.mlp_gate, state["mlp_gate"], x, self.mlp_layer_norm
        )
        x, state["mlp_accumulator"] = self.mlp_accumulator.flush(
            state["mlp_accumulator"], self._mlp(ctx, x)
        )
        return counted_add(ctx, x, skip_2), state

    def _gate_flush(self, gate, gate_state, x, ln):
        """A gate's flush around its LN (core/blocks.py:1131-1136 of the
        JAX package): before it the gate keeps a copy of x (the kernels
        update the state in place, and x is the caller's); after it,
        ln(x). Returns (ln(x), gate state)."""
        if self.gate_before_ln:
            _, gate_state = gate.flush(gate_state, x.clone(memory_format=torch.contiguous_format))
            return layer_norm(x, ln), gate_state
        x = layer_norm(x, ln)
        _, gate_state = gate.flush(gate_state, x)
        return x, gate_state

    def _gate_ln(self, ctx, ln, gate, gate_state, x):
        """A gathering gate around its LN (core/blocks.py:1738-1746 of the
        JAX package): before it the gate selects from x and the gathered
        rows are normalised; after it, it selects from ln(x). Returns
        (rows, index, mask, gate state)."""
        if self.gate_before_ln:
            x_t, index, mask, gate_state = gate.incremental(ctx, gate_state, x)
            return layer_norm(x_t, ln), index, mask, gate_state
        return gate.incremental(ctx, gate_state, layer_norm(x, ln))

    def _select_ln(self, ln):
        """(scale, bias) for a kernel's select pass, which applies them after
        the LN and takes x itself before it."""
        return (None, None) if self.gate_before_ln else (ln.scale, ln.bias)

    def _op_input(self, p, ln):
        """The op's input recomputed from a gate state: ln(p) before the
        LN, p itself after it."""
        return layer_norm(p, ln) if self.gate_before_ln else p

    def _mlp(self, ctx, x, valid_frac=1):
        return self.mlp_2(ctx, gelu(self.mlp_1(ctx, x, valid_frac)), valid_frac)

    def _attention_flush(self, ctx, state, x, aux):
        return self._forward_attention(ctx, x, aux), state

    def _attention_incremental(self, ctx, state, x, index, mask, aux):
        del index, mask
        return self._forward_attention(ctx, x, aux), state

    # -- incremental -------------------------------------------------------------

    def _incremental(self, ctx, state, x, norms, next_gate, aux):
        n = x.shape[-2]
        for gate in self.gates:
            check_kernel_policy(gate.policy)
        if self.gate_before_ln:
            norms = None  # handed-over norms are in the LN domain
        mode = self._fused_mode(n)
        if mode == "v4":
            return self._v4_step(ctx, state, x, norms, next_gate)
        if mode in ("v2", "blocked"):
            return self._group_step(ctx, state, x, norms, next_gate, aux, mode == "blocked")
        state = dict(state)
        skip_1 = x
        x, index, mask = self._qkv_group(ctx, state, x, norms, mode)
        x, state = self._attention_incremental(ctx, state, x, index, mask, aux)
        x, mlp_norms = self._projection_group(ctx, state, x, skip_1, mode)
        y, next_norms = self._mlp_group(ctx, state, x, mlp_norms, next_gate, mode)
        return y, state, next_norms

    def _group_step(self, ctx, state, x, norms, next_gate, aux, blocked):
        """One step of the whole-group regimes, "v2" and "blocked"."""
        n = x.shape[-2]
        group_linear = self._blocked_group_linear if blocked else self._v2_group_linear
        state = dict(state)
        skip_1 = x
        if self._resident_qkv(n):
            x = self._resident_qkv_group(ctx, state, x, norms)
            x = self._forward_attention(ctx, x, aux, pre_partitioned=True)
        else:
            outs, index, mask = group_linear(
                ctx, self.qkv_gate, state["qkv_gate"], state["qkv_accumulator"], x,
                self.input_layer_norm, self._ln_mode, self.qkv,
                need_index=self._attention_uses_index, norms=norms,
            )
            x, state = self._attention_incremental(ctx, state, outs[1], index, mask, aux)
        # the projection group emits the MLP gate's norms, which are
        # LN-domain norms: not for a gate before LN
        own_mlp = None
        if not self.gate_before_ln and self.share_gate_passes is not False:
            own_mlp = (state["mlp_gate"]["p"], self.mlp_layer_norm.scale, self.mlp_layer_norm.bias)
        outs, _, _ = group_linear(
            ctx, self.projection_gate, state["projection_gate"],
            state["projection_accumulator"], x, None, "none", self.projection,
            skip=skip_1, next_gate=own_mlp,
        )
        x, mlp_norms = outs[2], outs[3]
        ctx.add("add_flops", x.numel())  # skip_1 residual
        group_mlp = self._blocked_group_mlp if blocked else self._v2_group_mlp
        y, next_norms = group_mlp(ctx, state, x, mlp_norms, next_gate)
        return y, state, next_norms

    # -- the "v2mlp", "v1", "v1v2", "v3" and unfused groups ---------------------------

    def _qkv_group(self, ctx, state, x, norms, mode):
        """The qkv group of the regimes without a whole-group kernel
        (core/blocks.py:1249-1297 of the JAX package): "v1"/"v1v2"/"v3"
        through ``ln_select_matmul``; otherwise the gate in PyTorch and the
        qkv linear recomputed densely from the gate state (select-only
        where the attention ignores the index), or, with a qkv buffer, on
        the selected rows and scattered in. Returns (qkv, index, mask),
        index None where no index is drawn."""
        ln = self.input_layer_norm
        if mode in ("v1", "v1v2", "v3"):
            y, index, mask, state["qkv_gate"] = self._fused_gate_group(
                ctx, self.qkv_gate, state["qkv_gate"], x, ln, self._ln_mode, self.qkv
            )
            return y, index, mask
        if (
            "qkv_accumulator" not in state
            and not self._attention_uses_index
            and self.qkv_gate.select_only_ok()
        ):
            c = x if self.gate_before_ln else layer_norm(x, ln)
            kcap, state["qkv_gate"] = self.qkv_gate.incremental_select(
                ctx, state["qkv_gate"], c, norms=norms
            )
            p = state["qkv_gate"]["p"]
            return self.qkv(ctx, self._op_input(p, ln), kcap / p.shape[-2]), None, None
        x_t, index, mask, state["qkv_gate"] = self._gate_ln(
            ctx, ln, self.qkv_gate, state["qkv_gate"], x
        )
        if "qkv_accumulator" not in state:
            p = state["qkv_gate"]["p"]
            frac = (index.shape[-1] / p.shape[-2]) * valid_fraction(mask)
            return self.qkv(ctx, self._op_input(p, ln), frac), index, mask
        x_t = self.qkv(ctx, x_t, valid_fraction(mask))
        x, state["qkv_accumulator"] = self.qkv_accumulator.incremental(
            state["qkv_accumulator"], x_t, index, mask
        )
        return x, index, mask

    def _projection_group(self, ctx, state, x, skip_1, mode):
        """The projection group and the skip add (core/blocks.py:1818-1906
        of the JAX package): "v3" through ``select_linear_skip_norms``,
        which also emits the MLP gate's norms; "v1"/"v1v2" through
        ``ln_select_matmul``; otherwise as the qkv group. Returns (y, the
        MLP gate's norms or None): ||ln(y) - p|| after the LN, ||y - p||
        before it."""
        gate, gate_state = self.projection_gate, state["projection_gate"]
        if mode == "v3":
            kcap, _, mask, cov = self._select(ctx, gate, gate_state["p"], x, None, "none")
            _, y, mlp_norms = select_linear_skip_norms(
                x, gate_state["p"], cov, self.projection.kernel, self.projection.bias, skip_1,
                state["mlp_gate"]["p"], *self._select_ln(self.mlp_layer_norm),
                next_ln=not self.gate_before_ln,
            )
            frac = (kcap / x.shape[-2]) * valid_fraction(mask)
            rows = x.numel() // x.shape[-1]
            ctx.add("linear_flops", frac * float(x.numel() * self.projection.out_features))
            ctx.add("bias_flops", frac * float(rows * self.projection.out_features))
            ctx.add("add_flops", y.numel())
            return y, mlp_norms
        if mode in ("v1", "v1v2"):
            x, _, _, state["projection_gate"] = self._fused_gate_group(
                ctx, gate, gate_state, x, None, "none", self.projection
            )
        elif "projection_accumulator" not in state and gate.select_only_ok():
            kcap, state["projection_gate"] = gate.incremental_select(ctx, gate_state, x)
            p = state["projection_gate"]["p"]
            x = self.projection(ctx, p, kcap / p.shape[-2])
        else:
            x_t, index, mask, state["projection_gate"] = gate.incremental(ctx, gate_state, x)
            if "projection_accumulator" not in state:
                p = state["projection_gate"]["p"]
                frac = (index.shape[-1] / p.shape[-2]) * valid_fraction(mask)
                x = self.projection(ctx, p, frac)
            else:
                x_t = self.projection(ctx, x_t, valid_fraction(mask))
                x, state["projection_accumulator"] = self.projection_accumulator.incremental(
                    state["projection_accumulator"], x_t, index, mask
                )
        return counted_add(ctx, x, skip_1), None

    def _mlp_group(self, ctx, state, x, norms, next_gate, mode):
        """The MLP group and the residual (core/blocks.py:1925-1959 of the
        JAX package): "v2mlp"/"v1v2"/"v3" through ``gate_group_mlp``; "v1"
        through ``ln_select`` and the MLP on the gathered rows; unfused
        with the gate in PyTorch. Returns (y, next_norms)."""
        if mode in ("v2mlp", "v1v2", "v3"):
            return self._v2_group_mlp(ctx, state, x, norms, next_gate)
        skip_2 = x
        ln = self.mlp_layer_norm
        if mode == "v1":
            x_t, index, mask, state["mlp_gate"] = self._fused_gate_select(
                ctx, state["mlp_gate"], x, ln
            )
        else:
            x_t, index, mask, state["mlp_gate"] = self._gate_ln(
                ctx, ln, self.mlp_gate, state["mlp_gate"], x
            )
        x_t = self._mlp(ctx, x_t, valid_fraction(mask))
        x, state["mlp_accumulator"] = self.mlp_accumulator.incremental(
            state["mlp_accumulator"], x_t, index, mask
        )
        return counted_add(ctx, x, skip_2), None

    def _fused_gate_group(self, ctx, gate, gate_state, x, ln, ln_mode, linear):
        """Gate norms -> selection -> ``ln_select_matmul`` (the gate-state
        select in place and the linear recomputed over every row of the
        new state). Returns (y, index, mask, gate state), counted as the
        gathered path."""
        kcap, index, mask, cov = self._select(
            ctx, gate, gate_state["p"], x, ln, ln_mode, need_index=True
        )
        scale, bias = (None, None) if ln_mode == "none" else (ln.scale, ln.bias)
        p, y = ln_select_matmul(
            x, gate_state["p"], cov, scale, bias, linear.kernel, linear.bias, ln_mode=ln_mode
        )
        frac = (kcap / x.shape[-2]) * valid_fraction(mask)
        ctx.add("linear_flops", frac * float(x.numel() * linear.out_features))
        ctx.add("bias_flops", frac * float(y.numel()))
        return y, index, mask, {"p": p}

    def _fused_gate_select(self, ctx, gate_state, x, ln):
        """The MLP gate of "v1": norms -> selection -> ``ln_select`` (in
        place); the selected rows of the new state are the MLP's input,
        normalised there when the gate sits before the LN. Returns (rows,
        index, mask, gate state)."""
        _, index, mask, cov = self._select(
            ctx, self.mlp_gate, gate_state["p"], x, ln, self._ln_mode, need_index=True
        )
        p = ln_select(
            x, gate_state["p"], cov, *self._select_ln(ln), apply_ln=not self.gate_before_ln
        )
        return self._op_input(take_rows(p, index), ln), index, mask, {"p": p}

    def _use_in_kernel_topk(self, policy, x):
        """Whether a group kernel selects its own rows (JAX
        ``_use_in_kernel_topk``; its TPU test is "x lies on the card")."""
        if self.in_kernel_topk is False:
            return False
        eligible = in_kernel_topk_eligible(policy)
        if self.in_kernel_topk is True:
            return eligible
        return eligible and x.is_cuda and x.shape[-2] <= self.TOPK_MAX_TOKENS

    def _select(self, ctx, gate, p, x, ln, ln_mode, norms=None, need_index=False,
                allow_topk=False):
        """Error norms (unless an upstream kernel handed them over) ->
        coverage and, with ``need_index``, the selected rows (B, k) int32,
        ascending (the JAX package lists them in top-k order; every
        consumer is order-free). A top-k policy takes its coverage straight
        from the norms, every slot valid (mask None); any other policy (a
        threshold, or a top-k that saves its status) lists its candidates
        with a mask, and the coverage holds only the valid ones, so that a
        group may cover fewer than kcap rows (JAX ``_v2_select``).
        ``allow_topk``: the caller's kernel can select its own rows, which
        it then does where :meth:`_use_in_kernel_topk` says so, no norms
        were handed over and no index is needed; the coverage is None
        then. Returns (kcap, index or None, mask or None, cov or None)."""
        ctx.add("gate_flops", x.numel())
        policy = gate.policy
        kcap = policy.capacity(x.shape[-2])
        if (
            allow_topk
            and norms is None
            and not need_index
            and self._use_in_kernel_topk(policy, x)
        ):
            return kcap, None, None, None
        if norms is None:
            if ln_mode == "post":
                norms = ln_norms(x, p, ln.scale, ln.bias)
            else:  # "pre", "none": error in the input domain
                norms = vector_norm(x - p, -1, 2)
        if topk_coverage_ok(policy):
            cov = coverage_from_norms(norms, kcap)
            index = index_from_coverage(cov, kcap).to(torch.int32) if need_index else None
            return kcap, index, None, cov
        index, mask = policy.select_from_norms(norms, ctx)
        cov = coverage(index, mask, x.shape[-2])
        return index.shape[-1], index.to(torch.int32), mask, cov

    @staticmethod
    def _keyed(index, mask, n):
        """The index list a blocked kernel takes: the masked-off slots keyed
        to the marker ``n``, so that rows 9 and 11 write nothing for them
        (JAX ``_blocked_select``)."""
        return index if mask is None else torch.where(mask, index, n)

    def _v2_group_linear(
        self, ctx, gate, gate_state, buf_state, x, ln, ln_mode, linear, skip=None,
        need_index=False, norms=None, next_gate=None,
    ):
        """Gate -> gathered linear -> buffer blend (-> skip add, next-gate
        norms) through ``gate_group_linear``. Returns ((p, b, y,
        next_norms), index, mask), counted as the gathered path, scaled by
        the valid share of a masked selection."""
        kcap, index, mask, cov = self._select(
            ctx, gate, gate_state["p"], x, ln, ln_mode, norms, need_index, allow_topk=True
        )
        scale, bias = (None, None) if ln_mode == "none" else (ln.scale, ln.bias)
        p_next, n_scale, n_bias = next_gate or (None, None, None)
        outs = gate_group_linear(
            x, gate_state["p"], buf_state["b"], cov, scale, bias, linear.kernel, linear.bias,
            skip, p_next, n_scale, n_bias, ln_mode=ln_mode, kcap=kcap,
        )
        frac = (kcap / x.shape[-2]) * valid_fraction(mask)
        rows = x.numel() // x.shape[-1]
        ctx.add("linear_flops", frac * float(x.numel() * linear.out_features))
        ctx.add("bias_flops", frac * float(rows * linear.out_features))
        return outs, index, mask

    def _resident_qkv_group(self, ctx, state, x, norms):
        """The qkv group over the window-major buffer: selection and the
        gate-state select row-major, the k-row qkv linear in PyTorch, and
        the buffer scatter at the window-major rows of the selected tokens
        (none for a masked-off slot). Returns the updated buffer (B, NW,
        3C)."""
        ln = self.input_layer_norm
        p = state["qkv_gate"]["p"]
        _, index, mask, cov = self._select(
            ctx, self.qkv_gate, p, x, ln, self._ln_mode, norms, True
        )
        h = self.qkv(ctx, layer_norm(take_rows(x, index), ln), valid_fraction(mask))
        block_select_p(x, p, cov, *self._select_ln(ln), apply_ln=not self.gate_before_ln)
        return block_scatter_rows(
            state["qkv_accumulator"]["b"], self._keyed(index, mask, x.shape[-2]), h,
            self._window_index(x.device),
        )

    # -- the "blocked" regime ------------------------------------------------------

    def _blocked_group_linear(
        self, ctx, gate, gate_state, buf_state, x, ln, ln_mode, linear, skip=None,
        need_index=False, norms=None, next_gate=None,
    ):
        """Gate -> the linear on the k selected rows in PyTorch -> one
        ``block_select_scatter`` pass (gate-state select, buffer blend, skip
        add, next-gate norms). Returns ((p, b, y, next_norms), index, mask),
        y and next_norms None where not asked for; the blocked groups list
        their rows whatever ``need_index`` says. The linear runs on every
        slot's row (a masked-off slot holds an in-range candidate), counted
        at the valid share."""
        del need_index
        _, index, mask, cov = self._select(
            ctx, gate, gate_state["p"], x, ln, ln_mode, norms, True
        )
        rows = take_rows(x, index)
        post = ln_mode == "post"
        if ln_mode != "none":  # LN commutes with the row gather
            rows = layer_norm(rows, ln)
        h = linear(ctx, rows, valid_fraction(mask))
        scale, bias = (ln.scale, ln.bias) if post else (None, None)
        p_next, n_scale, n_bias = next_gate or (None, None, None)
        outs = block_select_scatter(
            x, gate_state["p"], buf_state["b"], cov, self._keyed(index, mask, x.shape[-2]), h,
            scale, bias, skip, p_next, n_scale, n_bias, apply_ln=post,
        )
        return outs + (None,) * (4 - len(outs)), index, mask

    def _blocked_group_mlp(self, ctx, state, x, norms, next_gate):
        """Gate -> the MLP on the k selected rows in PyTorch -> one
        ``block_select_scatter`` pass with the residual x and the next
        gate's norms. Returns (y, next_norms)."""
        ln = self.mlp_layer_norm
        p, b = state["mlp_gate"]["p"], state["mlp_accumulator"]["b"]
        _, index, mask, cov = self._select(
            ctx, self.mlp_gate, p, x, ln, self._ln_mode, norms, True
        )
        h = self._mlp(ctx, layer_norm(take_rows(x, index), ln), valid_fraction(mask))
        p_next, n_scale, n_bias = next_gate or (None, None, None)
        outs = block_select_scatter(
            x, p, b, cov, self._keyed(index, mask, x.shape[-2]), h, *self._select_ln(ln), None,
            p_next, n_scale, n_bias, apply_ln=not self.gate_before_ln, residual_x=True,
        )
        ctx.add("add_flops", outs[2].numel())
        return outs[2], (outs[3] if p_next is not None else None)

    def _v2_group_mlp(self, ctx, state, x, norms, next_gate):
        """Gate -> gathered MLP -> buffer blend -> residual through
        ``gate_group_mlp``. Returns (y, next_norms)."""
        ln = self.mlp_layer_norm
        p, b = state["mlp_gate"]["p"], state["mlp_accumulator"]["b"]
        kcap, _, mask, cov = self._select(
            ctx, self.mlp_gate, p, x, ln, self._ln_mode, norms, allow_topk=True
        )
        p_next, n_scale, n_bias = next_gate or (None, None, None)
        _, _, y, next_norms = gate_group_mlp(
            x, p, b, cov, ln.scale, ln.bias, self.mlp_1.kernel, self.mlp_1.bias,
            self.mlp_2.kernel, self.mlp_2.bias, p_next, n_scale, n_bias,
            ln_mode=self._ln_mode, kcap=kcap,
        )
        frac = (kcap / x.shape[-2]) * valid_fraction(mask)
        rows = x.numel() // x.shape[-1]
        hidden = self.mlp_1.out_features
        ctx.add("linear_flops", frac * float(x.numel() * hidden))
        ctx.add("bias_flops", frac * float(rows * hidden))
        ctx.add("linear_flops", frac * float(rows * hidden * self.mlp_2.out_features))
        ctx.add("bias_flops", frac * float(rows * self.mlp_2.out_features))
        ctx.add("add_flops", y.numel())
        return y, next_norms

    def _v4_step(self, ctx, state, x, norms, next_gate):
        """One "v4" step: ``ln_norms`` (unless the previous block handed
        the norms over), kernel A, kernel B and kernel C."""
        n = x.shape[-2]
        kq, kp, km = (gate.policy.capacity(n) for gate in self.gates)
        if min(kq, kp, km) < 1:
            raise ValueError(f"a policy selects no token of {n}")
        ln1, ln2 = self.input_layer_norm, self.mlp_layer_norm
        p_qkv = state["qkv_gate"]["p"]
        p_proj = state["projection_gate"]["p"]
        p_mlp = state["mlp_gate"]["p"]
        b_mlp = state["mlp_accumulator"]["b"]
        if norms is None:
            norms = ln_norms(x, p_qkv, ln1.scale, ln1.bias)
        cov1 = coverage_from_norms(norms, kq)
        _, attn, norms2 = qkv_attention_group(
            x, p_qkv, cov1, p_proj, ln1.scale, ln1.bias, self.qkv.kernel,
            self.qkv.bias, heads=self.heads, inv_scale=1.0 / self.scale,
        )
        cov2 = coverage_from_norms(norms2, kp)
        _, y1, norms3 = proj_group(
            attn, p_proj, cov2, x, p_mlp, self.projection.kernel, self.projection.bias,
            ln2.scale, ln2.bias,
        )
        cov3 = coverage_from_norms(norms3, km)
        p_next, n_scale, n_bias = next_gate or (None, None, None)
        _, _, y, next_norms = gate_group_mlp(
            y1, p_mlp, b_mlp, cov3, ln2.scale, ln2.bias, self.mlp_1.kernel,
            self.mlp_1.bias, self.mlp_2.kernel, self.mlp_2.bias, p_next, n_scale,
            n_bias, ln_mode="post", kcap=km,
        )
        self._count_v4_step(ctx, x, kq, kp, km)
        return y, state, next_norms

    def _count_v4_step(self, ctx, x, kq, kp, km):
        """The unfused path's counts, key for key: select-only gates, the
        valid_frac recompute linears, the attention matmuls, the adds."""
        b, n, c = x.shape
        rows = float(b * n)
        hd = c // self.heads
        ctx.add("gate_flops", x.numel())  # qkv gate
        fq = kq / n
        ctx.add("linear_flops", fq * float(x.numel() * self.qkv.out_features))
        ctx.add("bias_flops", fq * rows * self.qkv.out_features)
        ctx.add("matmul_flops", float(b * self.heads * n * n * hd))  # q.kT
        ctx.add("matmul_flops", float(b * self.heads * n * hd * n))  # A.V
        ctx.add("gate_flops", x.numel())  # projection gate
        fp = kp / n
        ctx.add("linear_flops", fp * float(x.numel() * self.projection.out_features))
        ctx.add("bias_flops", fp * rows * self.projection.out_features)
        ctx.add("add_flops", x.numel())  # skip_1 residual
        ctx.add("gate_flops", x.numel())  # mlp gate
        fm = km / n
        hidden = self.mlp_1.out_features
        ctx.add("linear_flops", fm * float(x.numel() * hidden))
        ctx.add("bias_flops", fm * rows * hidden)
        ctx.add("linear_flops", fm * rows * hidden * self.mlp_2.out_features)
        ctx.add("bias_flops", fm * rows * self.mlp_2.out_features)
        ctx.add("add_flops", x.numel())  # mlp residual


class EventfulMatmul1Block(EventfulTokenwiseBlock):
    """Adds eventfulness to the query-key product. By default
    (``recompute_product``) an incremental step recomputes q.kT, counted as
    the reference's row and column updates; ``recompute_product = False``
    keeps the reference's cached product (``MatmulBuffer.incremental``).
    Global attention only."""

    _attention_uses_index = True

    def __init__(self, **block_kwargs):
        super().__init__(**block_kwargs)
        if self.window_size is not None:
            raise ValueError(f"{type(self).__name__} takes no windows")
        if self.pool_size is not None and any(
            s % p for s, p in zip(self.input_size, self.pool_size)
        ):
            raise ValueError(f"pool {self.pool_size} does not divide the grid {self.input_size}")
        self.recompute_product = True
        self.matmul_accumulator_1 = MatmulBuffer()

    def _pooled_tokens(self, n_tokens):
        if self.pool_size is None:
            return n_tokens
        extra = n_tokens - prod(self.input_size)  # class tokens, if any
        return extra + prod(s // p for s, p in zip(self.input_size, self.pool_size))

    def init_state(self, batch, n_tokens, dtype, device):
        state = super().init_state(batch, n_tokens, dtype, device)
        if not self.recompute_product:
            state["matmul_accumulator_1"] = self.matmul_accumulator_1.init_state(
                (batch, self.heads, n_tokens, self._pooled_tokens(n_tokens)), dtype, device
            )
        return state

    def _attention_flush(self, ctx, state, x, aux):
        a, v = self._matmul_1_flush(ctx, state, x, aux)
        a, v, old_dtype = self._cast_matmul_2(a, v)
        x = counted_matmul(ctx, a, v)
        return self._uncast_matmul_2(self._recombine_heads(x), old_dtype), state

    def _attention_incremental(self, ctx, state, x, index, mask, aux):
        a, _, v, _, _ = self._matmul_1_incremental(ctx, state, x, index, mask, aux)
        a, v, old_dtype = self._cast_matmul_2(a, v)
        x = counted_matmul(ctx, a, v)
        return self._uncast_matmul_2(self._recombine_heads(x), old_dtype), state

    def _matmul_1_flush(self, ctx, state, x, aux):
        q, k, v = self._partition_heads(x)
        k, v = self._pool_tokens(k), self._pool_tokens(v)
        if self.recompute_product:
            a = counted_matmul(ctx, q / self.scale, k.transpose(-2, -1))
        else:
            a, state["matmul_accumulator_1"] = self.matmul_accumulator_1.flush(
                ctx, state["matmul_accumulator_1"], q / self.scale, k.transpose(-2, -1)
            )
        return self._matmul_1_post(ctx, a, q, aux), v

    def _matmul_1_incremental(
        self, ctx, state, x, index, mask, aux, matmul=True, softmax=True, bias=True
    ):
        """Returns (attention, q, v, index_k, mask_k); with ``matmul`` False
        the product is left to the A.V kernel, counted here as the
        reference counts it, and the first item is the pooled k instead; with
        ``softmax`` (``bias``) False the softmax (the rel-pos bias) is left
        to it too."""
        q, k, v = self._partition_heads(x)
        k, v = self._pool_tokens(k), self._pool_tokens(v)
        index_k, mask_k = self._pool_index(index, mask)
        kt = k.transpose(-2, -1)
        if not matmul:
            self.matmul_accumulator_1.count_incremental(ctx, q, kt, index, index_k, mask, mask_k)
            return k, q, v, index_k, mask_k
        if self.recompute_product:
            a = self.matmul_accumulator_1.incremental_recompute(
                ctx, q / self.scale, kt, index, index_k, mask, mask_k
            )
        else:
            a, state["matmul_accumulator_1"] = self.matmul_accumulator_1.incremental(
                ctx, state["matmul_accumulator_1"], q / self.scale, kt, index, index_k, mask,
                mask_k,
            )
        return self._matmul_1_post(ctx, a, q, aux, softmax, bias), q, v, index_k, mask_k

    def _matmul_1_post(self, ctx, a, q, aux, softmax=True, bias=True):
        if self.relative_position is not None and bias:
            a = self.relative_position(ctx, a, q, self._derived(aux))
        return torch.softmax(a, dim=-1) if softmax else a

    def _pool_index(self, index, mask):
        """Token indices -> pooled-grid indices, deduplicated as the
        reference's ``.unique()``: sorted, repeats masked off (their slots
        hold 0)."""
        if self.pool_size is None or index is None:
            return index, mask
        width = self.input_size[1]
        index_y = (index // width) // self.pool_size[0]
        index_x = (index % width) // self.pool_size[1]
        pooled = index_y * (width // self.pool_size[1]) + index_x
        big = torch.iinfo(torch.int32).max
        key = pooled if mask is None else torch.where(mask, pooled, big)
        s = key.sort(dim=-1).values
        dup = torch.cat([torch.zeros_like(s[..., :1], dtype=torch.bool), s[..., 1:] == s[..., :-1]], -1)
        new_mask = ~dup & (s != big)
        return torch.where(new_mask, s, 0), new_mask


class EventfulBlock(EventfulMatmul1Block):
    """Adds eventfulness to the attention-value product. The delta-
    accumulated product is pure memoization (``product == p_a @ p_v`` at
    every step), so by default (``recompute_av``) an incremental step
    selects the changed columns of the attention matrix and rows of v into
    the gate states and recomputes ``p_a @ p_v``, counted as the
    reference's gathered delta products; ``recompute_av = False`` keeps the
    reference's delta accumulator (``TokenDeltaGate.incremental`` and
    ``MatmulDeltaAccumulator``).

    ``av_kernel`` and ``fuse_matmul_1`` mirror the JAX attributes: "auto"
    runs the recompute step through ``softmax_select_matmul`` by the JAX
    package's TPU rule, True always, False never. The kernel computes q.kT
    itself (its fused form) unless ``fuse_matmul_1`` is False or the
    product is cached, where it reads the logits tensor (its logits form,
    ``softmax_select_matmul_logits``)."""

    # the JAX package's TPU rule: the A.V kernel at >= 512 pooled keys, or
    # at any count for one stream
    AV_KERNEL_MIN_COLS = 512

    def __init__(self, **block_kwargs):
        super().__init__(**block_kwargs)
        self.recompute_av = True
        self.av_kernel = "auto"
        self.fuse_matmul_1 = "auto"
        self.v_gate = TokenDeltaGate()
        self.matmul_gate = TokenDeltaGate(structure="col")
        self.matmul_accumulator_2 = MatmulDeltaAccumulator()

    def init_state(self, batch, n_tokens, dtype, device):
        state = super().init_state(batch, n_tokens, dtype, device)
        n_p = self._pooled_tokens(n_tokens)
        sdtype = _CAST_DTYPES.get(self.matmul_2_cast, dtype)
        head_dim = self.dim // self.heads
        state["v_gate"] = self.v_gate.init_state((batch, self.heads, n_p, head_dim), sdtype, device)
        state["matmul_gate"] = self.matmul_gate.init_state(
            (batch, self.heads, n_tokens, n_p), sdtype, device
        )
        if not self.recompute_av:
            state["matmul_accumulator_2"] = self.matmul_accumulator_2.init_state(
                (batch, self.heads, n_tokens, head_dim), sdtype, device
            )
        return state

    def _attention_flush(self, ctx, state, x, aux):
        a, v = self._matmul_1_flush(ctx, state, x, aux)
        a, v, old_dtype = self._cast_matmul_2(a, v)
        # v may be a view of the qkv buffer, which later steps update in place
        _, state["v_gate"] = self.v_gate.flush(state["v_gate"], v.contiguous())
        _, state["matmul_gate"] = self.matmul_gate.flush(state["matmul_gate"], a)
        if self.recompute_av:
            x = counted_matmul(ctx, a, v)
        else:
            x, state["matmul_accumulator_2"] = self.matmul_accumulator_2.flush(
                ctx, state["matmul_accumulator_2"], a, v
            )
        return self._uncast_matmul_2(self._recombine_heads(x), old_dtype), state

    def _use_av_kernel(self, n_cols, batch):
        if not self.recompute_av or self.av_kernel is False:
            return False
        if self.av_kernel is True:
            return True
        if self.av_kernel != "auto":
            raise ValueError(f"av_kernel must be 'auto', True or False, got {self.av_kernel!r}")
        return n_cols >= self.AV_KERNEL_MIN_COLS or batch == 1

    def _attention_incremental(self, ctx, state, x, index, mask, aux):
        if not self._use_av_kernel(self._pooled_tokens(x.shape[-2]), x.shape[0]):
            a, _, v, index_k, mask_k = self._matmul_1_incremental(ctx, state, x, index, mask, aux)
            a, v, old_dtype = self._cast_matmul_2(a, v)
            if self.recompute_av:
                x = self._av_recompute(ctx, state, a, v, index_k, mask_k)
            else:
                x = self._av_delta(ctx, state, a, v, index_k, mask_k)
            return self._uncast_matmul_2(self._recombine_heads(x), old_dtype), state
        if self.fuse_matmul_1 is not False and self.recompute_product:
            k, q, v, index_k, mask_k = self._matmul_1_incremental(
                ctx, state, x, index, mask, aux, matmul=False
            )
            # the cast applies to the A.V operands only: the kernel computes
            # the logits from q and k in the working dtype
            old_dtype = None
            if self.matmul_2_cast is not None:
                old_dtype = v.dtype
                v = v.to(_CAST_DTYPES[self.matmul_2_cast])
            x = self._av_recompute(ctx, state, None, v, index_k, mask_k, q=q, k=k, aux=aux)
        else:
            # the logits form: the rel-pos bias and the softmax in the
            # kernel, the logits cast with v to the state dtype
            a, q, v, index_k, mask_k = self._matmul_1_incremental(
                ctx, state, x, index, mask, aux, softmax=False, bias=False
            )
            a, v, old_dtype = self._cast_matmul_2(a, v)
            x = self._av_recompute(ctx, state, a, v, index_k, mask_k, q=q, aux=aux)
        return self._uncast_matmul_2(self._recombine_heads(x), old_dtype), state

    def _av_recompute(self, ctx, state, a, v, index_k, mask_k, q=None, k=None, aux=None):
        """p_v = v's selected rows into the v gate state, p_a = the
        attention matrix's selected columns into the matmul gate state,
        x = p_a @ p_v. With ``q`` the step runs through the A.V kernel,
        which adds the rel-pos bias, takes the softmax, selects the columns
        into the state in place and multiplies: from the logits ``a``, or,
        with the pooled ``k`` (``a`` None), from the logits it computes
        itself. Counted as the reference's delta formulation."""
        p_a_state = state["matmul_gate"]["p"]
        ctx.add("gate_flops", float(v.numel()))  # v gate error pass
        # contiguous for the kernel: where() keeps the layout of v, a view
        # into the qkv rows where no pooling copies it
        p_v = select_rows(state["v_gate"]["p"], v, index_k, mask_k).contiguous()
        state["v_gate"] = {"p": p_v}
        ctx.add("gate_flops", float(p_a_state.numel()))  # matmul gate error pass
        if q is None:
            p_a = select_cols(p_a_state, a, index_k, mask_k)
            x = torch.matmul(p_a, p_v)
        else:
            terms = p = None
            if self.relative_position is not None:
                rp = self.relative_position
                terms, p = rp.bias_terms(ctx, q, self._derived(aux)), rp.pooled_size()
                ctx.add("add_flops", 2.0 * p_a_state.numel())  # the bias adds
            cov = coverage(index_k, mask_k, p_a_state.shape[-1])
            if k is None:
                # the cached product is a view into its scatter's buffer
                p_a, x = softmax_select_matmul_logits(
                    a.contiguous(), p_a_state, cov, p_v, terms, p=p
                )
            else:
                p_a, x = softmax_select_matmul(
                    p_a_state, cov, p_v, q.contiguous(), k.contiguous(), terms,
                    inv_scale=1.0 / self.scale, p=p,
                )
        state["matmul_gate"] = {"p": p_a}
        frac = valid_fraction(mask_k)
        kcap = index_k.shape[-1]
        batch_heads = p_a_state.numel() // (p_a_state.shape[-2] * p_a_state.shape[-1])
        out_size = float(batch_heads * p_a_state.shape[-2] * v.shape[-1])
        ctx.add("accumulator_flops", frac * float(batch_heads * kcap * v.shape[-1]) + 2.0 * out_size)
        ctx.add("matmul_flops", 2.0 * frac * out_size * kcap)
        return x

    def _av_delta(self, ctx, state, a, v, index_k, mask_k):
        """The reference's delta step (``recompute_av = False``): the v gate
        forced to the pooled key selection, the matmul gate forced to the v
        gate's, and their deltas into the accumulator."""
        v_n, v_delta, index_v, mask_v, state["v_gate"] = self.v_gate.incremental(
            ctx, state["v_gate"], v, forced_index=index_k, forced_mask=mask_k
        )
        a_n, a_delta, _, _, state["matmul_gate"] = self.matmul_gate.incremental(
            ctx, state["matmul_gate"], a, forced_index=index_v, forced_mask=mask_v
        )
        x, state["matmul_accumulator_2"] = self.matmul_accumulator_2.incremental(
            ctx, state["matmul_accumulator_2"], a_n, v_n, a_delta, v_delta, mask=mask_v
        )
        return x


BLOCK_CLASSES = {
    "Block": Block,
    "EventfulTokenwiseBlock": EventfulTokenwiseBlock,
    "EventfulMatmul1Block": EventfulMatmul1Block,
    "EventfulBlock": EventfulBlock,
}
