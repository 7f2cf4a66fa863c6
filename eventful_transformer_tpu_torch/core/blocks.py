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

Adaptive token sampling (``ats_fraction``, Fayyaz et al. 2022) keeps
the class token and the ``n_select`` tokens of the highest attention
scores after the attention of every block class, as the JAX package does
(its ``_adaptive_token_sampling``): the tokens after it, the skip and the
later gates and buffers are ``out_tokens`` wide. An ATS block runs the
plain attention (no attention or A.V kernel) and steps unfused in every
mode; the dense MLP kernel runs at its reduced token count. The sampled
indices are stabilised against the last frame's (``ats_last``), so the
dense ``Block`` carries state too.

Training (``ctx.training``): every block class takes the plain PyTorch
path the JAX package takes under training, which autograd differentiates:
the attention without ``window_attention`` or the A.V kernel, the rel-pos
bias added in plain PyTorch, the dense MLP without ``dense_mlp_residual``,
and the eventful blocks' incremental step unfused (a window-major qkv
buffer goes row-major for the step and back after it). No kernel wrapper
is reached: the kernels have no backward. ``drop_path_rate`` sets the
stochastic depth on both residual adds of the dense block and of the
eventful blocks' flush and unfused steps (JAX ``core/blocks.py:226, 252,
1906, 1959``); it is the identity outside training.

Sequence parallelism (``sequence_parallel``, the dense ``Block`` only,
as in the JAX package): the block's tokens are a shard of the sequence,
one per process of the mesh axis it names, whose process group the
caller hands over in ``ctx.groups`` (``parallel/evaluate.py``); the
attention trades tokens for heads by two all-to-alls
(``parallel/sequence.py``) and attends over the full sequence with its
heads/P heads by the route the single-process block takes at that N (the
global ``window_attention`` kernel at N <= 512, else plain PyTorch); the
MLP runs ``dense_mlp_residual`` over the shard's rows. Each process counts
its own shard's work.

Tensor parallelism (``tp_group``, set by ``parallel/sharding.py::
shard_params`` at tp > 1, on every block class): the block holds its
rank's heads and hidden units, and its forward is Megatron's, LN ->
``to_model_parallel`` -> the column linear (qkv: the packed qkv of H/tp
heads, attended by the route the single-process block takes at that
width: the global ``window_attention`` kernel at N <= 512 outside training,
``softmax_select_matmul`` for an ``EventfulBlock``'s A.V where its rule
takes it) -> the row linear without its bias -> ``from_model_parallel``
(the all-reduce) -> the bias, once -> drop-path and the residual, for the
attention and for the MLP (LN, mlp_1, GELU, mlp_2: plain PyTorch, since
``dense_mlp_residual`` adds its bias and residual on every rank). An
eventful block steps unfused (the fused regimes bake the whole channel
width into their kernels' epilogues), its gates and buffers at the width
of what they hold:

- the qkv and MLP gates, their LN and the MLP and projection buffers hold
  the replicated residual stream, whole on every rank, and select alike
  on every rank;
- the qkv buffer holds this rank's heads' qkv columns; the projection gate
  holds this rank's heads' share of the attention output, so its error
  norm spans the group: the one sum that does (``TokenGate.norm_group``,
  ``core/policies.py::vector_norm``: the partial sums of |e|^order
  all-reduced before the root), after which every rank takes the same
  rows and updates its own columns;
- the row-parallel projection and mlp_2 all-reduce their partial products
  (on the gathered rows, or over the whole gate state where the step
  recomputes them) before the buffer scatter, and add the bias once;
- the per-head state of ``EventfulMatmul1Block`` (the cached q.kT) and of
  ``EventfulBlock`` (the v and matmul gates, the delta-accumulated A.V, all
  forced to the qkv gate's replicated selection) is this rank's heads',
  and no collective touches it;
- ATS sums its scores over the heads: this rank's float32 head sum is
  all-reduced before the one rounding (:func:`ats_scores`), so every rank
  keeps the same tokens.

So a block's incremental step has three collectives over the group (the
projection's, the MLP's, the projection gate's norms), and a fourth with
ATS; its flush the first two (and ATS's); nothing per head takes one. Each rank counts its own share: a group's
``linear_flops`` and ``matmul_flops`` sum to the unsharded counts, and
the replicated work (LN, the gates on the residual stream, the
row-parallel biases, the adds) is counted on every rank. At tp = 1
nothing is set, and the block runs as above, every regime and kernel in
serving included.
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
    DropPath,
    LayerNorm,
    Linear,
    counted_add,
    counted_matmul,
    gelu,
    layer_norm,
)
from eventful_transformer_tpu_torch.core.policies import (
    check_kernel_policy,
    in_kernel_topk_eligible,
    reduced,
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


def ats_scores(a, v, group=None):
    """ATS token scores (B, N) float32 of the attention a (B, H, N, N) and
    v (B, H, N, d), with the JAX package's roundings in a's dtype: the
    class-token column times ||v|| (the float32 sum of the squares,
    rounded once, then its square root, as XLA fuses ``jnp.linalg.norm``),
    over its sum across the non-class tokens, the class token at +inf,
    summed over the heads (JAX ``core/blocks.py:686-694``; the
    reference's ``dim=-3`` sums its views instead). Each sum runs in
    float32 and rounds once; with ``group`` the heads are this rank's of a
    tensor-parallel group, and their float32 sum is all-reduced over it
    before the rounding."""
    norms = v.float().square().sum(dim=-1).to(v.dtype).sqrt()
    raw = a[..., 0] * norms
    scores = raw / raw[..., 1:].float().sum(dim=-1, keepdim=True).to(raw.dtype)
    scores[..., 0] = float("inf")
    return reduced(scores.float().sum(dim=-2), group).to(a.dtype).float()


def stabilize_ats_indices(last, new):
    """The JAX package's ``_stabilize_ats_indices`` on tensors: the old
    indices (B, k) that ``new`` (B, k, ascending) still selects keep their
    slots; the vacated slots take the newly selected indices, in order."""
    old_not_in_new = ~_is_member(last, new)
    new_in_old = _is_member(new, last.sort(dim=-1).values)
    # the new-not-in-old values first, in order
    order = torch.argsort(new_in_old.to(torch.int32), dim=-1, stable=True)
    fill_values = torch.gather(new, -1, order)
    rank = torch.cumsum(old_not_in_new.to(torch.int64), dim=-1) - 1
    fills = torch.gather(fill_values, -1, rank.clamp(0, new.shape[-1] - 1))
    return torch.where(old_not_in_new, fills, last)


def _is_member(values, sorted_ref):
    pos = torch.searchsorted(sorted_ref.contiguous(), values.contiguous(), side="left")
    pos = pos.clamp(0, sorted_ref.shape[-1] - 1)
    return torch.gather(sorted_ref, -1, pos) == values


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
        if ats_fraction is not None and (
            pool_size is not None or window_size is not None or not 0.0 <= ats_fraction <= 1.0
        ):
            raise ValueError(
                f"ATS takes a fraction in [0, 1] and global attention without pooling, got "
                f"ats_fraction={ats_fraction!r}, pool_size={pool_size!r}, "
                f"window_size={window_size!r}"
            )
        if sequence_parallel is not None and (
            type(self) is not Block
            or window_size is not None
            or pool_size is not None
            or relative_embedding_size is not None
            or ats_fraction is not None
        ):
            # top-k gates would select per shard; windows, pooling, rel-pos
            # and ATS keep the attention local or data-dependent
            raise ValueError(
                "sequence_parallel takes the dense Block with global attention and no "
                "pooling, rel-pos or ATS"
            )
        if not 0.0 <= drop_path_rate <= 1.0:
            raise ValueError(f"drop_path_rate must lie in [0, 1], got {drop_path_rate!r}")
        if matmul_2_cast not in (None, *_CAST_DTYPES):
            raise ValueError(f"matmul_2_cast must be None, float16 or bfloat16, got {matmul_2_cast!r}")
        if dim % heads:
            raise ValueError(f"{heads} heads do not divide dim {dim}")
        self.dim = dim
        self.heads = heads
        self.input_size = tuple(input_size)
        self.ats_fraction = ats_fraction
        self.matmul_2_cast = matmul_2_cast
        self.sequence_parallel = sequence_parallel
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
        self.drop_path = DropPath(drop_path_rate)
        self.relative_position = None
        if relative_embedding_size is not None:
            self.relative_position = RelativePositionEmbedding(
                attention_size, relative_embedding_size, dim // heads, pool_size=self.pool_size
            )
        self._window_perm_cache = None
        # the "model" process group of tensor parallelism (parallel/sharding.py)
        self.tp_group = None

    def n_select(self, n_tokens):
        """The tokens ATS keeps of ``n_tokens``, the class token included."""
        return int(self.ats_fraction * (n_tokens - 1)) + 1

    def out_tokens(self, n_tokens):
        return n_tokens if self.ats_fraction is None else self.n_select(n_tokens)

    @property
    def local_heads(self):
        """The heads this block attends: all of them, or its
        tensor-parallel rank's share (as many as its qkv's width holds)."""
        return self.qkv.out_features // (3 * (self.dim // self.heads))

    def init_state(self, batch, n_tokens, dtype, device):
        """{} without ATS; with it the last frame's sampled indices and
        whether there was one (a host bool: the first frame skips the
        stabilisation)."""
        del dtype
        if self.ats_fraction is None:
            return {}
        return {
            "ats_last": torch.zeros(
                (batch, self.n_select(n_tokens)), dtype=torch.int32, device=device
            ),
            "ats_has_last": False,
        }

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
        x = self._col(ctx, self.qkv, layer_norm(x, self.input_layer_norm))
        x, ats_index, state = self._forward_attention(ctx, x, aux, state=state)
        skip_1 = self._gather_ats_skip(skip_1, ats_index)
        x = counted_add(ctx, self.drop_path(ctx, self._row(ctx, self.projection, x)), skip_1)
        # the kernel has no backward, and would add its bias and residual
        # on every rank of a tensor-parallel group
        if ctx.training or self.tp_group is not None:
            x_t = self._mlp(ctx, layer_norm(x, self.mlp_layer_norm))
            return counted_add(ctx, self.drop_path(ctx, x_t), x), state, None
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

    def _mlp(self, ctx, x, valid_frac=1):
        return self._row(ctx, self.mlp_2, gelu(self._col(ctx, self.mlp_1, x, valid_frac)),
                         valid_frac)

    def _col(self, ctx, linear, x, valid_frac=1):
        """The qkv or mlp_1 linear; under tensor parallelism column-parallel,
        Megatron's ``to_model_parallel`` before it (the module's
        docstring)."""
        if self.tp_group is not None:
            from eventful_transformer_tpu_torch.parallel.sharding import to_model_parallel

            x = to_model_parallel(x, self.tp_group)
        return linear(ctx, x, valid_frac)

    def _row(self, ctx, linear, x, valid_frac=1):
        """The projection or mlp_2 linear; under tensor parallelism
        row-parallel: this rank's partial product, summed over the group,
        then the replicated bias, added once. Counted as the linear counts
        (this rank's rows)."""
        if self.tp_group is None:
            return linear(ctx, x, valid_frac)
        from eventful_transformer_tpu_torch.parallel.sharding import from_model_parallel

        y = from_model_parallel(torch.matmul(x, linear.kernel.to(x.dtype)), self.tp_group)
        y = y + linear.bias.to(x.dtype)
        ctx.add("linear_flops", valid_frac * float(x.numel() * linear.out_features))
        ctx.add("bias_flops", valid_frac * float(y.numel()))
        return y

    # -- attention -------------------------------------------------------------

    def _window_kernel_ok(self, ctx):
        return (
            self.window_size is not None
            and self.pool_size is None
            and self.matmul_2_cast is None
            and not ctx.training
        )

    def _global_kernel_ok(self, ctx, n):
        return (
            self.window_size is None
            and not ctx.training
            and self.ats_fraction is None
            and self.pool_size is None
            and self.matmul_2_cast is None
            and self.relative_position is None
            and n <= self.GLOBAL_ATTN_MAX_TOKENS
        )

    def _forward_attention(self, ctx, x, aux, pre_partitioned=False, state=None):
        """Multi-head attention of packed qkv (B, N, 3C) -> (B, N', C), N'
        the tokens ATS keeps (N without it). With ``pre_partitioned`` x is
        the window-major resident buffer (B, NW, 3C), whose pad rows
        already hold the qkv bias row. Returns (y, the ATS indices or None,
        state)."""
        if self.sequence_parallel is not None:
            return self._attention_ulysses(ctx, x, aux), None, state
        return self._attention(ctx, x, aux, pre_partitioned, state)

    def _attention_ulysses(self, ctx, x, aux):
        """Token-sharded qkv (B, N/P, 3C) -> (B, N/P, C): the heads/P heads
        of this process over all N tokens (JAX ``_attention_ulysses``),
        attended as the single-process block attends at N."""
        from eventful_transformer_tpu_torch.parallel.sequence import ulysses_attention

        group = ctx.groups.get(self.sequence_parallel)
        if group is None:
            raise ValueError(f"sequence_parallel={self.sequence_parallel!r}: the context holds "
                             "no process group of that mesh axis (Ctx(groups=...))")
        return ulysses_attention(
            x, self.heads, group, lambda qkv: self._attention(ctx, qkv, aux, False, None)[0]
        )

    def _attention(self, ctx, x, aux, pre_partitioned, state):
        """:meth:`_forward_attention` over as many heads as x's width holds
        (all the block's, or a sequence-parallel rank's share)."""
        if pre_partitioned:
            x = x.reshape(-1, prod(self.window_size), x.shape[-1])
            if any(self._window_padding()):
                # the pad-bias map, counted once as the partitioning paths count it
                self.qkv.apply_bias(ctx, x.new_zeros((1, 1, 1, x.shape[-1])))
        if self._window_kernel_ok(ctx):
            pad_bias = geom = None
            if not pre_partitioned:
                x, pad_bias, geom = self._partition_windows_zero(ctx, x)
            y = self._recombine_windows(self._fused_attention(ctx, x, aux, pad_bias, geom))
            return y, None, state
        if not pre_partitioned and self._global_kernel_ok(ctx, x.shape[-2]):
            return self._fused_attention(ctx, x, aux), None, state
        if not pre_partitioned:
            x = self._partition_windows(ctx, x)
        q, k, v = self._partition_heads(x)
        k = self._pool_tokens(k)
        v = self._pool_tokens(v)
        a = counted_matmul(ctx, q / self.scale, k.transpose(-2, -1))
        if self.relative_position is not None:
            a = self.relative_position(ctx, a, q, self._derived(aux))
        a = torch.softmax(a, dim=-1)
        a, ats_index, state = self._adaptive_token_sampling(state, a, v)
        a, v, old_dtype = self._cast_matmul_2(a, v)
        x = counted_matmul(ctx, a, v)
        x = self._recombine_windows(self._recombine_heads(x))
        return self._uncast_matmul_2(x, old_dtype), ats_index, state

    def _derived(self, aux):
        derived = (aux or {}).get("relative")
        return derived if derived is not None else self.relative_position.precompute()

    def _fused_attention(self, ctx, x, aux, pad_bias=None, geom=None):
        """x (Bw, T, 3C), one window (or the whole sequence) per row, through
        ``window_attention``; with ``geom``, the windows of a zero-padded
        map, whose pad rows the kernel fills with ``pad_bias`` and the pad
        terms; as many heads as x's width holds. Counted as the plain path
        counts (matmul-1, matmul-2 and, with rel-pos, the term einsums and
        the two adds)."""
        bw, t, c3 = x.shape
        d = self.dim // self.heads
        heads = c3 // (3 * d)
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
                x, None, pad_bias, heads=heads, scale=self.scale, a=a, geom=geom
            )
        ctx.add("matmul_flops", 2.0 * bw * heads * t * t * d)
        return out

    def _partition_heads(self, x):
        """Packed qkv (B, N, 3C') -> q, k, v (B, C' / head_dim, N,
        head_dim): as many heads as its width holds."""
        b, n = x.shape[:2]
        d = self.dim // self.heads
        x = x.reshape(b, n, 3, x.shape[-1] // (3 * d), d)
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

    # -- ATS -------------------------------------------------------------------

    def _adaptive_token_sampling(self, state, a, v):
        """Top-k ATS over the attention matrix a (B, H, N, N) and v (B, H,
        N, d) (JAX ``Block._adaptive_token_sampling``): the n_select
        tokens of the highest :func:`ats_scores`, the class token always
        among them, ties to the smallest index as ``lax.top_k``, ascending,
        then stabilised against the last frame's. Returns (a at the
        sampled rows, the indices (B, n_select) int32, state)."""
        if self.ats_fraction is None:
            return a, None, state
        scores = ats_scores(a, v, self.tp_group)
        k = self.n_select(scores.shape[-1])
        index = index_from_coverage(coverage_from_norms(scores, k), k).to(torch.int32)
        if state["ats_has_last"]:
            index = stabilize_ats_indices(state["ats_last"], index)
        state = dict(state, ats_last=index, ats_has_last=True)
        return take_rows(a, index), index, state

    @staticmethod
    def _gather_ats_skip(skip, ats_index):
        return skip if ats_index is None else take_rows(skip, ats_index)

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
        package, with its TPU thresholds under "auto"). STGT gates, ATS
        blocks and tensor-parallel blocks run unfused in every mode, and
        under "auto" a block with drop-path, as the JAX package's "auto"
        rule has it."""
        mode = self.fused_gates
        if (self.stgt or mode is False or self.ats_fraction is not None
                or self.tp_group is not None):
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
        if self.drop_path.drop_rate != 0.0:  # the JAX package's "auto" rule
            return False
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
            or self.drop_path.drop_rate != 0.0
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

    def _window_inverse(self, device):
        """(N,) int64 map of row-major token -> its window-major row, on
        ``device``, made once (a host copy inside a captured step would
        fail)."""
        key = ("inverse", device)
        if key not in self._window_index_cache:
            inv = torch.from_numpy(self._window_perm()[1])
            self._window_index_cache[key] = inv.to(device, torch.long)
        return self._window_index_cache[key]

    def init_state(self, batch, n_tokens, dtype, device):
        """The gates' and buffers' state; after the attention (projection
        and MLP groups) at the tokens ATS keeps; the qkv buffer and the
        projection gate at the width of this rank's heads (all of them
        without tensor parallelism)."""
        shape = (batch, self.out_tokens(n_tokens), self.dim)
        heads_shape = shape[:-1] + (self.projection.in_features,)
        state = super().init_state(batch, n_tokens, dtype, device)
        state.update(
            qkv_gate=self.qkv_gate.init_state((batch, n_tokens, self.dim), dtype, device),
            projection_gate=self.projection_gate.init_state(heads_shape, dtype, device),
            mlp_gate=self.mlp_gate.init_state(shape, dtype, device),
            mlp_accumulator=self.mlp_accumulator.init_state(shape, dtype, device),
        )
        # qkv and projection buffers where the regime gathers ("v2",
        # "blocked", or any regime that does not recompute); the others
        # recompute both from the gate states
        if not self._recompute(n_tokens) or self._fused_mode(n_tokens) in ("v2", "blocked"):
            rows = self._resident_rows() if self._resident_qkv(n_tokens) else n_tokens
            state["qkv_accumulator"] = self.qkv_accumulator.init_state(
                (batch, rows, self.qkv.out_features), dtype, device
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
        x = self._col(ctx, self.qkv, x)
        if "qkv_accumulator" in state and self._resident_qkv(x.shape[-2]):
            # pad rows hold the qkv bias row, uncounted: the attention entry
            # counts the pad-bias map once
            x = self._window_major(x, self.qkv.bias.to(x.dtype))
            x, state["qkv_accumulator"] = self.qkv_accumulator.flush(state["qkv_accumulator"], x)
            x, ats_index, state = self._forward_attention(
                ctx, x, aux, pre_partitioned=True, state=state
            )
        else:
            if "qkv_accumulator" in state:
                x, state["qkv_accumulator"] = self.qkv_accumulator.flush(
                    state["qkv_accumulator"], x
                )
            x, ats_index, state = self._attention_flush(ctx, state, x, aux)
        skip_1 = self._gather_ats_skip(skip_1, ats_index)
        _, state["projection_gate"] = self.projection_gate.flush(state["projection_gate"], x)
        x = self._row(ctx, self.projection, x)
        if "projection_accumulator" in state:
            x, state["projection_accumulator"] = self.projection_accumulator.flush(
                state["projection_accumulator"], x
            )
        x = counted_add(ctx, self.drop_path(ctx, x), skip_1)
        skip_2 = x
        x, state["mlp_gate"] = self._gate_flush(
            self.mlp_gate, state["mlp_gate"], x, self.mlp_layer_norm
        )
        x, state["mlp_accumulator"] = self.mlp_accumulator.flush(
            state["mlp_accumulator"], self._mlp(ctx, x)
        )
        return counted_add(ctx, self.drop_path(ctx, x), skip_2), state

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

    def _attention_flush(self, ctx, state, x, aux):
        """Returns (y, the ATS indices or None, state)."""
        return self._forward_attention(ctx, x, aux, state=state)

    def _attention_incremental(self, ctx, state, x, index, mask, aux):
        del index, mask
        return self._forward_attention(ctx, x, aux, state=state)

    # -- incremental -------------------------------------------------------------

    def _incremental(self, ctx, state, x, norms, next_gate, aux):
        n = x.shape[-2]
        for gate in self.gates:
            check_kernel_policy(gate.policy)
        if self.gate_before_ln:
            norms = None  # handed-over norms are in the LN domain
        # training runs the unfused step: the kernels have no backward
        mode = False if ctx.training else self._fused_mode(n)
        if mode == "v4":
            return self._v4_step(ctx, state, x, norms, next_gate)
        if mode in ("v2", "blocked"):
            return self._group_step(ctx, state, x, norms, next_gate, aux, mode == "blocked")
        state = dict(state)
        skip_1 = x
        # a window-major qkv buffer (the layout of the "v2" and "blocked"
        # regimes) goes row-major for the unfused step and back after it
        resident = "qkv_accumulator" in state and self._resident_qkv(n)
        if resident:
            inv = self._window_inverse(x.device)
            state["qkv_accumulator"] = {"b": state["qkv_accumulator"]["b"].index_select(1, inv)}
        x, index, mask = self._qkv_group(ctx, state, x, norms, mode)
        if resident:
            state["qkv_accumulator"] = {"b": self._window_major(x, self.qkv.bias.to(x.dtype))}
        x, ats_index, state = self._attention_incremental(ctx, state, x, index, mask, aux)
        skip_1 = self._gather_ats_skip(skip_1, ats_index)
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
            x, _, _ = self._forward_attention(ctx, x, aux, pre_partitioned=True)
        else:
            outs, index, mask = group_linear(
                ctx, self.qkv_gate, state["qkv_gate"], state["qkv_accumulator"], x,
                self.input_layer_norm, self._ln_mode, self.qkv,
                need_index=self._attention_uses_index, norms=norms,
            )
            x, _, state = self._attention_incremental(ctx, state, outs[1], index, mask, aux)
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
            y = self._col(ctx, self.qkv, self._op_input(p, ln), kcap / p.shape[-2])
            return y, None, None
        x_t, index, mask, state["qkv_gate"] = self._gate_ln(
            ctx, ln, self.qkv_gate, state["qkv_gate"], x
        )
        if "qkv_accumulator" not in state:
            p = state["qkv_gate"]["p"]
            frac = (index.shape[-1] / p.shape[-2]) * valid_fraction(mask)
            return self._col(ctx, self.qkv, self._op_input(p, ln), frac), index, mask
        x_t = self._col(ctx, self.qkv, x_t, valid_fraction(mask))
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
            x = self._row(ctx, self.projection, p, kcap / p.shape[-2])
        else:
            x_t, index, mask, state["projection_gate"] = gate.incremental(ctx, gate_state, x)
            if "projection_accumulator" not in state:
                p = state["projection_gate"]["p"]
                frac = (index.shape[-1] / p.shape[-2]) * valid_fraction(mask)
                x = self._row(ctx, self.projection, p, frac)
            else:
                x_t = self._row(ctx, self.projection, x_t, valid_fraction(mask))
                x, state["projection_accumulator"] = self.projection_accumulator.incremental(
                    state["projection_accumulator"], x_t, index, mask
                )
        return counted_add(ctx, self.drop_path(ctx, x), skip_1), None

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
        return counted_add(ctx, self.drop_path(ctx, x), skip_2), None

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
                (batch, self.local_heads, n_tokens, self._pooled_tokens(n_tokens)), dtype, device
            )
        return state

    def _attention_flush(self, ctx, state, x, aux):
        a, v = self._matmul_1_flush(ctx, state, x, aux)
        a, ats_index, state = self._adaptive_token_sampling(state, a, v)
        a, v, old_dtype = self._cast_matmul_2(a, v)
        x = counted_matmul(ctx, a, v)
        return self._uncast_matmul_2(self._recombine_heads(x), old_dtype), ats_index, state

    def _attention_incremental(self, ctx, state, x, index, mask, aux):
        a, _, v, _, _ = self._matmul_1_incremental(ctx, state, x, index, mask, aux)
        # ATS samples before the cast here, after it in EventfulBlock (as
        # the JAX package orders them)
        a, ats_index, state = self._adaptive_token_sampling(state, a, v)
        a, v, old_dtype = self._cast_matmul_2(a, v)
        x = counted_matmul(ctx, a, v)
        return self._uncast_matmul_2(self._recombine_heads(x), old_dtype), ats_index, state

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
        n_a = self.out_tokens(n_tokens)  # the attention rows ATS keeps
        sdtype = _CAST_DTYPES.get(self.matmul_2_cast, dtype)
        head_dim, heads = self.dim // self.heads, self.local_heads
        state["v_gate"] = self.v_gate.init_state((batch, heads, n_p, head_dim), sdtype, device)
        state["matmul_gate"] = self.matmul_gate.init_state(
            (batch, heads, n_a, n_p), sdtype, device
        )
        if not self.recompute_av:
            state["matmul_accumulator_2"] = self.matmul_accumulator_2.init_state(
                (batch, heads, n_a, head_dim), sdtype, device
            )
        return state

    def _attention_flush(self, ctx, state, x, aux):
        a, v = self._matmul_1_flush(ctx, state, x, aux)
        a, v, old_dtype = self._cast_matmul_2(a, v)
        # ATS scores the cast a and v here (JAX core/blocks.py:2163-2164)
        a, ats_index, state = self._adaptive_token_sampling(state, a, v)
        # v may be a view of the qkv buffer, which later steps update in place
        _, state["v_gate"] = self.v_gate.flush(state["v_gate"], v.contiguous())
        _, state["matmul_gate"] = self.matmul_gate.flush(state["matmul_gate"], a)
        if self.recompute_av:
            x = counted_matmul(ctx, a, v)
        else:
            x, state["matmul_accumulator_2"] = self.matmul_accumulator_2.flush(
                ctx, state["matmul_accumulator_2"], a, v
            )
        return self._uncast_matmul_2(self._recombine_heads(x), old_dtype), ats_index, state

    def _use_av_kernel(self, ctx, n_cols, batch):
        if (
            not self.recompute_av
            or self.av_kernel is False
            or self.ats_fraction is not None
            or ctx.training
        ):
            return False
        if self.av_kernel is True:
            return True
        if self.av_kernel != "auto":
            raise ValueError(f"av_kernel must be 'auto', True or False, got {self.av_kernel!r}")
        return n_cols >= self.AV_KERNEL_MIN_COLS or batch == 1

    def _attention_incremental(self, ctx, state, x, index, mask, aux):
        if not self._use_av_kernel(ctx, self._pooled_tokens(x.shape[-2]), x.shape[0]):
            a, _, v, index_k, mask_k = self._matmul_1_incremental(ctx, state, x, index, mask, aux)
            a, v, old_dtype = self._cast_matmul_2(a, v)
            a, ats_index, state = self._adaptive_token_sampling(state, a, v)
            if self.recompute_av:
                x = self._av_recompute(ctx, state, a, v, index_k, mask_k)
            else:
                x = self._av_delta(ctx, state, a, v, index_k, mask_k)
            return self._uncast_matmul_2(self._recombine_heads(x), old_dtype), ats_index, state
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
        return self._uncast_matmul_2(self._recombine_heads(x), old_dtype), None, state

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
