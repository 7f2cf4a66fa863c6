"""Transformer blocks (port of the dense ``Block`` and of
``EventfulTokenwiseBlock`` from ``eventful_transformer_tpu/core/blocks.py``).

``Block`` is the dense pre-LN ViT block with global attention, as the JAX
package runs it on the TPU: LN and the qkv and projection linears in plain
PyTorch, the attention through ``window_attention`` in its global mode and
the MLP half through ``dense_mlp_residual``. The ``EventfulTokenwiseBlock``
runs its flush step with the same attention kernel and a plain MLP (whose
output fills the token buffer), and every incremental step through the
kernel pipeline of the JAX package's "v4" block step: ``ln_norms`` (first
block of a step only), kernel A, kernel B and kernel C, with the top-k
coverage computed between them.

Windows, pooling, relative positions, ATS, drop-path, matmul-2 casting,
sequence parallelism, gate-before-LN and STGT gates are not ported; asking
for one raises ``NotImplementedError`` naming the ROADMAP.md item that
holds it.
"""

from __future__ import annotations

from math import sqrt

from torch import nn

from eventful_transformer_tpu_torch.core.gating import TokenBuffer, TokenGate
from eventful_transformer_tpu_torch.core.indexing import coverage_from_norms
from eventful_transformer_tpu_torch.core.nn import LayerNorm, Linear, counted_add, gelu, layer_norm
from eventful_transformer_tpu_torch.core.policies import check_kernel_policy
from eventful_transformer_tpu_torch.ops.block_fused import proj_group, qkv_attention_group
from eventful_transformer_tpu_torch.ops.dense_mlp import dense_mlp_residual
from eventful_transformer_tpu_torch.ops.gate_fused import ln_norms
from eventful_transformer_tpu_torch.ops.gate_group import gate_group_mlp
from eventful_transformer_tpu_torch.ops.window_attention import window_attention


def not_ported(what, item):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, open item {item})")


class Block(nn.Module):
    """Dense pre-LN Transformer block with global attention."""

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
        for value, what, item in (
            (ats_fraction, "ATS", 10),
            (matmul_2_cast, "matmul_2_cast", 10),
            (relative_embedding_size, "relative position embedding", 13),
            (pool_size, "k/v pooling", 13),
            (window_size, "windowed attention", 13),
            (sequence_parallel, "sequence parallelism", 17),
        ):
            if value is not None:
                raise not_ported(what, item)
        if drop_path_rate != 0.0:
            raise not_ported("drop-path (training)", 12)
        if dim % heads:
            raise ValueError(f"{heads} heads do not divide dim {dim}")
        del input_size  # token grid: only windows and rel-pos need it
        self.dim = dim
        self.heads = heads
        self.scale = sqrt(dim // heads)
        self.qkv = Linear(dim, dim * 3)
        self.projection = Linear(dim, dim)
        self.mlp_1 = Linear(dim, dim * mlp_ratio)
        self.mlp_2 = Linear(dim * mlp_ratio, dim)
        self.input_layer_norm = LayerNorm(dim)
        self.mlp_layer_norm = LayerNorm(dim)

    def init_state(self, batch, n_tokens, dtype, device):
        del batch, n_tokens, dtype, device
        return {}

    def forward(self, ctx, state, x, mode=None, qkv_norms=None, next_gate=None):
        """Returns (y, state, None); ``mode`` and the gate-norm handoff
        arguments only mean something to eventful blocks."""
        del mode, qkv_norms, next_gate
        skip_1 = x
        x = layer_norm(x, self.input_layer_norm)
        x = self.qkv(ctx, x)
        x = self._attention(ctx, x)
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

    def _attention(self, ctx, x):
        """Global multi-head attention of packed qkv (B, N, 3C) -> (B, N, C),
        counted as the plain path's q.kT and A.V matmuls."""
        b, n, _ = x.shape
        ctx.add("matmul_flops", 2.0 * b * self.heads * n * n * (self.dim // self.heads))
        return window_attention(x, heads=self.heads, scale=self.scale)

    def _mlp(self, ctx, x):
        return self.mlp_2(ctx, gelu(self.mlp_1(ctx, x)))


class EventfulTokenwiseBlock(Block):
    """Gates the token-wise ops: qkv, projection and MLP each sit behind a
    token gate. Step 0 runs dense (``mode="flush"``); later steps
    (``mode="incremental"``) run the kernel pipeline, which recomputes qkv
    and the projection densely from the gate states (buffer == op(p)) and
    runs the MLP on the selected rows only."""

    def __init__(self, gate_before_ln=False, stgt=False, **block_kwargs):
        if gate_before_ln:
            raise not_ported("gate_before_ln", 10)
        if stgt:
            raise not_ported("STGT gates", 10)
        super().__init__(**block_kwargs)
        self.qkv_gate = TokenGate()
        self.projection_gate = TokenGate()
        self.mlp_gate = TokenGate()
        self.mlp_accumulator = TokenBuffer()

    @property
    def gates(self):
        return [self.qkv_gate, self.projection_gate, self.mlp_gate]

    def init_state(self, batch, n_tokens, dtype, device):
        shape = (batch, n_tokens, self.dim)
        return {
            "qkv_gate": self.qkv_gate.init_state(shape, dtype, device),
            "projection_gate": self.projection_gate.init_state(shape, dtype, device),
            "mlp_gate": self.mlp_gate.init_state(shape, dtype, device),
            "mlp_accumulator": self.mlp_accumulator.init_state(shape, dtype, device),
        }

    def forward(self, ctx, state, x, mode=None, qkv_norms=None, next_gate=None):
        """``mode``: "flush" or "incremental". ``qkv_norms``: this block's
        qkv-gate norms from the previous block's kernel C. ``next_gate``:
        the next block's (p_qkv, ln_scale, ln_bias), whose norms kernel C
        then emits. Returns (y, state, next_norms); the state tensors are
        updated in place by the incremental step."""
        if mode == "flush":
            y, state = self._flush(ctx, state, x)
            return y, state, None
        if mode == "incremental":
            return self._step(ctx, state, x, qkv_norms, next_gate)
        raise ValueError(f"mode must be 'flush' or 'incremental', got {mode!r}")

    def _flush(self, ctx, state, x):
        state = dict(state)
        skip_1 = x
        x = layer_norm(x, self.input_layer_norm)
        _, state["qkv_gate"] = self.qkv_gate.flush(state["qkv_gate"], x)
        x = self._attention(ctx, self.qkv(ctx, x))
        _, state["projection_gate"] = self.projection_gate.flush(state["projection_gate"], x)
        x = counted_add(ctx, self.projection(ctx, x), skip_1)
        skip_2 = x
        x = layer_norm(x, self.mlp_layer_norm)
        _, state["mlp_gate"] = self.mlp_gate.flush(state["mlp_gate"], x)
        x, state["mlp_accumulator"] = self.mlp_accumulator.flush(
            state["mlp_accumulator"], self._mlp(ctx, x)
        )
        return counted_add(ctx, x, skip_2), state

    def _capacities(self, n):
        caps = []
        for gate in self.gates:
            check_kernel_policy(gate.policy)
            k = gate.policy.capacity(n)
            if k < 1:
                raise ValueError(f"policy {gate.policy!r} selects no token of {n}")
            caps.append(k)
        return caps

    def _step(self, ctx, state, x, norms, next_gate):
        n = x.shape[-2]
        kq, kp, km = self._capacities(n)
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
            n_bias, kcap=km,
        )
        self._count_step(ctx, x, kq, kp, km)
        return y, state, next_norms

    def _count_step(self, ctx, x, kq, kp, km):
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


BLOCK_CLASSES = {"Block": Block, "EventfulTokenwiseBlock": EventfulTokenwiseBlock}
