"""Operation counting (port of ``eventful_transformer_tpu/core/counting.py``).

The port runs eagerly, so a count is a Python float added on the host; the
JAX package's traced (sum, compensation) pairs and its ``cond``/``scan``
helpers exist only for tracing and are not ported. Keys and formulas are the
reference's:

==================== =====================================================
key                  increment
==================== =====================================================
add_flops            result.numel() per counted add
bias_flops           result.numel() per bias add
convNd_flops         result.numel() * fan_in
einsum_flops         out.numel() * contracted size
linear_flops         input.numel() * out_features
matmul_flops         result.numel() * a.shape[-1]
gate_flops           reference-state numel per incremental gate call
accumulator_flops    v_n_tilde.numel() + 2 * product.numel()
==================== =====================================================
"""

from __future__ import annotations

from sys import stdout

import torch

COUNT_KEYS = (
    "accumulator_flops",
    # not a FLOP count: #gate calls whose threshold-policy capacity saturated
    "policy_saturated",
    "add_flops",
    "bias_flops",
    "conv1d_flops",
    "conv2d_flops",
    "conv3d_flops",
    "einsum_flops",
    "gate_flops",
    "linear_flops",
    "matmul_flops",
)


class Ctx:
    """Per-call context threaded through ``forward``.

    ``count_mode``: when False, :meth:`add` is a no-op and ``counts`` stays
    empty. The port is inference-only, so there is no training flag or rng.
    A count given as a tensor (a masked selection's valid share, a
    threshold policy's ``policy_saturated``) stays on its device until
    ``counts`` is read, which reads every such count in one transfer: one
    host synchronisation per read, not one per count.
    """

    __slots__ = ("count_mode", "_counts", "_pending")

    def __init__(self, count_mode=False):
        self.count_mode = count_mode
        self._counts = Counts({k: 0.0 for k in COUNT_KEYS} if count_mode else {})
        self._pending = []

    def add(self, key, value):
        if not self.count_mode:
            return
        if isinstance(value, torch.Tensor):
            self._pending.append((key, value.detach().reshape(()).float()))
        else:
            self._counts[key] += float(value)

    @property
    def counts(self):
        if self._pending:
            device = self._pending[0][1].device
            values = torch.stack([v.to(device) for _, v in self._pending]).tolist()
            for (key, _), value in zip(self._pending, values):
                self._counts[key] += value
            self._pending = []
        return self._counts


class Counts(dict):
    """Dict-with-arithmetic with CSV and pretty output (the reference's
    ``Counts``, eventful_transformer/base.py:7-78)."""

    def __missing__(self, key):
        return 0

    def __add__(self, other):
        result = Counts(self)
        if isinstance(other, dict):
            for key, value in other.items():
                result[key] = result.get(key, 0) + value
        else:
            for key in result:
                result[key] += other
        return result

    __radd__ = __add__

    def __mul__(self, other):
        result = Counts(self)
        for key in result:
            result[key] *= other
        return result

    __rmul__ = __mul__

    def __neg__(self):
        return Counts({k: -v for k, v in self.items()})

    def __sub__(self, other):
        return self.__add__(-other)

    def __rsub__(self, other):
        return self.__neg__().__add__(other)

    def __truediv__(self, other):
        return self.__mul__(1.0 / other)

    def nonzero(self):
        return Counts({k: v for k, v in self.items() if v != 0})

    def csv_header(self):
        return dict_csv_header(self)

    def csv_line(self):
        return dict_csv_line(self)

    def pretty_print(self, indent=4, value_format=".3e", file=stdout, flush=False):
        print(dict_string(self, indent, value_format), file=file, flush=flush)


def dict_csv_header(x):
    return ",".join(k for k in sorted(x.keys()))


def dict_csv_line(x):
    return ",".join(f"{x[k]:g}" for k in sorted(x.keys()))


def dict_string(x, indent=4, value_format=".4g"):
    lines = []
    key_length = max(len(str(key)) for key in x.keys())
    format_str = " " * indent + f"{{:<{key_length + 1}}} {{:{value_format}}}"
    for key in sorted(x.keys()):
        lines.append(format_str.format(f"{key}:", x[key]))
    return "\n".join(lines)
