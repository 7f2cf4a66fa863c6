"""Weights across the two packages (port of the loading half of
``eventful_transformer_tpu/utils/params.py``).

The port's parameter names are the JAX pytree's paths with ``.`` for
``/``: ``spatial_model.backbone.blocks.3.qkv.kernel`` holds
``spatial_model/backbone/blocks/3/qkv/kernel``. Linear kernels keep the JAX
``(in, out)`` layout, so nothing is transposed on the way; convolution
kernels are stored in torch's layout, and a module that holds one names
the axes that make it from the JAX kernel in ``jax_permute``
(``ops/conv.py``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def flatten_tree(tree, prefix=""):
    """Nested dicts and lists of arrays -> {"a/0/b": np.ndarray}, the
    layout of the JAX package's ``save_params`` ``.npz``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _permutes(module):
    """{"a/b/kernel": axes} for every parameter stored in another layout
    than the JAX package's."""
    return {
        f"{prefix}.{key}".lstrip(".").replace(".", "/"): axes
        for prefix, m in module.named_modules()
        for key, axes in getattr(m, "jax_permute", {}).items()
    }


def params_from_jax(module, source):
    """Copy JAX parameters into ``module`` in place and return it.

    ``source``: a ``.npz`` path written by the JAX package's ``save_params``,
    a flat ``{"a/b": array}`` dict, or the nested pytree of numpy arrays.
    Keys under the prefixes in ``module.unported_params`` (parts of the
    JAX model the port does not hold yet) are skipped. Raises
    ``ValueError`` on missing, extra or mis-shaped keys. Convolution
    kernels are permuted to torch's layout; values are cast to each
    parameter's dtype and moved to its device."""
    if isinstance(source, (str, Path)):
        with np.load(source) as data:
            flat = {k: data[k] for k in data.files}
    elif all(isinstance(v, np.ndarray) for v in source.values()):
        flat = dict(source)
    else:
        flat = flatten_tree(source)
    skip = tuple(getattr(module, "unported_params", ()))
    flat = {k: v for k, v in flat.items() if not k.startswith(skip)} if skip else flat
    params = {name.replace(".", "/"): p for name, p in module.named_parameters()}
    missing = sorted(set(params) - set(flat))
    extra = sorted(set(flat) - set(params))
    if missing or extra:
        raise ValueError(f"parameter mismatch: missing={missing[:8]} extra={extra[:8]}")
    permutes = _permutes(module)
    for key, p in params.items():
        value = np.asarray(flat[key])
        if key in permutes:
            value = value.transpose(permutes[key])
        if value.shape != tuple(p.shape):
            raise ValueError(f"shape mismatch at {key}: {value.shape} vs {tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))
    return module


def params_to_numpy(module):
    """{"a/b": np.ndarray (float32)} of every parameter of ``module``, in
    the JAX package's layouts."""
    permutes = _permutes(module)
    out = {}
    for name, p in module.named_parameters():
        key = name.replace(".", "/")
        value = p.detach().float().cpu().numpy()
        out[key] = value.transpose(np.argsort(permutes[key])) if key in permutes else value
    return out
