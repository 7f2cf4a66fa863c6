"""Weights across the packages: the JAX package's ``save_params`` ``.npz``
loads into the port's modules, round-trips, and mismatches raise."""

import jax
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.core.blocks import Block as JaxBlock
from eventful_transformer_tpu.utils.params import save_params
from eventful_transformer_tpu_torch.core.blocks import Block
from eventful_transformer_tpu_torch.utils.params import (
    flatten_tree,
    params_from_jax,
    params_to_numpy,
)

KWARGS = dict(dim=32, heads=4, mlp_ratio=2, input_size=(2, 3))


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture
def jax_params():
    return jax.tree_util.tree_map(np.asarray, JaxBlock(**KWARGS).init(jax.random.PRNGKey(0)))


def test_npz_roundtrip(jax_params, tmp_path):
    path = tmp_path / "block.npz"
    save_params(path, jax_params)
    blk = params_from_jax(Block(**KWARGS), path)
    flat = flatten_tree(jax_params)
    got = params_to_numpy(blk)
    assert set(got) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(got[key], value)
    # the (in, out) kernel layout is kept, not transposed
    assert tuple(blk.qkv.kernel.shape) == flat["qkv/kernel"].shape == (32, 96)


def test_nested_tree_and_dtype(jax_params):
    blk = Block(**KWARGS).to(torch.bfloat16)
    params_from_jax(blk, jax_params)
    assert blk.mlp_1.kernel.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        blk.mlp_1.kernel.detach().float().numpy(),
        torch.tensor(jax_params["mlp_1"]["kernel"]).bfloat16().float().numpy(),
    )


def test_missing_extra_and_misshaped_keys_raise(jax_params):
    flat = flatten_tree(jax_params)
    missing = dict(flat)
    del missing["projection/bias"]
    with pytest.raises(ValueError, match="missing=\\['projection/bias'\\]"):
        params_from_jax(Block(**KWARGS), missing)
    extra = dict(flat, **{"relative_position/y_embedding": np.zeros((3, 8), np.float32)})
    with pytest.raises(ValueError, match="extra=\\['relative_position/y_embedding'\\]"):
        params_from_jax(Block(**KWARGS), extra)
    misshaped = dict(flat, **{"qkv/kernel": flat["qkv/kernel"].T})
    with pytest.raises(ValueError, match="shape mismatch at qkv/kernel"):
        params_from_jax(Block(**KWARGS), misshaped)
