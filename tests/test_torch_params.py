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


def test_vivit_eventful_block_tree_roundtrips():
    """The paper's K400 configuration (EventfulBlock in every spatial block,
    the matmul-2 cast) adds no parameters: the JAX model's whole tree
    loads key for key and reads back unchanged."""
    from eventful_transformer_tpu.models import FactorizedViViT as JaxViViT
    from eventful_transformer_tpu_torch.models import FactorizedViViT

    block = dict(dim=32, heads=4, mlp_ratio=2)
    config = dict(
        classes=5, input_shape=[4, 3, 16, 16], normalize_mean=0.45, normalize_std=0.225,
        spatial_views=3, temporal_stride=2, temporal_views=4, tubelet_shape=[2, 8, 8],
        spatial_config=dict(depth=2, position_encoding_size=[2, 2], block_class="EventfulBlock",
                            block_config=dict(block, matmul_2_cast="bfloat16")),
        temporal_config=dict(depth=1, position_encoding_size=[2], block_config=block),
    )
    flat = flatten_tree(
        jax.tree_util.tree_map(np.asarray, JaxViViT(**config).init(jax.random.PRNGKey(1)))
    )
    got = params_to_numpy(params_from_jax(FactorizedViViT(**config, device="cpu"), flat))
    assert set(got) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(got[key], value)
