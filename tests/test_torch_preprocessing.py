"""ViViT's preprocessing in the port against the JAX package: the bilinear
resize matrices (plain and antialiased, down and up) and
``ViViTPreprocessing`` on raw videos, uint8 and float, whose short edge is
not the model's (so the antialiased resize runs), one shorter than a view
(its last frame repeated), with one and several spatial and temporal views.

The matrices at 1e-7; the views at 1e-5 (float32 separable matmuls in other
orders; values of normalised pixels, a few units).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.models.vivit import ViViTPreprocessing as JaxPreprocessing
from eventful_transformer_tpu.ops import resize as jax_resize
from eventful_transformer_tpu_torch.models.vivit import ViViTPreprocessing
from eventful_transformer_tpu_torch.ops import resize


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("antialias", [True, False], ids=["antialias", "plain"])
@pytest.mark.parametrize("sizes", [(40, 32), (398, 224), (28, 32), (7, 5)])
def test_resize_bilinear_matches_jax(sizes, antialias):
    np.testing.assert_allclose(
        resize.resize_matrix_bilinear(*sizes, antialias),
        jax_resize._resize_matrix_bilinear(*sizes, antialias), rtol=0, atol=1e-7,
    )
    x = np.random.default_rng(0).standard_normal((2, 3, sizes[0], sizes[0] + 3)).astype(np.float32)
    out = (sizes[1], sizes[1] + 2)
    ref = jax_resize.resize_bilinear(jnp.asarray(x), out, antialias=antialias)
    got = resize.resize_bilinear(torch.from_numpy(x), out, antialias=antialias)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


CASES = {
    # (video shape, dtype, spatial views, temporal views)
    "uint8_down_3x2": ((1, 20, 3, 40, 56), np.uint8, 3, 2),
    "uint8_short_up_1x1": ((2, 11, 3, 28, 30), np.uint8, 1, 1),
    "float_no_resize_3x4": ((1, 40, 3, 32, 57), np.float32, 3, 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_preprocessing_matches_jax(case):
    shape, dtype, spatial, temporal = CASES[case]
    rng = np.random.default_rng(1)
    if dtype == np.uint8:
        video = rng.integers(0, 256, shape, dtype=np.uint8)
    else:
        video = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    kwargs = dict(input_shape=(8, 3, 32, 32), normalize_mean=0.45, normalize_std=0.225,
                  spatial_views=spatial, temporal_stride=2, temporal_views=temporal)
    ref = JaxPreprocessing(**kwargs)(video)
    got = ViViTPreprocessing(**kwargs)(torch.from_numpy(video))
    assert len(got) == len(ref) == spatial * temporal
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape == (shape[0], 8, 3, 32, 32)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
