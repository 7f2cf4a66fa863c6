"""A slim ViTDet backbone with STGT gates in every block
(configs/evaluate/vitdet_vid/stgt_672.yml: ``EventfulTokenwiseBlock`` with
``stgt: true``) at the token count of 672 x 672 frames (N = 1764), against
the JAX package through ``pre_backbone`` and ``apply_backbone``: 2 streams
over a flush and 2 incremental frames, k = 256. STGT runs unfused in both
packages, whatever ``fused_gates`` says, with qkv and projection buffers
(``recompute_buffers`` False). Widths and depth cut as in
tests/test_torch_compare_ln.py, which holds the comparison; tolerance 1e-4
over several frames, counts at rtol 1e-6.
"""

import pytest
import torch

from eventful_transformer_tpu.core.policies import TokenNormTopK as JaxTopK
from eventful_transformer_tpu.models.vitdet import ViTDet as JaxViTDet
from eventful_transformer_tpu.utils.misc import set_policies as jax_set_policies
from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
from eventful_transformer_tpu_torch.models import ViTDet
from eventful_transformer_tpu_torch.utils.misc import set_policies
from tests.test_torch_compare_ln import run_pair, slim_config


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def test_slim_stgt_n1764_is_unfused_and_matches_jax(monkeypatch):
    monkeypatch.setenv("EVT_UNROLL_BLOCKS", "1")
    config = slim_config(672, stgt=True)
    jax_model, model = JaxViTDet(**config), ViTDet(**config, device="cpu")
    jax_set_policies(jax_model, JaxTopK, k=256)
    set_policies(model, TokenNormTopK, k=256)
    for jax_blk, blk in zip(jax_model.backbone.blocks, model.backbone.blocks):
        assert blk.fused_gates == "auto" and blk._fused_mode(1764) is False
        assert not jax_blk.recompute_buffers and not blk.recompute_buffers
    run_pair(jax_model, model, 672, seed=42)
