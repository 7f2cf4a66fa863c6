"""Each CUDA kernel against its plain PyTorch version on the card, in
float32 and bfloat16, at small shapes and at ragged ones (N not a multiple
of any tile, C = 64 and 256). Marked ``cuda``: skipped where no CUDA device
is present. Run on the card with ``python -m pytest -m cuda
tests/test_torch_cuda.py``. ``chip_smoke.py`` holds the kernels against
the same plain versions at the main path's shapes."""

import pytest
import torch

from eventful_transformer_tpu_torch.ops import kernel_check

pytestmark = pytest.mark.cuda

SHAPES = [(2, 24, 64, 4, 9), (3, 37, 256, 4, 11), (2, 197, 64, 2, 98)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", sorted(kernel_check.KERNELS))
def test_kernel_matches_plain(name, shape, dtype, device):
    wrapper = kernel_check.KERNELS[name][0]
    before = wrapper.launches
    inputs = kernel_check.make_inputs(*shape, dtype, device, seed=1)
    rows = kernel_check.errors(name, inputs)
    assert [row["output"] for row in rows] == list(kernel_check.KERNELS[name][4])
    assert all(row["ok"] for row in rows), rows
    assert wrapper.launches == before + 1


def test_wrapper_rejects_mixed_dtypes(device):
    d = kernel_check.make_inputs(2, 24, 64, 4, 9, torch.bfloat16, device)
    with pytest.raises(TypeError, match="p is torch.float32"):
        kernel_check.KERNELS["ln_norms"][0](d["x"], d["p_qkv"].float(), d["ln1_s"], d["ln1_b"])
