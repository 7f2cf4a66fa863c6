"""The bounds that hold each CUDA kernel to its plain version
(``ops/kernel_check.py``), on the CPU: they pass equal outputs and a rare
one-ulp flip, and fail a dropped rounding point's many one-ulp changes and
a float32 norm that lost a term."""

import pytest
import torch

from eventful_transformer_tpu_torch.ops import kernel_check


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _bf16(seed=0, n=4096):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, generator=g).to(torch.bfloat16)


def _next_up(t, mask):
    """t with the elements under ``mask`` moved one ulp away from zero."""
    bits = t.view(torch.int16)
    return torch.where(mask, bits + 1, bits).view(torch.bfloat16)


def test_ulp_order_counts_ulps_across_zero():
    t = torch.tensor([0.0, -0.0, 1.0], dtype=torch.bfloat16)
    up = _next_up(t, torch.ones(3, dtype=torch.bool))
    gaps = (kernel_check._ulp_order(up) - kernel_check._ulp_order(t)).tolist()
    assert gaps == [1, -1, 1]
    assert kernel_check._ulp_order(t)[:2].tolist() == [0, 0]


def test_equal_outputs_pass():
    t = _bf16()
    row = kernel_check.compare(t, t.clone())
    assert row["ok"] and row["differ_share"] == 0.0 and row["max_ulp_gap"] == 0


def test_rare_one_ulp_flips_pass():
    t = _bf16()
    mask = torch.zeros_like(t, dtype=torch.bool)
    mask[::256] = True  # 0.4 % of the elements
    row = kernel_check.compare(_next_up(t, mask), t)
    assert row["ok"], row
    assert row["max_ulp_gap"] == 1


@pytest.mark.parametrize("every", [2, 10], ids=["50pct", "10pct"])
def test_dropped_rounding_point_fails(every):
    """A dropped rounding moves many elements by one ulp: each within the
    scaled bound, but far beyond the share of elements allowed to differ."""
    t = _bf16()
    mask = torch.zeros_like(t, dtype=torch.bool)
    mask[::every] = True
    row = kernel_check.compare(_next_up(t, mask), t)
    assert row["max_scaled_err"] <= kernel_check.BF16_BOUNDS["scaled"]
    assert not row["ok"], row


def test_float32_norm_without_ln_bias_fails():
    """A norm off by 0.25 %, as one that drops the LN bias, fails the
    float32 bound; summation-order noise passes."""
    norms = 20.0 + torch.rand(512, generator=torch.Generator().manual_seed(1))
    assert kernel_check.compare(norms * (1 + 1e-6), norms)["ok"]
    assert not kernel_check.compare(norms * 1.0025, norms)["ok"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "name", ["gate_group_mlp_pre", "gate_group_linear_pre", "ln_select_matmul_pre"]
)
def test_dropped_ln_in_a_pre_form_fails(name, dtype, monkeypatch):
    """A "pre" form that forgets to normalise the rows it feeds the op,
    planted in its plain version: the gate state it writes is unchanged
    and passes, the op's output fails the bounds."""
    import inspect

    d = kernel_check.make_inputs(2, 197, 256, 4, 24, dtype, "cpu")
    want = kernel_check.call(name, d, plain=True)
    module = inspect.getmodule(kernel_check.KERNELS[name][1])
    monkeypatch.setattr(module, "ln_f32", lambda x, scale, bias: x.float())
    got = kernel_check.call(name, d, plain=True)
    rows = [kernel_check.compare(a, b) for a, b in zip(got, want)]
    assert rows[0]["ok"] and rows[0]["max_abs_err"] == 0.0  # p' takes x itself
    assert not all(row["ok"] for row in rows[1:]), rows


@pytest.mark.parametrize("name", ["gate_group_linear_topk", "gate_group_mlp_topk"])
def test_selection_faults_fail(name):
    """The selection check of a group that selects its own rows passes the
    plain selection and fails planted faults: ties broken to the largest
    index (on planted ties), one row too many, and for the "post" form the
    norms taken without the LN."""
    from eventful_transformer_tpu_torch.core.indexing import coverage_from_norms
    from eventful_transformer_tpu_torch.ops import gate_group

    d = kernel_check.make_inputs(2, 197, 256, 4, 24, torch.float32, "cpu", ties=name)
    got = kernel_check.call(name, d, plain=True)[-1]
    assert kernel_check.selection_check(name, d, got)["ok"]
    xk, pk, sk, bk, mode = kernel_check.TOPK[name]
    norms = gate_group.topk_norms_plain(d[xk], d[pk], d.get(sk), d.get(bk), mode)
    largest_index = coverage_from_norms(norms.flip(-1), d["k"]).flip(-1)
    row = kernel_check.selection_check(name, d, largest_index)
    assert not row["ok"] and row["selections_differing"] == 2, row
    extra = coverage_from_norms(norms, d["k"] + 1)
    assert not kernel_check.selection_check(name, d, extra)["ok"]
    if mode == "post":
        no_ln = coverage_from_norms(
            gate_group.topk_norms_plain(d[xk], d[pk], None, None, "none"), d["k"]
        )
        assert not kernel_check.selection_check(name, d, no_ln)["ok"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_blend_faults_fail(dtype):
    """The scatter-blend must equal its plain version bit for bit: the
    index copy's single write at a duplicated index fails, as does a blend
    that adds the values to x without removing it; the plain version
    itself passes."""
    from eventful_transformer_tpu_torch.core.indexing import put_rows

    d = kernel_check.make_inputs(2, 197, 256, 4, 24, dtype, "cpu")
    want = kernel_check.call("scatter_blend_duplicate", d, plain=True)[0]
    assert kernel_check.compare_exact(want.clone(), want)["ok"]
    copy = put_rows(d["buf_proj"], d["w_dup"].clamp(min=0), d["h_c"])
    assert not kernel_check.compare_exact(copy, want)["ok"]
    want = kernel_check.call("scatter_blend", d, plain=True)[0]
    x, values, index = d["buf_proj"], d["h_c"], d["blend_index"].long()
    no_removal = x.float().scatter_add(1, index[..., None].expand(values.shape), values.float())
    assert not kernel_check.compare_exact(no_removal.to(dtype), want)["ok"]


@pytest.mark.parametrize(
    "name", ["window_attention", "window_attention_windowed", "window_attention_padded",
             "scatter_blend", "scatter_blend_qkv", "fused_attention", "window_attention_grid",
             "window_attention_grid_noterms", "scatter_rows_inplace", "scatter_rows_inplace_qkv",
             "gather_rows", "gather_rows_qkv", "ln_select_noln"],
)
def test_library_calls_compute_the_same_function(name):
    """The PyTorch call timed beside a kernel computes its function on the
    same inputs: attention through scaled_dot_product_attention (rel-pos
    terms as a float mask, pad rows substituted; the grid form through the
    partition of its map) within 1e-5 of the plain version in float32, the
    blend's Tensor.scatter, the row scatter's Tensor.scatter_, the
    gather's torch.gather and the no-LN select's torch.where equal to it."""
    d = kernel_check.make_inputs(2, 37, 64, 4, 11, torch.float32, "cpu", seed=1)
    want = kernel_check.call(name, d, plain=True)[0]
    got = kernel_check.library_call(name, d)()
    if "attention" in name:
        if got.shape != want.shape:  # SDPA's (B, H, N, d)
            got = got.transpose(1, 2).reshape(want.shape)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(got, want)
    for other in ("scatter_blend_masked", "scatter_rows_inplace_masked",
                  "scatter_rows_inplace_cast"):
        assert kernel_check.library_call(other, d) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cast_attention_library_call_is_sdpa_in_bfloat16(dtype):
    """Row 21's cast form (bfloat16 probabilities) beside SDPA on q, k and
    v cast to bfloat16: a bfloat16 result within the bfloat16 outputs'
    scaled error (2e-2) of the plain version, in either dtype of the
    inputs."""
    d = kernel_check.make_inputs(2, 37, 64, 4, 11, dtype, "cpu", seed=1)
    want = kernel_check.call("fused_attention_cast", d, plain=True)[0]
    got = kernel_check.library_call("fused_attention_cast", d)()
    assert got.dtype == torch.bfloat16
    got = got.transpose(1, 2).reshape(want.shape).float()
    scaled = ((got - want.float()).abs() / want.float().abs().clamp(min=1.0)).max()
    assert float(scaled) <= kernel_check.BF16_BOUNDS["scaled"]


@pytest.mark.parametrize("name", ["block_select_p_noln", "block_scatter_rows"])
def test_window_row_library_calls_compute_the_same_function(name):
    """Rows 10 (without the LN) and 11: torch.where and Tensor.index_put_
    (on the valid slots, gathered beforehand) equal the plain version on
    inputs with an invalid (-1) slot in every batch row."""
    d = kernel_check.make_inputs(2, 37, 64, 4, 11, torch.float32, "cpu", seed=1)
    assert bool((d["w_index"] < 0).any())
    want = kernel_check.call(name, d, plain=True)[0]
    assert torch.equal(kernel_check.library_call(name, d)(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_row_scatter_faults_fail(dtype):
    """The row scatter must equal its plain version bit for bit: a scatter
    that writes the masked-off slots too fails, as does one that drops the
    float32 values' cast to the buffer's dtype (rounding toward zero
    instead); the gather of the neighbouring rows fails."""
    d = kernel_check.make_inputs(2, 197, 256, 4, 24, dtype, "cpu")
    want = kernel_check.call("scatter_rows_inplace_masked", d, plain=True)[0]
    assert kernel_check.compare_exact(want.clone(), want)["ok"]
    all_slots = kernel_check.call("scatter_rows_inplace", d, plain=True)[0]
    assert not kernel_check.compare_exact(all_slots, want)["ok"]
    if dtype == torch.bfloat16:
        want = kernel_check.call("scatter_rows_inplace_cast", d, plain=True)[0]
        truncated = (d["rows_vals_f32"].view(torch.int32) & -65536).view(torch.float32)
        got = kernel_check.call("scatter_rows_inplace_cast", dict(d, rows_vals_f32=truncated),
                                plain=True)[0]
        assert not kernel_check.compare_exact(got, want)["ok"]
    want = kernel_check.call("gather_rows_qkv", d, plain=True)[0]
    shifted = (d["rows_index"] + 1) % d["rows_buf_qkv"].shape[1]
    got = kernel_check.call("gather_rows_qkv", dict(d, rows_index=shifted), plain=True)[0]
    assert not kernel_check.compare_exact(got, want)["ok"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dropped_cast_in_fused_attention_fails(dtype):
    """The matmul-2 cast left out (the probabilities kept in float32)
    fails the bounds in either working dtype; in float32 the cast form's
    own bound passes a probability flipped across a bfloat16 rounding
    boundary (q's scale one float32 ulp off), which the plain float32
    bound does not."""
    from eventful_transformer_tpu_torch.ops.attention import fused_attention_plain

    d = kernel_check.make_inputs(8, 197, 256, 4, 24, dtype, "cpu")
    check = kernel_check.comparison("fused_attention_cast")
    want = kernel_check.call("fused_attention_cast", d, plain=True)[0]
    got = kernel_check.call("fused_attention", d, plain=True)[0]
    assert not check(got, want)["ok"]
    if dtype == torch.float32:
        flipped = fused_attention_plain(d["qkv"], heads=4, scale=8.0 * (1 + 2**-23),
                                        cast=torch.bfloat16)
        assert check(flipped, want)["ok"] and not kernel_check.compare(flipped, want)["ok"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_shifted_window_in_the_grid_fails(dtype):
    """Windows cut one column off the window grid (the map rolled by one
    column) fail the bounds, with and without the rel-pos terms."""
    d = kernel_check.make_inputs(2, 196, 256, 4, 24, dtype, "cpu", pad_window=(7, 7))
    for name in ("window_attention_grid", "window_attention_grid_noterms"):
        want = kernel_check.call(name, d, plain=True)[0]
        rolled = d["qkv_map"].roll(1, dims=2)
        got = kernel_check.call(name, dict(d, qkv_map=rolled), plain=True)[0].roll(-1, dims=2)
        assert not kernel_check.compare(got, want)["ok"]
