"""Row 11, ``block_scatter_rows``: the port's plain version against the JAX
package's Pallas kernel in interpret mode, bit for bit in float32 and
bfloat16 (a row copy), on the range rule (indices of NW and more, and below
-1, beside -1 slots, unsorted) and on the window map the port's windowed
qkv group hands it; the port's window map against the JAX block's; and
every ``extern "C"`` entry of ``csrc/*.cu`` against the ctypes signature
``ops/_build.py`` declares for it, since a pointer passed as a 32-bit int
would fail only on the card."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventful_transformer_tpu.ops.pallas import gate_block as jax_gate_block
from eventful_transformer_tpu_torch.core.indexing import window_row_map
from eventful_transformer_tpu_torch.ops import _build
from eventful_transformer_tpu_torch.ops.gate_block import block_scatter_rows_plain

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _rows(b, n, k, f, seed):
    rng = np.random.default_rng(seed)
    buf = rng.standard_normal((b, n, f)).astype(np.float32)
    h = rng.standard_normal((b, k, f)).astype(np.float32)
    return rng, buf, h


def _jax(buf, index, h, jdtype):
    return jax_gate_block.block_scatter_rows(
        jnp.asarray(buf, jdtype), jnp.asarray(index), jnp.asarray(h, jdtype), block_n=16,
        interpret=True,
    )


def _t(a, dtype=torch.float32):
    """A torch copy of ``a`` in ``dtype`` (the plain version writes in place)."""
    return torch.tensor(a).to(dtype)


def _same(port, ref):
    np.testing.assert_array_equal(port.float().numpy(), np.asarray(ref.astype(jnp.float32)))


# slot values beside the valid rows: ("above", NW and more), ("below", under
# -1), both; each batch row also keeps a -1 slot
OUT_OF_RANGE = {"above": lambda nw: [nw, nw + 5], "below": lambda nw: [-2, -7],
                "both": lambda nw: [nw + 1, -3]}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(OUT_OF_RANGE))
def test_out_of_range_slots_write_nothing_as_in_jax(case, dtype):
    """The one-hot of the JAX kernel matches no row for an index outside
    [0, NW): such slots, in unsorted order beside -1 slots and valid ones,
    leave every row they name untouched, bit for bit as the JAX kernel."""
    tdtype, jdtype = DTYPES[dtype]
    b, nw, k, f = 2, 40, 12, 64
    rng, buf, h = _rows(b, nw, k, f, seed=5)
    index = np.stack([rng.permutation(nw)[:k] for _ in range(b)]).astype(np.int32)
    bad = OUT_OF_RANGE[case](nw)
    index[0, 2], index[0, 7] = bad
    index[1, 0], index[1, 9] = bad[::-1]
    index[:, 4] = -1
    ref = _jax(buf, index, h, jdtype)
    port = block_scatter_rows_plain(_t(buf, tdtype), _t(index, torch.int32), _t(h, tdtype))
    _same(port, ref)
    unchanged = np.ones((b, nw), bool)
    for r in range(b):
        unchanged[r, index[r][(index[r] >= 0) & (index[r] < nw)]] = False
    np.testing.assert_array_equal(port.float().numpy()[unchanged],
                                  _t(buf, tdtype).float().numpy()[unchanged])


def test_out_of_range_small_case_changes_only_the_named_rows():
    """B = 2, NW = 8, index [[1, 8, -1], [0, 9, 3]]: rows [1] and [0, 3]
    change, in the JAX kernel and the plain version alike."""
    _, buf, h = _rows(2, 8, 3, 16, seed=6)
    index = np.array([[1, 8, -1], [0, 9, 3]], np.int32)
    ref = np.asarray(_jax(buf, index, h, jnp.float32))
    port = block_scatter_rows_plain(_t(buf), _t(index, torch.int32), _t(h)).numpy()
    np.testing.assert_array_equal(port, ref)
    changed = [sorted(np.nonzero((port[r] != buf[r]).any(-1))[0].tolist()) for r in range(2)]
    assert changed == [[1], [0, 3]]


# (input_size, window): a grid of whole windows and one padded to them
GRIDS = {"unpadded": ((6, 9), (3, 3)), "padded": ((7, 10), (3, 4))}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_row_map_form_matches_jax_on_the_taken_index(grid, dtype):
    """block_scatter_rows_plain(b, index, h, row_map) equals the JAX kernel
    on jnp.take(row_map, index), the JAX package's windowed qkv group, on
    the port's own window map: row-major tokens in random order, the
    selection's marker N (mapped to -1), -1 and indices past the map (both
    matching no row in either) among the slots."""
    tdtype, jdtype = DTYPES[dtype]
    (gh, gw), window = GRIDS[grid]
    n = gh * gw
    row_map = window_row_map((gh, gw), window)
    nw = (gh + -gh % window[0]) * (gw + -gw % window[1])
    assert (nw > n) == (grid == "padded")
    b, k, f = 2, 14, 48
    rng, buf, h = _rows(b, nw, k, f, seed=7)
    index = np.stack([rng.permutation(n)[:k] for _ in range(b)]).astype(np.int32)
    index[:, 3] = n  # the marker
    index[0, 8], index[1, 1] = -1, n + 4
    taken = jnp.take(jnp.asarray(row_map), jnp.asarray(index), axis=0)
    ref = _jax(buf, taken, h, jdtype)
    port = block_scatter_rows_plain(_t(buf, tdtype), _t(index, torch.int32), _t(h, tdtype),
                                    _t(row_map, torch.int32))
    _same(port, ref)
    changed = (port.float() != _t(buf, tdtype).float()).any(-1)
    assert int(changed.sum()) == 2 * (k - 2)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_window_row_map_is_the_jax_blocks(grid):
    """The port's window map is the JAX windowed block's ``_window_inv_ext``
    (row-major token -> window-major row, the marker N -> -1)."""
    from eventful_transformer_tpu.core.blocks import EventfulTokenwiseBlock

    input_size, window = GRIDS[grid]
    blk = EventfulTokenwiseBlock(dim=64, heads=4, mlp_ratio=2, input_size=input_size,
                                 window_size=window)
    np.testing.assert_array_equal(window_row_map(input_size, window), blk._window_inv_ext())


# -- the C entries against their ctypes signatures -------------------------

_KINDS = {_build._P: "pointer", _build._I: "int", _build._L: "long long", _build._F: "float"}
_ENTRY = re.compile(r"\b(?:int|long long|const char\*)\s+(etk_\w+)\(([^)]*)\)\s*\{")


def _c_entries():
    """{name: [parameter kinds]} of every C entry defined in csrc/*.cu, each
    inside an ``extern "C"`` block or declared ``extern "C"``."""
    entries = {}
    for src in sorted(_build.CSRC_DIR.glob("*.cu")):
        text = src.read_text()
        for match in _ENTRY.finditer(text):
            before = text[: match.start()]
            opened = before.count('extern "C" {') > before.count('}  // extern "C"')
            declared = before.rstrip().endswith('extern "C"')
            assert opened or declared, f"{src.name}: {match.group(1)} is not extern \"C\""
            params = [p.strip() for p in match.group(2).split(",") if p.strip()]
            entries[match.group(1)] = [_kind(p) for p in params]
    return entries


def _kind(param):
    if "*" in param:
        return "pointer"
    words = param.split()[:-1]  # the type, without the name
    return {"int": "int", "long long": "long long", "float": "float"}[" ".join(words)]


# the two entries load_library declares apart from SIGNATURES
_OTHER = {"etk_error_string": ["int"], "etk_tensor_map_encodes": []}


def test_every_c_entry_has_a_signature():
    assert set(_c_entries()) == set(_build.SIGNATURES) | set(_OTHER)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES) + sorted(_OTHER))
def test_c_entry_matches_its_signature(name):
    """Count and kind (pointer, int, long long, float) of each parameter."""
    want = _OTHER[name] if name in _OTHER else [_KINDS[t] for t in _build.SIGNATURES[name]]
    assert _c_entries()[name] == want
