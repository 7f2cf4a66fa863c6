"""``chip_smoke.py``'s check of the TMA descriptors a warm forward encodes,
driven on the CPU by a scripted sequence of forwards: each forward adds
its encodes to the library's count and its bytes to what the caching
allocator reserves."""

import pytest

import chip_smoke


def scripted(monkeypatch, forwards):
    """Point ``chip_smoke``'s encode count and the allocator's reserve at
    counters that each call of the returned ``run`` advances by the next
    (encodes, bytes) of ``forwards``; returns (run, the calls made)."""
    state = dict(encodes=0, reserved=0, calls=0)
    monkeypatch.setattr(chip_smoke, "tma_encodes", lambda: state["encodes"])
    monkeypatch.setattr(chip_smoke.torch.cuda, "memory_reserved", lambda: state["reserved"])

    def run(model, views):
        encodes, grew = forwards[state["calls"]]
        state["calls"] += 1
        state["encodes"] += encodes
        state["reserved"] += grew

    return run, state


def warm(monkeypatch, forwards):
    """warm_encodes after a cold forward of ``forwards[0]``."""
    run, state = scripted(monkeypatch, forwards)
    before = chip_smoke.tma_encodes()
    run(None, None)
    return chip_smoke.warm_encodes(None, None, before, run=run), state["calls"]


def test_settled_allocator_stops_after_two_warm_forwards(monkeypatch):
    got, calls = warm(monkeypatch, [(53, 900), (11, 0), (0, 0)])
    assert got == dict(cold=53, warm=[11, 0], grew=[0, 0])
    assert calls == 3
    chip_smoke.check_warm_encodes({"v1": got}, "test")


def test_a_warm_forward_that_reserves_more_earns_one_more(monkeypatch):
    # the first warm forward reserves more, so the second places its
    # scratch anew too; the third, after a forward that reserved nothing,
    # must encode none
    got, calls = warm(monkeypatch, [(53, 900), (20, 64), (19, 0), (0, 0), (7, 0)])
    assert got == dict(cold=53, warm=[20, 19, 0], grew=[64, 0, 0])
    assert calls == 4
    chip_smoke.check_warm_encodes({"v1": got}, "test")


@pytest.mark.parametrize("forwards", [
    [(53, 900), (11, 0), (3, 0)],  # encodes after a settled forward
    [(53, 900), (20, 64), (19, 0), (2, 0)],  # the same, one forward later
])
def test_encodes_after_a_settled_forward_fail(monkeypatch, forwards):
    got, _ = warm(monkeypatch, forwards)
    with pytest.raises(AssertionError, match="encoded TMA descriptors"):
        chip_smoke.check_warm_encodes({"v1": got}, "test")


def test_an_allocator_that_never_settles_fails(monkeypatch):
    forwards = [(53, 900)] + [(0, 64)] * chip_smoke.MAX_WARM_FORWARDS
    got, calls = warm(monkeypatch, forwards)
    assert len(got["warm"]) == chip_smoke.MAX_WARM_FORWARDS
    assert calls == 1 + chip_smoke.MAX_WARM_FORWARDS
    with pytest.raises(AssertionError):
        chip_smoke.check_warm_encodes({"v1": got}, "test")


# -- graph_paths' comparison of the eager and the captured step ----------------------


@pytest.mark.parametrize("case", ["equal", "negative_zero", "one_ulp", "nan_alike", "shape",
                                  "structure"])
def test_graph_paths_compare_bit_for_bit(case):
    """``tree_bits`` holds two trees of tensors bit for bit: a NaN equals
    the same NaN, -0.0 differs from 0.0, one float32 ulp differs (with its
    size reported), and another shape or structure differs."""
    import torch

    a = {"out": torch.tensor([1.0, 0.0, float("nan")]), "state": [torch.arange(3)]}
    b = {"out": a["out"].clone(), "state": [a["state"][0].clone()]}
    want = (True, 0.0)
    if case == "negative_zero":
        b["out"][1] = -0.0
        want = (False, 0.0)
    elif case == "one_ulp":
        b["out"][0] = torch.nextafter(torch.tensor(1.0), torch.tensor(2.0))
        want = (False, float(b["out"][0].double() - 1.0))
    elif case == "shape":
        b["state"][0] = torch.arange(4)
        want = (False, None)
    elif case == "structure":
        b["state"].append(torch.zeros(1))
        want = (False, None)
    assert chip_smoke.tree_bits(a, b) == want


def test_graph_check_names_the_failed_comparisons():
    ok = dict(counts_equal=True, launches_equal=True, replays_equal=True, outputs_equal=True,
              state_equal=True)
    chip_smoke.graph_check("A", ok)
    chip_smoke.graph_check("A", dict(ok, outputs_equal=False), exact=False)
    with pytest.raises(AssertionError, match=r"\['outputs_equal'\]"):
        chip_smoke.graph_check("A", dict(ok, outputs_equal=False))
    with pytest.raises(AssertionError, match=r"\['launches_equal'\]"):
        chip_smoke.graph_check("A", dict(ok, launches_equal=False), exact=False)
