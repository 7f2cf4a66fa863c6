"""``parallel.mesh.spawn``'s report of a failed run, on the CPU: every
rank's outcome (the traceback a rank raised, the signal that ended one with
the Python stack its fault handler wrote, a rank spawn stopped), so that a
rank that dies without a Python exception is named and not hidden behind
its peers' errors. The rank function is tests/torch_parallel_ranks.py's
``outcome``."""

import pytest

import torch_parallel_ranks
from eventful_transformer_tpu_torch.parallel.mesh import spawn


def test_spawn_returns_every_rank_result_in_rank_order():
    assert spawn(torch_parallel_ranks.outcome, 3, args=(-1, None, 0.0), threads=1) == [0, 1, 2]


def test_spawn_reports_the_rank_that_raised_and_the_others():
    with pytest.raises(RuntimeError) as error:
        spawn(torch_parallel_ranks.outcome, 2, args=(1, "raise"), threads=1)
    text = str(error.value)
    assert text.startswith("spawned rank failed:")
    assert "rank 1:\nTraceback" in text and "planted failure on rank 1" in text
    assert "rank 0: exit code 0" in text


@pytest.mark.parametrize("how,code", [("SIGKILL", -9), ("SIGSEGV", -11)])
def test_spawn_names_the_signal_that_ended_a_rank(how, code):
    """A rank ended by a signal leaves no error file: the report names the
    signal and the exit code; where the fault handler catches the signal
    (SIGSEGV, as a crash in native code raises it), the rank's Python
    stack too."""
    with pytest.raises(RuntimeError) as error:
        spawn(torch_parallel_ranks.outcome, 2, args=(0, how), threads=1)
    text = str(error.value)
    assert f"rank 0: ended by signal {how} (exit code {code}), no Python exception" in text
    assert "rank 1: exit code 0" in text
    assert ("rank 0 fault handler:" in text and "in outcome" in text) == (how == "SIGSEGV")


def test_spawn_timeout_names_each_rank_it_stopped():
    with pytest.raises(RuntimeError) as error:
        spawn(torch_parallel_ranks.outcome, 2, args=(-1, None, 60.0), timeout=5, threads=1)
    text = str(error.value)
    assert text.startswith("timed out after 5 s:")
    assert "rank 0: still running, stopped by spawn" in text
    assert "rank 1: still running, stopped by spawn" in text
