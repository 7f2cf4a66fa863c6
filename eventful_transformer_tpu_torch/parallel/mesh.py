"""Process groups and device meshes (port of ``make_mesh`` in
``eventful_transformer_tpu/parallel/mesh.py``).

The JAX package runs one program over many devices; the port runs one
process per GPU, as ``torchrun`` launches it:

    torchrun --standalone --nproc_per_node=N -m <module> [arguments]

Each process joins the default process group with the rank, world size and
local rank that torchrun puts in its environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``); with none of them set the
group has one rank. The backend follows the device: NCCL for ``cuda``
(after ``torch.cuda.set_device(LOCAL_RANK)``), gloo for ``cpu``; a failed
NCCL initialisation is an error, never a fall back to gloo. Setting
:data:`BACKEND_ENV` to ``gloo`` asks for gloo on the card instead, so that
several processes can share one GPU (NCCL refuses two ranks on one device;
rank r takes GPU r modulo the GPUs there are): a setting for tests and the
smoke run on one card, whose failed collective fails as NCCL's would. ``make_mesh``
lays the processes out on named axes ("data", "seq", "model", "pipe"), as
the JAX mesh names its axes; ``mesh.get_group(axis)`` is an axis's process
group. ``best_dp_tp_mesh`` picks the ("data", "model") shape of a
data-parallel x tensor-parallel run; ``prefix_mesh`` puts one axis over the
first ranks only (the dry run's pipeline and evaluation over fewer ranks
than the world has). ``initialize_distributed`` joins a group across hosts
(the JAX ``jax.distributed.initialize``). :func:`spawn` starts ranks on one
host for the tests.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import tempfile
import time
import traceback
from math import prod
from pathlib import Path

import torch
import torch.distributed as dist

# an init_method URL (``file://...``, ``tcp://...``) that takes the place of
# torchrun's MASTER_ADDR/MASTER_PORT; :func:`spawn` sets it to a FileStore
INIT_METHOD_ENV = "EVT_DIST_INIT_METHOD"
# "nccl" (the default) or "gloo": the backend of a group on the card
BACKEND_ENV = "EVT_DIST_BACKEND"


def init_process_group(device="cuda"):
    """Join the default process group from torchrun's environment (or the
    :data:`INIT_METHOD_ENV` URL), on ``device``'s backend; one rank where
    nothing is set. Returns True where this call made the group, False
    where it already existed."""
    if dist.is_initialized():
        return False
    rank = int(os.environ.get("RANK", 0))
    world_size = int(os.environ.get("WORLD_SIZE", 1))
    if os.environ.get(INIT_METHOD_ENV):
        where = dict(init_method=os.environ[INIT_METHOD_ENV])
    elif "MASTER_ADDR" in os.environ:
        where = dict(init_method="env://")
    elif world_size == 1:
        where = dict(store=dist.HashStore())
    else:
        raise RuntimeError(f"WORLD_SIZE={world_size} without MASTER_ADDR: launch with torchrun")
    _join(device, rank, world_size, **where)
    return True


def backend_for(device):
    """The backend of a group on ``device``: gloo on the CPU; on the card
    NCCL, or what :data:`BACKEND_ENV` names ("nccl" or "gloo")."""
    if torch.device(device).type != "cuda":
        return "gloo"
    backend = os.environ.get(BACKEND_ENV) or "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"{BACKEND_ENV}={backend!r}: the card's backends are 'nccl' and 'gloo'")
    return backend


def _join(device, rank, world_size, **where):
    """The default group on ``device``'s backend (:func:`backend_for`): on
    the card the GPU of ``LOCAL_RANK`` (modulo the GPUs there are, where
    gloo lets ranks share one), initialised, so that a ``DeviceMesh`` keeps
    it."""
    device = torch.device(device)
    backend = backend_for(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks on gloo")
        local = int(os.environ.get("LOCAL_RANK", 0))
        if backend == "gloo":
            local %= torch.cuda.device_count()
        torch.cuda.set_device(local)
        torch.cuda.init()
    dist.init_process_group(backend, rank=rank, world_size=world_size, **where)


def destroy():
    """Destroy the default process group, where there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def distributed(device="cuda"):
    """The default process group on ``device``'s backend for the block's
    duration; a group this made is destroyed on exit, one the caller made
    is left."""
    made = init_process_group(device)
    try:
        yield
    finally:
        if made:
            destroy()


def make_mesh(shape=None, axis_names=("data",), device="cuda"):
    """A ``DeviceMesh`` over every process of the default group (made here
    where there is none). ``shape=None`` puts every process on the first
    axis; a ``-1`` entry is inferred."""
    from torch.distributed.device_mesh import init_device_mesh

    init_process_group(device)
    n = dist.get_world_size()
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = list(shape)
    if -1 in shape:
        shape[shape.index(-1)] = n // prod(s for s in shape if s != -1)
    if prod(shape) != n or len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} with axes {axis_names} does not fit {n} processes")
    return init_device_mesh(torch.device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def dp_tp_shape(n, max_tp=4):
    """(dp, tp) of ``n`` processes: tp the largest divisor of ``n`` at most
    ``max_tp`` (JAX ``best_dp_tp_mesh``: the model axis carries the heavier
    traffic, so it is the inner one)."""
    tp = next(t for t in range(min(max_tp, n), 0, -1) if n % t == 0)
    return n // tp, tp


def best_dp_tp_mesh(n_devices=None, max_tp=4, device="cuda"):
    """A ("data", "model") mesh over every process (made here where there
    is no group), of :func:`dp_tp_shape`; "model" is the inner axis, so a
    tensor-parallel group holds consecutive ranks (on one host, the GPUs
    NVLink joins). ``n_devices``, where given, must be the world size: a
    mesh over fewer processes than the group has is :func:`prefix_mesh`'s."""
    init_process_group(device)
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"best_dp_tp_mesh over {n_devices} devices in a group of {n} processes")
    return make_mesh(dp_tp_shape(n, max_tp), ("data", "model"), device)


class PrefixMesh:
    """One named axis over the first ``size`` ranks of the default group;
    ``get_group(axis)`` as a ``DeviceMesh`` has it."""

    def __init__(self, axis, group):
        self.axis, self.group = axis, group

    def get_group(self, axis):
        if axis != self.axis:
            raise KeyError(f"the mesh has the axis {self.axis!r}, not {axis!r}")
        return self.group


def prefix_mesh(size, axis, device="cuda"):
    """The axis ``axis`` over ranks 0 ... size - 1 of the default group
    (made here where there is none): a :func:`make_mesh` of every process
    where ``size`` is the world size, else a :class:`PrefixMesh` on the
    ranks inside it and None on the others. Every rank must call it."""
    init_process_group(device)
    n = dist.get_world_size()
    if not 1 <= size <= n:
        raise ValueError(f"a mesh of {size} processes in a group of {n}")
    if size == n:
        return make_mesh((n,), (axis,), device)
    group = dist.new_group(list(range(size)))
    return PrefixMesh(axis, group) if dist.get_rank() < size else None


def initialize_distributed(coordinator_address, num_processes, process_id, device="cuda"):
    """Join a default group of ``num_processes`` processes across hosts as
    rank ``process_id``, through the ``tcp://`` rendezvous at
    ``coordinator_address`` ("host:port", served by rank 0), on
    ``device``'s backend (JAX ``initialize_distributed``), one process a
    GPU, on the GPU of ``LOCAL_RANK`` (0 where unset). Returns True where
    this call made the group, False where one existed."""
    if dist.is_initialized():
        return False
    address = coordinator_address
    if not address.startswith("tcp://"):
        address = f"tcp://{address}"
    _join(device, process_id, num_processes, init_method=address)
    return True


@contextlib.contextmanager
def entry_mesh(config, axis):
    """The evaluate entry points' mesh: every process torchrun started on
    the one axis ``axis``, on the model's device (``model.device``, the
    card by default). Yields (mesh, whether this rank writes the run's
    files: the first); the group is destroyed on exit where this made it."""
    device = (config.get("model") or {}).get("device", "cuda")
    with distributed(device):
        yield make_mesh((-1,), (axis,), device), dist.get_rank() == 0


def first_then_rest(fn, writes):
    """``fn()`` on the writing rank, then on the others: a dataset that
    unpacks its files at first use unpacks them once."""
    if not writes:
        dist.barrier()
    out = fn()
    if writes:
        dist.barrier()
    return out


def spawn(fn, world_size, args=(), timeout=600, threads=None):
    """Run ``fn(*args)`` in ``world_size`` new processes on this host, each
    a rank (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` set as torchrun sets
    them, the rendezvous a FileStore in a temporary directory), and return
    their results in rank order. ``fn`` must be importable by name and
    joins the group itself (:func:`make_mesh` or :func:`distributed`, on
    its device); a group still open when it returns is destroyed. A rank
    that fails, or a run past ``timeout`` seconds, stops every rank and
    raises here with every rank's outcome (:func:`_outcomes`); ``threads``
    sets each rank's ``torch.set_num_threads``."""
    import multiprocessing

    context = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="evt_spawn_") as tmp:
        procs = [
            context.Process(target=_rank_main,
                            args=(fn, args, rank, world_size, f"file://{tmp}/store", tmp, threads))
            for rank in range(world_size)
        ]
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + timeout

        def failing():
            return (any(Path(tmp).glob("error_*.txt"))
                    or any(proc.exitcode not in (None, 0) for proc in procs))

        while any(proc.is_alive() for proc in procs) and not failing():
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
        # a failed rank's peers fail within moments (a closed connection):
        # their own outcomes are part of the report
        grace = time.monotonic() + SPAWN_GRACE
        while failing() and any(proc.is_alive() for proc in procs) and time.monotonic() < grace:
            time.sleep(0.05)
        stopped = [proc.is_alive() for proc in procs]
        timed_out = any(stopped) and not failing()
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
            proc.join(10)
            if proc.is_alive():
                proc.kill()
                proc.join()
        if any(stopped) or any(proc.exitcode != 0 for proc in procs):
            head = f"timed out after {timeout} s" if timed_out else "spawned rank failed"
            raise RuntimeError(f"{head}:\n" + _outcomes(tmp, procs, stopped))
        results = []
        for rank in range(world_size):
            with open(Path(tmp, f"result_{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


# seconds spawn waits, once a rank has failed, for the others to end
SPAWN_GRACE = 5.0


def _outcomes(tmp, procs, stopped):
    """One entry a rank: the traceback it raised (its ``error_<rank>.txt``),
    else how it ended: its exit code, the signal that ended it with the
    Python stack the fault handler wrote (``fault_<rank>.txt``), or that
    spawn stopped it while it still ran."""
    import signal

    lines = []
    for rank, (proc, was_stopped) in enumerate(zip(procs, stopped)):
        error = Path(tmp, f"error_{rank}.txt")
        fault = Path(tmp, f"fault_{rank}.txt")
        fault_text = fault.read_text().strip() if fault.exists() else ""
        if error.exists():
            lines.append(error.read_text().rstrip())
        elif was_stopped:
            lines.append(f"rank {rank}: still running, stopped by spawn")
        elif proc.exitcode is not None and proc.exitcode < 0:
            name = signal.Signals(-proc.exitcode).name
            lines.append(f"rank {rank}: ended by signal {name} (exit code {proc.exitcode}), "
                         "no Python exception")
        else:
            lines.append(f"rank {rank}: exit code {proc.exitcode}"
                         + ("" if proc.exitcode == 0 else ", no Python exception"))
        if fault_text:
            lines.append(f"rank {rank} fault handler:\n{fault_text}")
    return "\n".join(lines)


def _rank_main(fn, args, rank, world_size, init_method, tmp, threads):
    import faulthandler

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world_size))
    os.environ[INIT_METHOD_ENV] = init_method
    # a fatal signal (a crash in native code) leaves this rank's Python stack
    fault = open(Path(tmp, f"fault_{rank}.txt"), "w")
    faulthandler.enable(file=fault)
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        result = fn(*args)
        with open(Path(tmp, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        Path(tmp, f"error_{rank}.txt").write_text(f"rank {rank}:\n{traceback.format_exc()}")
        raise
    finally:
        destroy()
