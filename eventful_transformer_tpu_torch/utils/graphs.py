"""Captured steps: a model step recorded once as a CUDA graph and replayed,
the port's counterpart of the JAX package's ``jax.jit`` steps (JAX
``utils/evaluate.py:52``, ``:77``, ``utils/spatial.py:31``, the frame
functions of ``scripts/evaluate/vitdet_vid.py`` and the timed steps of
``scripts/time/*``). A replay launches every kernel of the step with no
Python in between, as the JAX package runs each step as one program.

:class:`GraphStep` keeps one graph for each key: the inputs' shapes and
dtypes, the step's static arguments (``mode``), and everything the Python
path branches on at capture: every plain attribute of the model's modules
(the policies with their k, capacity and threshold, ``fused_gates``,
``share_gate_passes``, ``spatial_only``), the class switch
``in_kernel_topk``, the module switch ``core.indexing.USE_PALLAS_BLEND``,
and the parameters' addresses (a graph reads the weights where they lay at
capture). As the JAX step's docstring says, a step must be rebuilt when
the policies change; here the key changes and the step captures again.

A new key first runs the step once on a side stream (the warm-up
``torch.cuda.graphs`` asks for): that run builds the kernels and does the
one-time host work of the wrappers (``cudaFuncSetAttribute``, the driver
entry point of ``csrc/gemm_tc.cu``, cuBLAS's handle, the lazily built
index maps). Then the step is captured into a graph whose private memory
pool keeps every scratch tensor at the address it had at capture, which
the TMA descriptors baked into the graph (``csrc/gemm_tc.cu``, cached by
address, passed by value) need. Each call copies its inputs into the
step's static input buffers, replays, clones the outputs, and reads the
tensor counts once (``core/counting.py``): one host synchronisation a
call, as the JAX step returns its counts.

The kernel wrappers count their launches in Python (``<wrapper>.launches``
and their forms, bodies and cores), which runs only at capture. A graph
keeps what its capture counted, undoes it (a capture launches nothing) and
adds it at each replay, where those kernels do launch; the warm-up that
builds a graph is undone too, so the counts tally the launches of the
calls made.

A stateful step (``stateful=True``: ViTDet's backbone, whose state crosses
frames) keeps the state in static tensors, one set for each shape of the
state and shared by the keys (the flush and the incremental graph read and
write the same tensors). At capture the step compares each output state
leaf with its input leaf: where the kernels updated the state in place
nothing more is done, elsewhere a ``copy_`` into the input leaf ends the
graph (``write_back``: the leaves and bytes). The state a call returns is
that static state: the next call overwrites it, so clone it to keep it.
A call given another state copies it in first.

Refused, each with an error, never run eagerly instead: grad mode and
``Ctx(training=True)`` (the kernels have no backward), a forward that
holds a collective (``ctx.groups``, a block's ``tp_group`` or
``sequence_parallel``, a gate's ``norm_group``: NCCL capture is not
done), a CPU tensor, and a capture that fails (a host synchronisation,
for one), which raises :class:`CaptureError` naming the line of the port
where it failed.

:func:`model_step` picks the captured or the eager step for a model, with
the same call convention: captured on the card unless ``graph=False``, the
eager step on the CPU (``graph=True`` there raises).
"""

from __future__ import annotations

import functools
import importlib
import time
import traceback
from pathlib import Path

import torch
from torch import nn

from eventful_transformer_tpu_torch.core import indexing
from eventful_transformer_tpu_torch.core.counting import Counts, Ctx, add_counts
from eventful_transformer_tpu_torch.utils.bucketing import clone_state

PACKAGE_DIR = Path(__file__).resolve().parent.parent
# attributes of a module that name a process group for a collective in the
# forward
COLLECTIVES = ("tp_group", "sequence_parallel", "norm_group")
# class attributes the Python path branches on (beside every plain
# attribute an instance holds)
CLASS_SWITCHES = ("in_kernel_topk",)
# the modules of ops/ whose wrappers count their launches
COUNTING_OPS = ("attention", "av_softmax", "block_fused", "dense_mlp", "gate_block", "gate_fused",
                "gate_group", "nms", "relpos", "scatter", "scatter_blend", "window_attention")
COUNTERS = ("form_launches", "body_launches", "core_launches", "row_body_launches")
_PLAIN = (bool, int, float, str, type(None), torch.dtype)
_PACKAGE = __name__.split(".")[0]
_SKIP = object()


class CaptureError(RuntimeError):
    """A step's capture failed; the step is not run eagerly instead."""


# -- trees ---------------------------------------------------------------------


def leaves(tree, path=()):
    """(path, leaf) of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from leaves(value, path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from leaves(value, path + (i,))
    else:
        yield path, tree


def map_tree(tree, fn, path=()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {key: map_tree(value, fn, path + (key,)) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(value, fn, path + (i,)) for i, value in enumerate(tree))
    return fn(path, tree)


def _tensor_leaves(tree):
    return {path: leaf for path, leaf in leaves(tree) if isinstance(leaf, torch.Tensor)}


def _signature(tensors):
    return tuple((path, tuple(t.shape), t.dtype, t.device) for path, t in tensors.items())


# -- keys ----------------------------------------------------------------------


def _setting(value, depth=2):
    """A hashable stand-in for an attribute the Python path may branch on,
    or _SKIP: plain values, tuples of them, and (``depth`` levels down)
    the attributes of an object of the port that is not a module, such as
    a gate and its policy."""
    if isinstance(value, _PLAIN):
        return value
    if isinstance(value, (tuple, list)):
        items = tuple(_setting(v, 0) for v in value)
        return _SKIP if any(v is _SKIP for v in items) else items
    if (depth and type(value).__module__.startswith(_PACKAGE)
            and not isinstance(value, nn.Module) and hasattr(value, "__dict__")):
        items = ((name, _setting(v, depth - 1)) for name, v in vars(value).items())
        return (type(value).__name__,) + tuple(item for item in items if item[1] is not _SKIP)
    return _SKIP


def collective(modules, ctx_kwargs=None):
    """A description of the collective a forward would hold, or None: a
    context with ``groups``, or a module naming a process group."""
    if ctx_kwargs and ctx_kwargs.get("groups"):
        return f"ctx.groups {sorted(ctx_kwargs['groups'])}"
    for module in modules:
        for owner in (module, *getattr(module, "gates", ())):
            for attr in COLLECTIVES:
                if getattr(owner, attr, None) is not None:
                    return f"{type(owner).__name__}.{attr}"
    return None


@functools.cache
def counting_wrappers():
    """The kernel wrappers that count their launches."""
    found = []
    for name in COUNTING_OPS:
        module = importlib.import_module(f"eventful_transformer_tpu_torch.ops.{name}")
        for value in vars(module).values():
            if callable(value) and isinstance(getattr(value, "launches", None), int) \
                    and value not in found:
                found.append(value)
    return tuple(found)


def _launch_counts():
    return [(w.launches, {a: dict(getattr(w, a)) for a in COUNTERS if hasattr(w, a)})
            for w in counting_wrappers()]


def _launch_delta(before, after):
    return [(n1 - n0, {a: {k: c1[a][k] - c0[a].get(k, 0) for k in c1[a]} for a in c1})
            for (n0, c0), (n1, c1) in zip(before, after)]


def add_launches(delta, sign=1):
    """Add ``delta`` (of :func:`_launch_delta`) times ``sign`` to the
    wrappers' launch counts."""
    for wrapper, (n, counters) in zip(counting_wrappers(), delta):
        if not n and not any(any(c.values()) for c in counters.values()):
            continue
        wrapper.launches += sign * n
        for attr, counts in counters.items():
            target = getattr(wrapper, attr)
            for key, value in counts.items():
                target[key] = target.get(key, 0) + sign * value


def _failure_site(exc):
    """(the exception a capture failure arose from, "file:line in function:
    source" of the deepest frame of the port's own code in it)."""
    chain, e = [], exc
    while e is not None and e not in chain:
        chain.append(e)
        e = e.__cause__ or e.__context__
    for e in reversed(chain):
        frames = [f for f in traceback.extract_tb(e.__traceback__)
                  if f.filename.startswith(str(PACKAGE_DIR)) and f.filename != __file__]
        if frames:
            f = frames[-1]
            where = Path(f.filename).relative_to(PACKAGE_DIR.parent)
            return e, f"{where}:{f.lineno} in {f.name}: {(f.line or '').strip()}"
    return exc, "an unknown line"


# -- the steps -----------------------------------------------------------------


class _Entry:
    """One key's graph and what its replays need."""

    __slots__ = ("graph", "static", "outputs", "state_out", "host_counts", "count_keys",
                 "count_values", "launches", "write_back")


class GraphStep:
    """``fn(ctx, *tensors, **static)`` (``stateful``: ``fn(ctx, state,
    *tensors, **static) -> (outputs, state)``) captured per key and
    replayed. A call ``step(*tensors, **static)`` returns (outputs,
    counts), a stateful one ``step(state, *tensors, **static)`` (outputs,
    state, counts); ``static`` holds hashable Python values (ViTDet's
    ``mode``) and is part of the key. ``model`` is the module whose
    forward ``fn`` runs: its modules are listed when the step is built,
    and their settings and parameter addresses are read at each call.
    ``ctx_kwargs`` go to each call's ``Ctx``. ``capture=False`` runs the
    same static-buffer step eagerly (where no card is: the write-back plan
    and the count split can be held there). ``captures`` and
    ``capture_seconds`` tally the graphs made and the seconds their
    warm-ups and captures took."""

    def __init__(self, model, fn, stateful=False, count_mode=True, capture=True, name=None,
                 **ctx_kwargs):
        if ctx_kwargs.get("training"):
            raise ValueError("a captured step runs inference: Ctx(training=True) takes the "
                             "plain path under autograd, which a graph does not replay")
        self._modules = list(model.modules())
        self._names = [(-1, ())] * len(self._modules)
        held = collective(self._modules, ctx_kwargs)
        if held is not None:
            raise ValueError(f"the forward holds a collective ({held}); a captured step "
                             "takes none (NCCL capture is not done): run it eagerly")
        self.model, self.fn, self.stateful = model, fn, stateful
        self.count_mode, self.capture, self.ctx_kwargs = count_mode, capture, ctx_kwargs
        self.name = name or getattr(fn, "__name__", "step")
        self._entries = {}
        self._inputs = {}  # input signature -> static input tensors
        self._states = {}  # state signature -> static state tensors by path
        self.captures = 0
        self.capture_seconds = 0.0
        self.last_write_back = None

    # the key ----------------------------------------------------------------

    def model_key(self):
        """What the model's Python path branches on, and where its weights
        lie. A module's public attribute names are listed again only when
        its attributes change in number."""
        key = [indexing.USE_PALLAS_BLEND]
        for i, module in enumerate(self._modules):
            attrs = module.__dict__
            if len(attrs) != self._names[i][0]:
                self._names[i] = (len(attrs), tuple(n for n in attrs if not n.startswith("_")))
            names = self._names[i][1]
            key.append(names)
            for name in names:
                value = attrs[name]
                key.append(value if isinstance(value, _PLAIN) else _setting(value))
            cls = type(module)
            for name in CLASS_SWITCHES:
                key.append(attrs.get(name, getattr(cls, name, None)))
            for group in (module._parameters, module._buffers):
                for t in group.values():
                    if t is not None:
                        key.append(t.data_ptr())
                        key.append(t.dtype)
        return tuple(key)

    # a call -----------------------------------------------------------------

    def __call__(self, *args, **static):
        if torch.is_grad_enabled():
            raise RuntimeError(f"{self.name}: grad mode is on; a captured step runs under "
                               "torch.no_grad() (the kernels have no backward)")
        state, args = (args[0], args[1:]) if self.stateful else (None, args)
        tensors = _tensor_leaves(state) if self.stateful else {}
        if self.capture:
            host = [t for t in list(args) + list(tensors.values()) if t.device.type != "cuda"]
            if host:
                raise ValueError(f"{self.name}: a captured step takes CUDA tensors, got one on "
                                 f"{host[0].device}")
        inputs = self._static_inputs(args)
        static_state = self._static_state(tensors) if self.stateful else None
        others = tuple((p, v) for p, v in leaves(state) if not isinstance(v, torch.Tensor)) \
            if self.stateful else ()
        key = (_signature(dict(enumerate(args))), _signature(tensors), others,
               tuple(sorted(static.items())), self.model_key())
        in_state = None
        if self.stateful:
            in_state = map_tree(state, lambda p, v: static_state[p] if p in static_state else v)
        if not self.capture:
            return self._eager(inputs, in_state, static)
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = self._build(inputs, in_state, static)
        entry.graph.replay()
        add_launches(entry.launches)
        outputs = clone_state(entry.outputs)
        counts = Counts(entry.host_counts)
        if entry.count_values is not None:
            add_counts(counts, entry.count_keys, entry.count_values.tolist())
        self.last_write_back = entry.write_back
        if self.stateful:
            return outputs, entry.state_out, counts
        return outputs, counts

    def write_back_summary(self):
        """Each graph's static arguments with the state leaves and bytes
        its write-back copies."""
        return [dict(entry.static, leaves=len(entry.write_back),
                     bytes=sum(b for _, b in entry.write_back),
                     paths=["/".join(map(str, p)) for p, _ in entry.write_back[:8]])
                for entry in self._entries.values()]

    def _static_inputs(self, args):
        """The static input buffers of the args' signature, the args copied
        in (a new signature's buffers are copies)."""
        sig = _signature(dict(enumerate(args)))
        static = self._inputs.get(sig)
        if static is None:
            static = self._inputs[sig] = [a.clone() for a in args]
            return static
        for buf, a in zip(static, args):
            if buf.data_ptr() != a.data_ptr():
                buf.copy_(a)
        return static

    def _static_state(self, tensors):
        """The static state tensors (by path) of the state's signature, the
        caller's state copied in unless it is that state."""
        sig = _signature(tensors)
        static = self._states.get(sig)
        if static is None:
            static = self._states[sig] = {p: t.clone() for p, t in tensors.items()}
            return static
        for path, t in tensors.items():
            if static[path].data_ptr() != t.data_ptr():
                static[path].copy_(t)
        return static

    def _ctx(self):
        return Ctx(count_mode=self.count_mode, **self.ctx_kwargs)

    def _body(self, ctx, inputs, in_state, static):
        """One run of ``fn`` on the static buffers, with the write-back:
        (outputs, the returned state, the write-back plan)."""
        if not self.stateful:
            return self.fn(ctx, *inputs, **static), None, ()
        outputs, out_state = self.fn(ctx, in_state, *inputs, **static)
        return (outputs,) + write_back(in_state, out_state)

    def _eager(self, inputs, in_state, static):
        ctx = self._ctx()
        outputs, out_state, self.last_write_back = self._body(ctx, inputs, in_state, static)
        outputs = clone_state(outputs)
        if self.stateful:
            return outputs, out_state, ctx.counts
        return outputs, ctx.counts

    def _build(self, inputs, in_state, static):
        """Warm up on a side stream, then capture; raise CaptureError where
        the capture fails."""
        held = collective(self._modules)
        if held is not None:
            raise ValueError(f"{self.name}: the forward holds a collective ({held}); a captured "
                             "step takes none")
        start = time.perf_counter()
        before = _launch_counts()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            # on a copy of the state: the kernels update it in place
            self._body(self._ctx(), inputs, clone_state(in_state), static)
        torch.cuda.current_stream().wait_stream(side)
        warm = _launch_counts()
        entry = _Entry()
        entry.graph = torch.cuda.CUDAGraph()
        ctx = self._ctx()
        ctx.capturing = True
        try:
            # thread-local: another thread of the process (NCCL's watchdog,
            # the profiler) may call the runtime while this one captures
            with torch.cuda.graph(entry.graph, capture_error_mode="thread_local"):
                outputs, out_state, plan = self._body(ctx, inputs, in_state, static)
                entry.count_keys, entry.count_values = ctx.tensor_counts()
        except Exception as exc:  # noqa: BLE001 - re-raised with its site
            add_launches(_launch_delta(before, _launch_counts()), -1)
            cause, site = _failure_site(exc)
            raise CaptureError(f"{self.name}: capture failed at {site} ({type(cause).__name__}: "
                               f"{cause}); the step is not run eagerly instead") from exc
        captured = _launch_counts()
        add_launches(_launch_delta(before, captured), -1)
        entry.launches = _launch_delta(warm, captured)
        entry.outputs, entry.state_out, entry.write_back = outputs, out_state, plan
        entry.static = static
        entry.host_counts = ctx.host_counts()
        self.captures += 1
        self.capture_seconds += time.perf_counter() - start
        return entry


def write_back(in_state, out_state):
    """The output state with each tensor leaf the input's (the static
    tensor), and the plan: where an output leaf is not its input leaf
    updated in place, copy it into the input leaf (an output that shares
    memory with another input leaf is cloned first). Returns (state,
    [(path, bytes)] of the leaves copied)."""
    ins, outs = _tensor_leaves(in_state), _tensor_leaves(out_state)
    if ins.keys() != outs.keys():
        raise ValueError(f"the step's state changed its leaves: {sorted(ins.keys() ^ outs.keys())}")
    storages = {t.untyped_storage().data_ptr() for t in ins.values()}
    copies = []
    for path, out in outs.items():
        target = ins[path]
        if (out.shape, out.dtype) != (target.shape, target.dtype):
            raise ValueError(f"state leaf {path}: {tuple(out.shape)} {out.dtype} out of "
                             f"{tuple(target.shape)} {target.dtype}")
        if out.data_ptr() == target.data_ptr() and out.stride() == target.stride():
            continue
        # cloned before any copy lands: the copies may overwrite what it reads
        copies.append((path, out.clone() if out.untyped_storage().data_ptr() in storages
                       else out))
    plan = []
    for path, out in copies:
        ins[path].copy_(out)
        plan.append((path, out.numel() * out.element_size()))
    state = map_tree(out_state, lambda p, v: ins[p] if p in ins else v)
    return state, plan


class EagerStep:
    """:class:`GraphStep`'s call convention, run eagerly: each call makes
    its context, runs ``fn`` and reads the counts."""

    def __init__(self, model, fn, stateful=False, count_mode=True, name=None, **ctx_kwargs):
        del model
        self.fn, self.stateful, self.count_mode, self.ctx_kwargs = fn, stateful, count_mode, \
            ctx_kwargs
        self.name = name or getattr(fn, "__name__", "step")

    def __call__(self, *args, **static):
        ctx = Ctx(count_mode=self.count_mode, **self.ctx_kwargs)
        if self.stateful:
            outputs, state = self.fn(ctx, *args, **static)
            return outputs, state, ctx.counts
        return self.fn(ctx, *args, **static), ctx.counts


def use_graph(model, graph=None):
    """Whether a step of ``model`` is captured: ``graph`` where given, else
    where the model lies on the card; ``graph=True`` on a CPU model
    raises."""
    on_card = next(model.parameters()).device.type == "cuda"
    if graph is None:
        return on_card
    if graph and not on_card:
        raise ValueError("graph=True captures a CUDA graph, which needs the model on the card")
    return bool(graph)


def model_step(model, fn, graph=None, **kwargs):
    """``fn`` as a :class:`GraphStep` where :func:`use_graph` says so, else
    as an :class:`EagerStep` (same call convention)."""
    if use_graph(model, graph):
        return GraphStep(model, fn, **kwargs)
    return EagerStep(model, fn, **kwargs)
