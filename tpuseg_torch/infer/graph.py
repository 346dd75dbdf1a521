"""Captured programs: the port's counterpart of the reference's jitted
inference calls (``jax.jit`` in ``tpuseg/infer/pipeline.py`` and
``tpuseg/infer/sharded.py``) and train step (``tpuseg/train/loop.py``).

XLA compiles a call once for its argument shapes and replays the program.
On the card the counterpart is a CUDA graph: :class:`CapturedProgram`
wraps an eager body ``fn(*args)`` and, per key (the shapes, dtypes and
devices of the tensor arguments, with any non-tensor argument as it is),

1. runs ``fn`` eagerly the first time it sees the key. This is also the
   warm-up a capture needs: cuDNN plans, cuBLAS handles, the kernel
   library's load and its shared-memory opt-ins happen outside the capture;
2. on the second call, copies the arguments into static buffers it owns,
   captures ``fn`` on them (``torch.cuda.graph``, on a side stream) and
   replays the graph;
3. afterwards copies the arguments in, replays, and returns clones of the
   graph's outputs, so a caller keeps its result across calls, as it keeps
   a jitted function's fresh arrays.

A body may take a tensor argument to the key only through its shape: a
Python number it reads is baked into the graph, so a value that changes
from call to call must be a tensor argument (the sharded call's
``z_offset`` is a 0-d device tensor for that reason). Arguments that are
not all on one CUDA device (CPU tensors, for the tests and the CPU paths)
run ``fn`` eagerly on every call. A capture that fails raises; nothing runs
eagerly in its place.

What can be captured is a rule of the settings, :func:`eager_reason`, that
every factory applies: a body that reads the host between its launches
(the plain twins, ``postproc.resolve_impl="xla"``) cannot be, and such a
program runs eagerly on every call, its ``mode`` saying why. The train
step's rule is :func:`train_eager_reason`.

A training body (``autograd=True``: ``train/step.TrainStep``) runs with
autograd and changes state the program does not own: the parameters, the
optimizer's moments, the BatchNorm statistics. A capture runs nothing, and
the replay that follows it runs the body once, so the capture call, like
every other, advances that state once (no warm-up steps on a side stream:
they would be real updates). Its random draws come from generators the
body names (``generators``), registered with each graph before its
capture, so a replay draws from their state at the replay: reseeded on the
host, they give the eager body's draws.

A graph also reads what the body reads besides its arguments: the model's
parameters and buffers, at the addresses they had at the capture. A
program is given that as a ``context`` (:func:`module_state`: each
parameter's and buffer's address, dtype, device and shape, each module's
training flag), read at each call; when it changes (``model.half()``, a
move, ``load_state_dict(..., assign=True)``, ``model.train()``), the
program releases its graphs and starts over, so the next call of a key is
eager again.

The kernel wrappers' host counters (``.launches``, ``.mma_launches``,
``.tile_launches`` of ``ops.KERNEL_WRAPPERS``) count what Python enqueues,
and a replay enqueues nothing from Python, so each graph keeps the counters'
change during its capture and adds it on every later replay: a counter
still counts the launches that ran. The state the wrappers keep about their
last call (``ops.LAST_CALL_STATE``, and whatever ``state`` names) points,
after a replay, at the graph's own buffers of that state, which the replay
has just written.

Memory: every graph of a program lives as long as the program, one graph a
key, and its private memory pool stays reserved with it: the body's own
allocations as the capture made them, which may exceed an eager call's
(the pool does not shrink between calls). ``release()`` drops the graphs
and gives the pool back. The graphs of one program share one pool, as do
the two programs of a ``"staged"`` call (:class:`Chain`): a graph's
outputs are cloned before any other graph of the pool runs, and its
arguments are copied into static buffers allocated outside the pool.
"""

from __future__ import annotations

import functools
import gc
import time
import weakref

import torch

from tpuseg_torch.ops import KERNEL_WRAPPERS, LAST_CALL_STATE
from tpuseg_torch.utils import profiling
from tpuseg_torch.utils.profiling import span

COUNTER_ATTRS = ("launches", "mma_launches", "tile_launches")


def eager_reason(cfg, plain: bool = False) -> str | None:
    """Why a body built from ``cfg`` (and ``plain``) cannot be captured,
    as the mode its program states, or None. The plain twins read the host
    between passes (``ops/resolve._chase_loop``, ``_flood_loop``), and
    ``postproc.resolve_impl="xla"`` runs the plain flood on every device."""
    if plain:
        return "eager: plain twins"
    if cfg.postproc.resolve_impl == "xla":
        return "eager: resolve_impl='xla' reads the host"
    return None


def train_eager_reason(group) -> str | None:
    """Why a train step cannot be captured: under a ``torch.distributed``
    group its gradient and BatchNorm all-reduces are collectives the host
    drives (gloo), and NCCL across cards is not measured here."""
    if group is not None:
        return "eager: torch.distributed group"
    return None


def module_state(*modules) -> tuple:
    """A program's ``context`` for ``modules``: per module its training
    flag and each parameter's and buffer's address, dtype, device and shape
    (module docstring; read from the modules' own dicts, ~2.5x quicker than
    ``parameters(recurse=False)``)."""
    return tuple(
        (m.training, tuple((t.data_ptr(), t.dtype, t.device, t.shape)
                           for t in (*m._parameters.values(),
                                     *m._buffers.values())
                           if t is not None))
        for module in modules for m in module.modules())


def _counters() -> list:
    return [(w, a) for w in KERNEL_WRAPPERS for a in COUNTER_ATTRS
            if hasattr(w, a)]


def _tensors(tree) -> list:
    """The tensors of a nest of lists, tuples and dicts, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _rebuild(tree, tensors):
    """``tree`` with its tensors replaced, in order, from the iterator
    ``tensors``."""
    if isinstance(tree, torch.Tensor):
        return next(tensors)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, tensors) for x in tree)
    if isinstance(tree, dict):
        return {k: _rebuild(v, tensors) for k, v in tree.items()}
    return tree


def signature(tree):
    """The key of a call: the nest's structure, each tensor's shape, dtype
    and device, and every other leaf as it is (it must be hashable)."""
    if isinstance(tree, torch.Tensor):
        return ("tensor", tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(signature(x) for x in tree))
    if isinstance(tree, dict):
        return ("dict", tuple((k, signature(v)) for k, v in tree.items()))
    return ("value", type(tree), tree)


class CudaGraphs:
    """The graph backend on the card (tests substitute a stand-in)."""

    @staticmethod
    def accepts(devices: set) -> bool:
        """Capture only calls whose tensors all sit on one CUDA device."""
        return len(devices) == 1 and next(iter(devices)).type == "cuda"

    @staticmethod
    def new_pool():
        return torch.cuda.graph_pool_handle()

    @staticmethod
    def capture(fn, args, pool, device, generators=()):
        """``(graph, outputs, bytes the capture reserved)``; the outputs
        are the graph's own buffers, written by each replay. The cyclic
        garbage collector is run before and held off during the capture:
        a graph it frees in the middle of a capture (a program in a
        reference cycle) invalidates the capture. ``generators`` are
        registered with the graph first. Only the capturing thread is held
        to the capture's rules ("thread_local"): the train loop's prefetch
        thread pins and uploads the next batch meanwhile, and a training
        body's backward runs on autograd's thread, on the capturing
        stream."""
        with torch.cuda.device(device):
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_reserved()
            graph = torch.cuda.CUDAGraph()
            for g in generators:
                graph.register_generator_state(g)
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=pool,
                                      capture_error_mode="thread_local"):
                    out = fn(*args)
                    profiling.mark_end()
            finally:
                if collecting:
                    gc.enable()
            return graph, out, torch.cuda.memory_reserved() - before

    @staticmethod
    def replay(graph, device) -> None:
        with torch.cuda.device(device):
            graph.replay()

    @staticmethod
    def release(graphs) -> None:
        """Free ``graphs`` and return their pool's unused memory."""
        for graph in graphs:
            graph.reset()
        torch.cuda.empty_cache()


class GraphPool:
    """One memory pool, made at the first capture, for the graphs that
    share it."""

    def __init__(self, backend=CudaGraphs):
        self.backend, self._handle = backend, None

    def handle(self):
        if self._handle is None:
            self._handle = self.backend.new_pool()
        return self._handle


def _ungauge(program: str, reserved: int) -> None:
    profiling.gauge(program, "graphs", -1)
    profiling.gauge(program, "pool_bytes", -reserved)


class _Graph:
    """One captured key: the graph, its static arguments and outputs, the
    counters' change during the capture, the state it left and the stage
    marks it took in (``marks``, ``utils/profiling.py``)."""

    def __init__(self, program, args):
        backend = program.backend
        leaves = _tensors(args)
        self.device = leaves[0].device
        self.inputs = [torch.empty_like(
            t, memory_format=torch.contiguous_format).copy_(t) for t in leaves]
        counters = _counters()
        before = [getattr(o, a) for o, a in counters]
        t0 = time.perf_counter()
        with profiling.capturing() as self.marks:
            self.graph, out, reserved = backend.capture(
                program.eager, _rebuild(args, iter(self.inputs)),
                program.pool.handle(), self.device, program.generators())
        self._replay = functools.partial(backend.replay, self.graph,
                                         self.device)
        self.stats = {"capture_s": time.perf_counter() - t0,
                      "reserved_bytes": reserved}
        for name, by in (("captures", 1), ("graphs", 1),
                         ("pool_bytes", reserved)):
            profiling.gauge(program.name, name, by)
        # the graph's share of the gauges goes when it is released or dropped
        self.ungauge = weakref.finalize(self, _ungauge, program.name,
                                        reserved)
        self.ungauge.atexit = False
        self.launches = [(o, a, getattr(o, a) - n)
                         for (o, a), n in zip(counters, before)
                         if getattr(o, a) != n]
        self.outputs, self.structure = _tensors(out), out
        self.state = [(h, a, getattr(h, a)) for h, a in program.state]

    def run(self, args, count: bool):
        with span("program.copy_in"):
            for s, t in zip(self.inputs, _tensors(args)):
                s.copy_(t)
        with span(profiling.REPLAY) as replay:
            self._replay()
        if replay is not None:
            self.marks.launched(replay)
        if count:
            for o, a, n in self.launches:
                setattr(o, a, getattr(o, a) + n)
        for h, a, value in self.state:
            setattr(h, a, value)
        with span("program.clone_out"):
            return _rebuild(self.structure,
                            (t.clone() for t in self.outputs))


class CapturedProgram:
    """``fn`` run as a captured graph from the second call of a key on
    (module docstring). ``eager`` is the body; ``graphs`` the captured
    keys (their ``.stats``: capture seconds and the bytes the capture
    reserved); ``mode`` is "captured", or ``eager_reason``: why every call
    runs eagerly; ``last_run`` says how the last call ran: "eager: first
    sight", "capture", "replay", "eager: not on one CUDA device" or the
    ``eager_reason``. ``state``: more ``(holder, attribute)`` pairs the
    body sets per call, beside ``ops.LAST_CALL_STATE``. ``context``: a
    function of no arguments giving a hashable value of what the body reads
    besides its arguments (:func:`module_state`); the graphs are released
    when it changes. ``autograd``: a training body (module docstring), run
    with autograd rather than under inference mode; ``generators``: a
    function of no arguments giving the generators the body draws from
    (read at the capture). ``captures`` counts the graphs captured.
    ``name`` owns the program's gauges in the recorder
    (``utils/profiling.py``: ``captures``, and the live ``graphs`` and their
    ``pool_bytes``); each call is a ``program.call`` span, with children
    ``program.harvest`` (the last replays' stage marks read),
    ``program.context``, ``program.eager``, ``program.capture``,
    ``program.copy_in``, ``program.replay`` and ``program.clone_out``."""

    def __init__(self, fn, state=(), pool: GraphPool | None = None,
                 backend=CudaGraphs, context=None,
                 eager_reason: str | None = None, autograd: bool = False,
                 generators=tuple, name: str = "program"):
        self.eager, self.backend, self.context = fn, backend, context
        self.name = name
        self.mode = eager_reason or "captured"
        self.state = LAST_CALL_STATE + tuple(state)
        self.pool = pool if pool is not None else GraphPool(backend)
        self.graphs, self._seen, self.last_run = {}, set(), None
        self._context = None
        self.autograd, self.generators, self.captures = autograd, generators, 0

    def release(self) -> None:
        """Drop every graph and give the pool's memory back (what their
        outputs still hold stays with those tensors); the next call of a
        key runs eagerly again."""
        graphs = [g.graph for g in self.graphs.values()]
        for g in self.graphs.values():
            g.ungauge()
        self.graphs, self._seen = {}, set()
        if graphs:
            self.backend.release(graphs)

    def __call__(self, *args):
        with span(profiling.CALL), torch.inference_mode(not self.autograd):
            if profiling.RECORDER.pending:
                self._harvest()
            return self._call(*args)

    def _harvest(self) -> None:
        """Read the stages of this program's last replays, before a graph's
        next launch overwrites them (``utils/profiling.py``)."""
        with span(profiling.HARVEST):
            for graph in self.graphs.values():
                if graph.marks.launch is not None:
                    graph.marks.harvest()

    def _eager(self, why: str, args):
        self.last_run = why
        with span("program.eager"):
            return self.eager(*args)

    def _call(self, *args):
        if self.mode != "captured":
            return self._eager(self.mode, args)
        if not self.backend.accepts({t.device for t in _tensors(args)}):
            return self._eager("eager: not on one CUDA device", args)
        if self.context is not None:
            with span("program.context"):
                context = self.context()
            if context != self._context:
                self.release()
                self._context = context
        key = signature(args)
        graph = self.graphs.get(key)
        if graph is not None:
            self.last_run = "replay"
            return graph.run(args, count=True)
        if key not in self._seen:
            self._seen.add(key)
            return self._eager("eager: first sight", args)
        with span("program.capture"):
            graph = self.graphs[key] = _Graph(self, args)
        self.captures += 1
        self.last_run = "capture"
        # the capture itself moved the counters once
        return graph.run(args, count=False)


class Chain:
    """Two captured programs called one after the other, ``second(first(
    *args))``, on one memory pool: the reference's ``"staged"`` program
    (two jitted stages). ``eager`` is the unsplit body; ``context`` and
    ``eager_reason`` are each program's, ``names`` their names."""

    def __init__(self, first, second, eager, backend=CudaGraphs,
                 context=None, eager_reason: str | None = None,
                 names=("program", "program")):
        pool = GraphPool(backend)
        self.programs = tuple(
            CapturedProgram(fn, pool=pool, backend=backend, context=context,
                            eager_reason=eager_reason, name=name)
            for fn, name in zip((first, second), names))
        self.eager, self.mode = eager, self.programs[0].mode

    def __call__(self, *args):
        return self.programs[1](self.programs[0](*args))

    def release(self) -> None:
        for p in self.programs:
            p.release()

    @property
    def last_run(self) -> str:
        return " + ".join(str(p.last_run) for p in self.programs)

    @property
    def graphs(self) -> dict:
        return {(i, k): g for i, p in enumerate(self.programs)
                for k, g in p.graphs.items()}
