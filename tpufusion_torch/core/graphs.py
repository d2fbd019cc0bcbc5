"""The step program: one attack step captured once as a CUDA graph and
replayed, the port's counterpart of the JAX package's ``jit`` +
``lax.scan`` (``tpufusion/attacks/pgd.py``, ``whitebox.py``, ``cw.py``).

A step body ``body(state, inputs)`` reads and writes only static buffers:
``state``, a nest of tensors that the body updates in place (the
adversarial pixels, the optimizer's moments, the loss trace, a device step
index), and ``inputs``, a nest of tensors it only reads (the images, the
target, the reference bundle). Anything else it touches (a module, a
config) is fixed when the program is built.

On the card ``StepProgram``:

- takes its first ``WARMUP`` steps eagerly, on its own state and on a side
  stream: they are real steps of the attack, and they build the kernels
  (``ops/_lib.py::load``) and settle cuDNN's and cuBLAS's plans before the
  capture;
- then captures the body once with ``torch.cuda.graph`` (global mode, its
  own memory pool or that of the program it is replayed in turn with) and
  raises on any capture error: nothing falls back to an eager run;
- replays it for every later step. The wrappers count a launch when their
  Python runs, so at capture; the program takes those counts back out and
  adds them at each replay, and ``ops.launch_counts()`` reads per step as
  the eager loop's.

So a call of ``n`` steps on a new program costs ``WARMUP`` eager steps, one
capture and ``n - WARMUP`` replays, and a later call on the same program
only replays. The graph holds the addresses of the state, the inputs and
the parameters of the modules its body reads: these must stay where they
are while the program lives (``ProgramCache`` keys on them).

On the CPU, where a graph does not exist, ``run`` calls the body. The
eager loops (``attacks/pgd.py::pgd_eager`` and its kin) are the plain
twins the programs are held against.
"""

from __future__ import annotations

import time

import torch

from tpufusion_torch import ops

WARMUP = 1  # eager steps a program takes on its own state before its capture


def map_tensors(fn, tree):
    """``tree`` with ``fn`` applied to each tensor leaf (dicts, lists and
    tuples are walked; other leaves are kept)."""
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def tensor_leaves(tree) -> list:
    out = []
    map_tensors(out.append, tree)
    return out


def static_copy(tree):
    """Fresh contiguous buffers holding a copy of every tensor of ``tree``."""
    return map_tensors(lambda t: t.detach().clone(memory_format=torch.contiguous_format), tree)


def load_into(dst, src) -> None:
    """Copy each tensor of ``src`` into the buffer at the same place in
    ``dst`` (same structure)."""
    for d, s in zip(tensor_leaves(dst), tensor_leaves(src), strict=True):
        d.copy_(s)


def addresses(obj, depth: int = 3) -> tuple:
    """Where the tensors of ``obj`` live: a module's parameters and
    buffers, a tensor's own; another object's attributes are walked
    ``depth`` levels down (a pipeline's drawer, its generator); () for
    anything else."""
    if isinstance(obj, torch.nn.Module):
        return tuple(t.data_ptr() for t in (*obj.parameters(), *obj.buffers()))
    if isinstance(obj, torch.Tensor):
        return (obj.data_ptr(),)
    if depth and hasattr(obj, "__dict__") and not isinstance(obj, type):
        return tuple(p for v in vars(obj).values() for p in addresses(v, depth - 1))
    return ()


def signature(*args) -> tuple:
    """A call's cache key: each tensor's shape, dtype and device, each
    other argument's identity and the addresses of its tensors (a
    classifier module's parameters, which a graph holds)."""
    return tuple((tuple(a.shape), a.dtype, a.device) if isinstance(a, torch.Tensor)
                 else ("id", id(a), addresses(a)) for a in args)


def backend_flags() -> tuple:
    """The flags that choose the library kernels a capture bakes in: a
    graph captured under one setting must not replay under another (a
    caller who turns deterministic algorithms on expects them)."""
    cudnn = torch.backends.cudnn
    return (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32, torch.are_deterministic_algorithms_enabled())


def split_args(args: tuple):
    """``(tensors, rebuild)``: the tensors among a call's extra arguments
    (the program's static inputs) and ``rebuild(tensors) -> args`` putting
    their static buffers back in place; the other arguments are fixed."""
    at = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]

    def rebuild(tensors):
        out = list(args)
        for i, t in zip(at, tensors, strict=True):
            out[i] = t
        return out
    return [args[i] for i in at], rebuild


def _add_counts(delta: dict, times: int) -> None:
    ops.add_launch_counts({k: v * times for k, v in delta.items() if v})


class StepProgram:
    """``body(state, inputs)`` as a program: warmed up, captured once and
    replayed on the card (see the module note), called on the CPU.
    ``run(n)`` takes n steps. ``capture_ms`` (the capture and the graph's
    instantiation, host clock with the device synchronised), ``launches``
    (the kernel launches of one replay) and ``replays`` (graph replays; body
    calls on the CPU) describe it. ``pool_of``, another ``StepProgram``,
    shares that program's memory pool once it is captured: safe for
    programs replayed one after the other on one stream. ``limit`` is the
    most steps a loaded state takes (a trace's length: one more would write
    past it on the device)."""

    def __init__(self, body, state, inputs, *, limit: int, pool_of=None):
        self.body, self.state, self.inputs = body, state, inputs
        self.limit, self.taken = limit, 0
        self.device = tensor_leaves(state)[0].device
        self.pool_of = pool_of
        self.graph = None
        self.warmed = 0
        self.capture_ms = 0.0
        self.launches: dict = {}
        self.replays = 0
        self.released = False

    @property
    def warm_left(self) -> int:
        """Eager steps still to take before the capture (0 on the CPU)."""
        return 0 if self.device.type != "cuda" else max(WARMUP - self.warmed, 0)

    def _warm_up(self, n: int) -> None:
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(n):
                self.body(self.state, self.inputs)
        main.wait_stream(side)
        self.warmed += n

    def capture(self) -> None:
        """Capture the body, once its warm-up steps are taken (``run`` does
        this at the first step after them). It raises on a capture error, on
        the CPU and before the warm-up."""
        if self.graph is not None:
            return
        if self.device.type != "cuda" or self.warm_left:
            raise RuntimeError("a step program captures on the card, after its warm-up steps")
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        before = ops.launch_counts()
        ptrs = [t.data_ptr() for t in tensor_leaves(self.state)]
        pool = None if self.pool_of is None else self.pool_of.pool
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=pool):
                self.body(self.state, self.inputs)
        finally:
            # the capture launched nothing (nor did a failed one): its
            # counts go back out
            after = ops.launch_counts()
            self.launches = {k: after[k] - before[k] for k in after}
            _add_counts(self.launches, -1)
        torch.cuda.synchronize(self.device)
        if [t.data_ptr() for t in tensor_leaves(self.state)] != ptrs:
            raise RuntimeError("the step body replaced a static buffer of its state; "
                               "it must write them in place")
        self.graph = graph
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    @property
    def pool(self):
        return None if self.graph is None else self.graph.pool()

    def load(self, state, inputs) -> None:
        """Copy a call's starting state and inputs into the static buffers."""
        load_into(self.state, state)
        load_into(self.inputs, inputs)
        self.taken = 0

    def run(self, n: int = 1) -> None:
        """Take ``n`` steps: the warm-up steps left, then replays of the
        graph (captured at the first of them); calls of the body on the
        CPU."""
        if self.released:
            raise RuntimeError("this step program was released")
        if self.taken + n > self.limit:
            raise ValueError(f"{self.taken} + {n} steps exceed the {self.limit} a loaded "
                             f"state takes: load a new one first")
        self.taken += n
        if self.device.type != "cuda":
            for _ in range(n):
                self.body(self.state, self.inputs)
            self.replays += n
            return
        warm = min(n, self.warm_left)
        if warm:
            self._warm_up(warm)
            n -= warm
        if not n:
            return
        self.capture()
        for _ in range(n):
            self.graph.replay()
        self.replays += n
        _add_counts(self.launches, n)

    def release(self) -> None:
        """Free the graph and its memory pool (the static buffers go with
        the program)."""
        if self.graph is not None:
            self.graph.reset()
            self.graph = None
        self.released = True
        self.state = self.inputs = None


class ProgramCache:
    """The step programs of one attack object, keyed by ``signature``, by
    the addresses of ``fixed`` (what the bodies read besides their
    arguments: the pipeline), so that a module whose parameters moved gets
    a new program, and by ``backend_flags``: an entry is what ``build()``
    made, a program or a list of them (one per chunk). It keeps the call's non-tensor arguments alive, so
    that their identities stay theirs. Iterating gives every program;
    ``release()`` frees them all."""

    def __init__(self, fixed=()):
        self.fixed = tuple(fixed)
        self.programs: dict = {}

    def get(self, key, build, keep=()):
        key = (key, tuple(addresses(f) for f in self.fixed), backend_flags())
        hit = self.programs.get(key)
        if hit is None:
            hit = self.programs[key] = (
                build(), tuple(a for a in keep if not isinstance(a, torch.Tensor)))
        return hit[0]

    def __iter__(self):
        for entry, _ in self.programs.values():
            yield from entry if isinstance(entry, list) else (entry,)

    def release(self) -> None:
        for prog in self:
            prog.release()
        self.programs.clear()
