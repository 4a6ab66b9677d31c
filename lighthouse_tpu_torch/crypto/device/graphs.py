"""CUDA graphs per argument shape: the port's counterpart of ``jax.jit``.

The JAX package dispatches each stage of its verifier as one compiled XLA
executable per argument shape. The port's stages are plain torch code
around three hand-written kernels; run eagerly, a verify is tens of
thousands of small launches and their host dispatch is most of its wall.
:class:`CapturedProgram` records a function once per argument signature
into a ``torch.cuda.CUDAGraph`` and replays it afterwards: one graph
launch in place of the launches it holds.

A call with

* CPU tensors runs ``fn`` eagerly: no graph exists on the CPU (the tests'
  path);
* CUDA tensors, for the first time at its key (the device and each
  argument's shape and dtype, as jit's cache is keyed), under the device's
  lock:

  1. runs ``fn`` once eagerly on a side stream: the warm-up builds the
     kernels (``kernels.build``), loads their modules (no lazy loading may
     happen under capture) and fills the constant caches (``fp.on_device``,
     ``fp.LinMap``). Its launches are real and counted; its wall is the
     function's eager wall;
  2. captures ``fn`` over static copies of the arguments and instantiates
     the graph. The kernel counters the capture bumped (no kernel ran) are
     rolled back and kept as the graph's credit; they must equal the
     warm-up's;
  3. replays once and holds every output equal to the warm-up's
     (``torch.equal``), uncredited;

* CUDA tensors at a captured key: copies each argument into its static
  input, replays, and credits the kernel counters (``kernels.credit``), so
  ``kernels.launches``/``lanes``/``lane_hist`` count per call as an eager
  run would.

Outputs are clones owned by the caller: the graph's own output buffers
are overwritten by the next replay of the key. There is no fallback: a
capture, instantiation, check or replay that fails raises, and ``fn``
runs on a CUDA tensor only as the warm-up before its capture.

Capture uses PyTorch's default "global" mode, which refuses an allocation,
copy or sync that any other thread makes while a capture runs. So capture
and replay take one re-entrant lock per device (:func:`device_lock`), and
the port's callers hold it around all their device work (the backend's
pack and dispatch, the warm-up's dummy arguments). :func:`status` reports
the seconds callers waited on it, and per graph its capture seconds,
eager warm-up seconds, node count (the launches captured, through the
driver's ``cuGraphGetNodes``) and pool bytes (reserved memory around the
capture, ``torch.cuda.memory_stats``).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
import time
import weakref

import torch

from . import kernels


class GraphCaptureError(RuntimeError):
    """A capture whose replay or launch counts disagree with its eager
    warm-up."""


_LOCKS: dict = {}            # device index -> RLock
_lock_wait_s: dict = {}      # device index -> seconds callers waited
_GUARD = threading.Lock()
_PROGRAMS: "weakref.WeakSet[CapturedProgram]" = weakref.WeakSet()
_side_streams: dict = {}     # device index -> the capture stream

# Opt-in device timing of replays (CUDA events around each one): a graph's
# device time, the gaps between its nodes included.
_event_timing = False
_events: list = []


def _cuda_index(device) -> int | None:
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return dev.index if dev.index is not None else torch.cuda.current_device()


@contextlib.contextmanager
def device_lock(device):
    """Hold ``device``'s capture-and-replay lock (re-entrant; a no-op off
    CUDA). The seconds spent waiting for it add to :func:`status`."""
    idx = _cuda_index(device)
    if idx is None:
        yield
        return
    with _GUARD:
        lock = _LOCKS.setdefault(idx, threading.RLock())
    t0 = time.perf_counter()
    lock.acquire()
    waited = time.perf_counter() - t0
    with _GUARD:
        _lock_wait_s[idx] = _lock_wait_s.get(idx, 0.0) + waited
    try:
        yield
    finally:
        lock.release()


def set_event_timing(on: bool) -> None:
    """Bracket every later replay with CUDA events (off by default)."""
    global _event_timing
    _event_timing = bool(on)
    _events.clear()


def replay_device_ms() -> float:
    """Device milliseconds of the replays timed since the last call (waits
    for them), then forgets them."""
    total = 0.0
    for start, end in _events:
        end.synchronize()
        total += start.elapsed_time(end)
    _events.clear()
    return total


def _node_count(graph) -> int:
    """Nodes of a kept ``cudaGraph_t`` (the driver's ``cuGraphGetNodes``)."""
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    n = ctypes.c_size_t(0)
    err = lib.cuGraphGetNodes(graph.raw_cuda_graph(), None, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes: CUDA driver error {err}")
    return n.value


def _reserved(idx: int) -> int:
    return torch.cuda.memory_stats(idx).get("reserved_bytes.all.current", 0)


def _tensors(out) -> tuple:
    """``fn``'s result as a tuple of tensors (a bare tensor is one)."""
    outs = out if isinstance(out, tuple) else (out,)
    if not all(isinstance(t, torch.Tensor) for t in outs):
        raise TypeError("a captured function must return a tensor or a tuple of tensors")
    return outs


class _Graph:
    """One captured key: the graph, its static inputs and outputs, the
    kernel counts each replay credits, and what its capture cost."""

    __slots__ = ("graph", "inputs", "outputs", "single", "credit", "done",
                 "warmup_s", "capture_s", "instantiate_s", "nodes", "pool_bytes",
                 "replays")

    def record(self) -> dict:
        return {
            "warmup_s": self.warmup_s, "capture_s": self.capture_s,
            "instantiate_s": self.instantiate_s,
            "nodes": self.nodes, "pool_bytes": self.pool_bytes,
            "replays": self.replays,
            "launches": {k: v[0] for k, v in self.credit.items()},
        }


class CapturedProgram:
    """``fn`` (tensors in, a tensor or a tuple of tensors out) captured
    once per key as a CUDA graph and replayed afterwards; see the module
    docstring for the protocol."""

    def __init__(self, fn, name: str | None = None):
        self.fn = fn
        self.name = name or fn.__name__
        self._graphs: dict = {}
        _PROGRAMS.add(self)

    @staticmethod
    def key(args) -> tuple:
        """(device, ((shape, dtype), ...)): the graph's key for ``args``."""
        return (str(args[0].device),
                tuple((tuple(a.shape), str(a.dtype)) for a in args))

    def graph_for(self, *args) -> _Graph | None:
        """The captured graph ``args`` would replay, or None."""
        return self._graphs.get(self.key(args))

    def __call__(self, *args):
        if not args or not all(isinstance(a, torch.Tensor) for a in args):
            raise TypeError(f"{self.name}: every argument must be a tensor")
        devices = {a.device for a in args}
        if all(d.type == "cpu" for d in devices):
            return self.fn(*args)
        if len(devices) != 1:
            raise ValueError(f"{self.name}: arguments lie on {sorted(map(str, devices))}")
        dev = args[0].device
        key = self.key(args)
        with device_lock(dev):
            g = self._graphs.get(key)
            if g is None:
                g = self._capture(args, dev)
                self._graphs[key] = g
                return self._outputs(g, dev)
            return self._replay(g, args, dev)

    def _capture(self, args, dev) -> _Graph:
        idx = _cuda_index(dev)
        side = _side_streams.get(idx)
        if side is None:
            side = _side_streams.setdefault(idx, torch.cuda.Stream(dev))
        g = _Graph()
        g.replays = 0
        # 1. eager warm-up on the side stream
        torch.cuda.synchronize(dev)
        before = kernels.snapshot()
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            ref = _tensors(self.fn(*args))
        torch.cuda.synchronize(dev)
        g.warmup_s = time.perf_counter() - t0
        eager = kernels.since(before)
        # 2. capture over static copies of the arguments
        g.inputs = [a.clone() for a in args]
        torch.cuda.synchronize(dev)
        reserved0 = _reserved(idx)
        g.graph = torch.cuda.CUDAGraph(keep_graph=True)
        snap = kernels.snapshot()
        t0 = time.perf_counter()
        try:
            with torch.cuda.stream(side):
                g.graph.capture_begin(capture_error_mode="global")
                try:
                    out = self.fn(*g.inputs)
                except BaseException:
                    with contextlib.suppress(Exception):
                        g.graph.capture_end()
                    raise
                g.graph.capture_end()
        finally:
            g.credit = kernels.since(snap)
            kernels.restore(snap)
        t1 = time.perf_counter()
        g.graph.instantiate()
        torch.cuda.synchronize(dev)
        g.instantiate_s = time.perf_counter() - t1
        g.capture_s = time.perf_counter() - t0  # the instantiation included
        g.pool_bytes = _reserved(idx) - reserved0
        g.nodes = _node_count(g.graph)
        g.single = not isinstance(out, tuple)
        g.outputs = _tensors(out)
        if g.credit != eager:
            raise GraphCaptureError(
                f"{self.name}: the capture counted launches {g.credit}, the warm-up {eager}")
        # 3. one uncredited replay, held equal to the warm-up
        g.graph.replay()
        torch.cuda.synchronize(dev)
        for i, (o, r) in enumerate(zip(g.outputs, ref)):
            if not torch.equal(o, r):
                raise GraphCaptureError(f"{self.name}: output {i} of the first replay "
                                        "differs from the eager warm-up")
        return g

    def _replay(self, g: _Graph, args, dev):
        stream = torch.cuda.current_stream(dev)
        stream.wait_event(g.done)  # the previous call's reads and clones
        for s, a in zip(g.inputs, args):
            s.copy_(a)
        if _event_timing:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            g.graph.replay()
            end.record(stream)
            _events.append((start, end))
        else:
            g.graph.replay()
        kernels.credit(g.credit)
        g.replays += 1
        return self._outputs(g, dev)

    @staticmethod
    def _outputs(g: _Graph, dev):
        outs = tuple(o.clone() for o in g.outputs)
        g.done = torch.cuda.Event()
        g.done.record(torch.cuda.current_stream(dev))
        return outs[0] if g.single else outs

    def reset(self) -> None:
        """Drop every captured graph of this program."""
        self._graphs.clear()


def status() -> dict:
    """Captured graphs by program and key, the totals of nodes and pool
    bytes, and the seconds callers waited on each device's lock."""
    progs = {}
    nodes = pool = 0
    for p in sorted(_PROGRAMS, key=lambda p: p.name):
        recs = {f"{dev} " + " ".join(
                    "x".join(map(str, shape)) + f":{dtype.split('.')[-1]}"
                    for shape, dtype in sig): g.record()
                for (dev, sig), g in list(p._graphs.items())}
        if recs:
            progs[p.name] = recs
            nodes += sum(r["nodes"] for r in recs.values())
            pool += sum(r["pool_bytes"] for r in recs.values())
    with _GUARD:
        waits = {f"cuda:{i}": s for i, s in sorted(_lock_wait_s.items())}
    return {"programs": progs, "graphs": sum(len(r) for r in progs.values()),
            "nodes": nodes, "pool_bytes": pool, "lock_wait_s": waits}


def reset() -> None:
    """Drop every program's graphs (their pools return to the allocator)."""
    for p in list(_PROGRAMS):
        p.reset()
