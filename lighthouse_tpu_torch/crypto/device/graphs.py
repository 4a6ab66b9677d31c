"""CUDA graphs per argument shape: the port's counterpart of ``jax.jit``.

The JAX package dispatches each stage of its verifier as one compiled XLA
executable per argument shape. The port's stages are plain torch code
around three hand-written kernels; run eagerly, a verify is tens of
thousands of small launches and their host dispatch is most of its wall.
:class:`CapturedProgram` records a function once per key into a
``torch.cuda.CUDAGraph`` and replays it afterwards: one graph launch in
place of the launches it holds.

A graph's key is the device, the active engine triple (:func:`engines`:
the ``fp.mul``, Fp2 and line-step engines, which decide what a capture
records) and each argument's shape and dtype, as jit's cache is keyed. A
call with

* CPU tensors runs ``fn`` eagerly: no graph exists on the CPU (the tests'
  path);
* CUDA tensors, for the first time at its key, under the device's
  capture lock (the key is looked up again under it, so two first calls
  of one key capture once):

  1. runs ``fn`` once eagerly on the capture stream: the warm-up builds
     the kernels (``kernels.build``), loads their modules (no lazy loading
     may happen under capture) and fills the constant caches
     (``fp.on_device``, ``fp.LinMap``). Its launches are real: they are
     counted into a sink of this thread (``kernels.counting_into``) and
     then added to the global counters once. Its wall is the function's
     eager wall;
  2. captures ``fn`` over static copies of the arguments and instantiates
     the graph. The capture is cut into segments of at most
     :data:`SEGMENT_LAUNCHES` kernel launches, each a ``CUDAGraph`` of its
     own in one private pool, replayed in order (see Threads below for
     why). The kernel counts of the capture (no kernel ran) go to a
     second sink and are kept as the graph's credit; they must equal the
     warm-up's;
  3. replays once and holds every output equal to the warm-up's
     (``torch.equal``), uncredited;

* CUDA tensors at a captured key: under that graph's own lock, copies
  each argument into its static input, replays its segments, credits the kernel
  counters (``kernels.credit``), so ``kernels.launches``/``lanes``/
  ``lane_hist`` count per call as an eager run would, and clones the
  outputs.

Outputs are clones owned by the caller: the graph's own output buffers
are overwritten by the next replay of the key. There is no fallback: a
capture, instantiation, check or replay that fails raises, and ``fn``
runs on a CUDA tensor only as the warm-up before its capture.

Threads. Capture uses CUDA's "thread_local" mode: only the capturing
thread is barred from allocating, copying or syncing while it captures.
Other threads go on allocating, copying, replaying other graphs and
syncing their own streams beside it, so a cold key's capture never
stalls a warm key's replay. Two locks remain, neither held across a
batch:

* the capture lock, one per device, held only around one key's warm-up,
  capture, instantiation and check: it serializes captures with one
  another;
* the graph lock, one per captured key, held over the copy-in, replay
  and clone-out of that graph, so two threads replaying one key never
  interleave on its static buffers. A failover dispatch
  (:func:`no_graph_wait`) never waits for it: when another thread holds
  it, the failover runs ``fn`` eagerly on the card. The holder may be a
  dispatch the scheduler's watchdog reaped, which no one can stop, and on
  a mesh with two shards on one card the failover's shard replays the
  same graph.

The order is capture lock, then graph lock (only :func:`reset` takes
both); ``fp``'s fill lock is a leaf taken under neither by traffic. One
wait remains outside these locks: CUDA itself holds back every other
thread's CUDA calls (launches, copies, syncs, on any stream) through the
last part of a graph's instantiation, so a warm call beside a capture
can wait that long (the instantiation is a capture's last step). That
part grows with the graph's nodes, so a capture is cut into segments of
:data:`SEGMENT_LAUNCHES` launches, each instantiated on its own: the wait
is at most one segment's tail. On an NVIDIA H100 80GB HBM3 at 700 W a
stage-3 graph of 38,700 nodes took 1.9-3.6 s to instantiate whole and
held a warm verify beside it for up to 1.5 s; in 7 segments it
instantiates in 0.6-1.0 s, the longest segment 0.26 s, and no warm verify
beside a capture took more than 0.24 s (``chip_smoke.py`` phases 9-10).
The capture stream is a pool stream, which CUDA creates non-blocking, so
no other thread's work joins it through the legacy default stream, and the
caching allocator sends only that stream's allocations to the graph's
private pool. :func:`status` reports the seconds callers waited on each
kind of lock, and per graph its capture seconds, eager warm-up seconds,
node count (the launches captured, through ``cuGraphGetNodes``, summed
over its segments), segment count and longest segment instantiation,
pool bytes (the segments of its private pool in the allocator's
snapshot) and lock waits.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
import time
import weakref

import torch

from . import fp, fp2, kernels, pairing


class GraphCaptureError(RuntimeError):
    """A capture whose replay or launch counts disagree with its eager
    warm-up."""


_CAPTURE_LOCKS: dict = {}    # device index -> RLock (serializes captures)
_lock_wait_s: dict = {}      # ("capture" | "graph", device index) -> seconds waited
_GUARD = threading.Lock()
_PROGRAMS: "weakref.WeakSet[CapturedProgram]" = weakref.WeakSet()
_side_streams: dict = {}     # device index -> the capture stream
_busy_eager: dict = {}       # device index -> failover calls run eagerly beside a busy graph
_tls = threading.local()     # .no_wait: this thread is a failover dispatch

# Kernel launches per captured segment: about 1,000 graph nodes in stage 1
# and 5,500 in stage 3 (the torch ops between launches included).
SEGMENT_LAUNCHES = 256

# Opt-in device timing of replays (CUDA events around each one): a graph's
# device time, the gaps between its nodes included.
_event_timing = False
_events: list = []


def engines() -> tuple:
    """The active engine triple (fp, fp2, line): ``fp.get_impl()``,
    ``fp2.get_impl()`` and ``pairing.get_line_impl()``. Part of every
    graph's key, so a graph captured under one engine is never replayed
    under another."""
    return (fp.get_impl(), fp2.get_impl(), pairing.get_line_impl())


def _cuda_index(device) -> int | None:
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return dev.index if dev.index is not None else torch.cuda.current_device()


@contextlib.contextmanager
def _waited(lock, kind: str, idx: int, g=None):
    """Hold ``lock``; the seconds spent waiting for it add to
    :func:`status` under ``kind`` (and to graph ``g``'s record)."""
    t0 = time.perf_counter()
    lock.acquire()
    waited = time.perf_counter() - t0
    with _GUARD:
        _lock_wait_s[(kind, idx)] = _lock_wait_s.get((kind, idx), 0.0) + waited
        if g is not None:
            g.lock_wait_s += waited
    try:
        yield
    finally:
        lock.release()


def _capture_lock(idx: int):
    with _GUARD:
        return _CAPTURE_LOCKS.setdefault(idx, threading.RLock())


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


def _pool_bytes(pool) -> int:
    """Bytes of the allocator's segments in the private pool ``pool``
    (exact whatever other threads allocate meanwhile)."""
    pool = tuple(pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == pool)


def _tensors(out) -> tuple:
    """``fn``'s result as a tuple of tensors (a bare tensor is one)."""
    outs = out if isinstance(out, tuple) else (out,)
    if not all(isinstance(t, torch.Tensor) for t in outs):
        raise TypeError("a captured function must return a tensor or a tuple of tensors")
    return outs


class _Segments:
    """A capture cut into ``CUDAGraph`` segments: begins the first, and
    after every :data:`SEGMENT_LAUNCHES`-th kernel launch (the sink's
    ``on_launch``) ends the open segment and begins the next on the same
    stream and private pool, so the segments replayed in order do what
    one graph would."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: list = []
        self.launches = 0
        self._begin()

    def _begin(self) -> None:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        self.graphs.append(graph)

    def on_launch(self) -> None:
        self.launches += 1
        if self.launches % SEGMENT_LAUNCHES == 0:
            self.graphs[-1].capture_end()
            self._begin()

    def end(self) -> list:
        """End the open segment; the segments that hold nodes."""
        self.graphs[-1].capture_end()
        return [gr for gr in self.graphs if _node_count(gr)]


class _Graph:
    """One captured key: its graph segments, its static inputs and
    outputs, the kernel counts each replay credits, its lock, and what its
    capture cost."""

    __slots__ = ("segments", "inputs", "outputs", "single", "credit", "done", "lock",
                 "warmup_s", "capture_s", "instantiate_s", "instantiate_max_s", "nodes",
                 "pool_bytes", "replays", "lock_wait_s", "steps")

    def __init__(self):
        self.lock = threading.Lock()
        self.replays = 0
        self.lock_wait_s = 0.0
        self.done = None

    def record(self) -> dict:
        return {
            "warmup_s": self.warmup_s, "capture_s": self.capture_s,
            "instantiate_s": self.instantiate_s,
            "instantiate_max_s": self.instantiate_max_s, "segments": len(self.segments),
            "nodes": self.nodes, "pool_bytes": self.pool_bytes,
            "replays": self.replays, "lock_wait_s": self.lock_wait_s,
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
        """(device, engine triple, ((shape, dtype), ...)): the graph's key
        for ``args`` under the active engines."""
        return (str(args[0].device), engines(),
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
        idx = _cuda_index(dev)
        key = self.key(args)
        g = self._graphs.get(key)
        if g is None:
            with _waited(_capture_lock(idx), "capture", idx):
                g = self._graphs.get(key)  # another thread may have captured it
                if g is None:
                    g = self._capture(args, dev, idx)
                    with g.lock:  # published only with its first outputs cloned
                        self._graphs[key] = g
                        return self._outputs(g, dev)
        return self._replay(g, args, dev, idx)

    def _capture(self, args, dev, idx: int) -> _Graph:
        side = _side_streams.get(idx)
        if side is None:  # a pool stream: non-blocking
            side = _side_streams.setdefault(idx, torch.cuda.Stream(dev))
        caller = torch.cuda.current_stream(dev)
        g = _Graph()
        side.wait_stream(caller)  # the arguments are ready
        with torch.cuda.stream(side):
            # 1. eager warm-up: real launches, counted apart, then credited
            t = [time.perf_counter()]
            with kernels.counting_into() as eager:
                ref = _tensors(self.fn(*args))
            side.synchronize()
            t.append(time.perf_counter())
            g.warmup_s = t[1] - t[0]
            kernels.credit(eager)
            # 2. capture over static copies of the arguments
            g.inputs = [a.clone() for a in args]
            t.append(time.perf_counter())
            seg = _Segments()
            with kernels.counting_into(seg.on_launch) as g.credit:
                try:
                    out = self.fn(*g.inputs)
                except BaseException:
                    with contextlib.suppress(Exception):
                        seg.graphs[-1].capture_end()
                    raise
                g.segments = seg.end()
            t.append(time.perf_counter())
            each = []
            for graph in g.segments:  # one at a time: other threads wait on one tail
                t0 = time.perf_counter()
                graph.instantiate()
                each.append(time.perf_counter() - t0)
            t.append(time.perf_counter())
            g.instantiate_s = t[4] - t[3]
            g.instantiate_max_s = max(each, default=0.0)
            g.capture_s = t[4] - t[2]  # the instantiation included
            g.pool_bytes = _pool_bytes(seg.pool)
            g.nodes = sum(_node_count(graph) for graph in g.segments)
            t.append(time.perf_counter())
            g.single = not isinstance(out, tuple)
            g.outputs = _tensors(out)
            if g.credit != eager:
                raise GraphCaptureError(
                    f"{self.name}: the capture counted launches {g.credit}, the warm-up {eager}")
            # 3. one uncredited replay, held equal to the warm-up
            for graph in g.segments:
                graph.replay()
            side.synchronize()
            for i, (o, r) in enumerate(zip(g.outputs, ref)):
                if not torch.equal(o, r):
                    raise GraphCaptureError(f"{self.name}: output {i} of the first replay "
                                            "differs from the eager warm-up")
        caller.wait_stream(side)
        t.append(time.perf_counter())
        # host-clock spans of the steps, to place a capture beside other work
        g.steps = dict(zip(("warmup", "copy", "capture", "instantiate", "inspect", "check"),
                           zip(t, t[1:])))
        return g

    def _replay(self, g: _Graph, args, dev, idx: int):
        if getattr(_tls, "no_wait", False):
            # a failover: the holder may be a reaped dispatch that never
            # lets go, so a busy graph runs eagerly on the card instead
            if not g.lock.acquire(blocking=False):
                with _GUARD:
                    _busy_eager[idx] = _busy_eager.get(idx, 0) + 1
                return self.fn(*args)
            try:
                return self._replay_locked(g, args, dev)
            finally:
                g.lock.release()
        with _waited(g.lock, "graph", idx, g):
            return self._replay_locked(g, args, dev)

    def _replay_locked(self, g: _Graph, args, dev):
        stream = torch.cuda.current_stream(dev)
        stream.wait_event(g.done)  # the previous call's reads and clones
        for s, a in zip(g.inputs, args):
            s.copy_(a)
        if _event_timing:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            for graph in g.segments:
                graph.replay()
            end.record(stream)
            _events.append((start, end))
        else:
            for graph in g.segments:
                graph.replay()
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
        """Drop every captured graph of this program, once no capture runs
        and each graph's last replay has finished on the card."""
        with _all_capture_locks():
            for g in list(self._graphs.values()):
                with g.lock:
                    if g.done is not None:
                        g.done.synchronize()
            self._graphs.clear()


@contextlib.contextmanager
def _all_capture_locks():
    with _GUARD:
        locks = [_CAPTURE_LOCKS[i] for i in sorted(_CAPTURE_LOCKS)]
    with contextlib.ExitStack() as stack:
        for lock in locks:
            stack.enter_context(lock)
        yield


def status() -> dict:
    """Captured graphs by program and key, the totals of nodes and pool
    bytes, the seconds callers waited on each device's capture lock and on
    its graphs' locks, and the failover calls run eagerly beside a busy
    graph."""
    progs = {}
    nodes = pool = 0
    for p in sorted(_PROGRAMS, key=lambda p: p.name):
        recs = {f"{dev} {'/'.join(eng)} " + " ".join(
                    "x".join(map(str, shape)) + f":{dtype.split('.')[-1]}"
                    for shape, dtype in sig): g.record()
                for (dev, eng, sig), g in list(p._graphs.items())}
        if recs:
            progs[p.name] = recs
            nodes += sum(r["nodes"] for r in recs.values())
            pool += sum(r["pool_bytes"] for r in recs.values())
    with _GUARD:
        waits = {kind: {f"cuda:{i}": s for (k, i), s in sorted(_lock_wait_s.items())
                        if k == kind}
                 for kind in ("capture", "graph")}
        busy = {f"cuda:{i}": n for i, n in sorted(_busy_eager.items())}
    return {"programs": progs, "graphs": sum(len(r) for r in progs.values()),
            "nodes": nodes, "pool_bytes": pool, "lock_wait_s": waits,
            "failover_eager": busy}


@contextlib.contextmanager
def no_graph_wait():
    """This thread's calls are a failover dispatch while the block runs: a
    captured key whose graph lock another thread holds runs ``fn``
    eagerly (its launches counted as any eager call's) instead of waiting
    for the lock; :func:`status` counts them under ``failover_eager``."""
    prev = getattr(_tls, "no_wait", False)
    _tls.no_wait = True
    try:
        yield
    finally:
        _tls.no_wait = prev


def reset() -> None:
    """Drop every program's graphs (their pools return to the allocator),
    under every capture lock and each graph's lock."""
    with _all_capture_locks():
        for p in list(_PROGRAMS):
            p.reset()
