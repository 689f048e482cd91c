"""Step graphs: a loop body captured once as a CUDA graph and replayed.

The reference runs each of its loops (the auction rounds, the Statement
steps, the joint tiers) as one compiled `lax.while_loop` on the device.
PyTorch launches every operation of a body from the host, 435 to 609
device operations a round or step, each a few tens of µs of host time.
Here a loop call captures each kind of body once as a CUDA graph
(`torch.cuda.CUDAGraph`) and replays it: one launch a body.

A loop owns static buffers for everything its body reads and writes
across iterations (the state's tensors and, for a Statement step, the
carry): it copies its inputs in once at the start and out once at the
end, and a functional body writes its outputs back into them inside the
graph.  The host reads one small vector between replays (an auction
chunk's `[done, rounds]`, a step's flags, kernel K12's read), which is
what decides the next replay.

`StepGraphs.run(key, body)`:

* on the CPU, or for the eager form (`eager_graphs`, which chip_smoke's
  Recorder installs so that every kernel call goes through its Python
  wrapper, where it is recorded and counted), runs `body` eagerly;
* on the card, runs the first body of each `key` eagerly, on the capture
  stream: it warms everything that reads the host once and keeps the
  answer (the `state.aux` flags, the snapshot's task words and segment
  indexes, K3's `plan(T)`, the kernels' shared-memory opt-ins) and
  allocates the per-stream scratches for the capture stream (below).  The
  second run of a key captures the body into a graph and replays it;
  every later run replays.  A capture or replay that fails raises:
  nothing falls back to eager launches.  A loop that ends within its
  first body captures nothing; the graphs die with the loop call
  (`close`).  All graphs capture into one memory pool per card
  (`pool_for`), kept for the process: the graphs of a loop call share
  it, and once they are gone a later loop call's graphs reuse its blocks
  instead of allocating new device memory.

Per-stream scratches.  K3 `apply`'s float64 scratch and K3 `resolve`'s
row scratch (`kernels/resolve.py`) are kept per (device, stream).  A
graph bakes in the pointers of the capture stream's, allocated by the
eager first body on that stream, and its replays run on the caller's
stream.  `apply`'s scratch is zero between calls (the block that
completes a node's run clears its entries), so every replay of every
graph leaves it as it found it; graphs of one loop replay one after
another on one stream, never at once, so no two launches share it in
flight; an eager call on the caller's stream uses that stream's own.
`resolve`'s scratch is written before it is read in every launch.
"""

from __future__ import annotations

import ctypes
import time

import torch

#: the longest chunk of auction rounds between two host reads on the card
#: (chunks grow 1, 2, 4, ... up to it); at most CHUNK_CAP − 1 gated rounds
#: run past the fixed point.  The eager form reads after every round.
CHUNK_CAP = 8

#: when true, every replay is bracketed by a pair of CUDA events and
#: `totals["replay_ms"]` gains the device time between them (chip_smoke's
#: idle share; two event records a replay)
TIME_REPLAYS = False

#: what the loop calls of this process ran, captured and replayed
#: (chip_smoke's `step-graphs` lines); `reset_totals()` clears it
totals: dict = {}


def reset_totals() -> None:
    totals.clear()
    totals.update(loops=0, captured=0, replays=0, eager=0, reads=0, nodes={},
                  capture_ms=0.0, chunk_cap=0, replay_ms=0.0)


reset_totals()

_streams: dict = {}
_pools: dict = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream graphs of `device` are captured on (one per card, kept)."""
    s = _streams.get(device.index)
    if s is None:
        s = _streams[device.index] = torch.cuda.Stream(device)
    return s


def pool_for(device: torch.device):
    """The graph memory pool of `device` (one per card, kept).  A pool
    lives while a graph holds it, and one whose last graph is gone may
    not be captured into again; so a one-node graph captured into it
    first is kept with it, and the loop calls' graphs come and go."""
    got = _pools.get(device.index)
    if got is None:
        pool = torch.cuda.graph_pool_handle()
        anchor = torch.cuda.CUDAGraph()
        s = capture_stream(device)
        s.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(s):
            anchor.capture_begin(pool=pool, capture_error_mode="thread_local")
            torch.zeros(1, device=device)
            anchor.capture_end()
        got = _pools[device.index] = (pool, anchor)
    return got[0]


_libcuda = None


def graph_nodes(g: torch.cuda.CUDAGraph) -> int | None:
    """The nodes of a graph captured with `keep_graph=True`
    (cuGraphGetNodes; None if it fails)."""
    global _libcuda
    raw = g.raw_cuda_graph()
    if _libcuda is None:
        _libcuda = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    err = _libcuda.cuGraphGetNodes(ctypes.c_void_p(raw), None, ctypes.byref(n))
    return int(n.value) if err == 0 else None


class StepGraphs:
    """The captured bodies of one loop call (see the module docstring).
    `chunk_cap` is the longest run of auction rounds between two reads."""

    def __init__(self, device, eager: bool, chunk_cap: int) -> None:
        self.device = torch.device(device)
        self.eager = eager
        self.chunk_cap = chunk_cap
        self.graphs: dict = {}
        self.warm: set = set()
        self.events = [] if TIME_REPLAYS and not eager else None
        totals["loops"] += 1
        totals["chunk_cap"] = max(totals["chunk_cap"], chunk_cap)

    def run(self, key, body) -> None:
        if self.eager:
            body()
            totals["eager"] += 1
            return
        if key not in self.warm:
            self.warm.add(key)
            self._on_capture_stream(body)
            totals["eager"] += 1
            return
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._capture(key, body)
        if self.events is None:
            g.replay()
        else:
            ends = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ends[0].record()
            g.replay()
            ends[1].record()
            self.events.append(ends)
        totals["replays"] += 1

    def read(self, t: torch.Tensor) -> list:
        """The host read between replays: `t` as a list."""
        totals["reads"] += 1
        return t.tolist()

    def _on_capture_stream(self, body) -> None:
        s = capture_stream(self.device)
        cur = torch.cuda.current_stream(self.device)
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            body()
        cur.wait_stream(s)

    def _capture(self, key, body) -> torch.cuda.CUDAGraph:
        t0 = time.perf_counter()
        g = torch.cuda.CUDAGraph(keep_graph=True)    # kept to count its nodes
        s = capture_stream(self.device)
        cur = torch.cuda.current_stream(self.device)
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            # thread_local: another thread's CUDA calls do not void it
            g.capture_begin(pool=pool_for(self.device), capture_error_mode="thread_local")
            try:
                body()
            except BaseException:
                try:
                    g.capture_end()
                except RuntimeError:
                    pass
                raise
            g.capture_end()
        cur.wait_stream(s)
        g.instantiate()
        totals["captured"] += 1
        # nodes by the body's kind (a key's last part)
        kind = key[-1] if isinstance(key, tuple) else key
        totals["nodes"].setdefault(kind, []).append(graph_nodes(g))
        totals["capture_ms"] += (time.perf_counter() - t0) * 1e3
        return g

    def close(self) -> None:
        """Drop the graphs (their blocks go back to the card's pool) and
        add the replays' device time to `totals` when they were timed."""
        self.graphs.clear()
        if self.events:
            self.events[-1][1].synchronize()
            totals["replay_ms"] += sum(a.elapsed_time(b) for a, b in self.events)
            self.events.clear()


def eager_graphs(device) -> StepGraphs:
    """Every body eagerly, one auction round a read (the CPU's form)."""
    return StepGraphs(device, eager=True, chunk_cap=1)


def loop_graphs(device) -> StepGraphs:
    """The step graphs of one loop call: captured on the card, eager on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return eager_graphs(device)
    return StepGraphs(device, eager=False, chunk_cap=CHUNK_CAP)
