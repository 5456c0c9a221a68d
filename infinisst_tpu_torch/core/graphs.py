"""Device programs captured as CUDA graphs: the torch counterpart of a
``jax.jit`` function's compiled executable.

A ``DeviceProgram`` is a set of named pieces, each a function of no
arguments that reads and writes only static tensors (buffers allocated
before the first call and updated in place, never rebound), so that a
replay on the same addresses computes what a call would.  On CUDA the
program's first pass runs every piece eagerly on the capture stream (the
warm-up: the kernels' split-K counters, cuBLAS handles and the cached RoPE
tables are made there, before any capture), then each piece is captured
as one ``torch.cuda.CUDAGraph``; later passes replay them.  The graphs of
every program an owner makes share one memory pool: only temporaries live
there (everything that crosses pieces lives in the static buffers), and
the pieces replay one after another on one stream.  A pool made with
``warm_inside`` also takes its programs' warm-ups, whose temporaries then
reuse the blocks where the graphs captured before keep theirs (a train
step's warm-up is a whole step's activations and gradients, which beside
the pool would not fit a card at stage 2); a warm-up there must leave
nothing allocated once the pool holds a graph, or a replay of that graph
would overwrite it, and it raises if it does.  The decoders' pools keep
their warm-ups outside: a warm-up there makes lasting tables (a kernel's
split-K counters for a new shape).  On the CPU, where
CUDA graphs do not exist, the same pieces run as they are.

A failed capture or replay raises; nothing runs eagerly in its place.
A capture holds only its own thread to CUDA's rules for capture
(``capture_error_mode="thread_local"``): under the default "global" mode a
host allocation that another thread makes meanwhile (the trainer's loader
pins its batches in a thread of its own) voids the capture, depending on
timing.

A piece that draws random numbers names its generator (``generators``):
the generator is registered with that piece's graph, so that a replay
draws what a call from the generator's current state would (reseeding it
between passes holds), and advances it as the call would.

Launch counting survives replay: the dicts of counts that the kernel
wrappers and the model keep (their launches, the forward passes) grow
only where a wrapper runs, which a replay never does.  Their modules
register them here (``counter``).  A capture records what each piece
added to them, takes it back (nothing ran), and every replay adds it
again; the warm-up's extra calls (below) take theirs back too.

Host reads: ``read`` is the one way a program's caller reads a device
value.  Under ``strict_syncs`` (a private hook for checks) a pass runs
with ``torch.cuda.set_sync_debug_mode("error")``, lifted only inside
``read``: any other synchronisation raises.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Callable, Dict, List, Optional, Tuple

import torch

# set by ``strict_syncs``: passes run under sync debug mode "error"
_STRICT = False
# the designated host reads made so far (``read``), for checks
host_reads = 0


@contextlib.contextmanager
def strict_syncs():
    """Within: every ``DeviceProgram`` pass on CUDA runs under
    ``torch.cuda.set_sync_debug_mode("error")``, except inside ``read``."""
    global _STRICT
    prev, _STRICT = _STRICT, True
    try:
        yield
    finally:
        _STRICT = prev


# the registered dicts of counts (``counter``)
_counters: List[dict] = []


def counter(counts: dict) -> dict:
    """Register ``counts``, a module's dict of launch or forward counts
    that grows where a wrapper runs, so that replays keep it true.
    Returns it."""
    _counters.append(counts)
    return counts


Counts = List[Tuple[dict, dict]]  # (a registered dict, its values)


def _snapshot() -> Counts:
    return [(d, dict(d)) for d in _counters]


def _restore(snap: Counts):
    for d, s in snap:
        d.clear()
        d.update(s)


def _delta(snap: Counts) -> Counts:
    return [(d, {k: v - s.get(k, 0) for k, v in d.items()
                 if v != s.get(k, 0)}) for d, s in snap]


def _add(delta: Counts):
    for d, dd in delta:
        for k, v in dd.items():
            d[k] = d.get(k, 0) + v


def read(t: torch.Tensor) -> list:
    """``t.tolist()``: a designated host read (the only synchronisation a
    pass may make under ``strict_syncs``)."""
    global host_reads
    host_reads += 1
    if not (_STRICT and t.is_cuda):
        return t.tolist()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        return t.tolist()
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def put(dst, src):
    """Write the tensors of state ``src`` into the static buffers of
    ``dst`` (the same NamedTuple type), skipping those it already holds."""
    for d, s in zip(dst, src):
        if d.data_ptr() != s.data_ptr():
            d.copy_(s)


class GraphPool:
    """One memory pool and one capture stream for the programs of one
    owner (an agent, a serving engine, a trainer) on one card;
    ``warm_inside``: the programs' warm-ups allocate in the pool too (the
    module note)."""

    def __init__(self, device: torch.device, warm_inside: bool = False):
        self.device = device
        self.handle = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.warm_inside = warm_inside
        self.holds_graphs = False

    def _index(self) -> int:
        i = self.device.index
        return torch.cuda.current_device() if i is None else i

    def route_begin(self) -> Optional[int]:
        """With ``warm_inside``: from now on every allocation on the card
        (the autograd engine's thread's too) is made in the pool, which
        this holds a reference to until ``unref``; returns the bytes
        allocated before.  None otherwise."""
        if not self.warm_inside:
            return None
        # while allocations are routed, one that fails cannot give cached
        # blocks back and retry: give them back first
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated(self._index())
        torch._C._cuda_beginAllocateToPool(self._index(), self.handle)
        return before

    def route_end(self, before: Optional[int]) -> int:
        """Stop ``route_begin``'s routing; returns the bytes allocated since
        it that are still alive."""
        if before is None:
            return 0
        torch._C._cuda_endAllocateToPool(self._index(), self.handle)
        gc.collect()  # what only a cycle keeps will not be read again
        return torch.cuda.memory_allocated(self._index()) - before

    def unref(self, before: Optional[int]):
        """Drop ``route_begin``'s reference to the pool (after a capture
        took its own)."""
        if before is not None:
            torch._C._cuda_releasePool(self._index(), self.handle)


class DeviceProgram:
    """Named pieces (see the module note), captured on CUDA when
    ``pool`` is given, run as they are otherwise.

    A pass: ``with program.step():`` around ``run(name)`` for the pieces
    in the caller's order (host decisions between them only through
    ``read``).  The first pass with a pool is the warm-up; at its end
    every piece that did not run in it runs once more (a piece must
    tolerate that: it writes only scratch that the next pass starts
    afresh; its counts are taken back), and all are captured."""

    def __init__(self, pieces: Dict[str, Callable[[], None]],
                 pool: "GraphPool | None" = None,
                 generators: Optional[Dict[str, List[torch.Generator]]]
                 = None):
        self.pieces = dict(pieces)
        self.pool = pool
        self.generators = dict(generators or {})  # by piece (module note)
        self.graphs: Dict[str, torch.cuda.CUDAGraph] = {}
        self.deltas: Dict[str, Counts] = {}
        self.replays = 0  # passes that replayed the captured pieces
        self._ran = set()

    @property
    def captured(self) -> bool:
        return bool(self.graphs)

    @contextlib.contextmanager
    def step(self):
        """One pass: the body calls ``run`` for the pieces in its order.
        On an error nothing is captured and the error propagates."""
        with contextlib.ExitStack() as stack:
            if self.captured:
                if _STRICT:
                    prev = torch.cuda.get_sync_debug_mode()
                    torch.cuda.set_sync_debug_mode("error")
                    stack.callback(torch.cuda.set_sync_debug_mode, prev)
                yield
                self.replays += 1
                return
            if self.pool is None:
                yield
                return
            # the warm-up pass runs on the capture stream
            s = self.pool.stream
            s.wait_stream(torch.cuda.current_stream(self.pool.device))
            before = self.pool.route_begin()
            try:
                try:
                    with torch.cuda.stream(s):
                        yield
                        for name, fn in self.pieces.items():
                            if name not in self._ran:
                                # its warm-up: only scratch is written, and
                                # the pass's counts stay those of the
                                # pieces it ran
                                snap = _snapshot()
                                fn()
                                _restore(snap)
                finally:
                    kept = self.pool.route_end(before)
                torch.cuda.current_stream(self.pool.device).wait_stream(s)
                if kept > 0 and self.pool.holds_graphs:
                    raise RuntimeError(
                        f"a warm-up inside the graph pool left {kept} bytes "
                        "allocated, where a captured graph keeps its "
                        "temporaries")
                self._capture()
            finally:
                self.pool.unref(before)
            self.pool.holds_graphs = True

    def run(self, name: str):
        if self.captured:
            self.graphs[name].replay()
            _add(self.deltas[name])
            return
        self.pieces[name]()
        self._ran.add(name)

    def _capture(self):
        graphs, deltas = {}, {}
        for name, fn in self.pieces.items():
            snap = _snapshot()
            g = torch.cuda.CUDAGraph()
            for gen in self.generators.get(name, ()):
                g.register_generator_state(gen)
            try:
                # "thread_local": the capturing thread may make no unsafe
                # call, and another thread of the process (a trainer's
                # loader pinning its next batch) does not void the capture
                with torch.cuda.graph(g, pool=self.pool.handle,
                                      stream=self.pool.stream,
                                      capture_error_mode="thread_local"):
                    fn()
                deltas[name] = _delta(snap)
            finally:
                _restore(snap)  # a capture launches nothing
            graphs[name] = g
        self.graphs, self.deltas = graphs, deltas
