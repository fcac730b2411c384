"""CUDA graphs of a chunk of decode steps: the port's counterpart of the
compiled ``lax.while_loop`` in the JAX package's ``greedy_decode_jit``
(and ``beam_decode_jit``, ``greedy_timestamps_jit``).

``ChunkGraphs`` captures ``fn(n)``, a function that runs n decode steps
reading and writing only static tensors (no host value per step), once
per step count n, and replays it.  Before each capture it runs ``fn(n)``
eagerly on the capture's own side stream, so one-time host work (building
and loading the kernel libraries, ``cudaFuncSetAttribute`` behind the
entry points' ``static`` flags, cuBLAS handles and workspaces) never first
happens inside a capture; ``reset()`` puts the state back in bounds before
that run.  The caller re-initialises its state after the capture.

A replay issues no Python call, so no wrapper would count its launches:
while a capture runs, the wrappers of the capturing thread count into the
capture's own record (``spans.recording``; nothing launches then), which
every replay adds to the replaying thread's launch sink (``spans.add``).
So a count stays what each wrapper's count means, the kernel launches that
ran, also when another thread launches kernels during a capture.

The sampling generator, where the chunk draws random numbers (the
greedy and sampled chunks; a beam or timestamp chunk draws none and passes
None), is registered with every graph, so a replay draws
from its state at the time of the replay and advances it as the eager
chunk would: re-seeding it before a loop gives the eager chunk's random
numbers.  All graphs of one owner share one memory pool; they are replayed
one at a time, on one stream.  Captures are made one at a time in the
process (``torch.cuda.graph`` empties the allocator's cache as it starts,
which must not happen while another thread captures); replays and other
work of other threads go on meanwhile.  A failed capture or replay raises.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, Optional

import torch

from ..spans import add, recording, span

_capture_lock = threading.Lock()


class ChunkGraphs:
    """Captured chunks of one set of static buffers, by step count n.
    ``launch_delta[n]``: the kernel launches one replay of n steps makes,
    by (kernel, shape); ``replays[n]``: replays so far; ``capture_s``: host
    seconds spent in warm-up runs and captures.  Holds no reference to
    the function it captures, so the buffers' owner is freed with no
    cycle to collect."""

    def __init__(self, device: torch.device,
                 generator: Optional[torch.Generator], pool):
        self._generator = generator
        self._pool = pool
        self._stream = torch.cuda.Stream(device)
        self.graphs: Dict[int, torch.cuda.CUDAGraph] = {}
        self.launch_delta: Dict[int, collections.Counter] = {}
        self.replays: collections.Counter = collections.Counter()
        self.capture_s = 0.0

    def capture(self, n: int, fn: Callable[[int], None],
                reset: Callable[[], None]) -> None:
        """Warm ``fn(n)`` up eagerly after ``reset()``, then capture it."""
        with span("graphs.capture"):
            t0 = time.perf_counter()
            current = torch.cuda.current_stream(self._stream.device)
            reset()
            self._stream.wait_stream(current)
            with torch.cuda.stream(self._stream):
                fn(n)
            current.wait_stream(self._stream)
            graph = torch.cuda.CUDAGraph()
            if self._generator is not None:
                graph.register_generator_state(self._generator)
            # thread_local: CUDA calls of other threads (another decoder's
            # loop) may go on while this thread captures
            with _capture_lock, recording() as delta, \
                    torch.cuda.graph(graph, pool=self._pool,
                                     stream=self._stream,
                                     capture_error_mode="thread_local"):
                fn(n)
            self.graphs[n] = graph
            self.launch_delta[n] = delta
            self.capture_s += time.perf_counter() - t0

    def replay(self, n: int) -> None:
        self.graphs[n].replay()
        add(self.launch_delta[n])
        self.replays[n] += 1
