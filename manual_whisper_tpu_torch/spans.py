"""Program spans: the time and count of each host phase of a
transcription, per thread, and on a ``torch.profiler`` trace's clock.

``span(name)`` times a phase with ``time.perf_counter_ns`` and, when the
calling thread is bound (``bind``), adds its seconds and 1 into that
thread's sink: ``TranscribePipeline.last_stats["spans"][role][name] =
[seconds, count]``, with the role ``dispatch`` for the calling thread and
``fetch`` for the pipeline's fetch worker.  While a profiler is recording
it also opens ``record_function("mwx." + name)``, so the phase appears
beside the device's work on the trace's clock; with no profiler that call
is never made (it costs several microseconds even then).  A span carries
no parent: it nests in whatever span is open on its thread.  Only the
root, ``pipeline.transcribe``, carries an argument, the request's number
in the process.

Spans sit at layer boundaries on the host, never inside a function that
``ChunkGraphs`` captures nor inside per-step code, and none stays open
across a ``yield``.  ``SPANS`` names every span with the layer it
belongs to; readers and tests take the names from here.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from torch.autograd import profiler as _profiler

SPANS = (
    ("pipeline.transcribe", "pipeline/transcribe.py: the request (root)"),
    ("vad.pyannet", "models/vad.py: a block's PyanNet forward and its "
                    "probabilities on the host"),
    ("vad.segments", "pipeline/transcribe.py: a block's binarize and "
                     "merge_chunks"),
    ("chunks.batch", "pipeline/chunking.py: windows cut and padded on the "
                     "host"),
    ("encode.prep", "pipeline/transcribe.py: float to int16 on the host"),
    ("encode.upload", "pipeline/transcribe.py: int16 windows to the device, "
                      "as float"),
    ("encode.launch", "ops/mel.py and models/whisper.py: K1 and the "
                      "encoder's launches"),
    ("encode.wait", "pipeline/transcribe.py: the wait for the encode"),
    ("decode.loop", "models/decode.py: a whole decode loop"),
    ("decode.prepare", "models/decode.py: prefix, loop lookup, the prefix "
                       "tensor to the device"),
    ("decode.cross_kv", "models/decode.py: cross K/V launches"),
    ("decode.prefill", "models/decode.py: prefill and the first token"),
    ("decode.finish_check", "models/decode.py: the host waiting on the "
                            "device to test that every row finished"),
    ("decode.replay", "models/decode.py, models/graphs.py: one chunk, "
                      "replayed (or eager)"),
    ("decode.fetch", "models/decode.py: result copies enqueued (gathered "
                     "with a mesh)"),
    ("inflight.wait", "pipeline/transcribe.py: dispatch held at the "
                      "in-flight window"),
    ("finalize.batch", "pipeline/transcribe.py: one batch's finalize"),
    ("finalize.wait", "models/decode.py: the wait for a loop's results"),
    ("finalize.text", "models/decode.py: tokens to text and the gates"),
    ("finalize.retry", "models/decode.py: one rung of the fallback ladder"),
    ("graphs.capture", "models/graphs.py: one capture of a chunk"),
)
NAMES = tuple(name for name, _ in SPANS)

_local = threading.local()


class bind:
    """``with bind(sink, role):`` the spans this thread closes add into
    ``sink[role]`` (made if absent); the binding before is restored on
    exit.  One thread writes each role's dict."""

    __slots__ = ("_sink", "_before")

    def __init__(self, sink: Dict[str, Dict[str, List]], role: str):
        self._sink = sink.setdefault(role, {})

    def __enter__(self) -> Dict[str, List]:
        self._before = getattr(_local, "sink", None)
        _local.sink = self._sink
        return self._sink

    def __exit__(self, *exc) -> None:
        _local.sink = self._before


class span:
    """``with span(name):`` one phase; see the module docstring."""

    __slots__ = ("name", "args", "_t0", "_annotation")

    def __init__(self, name: str, args: Optional[str] = None):
        self.name = name
        self.args = args

    def __enter__(self) -> "span":
        self._t0 = time.perf_counter_ns()
        self._annotation = None
        if _profiler._is_profiler_enabled:
            self._annotation = _profiler.record_function("mwx." + self.name,
                                                         self.args)
            self._annotation.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        sink = getattr(_local, "sink", None)
        if sink is not None:
            seconds = (time.perf_counter_ns() - self._t0) * 1e-9
            cell = sink.get(self.name)
            if cell is None:
                sink[self.name] = [seconds, 1]
            else:
                cell[0] += seconds
                cell[1] += 1
