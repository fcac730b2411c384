"""The benchmark's own spans and counters around calls into the program.

Each tap wraps one entry of the program for the length of a run and
changes nothing it passes through:

- ``TranscribePipeline.transcribe``: one request record (thread, start,
  end, ``last_stats``); what the other taps see on the calling thread is
  filed under it, and so is what its decoder's fetch worker finalizes;
- ``TranscribePipeline._encode_windows``: an ``encode`` span;
- ``VoiceActivityDetector.iter_speech_probs``: a ``vad`` span per block,
  and the request's speech probabilities (the last block's);
- ``pipeline.transcribe.batch_chunks``: the windows (start, end) of each
  batch, in dispatch order;
- ``BatchDecoder.decode_submit``: a ``decode`` span with its rows and the
  positions the loop ran;
- ``BatchDecoder.decode_with_fallback``: the tokens served for each
  window of the batch, and their average log-probability;
- ``ChunkGraphs.capture`` and the kernel builds (``ops._build.build_logs``,
  ``audio.native``'s libraries): counts, so that a run can show that
  nothing was captured or compiled inside its window.

With ``annotate`` each span is also a ``torch.profiler`` user annotation
(``mwx.<name>``), so that a trace can tell what the host was doing.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List, Optional


class Taps:
    def __init__(self):
        self.requests: List[Dict[str, Any]] = []
        self.spans: List[tuple] = []        # (name, thread, t0, t1, meta)
        self.captures = 0
        self.native_builds = 0
        self.annotate = False
        self._by_thread: Dict[int, Dict[str, Any]] = {}
        self._by_decoder: Dict[int, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._undo: List[tuple] = []

    # -- bookkeeping ------------------------------------------------------
    def _request(self, decoder=None) -> Optional[Dict[str, Any]]:
        """The record of the transcription running on this thread, else
        the one whose dispatch last used ``decoder`` (a ``BatchDecoder``
        runs one transcription's batches at a time)."""
        with self._lock:
            rec = self._by_thread.get(threading.get_ident())
            if rec is None and decoder is not None:
                rec = self._by_decoder.get(id(decoder))
            return rec

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        ann = contextlib.nullcontext()
        if self.annotate:
            from torch.profiler import record_function
            ann = record_function(f"mwx.{name}")
        t0 = time.perf_counter()
        with ann:
            try:
                yield meta
            finally:
                t1 = time.perf_counter()
                with self._lock:
                    self.spans.append((name, threading.current_thread().name,
                                       t0, t1, meta))

    def _patch(self, owner, attr: str, make) -> None:
        orig = getattr(owner, attr)
        self._undo.append((owner, attr, orig))
        setattr(owner, attr, make(orig))

    def builds(self) -> int:
        """Kernel libraries compiled so far in the process: nvcc's
        (``_build.build_logs`` holds one log a build) and g++'s."""
        from manual_whisper_tpu_torch.ops import _build
        return len(_build.build_logs) + self.native_builds

    # -- install / remove -------------------------------------------------
    def install(self) -> "Taps":
        from manual_whisper_tpu_torch.audio import native as native_mod
        from manual_whisper_tpu_torch.models import decode as dec_mod
        from manual_whisper_tpu_torch.models import graphs as graphs_mod
        from manual_whisper_tpu_torch.models import vad as vad_mod
        from manual_whisper_tpu_torch.pipeline import transcribe as tr_mod
        taps = self

        def transcribe(orig):
            def wrapped(pipe, audio, *a, **kw):
                rec = {"thread": threading.current_thread().name,
                       "samples": (len(audio) if hasattr(audio, "shape")
                                   else None),
                       "batches": [], "results": {}, "probs": None,
                       "frame": None, "t0": time.perf_counter()}
                with taps._lock:
                    taps._by_thread[threading.get_ident()] = rec
                    taps.requests.append(rec)
                try:
                    with taps.span("transcribe"):
                        out = orig(pipe, audio, *a, **kw)
                    rec["stats"] = dict(pipe.last_stats)
                    rec["ok"] = True
                    return out
                except BaseException:
                    rec["ok"] = False
                    raise
                finally:
                    rec["t1"] = time.perf_counter()
                    with taps._lock:
                        taps._by_thread.pop(threading.get_ident(), None)
            return wrapped

        def encode(orig):
            def wrapped(pipe, windows):
                with taps.span("encode", rows=int(windows.shape[0])):
                    return orig(pipe, windows)
            return wrapped

        def iter_probs(orig):
            def wrapped(det, audio, *a, **kw):
                rec = taps._request()
                gen = orig(det, audio, *a, **kw)
                while True:
                    with taps.span("vad"):
                        item = next(gen, None)
                    if item is None:
                        return
                    if rec is not None and item[2]:
                        rec["probs"], rec["frame"] = item[0].copy(), item[1]
                    yield item
            return wrapped

        def batch_chunks(orig):
            def wrapped(*a, **kw):
                out = orig(*a, **kw)
                rec = taps._request()
                if rec is not None:
                    rec["batches"].extend(
                        [(c.start, c.end) for c in grp] for _, grp in out)
                return out
            return wrapped

        def submit(orig):
            def wrapped(dec, xa, *a, **kw):
                rec = taps._request()
                if rec is not None:
                    with taps._lock:
                        taps._by_decoder[id(dec)] = rec
                with taps.span("decode", rows=int(xa.shape[0])) as meta:
                    out = orig(dec, xa, *a, **kw)
                    meta["steps"] = int(out.steps)
                return out
            return wrapped

        def fallback(orig):
            def wrapped(dec, xa, first=None, n_valid=None, rng_tag=0, **kw):
                rec = taps._request(dec)
                with taps.span("finalize"):
                    results = orig(dec, xa, first=first, n_valid=n_valid,
                                   rng_tag=rng_tag, **kw)
                if rec is not None:
                    n = len(results) if n_valid is None else n_valid
                    rec["results"][rng_tag] = [
                        (list(r.tokens), r.avg_logprob) for r in results[:n]]
                return results
            return wrapped

        def capture(orig):
            def wrapped(*a, **kw):
                with taps._lock:
                    taps.captures += 1
                return orig(*a, **kw)
            return wrapped

        def native_build(orig):
            def wrapped(name, *a, **kw):
                fresh = not native_mod.library_path(name).exists()
                out = orig(name, *a, **kw)
                if fresh and out is not None:
                    with taps._lock:
                        taps.native_builds += 1
                return out
            return wrapped

        self._patch(native_mod, "build", native_build)
        self._patch(tr_mod.TranscribePipeline, "transcribe", transcribe)
        self._patch(tr_mod.TranscribePipeline, "_encode_windows", encode)
        self._patch(vad_mod.VoiceActivityDetector, "iter_speech_probs",
                    iter_probs)
        self._patch(tr_mod, "batch_chunks", batch_chunks)
        self._patch(dec_mod.BatchDecoder, "decode_submit", submit)
        self._patch(dec_mod.BatchDecoder, "decode_with_fallback", fallback)
        self._patch(graphs_mod.ChunkGraphs, "capture", capture)
        return self

    def remove(self) -> None:
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)

    def clear(self) -> None:
        with self._lock:
            self.requests.clear()
            self.spans.clear()
            self._by_decoder.clear()
