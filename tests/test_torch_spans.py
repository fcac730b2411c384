"""PyTorch port: the program spans (``manual_whisper_tpu_torch/spans.py``)
on the CPU, with the ``test`` model and the energy VAD.

- with no profiler recording, ``record_function`` is never entered, and
  the spans are still timed and counted into ``last_stats["spans"]``;
- under a CPU ``torch.profiler`` trace every ``mwx.`` annotation names a
  span of ``spans.SPANS``, each ``decode.*`` lies inside a
  ``decode.loop`` of its thread, and only the root carries an argument,
  the request's number;
- per request, ``decode.replay`` counts the chunks run (eager here; with
  stand-in CUDA graphs, the replays of the decoder's loops) and
  ``decode.finish_check`` the checks made; a cold request counts each
  capture under ``graphs.capture``, a warm one none;
- the fetch worker and the serial path (also with an in-flight window
  of one batch, so that finalizes run between dispatches) give the same
  counts once the two threads' roles are merged, no finalize lies inside
  the hand-off to the in-flight window, and nested spans never add up to
  more than the span that holds them, nor the dispatch thread's phases
  to more than the request's wall time;
- the benchmark's four readers of the spans, by hand, and None where the
  program keeps no spans.
"""

import collections
import contextlib
import importlib.util
import sys
import threading
import time
from pathlib import Path

import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from cpu_budget import one_torch_thread  # noqa: F401
from manual_whisper_tpu_torch import config as tconfig
from manual_whisper_tpu_torch import spans
from manual_whisper_tpu_torch.models import decode as tdecode

from test_pipeline import _speech_audio
from test_torch_fetch_worker import _load_hermetic

ROOT = Path(__file__).resolve().parent.parent
# the fetch worker; the serial path; the serial path with an in-flight
# window of one batch, which finalizes each batch before the next one's
# dispatch ends
PATH_ENV = {
    "worker": {"MWX_FETCH_WORKER": "1", "MWX_MAX_INFLIGHT_BATCHES": "8"},
    "serial": {"MWX_FETCH_WORKER": "0", "MWX_MAX_INFLIGHT_BATCHES": "8"},
    "serial_window1": {"MWX_FETCH_WORKER": "0",
                       "MWX_MAX_INFLIGHT_BATCHES": "1"},
}
PATHS = tuple(PATH_ENV)
# a ladder every row climbs: no random-weight text reaches logprob 0
LADDER = (0.0, 0.2)
EVERY_RUNG = {"log_prob_threshold": 0.0}
# the dispatch thread's phases that no other span of it holds, but for a
# retry's decode.loop, which its finalize.retry holds (the serial path)
DISPATCH_PHASES = ("vad.pyannet", "vad.segments", "chunks.batch",
                   "encode.prep", "encode.upload", "encode.launch",
                   "encode.wait", "decode.loop", "inflight.wait",
                   "finalize.batch")
NESTING = {
    "pipeline.transcribe": DISPATCH_PHASES,
    "decode.loop": ("decode.prepare", "decode.cross_kv", "decode.prefill",
                    "decode.finish_check", "decode.replay", "decode.fetch"),
    "finalize.batch": ("finalize.retry",),
}


def _counts(stats):
    """Span counts of a request, the threads' roles merged."""
    out = collections.Counter()
    for role in stats["spans"].values():
        for name, (_, n) in role.items():
            out[name] += n
    return out


def _held(role, parent):
    """Seconds of the spans that ``parent`` holds on one thread.  Where
    both ``decode.loop`` and ``finalize.batch`` are among them (the serial
    path's dispatch thread), the retries' loops lie in both: the
    ``finalize.retry`` that holds each is taken off once, so that no
    loop counts twice."""
    held = sum(role.get(c, (0.0,))[0] for c in NESTING[parent])
    if {"decode.loop", "finalize.batch"} <= set(NESTING[parent]):
        held -= role.get("finalize.retry", (0.0,))[0]
    return held


def _refuse(*a, **k):
    raise AssertionError("record_function entered with no profiler on")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """12 s of speech bursts (three batches) at batch 2 up a two-rung
    ladder, on each path of ``PATH_ENV``: once with ``record_function`` refusing
    to be entered (the chunks run and the finish checks made counted
    beside), once under a CPU profiler (the annotations and their
    arguments recorded)."""
    pipe = _load_hermetic(tmp_path_factory, asr_options=EVERY_RUNG)
    audio = _speech_audio(12.0)
    out = {}
    made = collections.Counter()
    real_chunk, real_all_true = tdecode.DecodeLoop._chunk, tdecode.all_true
    real_annotation = autograd_profiler.record_function

    def chunk(loop, n):
        made["chunks"] += 1
        return real_chunk(loop, n)

    def all_true(flag, group):
        made["checks"] += 1
        return real_all_true(flag, group)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdecode.DecodeLoop, "_chunk", chunk)
        mp.setattr(tdecode, "all_true", all_true)
        for path, env in PATH_ENV.items():
            for key, value in env.items():
                mp.setenv(key, value)
            tconfig.clear_env_cache()
            made.clear()
            with pytest.MonkeyPatch.context() as off:
                off.setattr(autograd_profiler, "record_function", _refuse)
                t0 = time.perf_counter()
                result = pipe.transcribe(audio, batch_size=2, language="zh",
                                         temperature=LADDER)
                wall = time.perf_counter() - t0
            out[path] = {"result": result, "stats": pipe.last_stats,
                         "wall": wall, **made}
            seen = []

            def annotation(name, args=None):
                seen.append((name, args))
                return real_annotation(name, args)
            with pytest.MonkeyPatch.context() as on:
                on.setattr(autograd_profiler, "record_function", annotation)
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CPU]
                ) as prof:
                    pipe.transcribe(audio, batch_size=2, language="zh",
                                    temperature=LADDER)
            events = [(e.name()[4:], e.start_ns(),
                       e.start_ns() + e.duration_ns(), e.start_thread_id())
                      for e in prof.profiler.kineto_results.events()
                      if e.name().startswith("mwx.")]
            out[path + ".traced"] = {"stats": pipe.last_stats,
                                     "annotations": seen, "events": events}
    tconfig.clear_env_cache()
    return out


# -- the spans themselves -------------------------------------------------

def test_names_unique_and_dotted():
    """Every name is unique, and none is one of the benchmark's own
    annotations (``transcribe``, ``vad``, ``encode``, ``decode``,
    ``finalize``, ``window``)."""
    assert len(set(spans.NAMES)) == len(spans.SPANS)
    assert all("." in name and layer for name, layer in spans.SPANS)
    assert not set(spans.NAMES) & {"transcribe", "vad", "encode", "decode",
                                   "finalize", "window"}


def test_unbound_thread_keeps_nothing():
    sink = {}
    with spans.span("decode.loop"):
        pass
    with spans.bind(sink, "dispatch"):
        with spans.span("decode.loop"):
            pass
    with spans.span("decode.loop"):
        pass
    assert sink["dispatch"]["decode.loop"][1] == 1


def test_bind_nests_and_restores():
    outer, inner = {}, {}
    with spans.bind(outer, "dispatch"):
        with spans.bind(inner, "fetch"):
            with spans.span("finalize.batch"):
                pass
        with spans.span("encode.wait"):
            pass
    assert {r: list(d) for r, d in inner.items()} == {
        "fetch": ["finalize.batch"]}
    assert {r: list(d) for r, d in outer.items()} == {
        "dispatch": ["encode.wait"]}


def test_threads_keep_their_own_roles():
    """Two threads bound to one sink under two roles: each role holds its
    thread's spans only, counted exactly."""
    sink = {}

    def work(role, name, n):
        with spans.bind(sink, role):
            for _ in range(n):
                with spans.span(name):
                    pass
    threads = [threading.Thread(target=work, args=a) for a in
               (("dispatch", "decode.replay", 500),
                ("fetch", "finalize.text", 300))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert {r: {k: v[1] for k, v in d.items()} for r, d in sink.items()} == {
        "dispatch": {"decode.replay": 500}, "fetch": {"finalize.text": 300}}


def test_seconds_are_the_span_time():
    sink = {}
    with spans.bind(sink, "dispatch"):
        t0 = time.perf_counter()
        with spans.span("encode.wait"):
            time.sleep(0.02)
        wall = time.perf_counter() - t0
    assert 0.02 <= sink["dispatch"]["encode.wait"][0] <= wall


# -- a request's spans ------------------------------------------------------

@pytest.mark.parametrize("path", PATHS)
def test_profiler_off_never_annotates(runs, path):
    """The run finished with ``record_function`` refusing: every span was
    timed and counted all the same."""
    st = runs[path]["stats"]
    assert runs[path]["result"]["segments"]
    assert st["spans"]["dispatch"]["pipeline.transcribe"][1] == 1
    assert set(_counts(st)) <= set(spans.NAMES)
    assert "decode_s" not in st


@pytest.mark.parametrize("path", PATHS)
def test_trace_events_are_program_spans(runs, path):
    events = runs[path + ".traced"]["events"]
    names = {e[0] for e in events}
    assert names <= set(spans.NAMES)
    assert {"pipeline.transcribe", "decode.loop", "encode.launch",
            "decode.replay"} <= names


@pytest.mark.parametrize("path", PATHS)
def test_decode_events_nest_in_a_loop(runs, path):
    events = runs[path + ".traced"]["events"]
    loops = [e for e in events if e[0] == "decode.loop"]
    inner = [e for e in events if e[0].startswith("decode.")
             and e[0] != "decode.loop"]
    assert loops and inner
    for name, s, e, thread in inner:
        assert any(ls <= s and e <= le and lt == thread
                   for _, ls, le, lt in loops), name


@pytest.mark.parametrize("path", PATHS)
def test_root_carries_the_request(runs, path):
    traced = runs[path + ".traced"]
    args = [a for n, a in traced["annotations"]
            if n == "mwx.pipeline.transcribe"]
    assert args == [str(traced["stats"]["request"])]
    assert traced["stats"]["request"] > runs[path]["stats"]["request"]
    assert all(a is None for n, a in traced["annotations"]
               if n != "mwx.pipeline.transcribe")


@pytest.mark.parametrize("path", PATHS)
def test_replays_are_the_chunks_run(runs, path):
    run = runs[path]
    assert run["chunks"] > 0
    assert _counts(run["stats"])["decode.replay"] == run["chunks"]


@pytest.mark.parametrize("path", PATHS)
def test_finish_checks_are_the_checks_made(runs, path):
    run = runs[path]
    assert run["checks"] > 0
    assert _counts(run["stats"])["decode.finish_check"] == run["checks"]


@pytest.mark.parametrize("path", PATHS)
def test_loops_are_the_decoder_calls(runs, path):
    st = runs[path]["stats"]
    counts = _counts(st)
    assert counts["decode.loop"] == st["decode_calls"] == (
        st["batches"] * len(LADDER))
    assert counts["finalize.batch"] == st["batches"]
    assert counts["finalize.retry"] == st["batches"] * (len(LADDER) - 1)
    assert counts["chunks.batch"] >= 1
    assert counts["encode.launch"] == counts["encode.wait"] == st["batches"]
    assert counts["inflight.wait"] == st["batches"]


@pytest.mark.parametrize("path", PATHS)
def test_finalize_runs_where_the_path_says(runs, path):
    roles = runs[path]["stats"]["spans"]
    if path == "worker":
        assert set(roles) == {"dispatch", "fetch"}
        assert "finalize.batch" not in roles["dispatch"]
        assert roles["dispatch"]["decode.loop"][1] == (
            runs[path]["stats"]["batches"])
    else:
        assert set(roles) == {"dispatch"}


def test_worker_and_serial_counts_equal(runs):
    for path in PATHS[1:]:
        assert _counts(runs["worker"]["stats"]) == _counts(
            runs[path]["stats"]), path
        assert runs["worker"]["result"] == runs[path]["result"], path


@pytest.mark.parametrize("path", PATHS)
def test_inflight_wait_holds_no_finalize(runs, path):
    """The hand-off to the in-flight window holds no finalize on any
    path; with a window of one batch the serial path finalizes batches
    while it still dispatches, each under its own ``finalize.batch``."""
    events = runs[path + ".traced"]["events"]
    waits = [e for e in events if e[0] == "inflight.wait"]
    finals = [e for e in events if e[0] == "finalize.batch"]
    # the profiler records the annotations of its own thread only, so the
    # fetch worker's finalizes may be missing from the events
    assert waits and (finals or path == "worker")
    for _, s, e, thread in finals:
        assert not any(ws < e and s < we and wt == thread
                       for _, ws, we, wt in waits)
    # finalizes of the dispatch thread that start before its last encode
    dispatch = next(t for n, _, _, t in events if n == "pipeline.transcribe")
    last_launch = max(s for n, s, _, _ in events if n == "encode.launch")
    early = sum(s < last_launch and t == dispatch for _, s, _, t in finals)
    assert (early > 0) == (path == "serial_window1")


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("parent", sorted(NESTING))
def test_children_within_parent(runs, path, parent):
    """On each thread the spans a span holds add up to no more than it."""
    for role in runs[path]["stats"]["spans"].values():
        if parent in role:
            assert _held(role, parent) <= role[parent][0]


@pytest.mark.parametrize("path", PATHS)
def test_dispatch_phases_within_wall(runs, path):
    dispatch = runs[path]["stats"]["spans"]["dispatch"]
    phases = _held(dispatch, "pipeline.transcribe")
    assert 0 < phases <= dispatch["pipeline.transcribe"][0] <= (
        runs[path]["wall"])


# -- captures: stand-in CUDA graphs on the CPU ----------------------------

class _Stream:
    def __init__(self, device=None):
        self.device = device

    def wait_stream(self, other):
        pass


class _Graph:
    def register_generator_state(self, generator):
        pass

    def replay(self):
        pass


@pytest.fixture(scope="module")
def captured_runs(tmp_path_factory):
    """A cold request and a warm one through a decoder whose loops are
    "captured" with stand-ins for the CUDA graph calls (a stand-in replay
    runs nothing, so the loops run to their end): per request, its spans,
    the graphs captured and the replays made."""
    pipe = _load_hermetic(tmp_path_factory)
    audio = _speech_audio(12.0)
    decoder = pipe._decoder("zh", (0.0,))
    decoder.captured = True
    out = []

    def graphs():
        return [loop.graphs for loop in decoder._loops.values()]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "graph_pool_handle", object)
        mp.setattr(torch.cuda, "Stream", _Stream)
        mp.setattr(torch.cuda, "current_stream", _Stream)
        mp.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
        mp.setattr(torch.cuda, "CUDAGraph", _Graph)
        mp.setattr(torch.cuda, "graph",
                   lambda *a, **k: contextlib.nullcontext())
        for _ in range(2):
            captures0 = sum(len(g.graphs) for g in graphs())
            replays0 = sum(sum(g.replays.values()) for g in graphs())
            pipe.transcribe(audio, batch_size=2, language="zh",
                            temperature=(0.0,))
            out.append({
                "stats": pipe.last_stats,
                "captures": sum(len(g.graphs) for g in graphs()) - captures0,
                "replays": sum(sum(g.replays.values()) for g in graphs())
                - replays0})
    return out


@pytest.mark.parametrize("request_", ["cold", "warm"])
def test_captures_counted_and_warm_request_none(captured_runs, request_):
    run = captured_runs[request_ == "warm"]
    counts = _counts(run["stats"])
    assert counts["graphs.capture"] == run["captures"]
    assert (run["captures"] > 0) == (request_ == "cold")


@pytest.mark.parametrize("request_", ["cold", "warm"])
def test_replay_count_is_the_graphs_replays(captured_runs, request_):
    run = captured_runs[request_ == "warm"]
    assert run["replays"] > 0
    assert _counts(run["stats"])["decode.replay"] == run["replays"]


# -- the benchmark's readers of the spans ---------------------------------

def _reader(name):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "spans_reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class _Run:
    """Two requests, the first traced: one ran its finalize on the fetch
    worker, the other on the serial path."""

    def __init__(self, with_spans=True, trace=True):
        a = {"windows": 10, "batches": 1, "token_rows": 1000,
             "spans": {"dispatch": {"decode.loop": [0.5, 1],
                                    "chunks.batch": [0.01, 1],
                                    "encode.prep": [0.02, 1],
                                    "encode.upload": [0.03, 1],
                                    "pipeline.transcribe": [0.9, 1]},
                       "fetch": {"finalize.batch": [0.004, 1],
                                 "finalize.wait": [0.0015, 1],
                                 "decode.loop": [7.0, 1]}}}
        b = {"windows": 6, "batches": 1, "token_rows": 600,
             "spans": {"dispatch": {"decode.loop": [0.3, 1],
                                    "chunks.batch": [0.02, 1],
                                    "encode.prep": [0.01, 1],
                                    "encode.upload": [0.01, 1],
                                    "finalize.batch": [0.002, 1],
                                    "finalize.wait": [0.0005, 1]}}}
        if not with_spans:
            del a["spans"], b["spans"]
        self.done = [{"record": {"stats": a}, "traced": True},
                     {"record": {"stats": b}, "traced": False},
                     {"record": {}, "traced": False}]
        self.trace = None if not trace else {"idle_by_label": {
            "host:encode.prep": 0.03, "host:decode.finish_check": 0.01,
            "host:pipeline.transcribe": 0.5, "host:encode": 0.2,
            "host:none": 0.1, "gaps_under_0.1ms": 0.3}}

    def requests(self, traced_only=False):
        return [r for r in self.done if r["traced"] or not traced_only]


READINGS = {
    # dispatch loops only: the fetch worker's 7 s are retries, not rows
    "decode_loop_ms_per_token_row.meeting": 1e3 * 0.8 / 1600,
    "window_prep_ms_per_window.meeting": 1e3 * 0.10 / 16,
    # finalize less its waits for the results, both threads
    "finalize_ms_per_window.meeting": 1e3 * (0.006 - 0.002) / 16,
    # the program's spans other than the root, over the traced batch
    "host_idle_ms_per_batch.meeting": 1e3 * 0.04 / 1,
}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_by_hand(name):
    assert _reader(name)(_Run()) == pytest.approx(READINGS[name])


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_silent_without_program_spans(name, monkeypatch):
    """A program without spans (the parent of this metric) reads None."""
    monkeypatch.setitem(sys.modules, "manual_whisper_tpu_torch.spans", None)
    assert _reader(name)(_Run(with_spans=False)) is None


def test_idle_reader_silent_without_trace():
    assert _reader("host_idle_ms_per_batch.meeting")(
        _Run(trace=False)) is None
