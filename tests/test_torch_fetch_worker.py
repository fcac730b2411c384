"""PyTorch port: the pipeline's fetch worker on the CPU.

``TranscribePipeline.transcribe`` finalizes each batch (the first rung's
results, the ladder's retries, the segments) on a fetch worker thread by
default, and on the calling thread with ``MWX_FETCH_WORKER=0`` or a mesh.
Held here, on the ``test`` config:

- the JAX package's two fetch-worker tests, ported (20 s of speech bursts,
  batch 2): the worker's segments equal the serial path's, and a window
  of one in-flight batch equals the default window;
- both paths on ``.synth_ckpt`` against the JAX pipeline (its own fetch
  worker) through the weight bridge, at a greedy ladder: segments equal;
- a sampled ladder whose gate fails every row at every rung: worker and
  serial equal exactly (the port reseeds before each loop, so sampled
  rungs do not depend on how the threads interleave), ``last_stats``
  counts equal, and no loop's static buffers ever serve two runs at once
  although the worker's retries and the dispatch thread's first rungs
  share the loop;
- failures: a finalize that raises (one batch in flight, several batches)
  and a dispatch that raises on its second batch reach the caller, with
  no deadlock and no thread left behind;
- with a mesh (a one-rank gloo world) the serial path is taken.
"""

import collections
import datetime
import threading
import time

import numpy as np
import pytest
import torch

from cpu_budget import one_torch_thread  # noqa: F401
from manual_whisper_tpu_torch import config as tconfig
from manual_whisper_tpu_torch.models import decode as tdecode
from manual_whisper_tpu_torch.pipeline import load_model
from manual_whisper_tpu_torch.pipeline.transcribe import TranscribePipeline

from test_pipeline import _speech_audio
from test_torch_pipeline import OPTS, _keys, _port_model, _synth_file

WORKER = "mwx-fetch"
# a sampled ladder that every row climbs to its end: no random-weight
# text reaches an average logprob of 0
EVERY_RUNG = {"log_prob_threshold": 0.0}
LADDER = (0.0, 0.2, 0.4)
COUNTS = ("batches", "windows", "rows", "token_rows", "decode_calls",
          "decode_steps", "beam_calls", "beam_steps", "rung_rows")


def _env(mp, **values):
    for k, v in values.items():
        mp.setenv(k, v)
    tconfig.clear_env_cache()


def _serial(mp):
    _env(mp, MWX_FETCH_WORKER="0")


class _Finalizers:
    """Records the thread of every finalize (``decode_with_fallback``, or
    ``timestamps_finalize`` in timestamp mode)."""

    def __init__(self, mp, fail_at=None, name="decode_with_fallback"):
        self.threads = []
        real = getattr(tdecode.BatchDecoder, name)
        rec = self

        def wrapped(dec, *a, **k):
            rec.threads.append(threading.current_thread().name)
            if fail_at is not None and len(rec.threads) == fail_at:
                raise RuntimeError("planted finalize failure")
            return real(dec, *a, **k)
        mp.setattr(tdecode.BatchDecoder, name, wrapped)


def _fetch_threads():
    return [t for t in threading.enumerate() if t.name == WORKER]


def _load_hermetic(tmp_path_factory, **kw):
    """``load_model`` on the CPU with an empty registry (the energy VAD),
    for module fixtures, which the suite's registry fixture does not
    reach."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MWX_WEIGHTS_DIR", str(tmp_path_factory.mktemp("empty")))
        tconfig.clear_env_cache()
        pipe = load_model("test", device="cpu", language="zh", **kw)
    tconfig.clear_env_cache()
    assert pipe.vad.model is None
    return pipe


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return _load_hermetic(tmp_path_factory)


def test_fetch_worker_matches_serial(model, monkeypatch):
    """Port of the JAX ``test_fetch_worker_matches_serial``: the serial
    path gives the worker's segments, in order, and progress ends at 100;
    the worker finalized every batch off the calling thread."""
    audio = _speech_audio(20.0)
    progress = []
    fin = _Finalizers(monkeypatch)
    ref = model.transcribe(audio, batch_size=2, language="zh",
                           temperature=(0.0,),
                           progress_callback=lambda p, m: progress.append(p))
    assert progress and progress[-1] == 100.0
    assert len(fin.threads) >= 3 and set(fin.threads) == {WORKER}
    fin.threads.clear()
    _serial(monkeypatch)
    got = model.transcribe(audio, batch_size=2, language="zh",
                           temperature=(0.0,))
    assert set(fin.threads) == {threading.current_thread().name}
    assert got == ref
    starts = [s["start"] for s in got["segments"]]
    assert starts == sorted(starts)


@pytest.mark.parametrize("worker", ["1", "0"], ids=["worker", "serial"])
def test_bounded_inflight_matches_unbounded(model, monkeypatch, worker):
    """Port of the JAX ``test_bounded_inflight_matches_unbounded``: one
    batch in flight gives the default window's segments, on both paths."""
    _env(monkeypatch, MWX_FETCH_WORKER=worker)
    audio = _speech_audio(20.0)
    ref = model.transcribe(audio, batch_size=2, language="zh",
                           temperature=(0.0,))
    _env(monkeypatch, MWX_MAX_INFLIGHT_BATCHES="1")
    got = model.transcribe(audio, batch_size=2, language="zh",
                           temperature=(0.0,))
    assert got == ref
    starts = [s["start"] for s in got["segments"]]
    assert starts == sorted(starts)


# ---------------------------------------------------------------------------
# .synth_ckpt against the JAX pipeline, greedy ladder
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def synth():
    from manual_whisper_tpu.convert.from_hf import load_params
    params = load_params(".synth_ckpt")
    if params is None:
        pytest.skip("no committed synth checkpoint")
    return params


@pytest.fixture(scope="module")
def synth_audio():
    return _synth_file(31, n_utts=6)[0]


@pytest.fixture(scope="module")
def jax_segments(synth, synth_audio):
    from manual_whisper_tpu.models import MODEL_CONFIGS as JCONFIGS
    from manual_whisper_tpu.pipeline.transcribe import TranscribePipeline \
        as JPipeline
    from manual_whisper_tpu.tokenizer import make_test_tokenizer
    jm = JPipeline(synth, JCONFIGS["test"], make_test_tokenizer(),
                   asr_options=OPTS, language="en")
    return jm.transcribe(synth_audio, batch_size=2, language="en",
                         temperature=(0.0,))["segments"]


@pytest.mark.parametrize("worker", ["1", "0"], ids=["worker", "serial"])
def test_paths_match_jax_pipeline(synth, synth_audio, jax_segments,
                                  monkeypatch, worker):
    _env(monkeypatch, MWX_FETCH_WORKER=worker)
    fin = _Finalizers(monkeypatch)
    tm = _port_model(synth, asr_options=OPTS, language="en")
    out = tm.transcribe(synth_audio, batch_size=2, language="en",
                        temperature=(0.0,))
    assert out["segments"] and tm.last_stats["batches"] >= 3
    assert set(fin.threads) == ({WORKER} if worker == "1"
                                else {threading.current_thread().name})
    assert _keys(out["segments"]) == _keys(jax_segments)


# ---------------------------------------------------------------------------
# A sampled ladder that every row climbs: worker against serial
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sampled_runs(tmp_path_factory):
    """The same 20 s at batch 2 through both paths, recording which
    thread ran each loop and how many runs of one loop overlapped (each
    run held a moment longer, to widen any window)."""
    pipe = _load_hermetic(tmp_path_factory, asr_options=EVERY_RUNG)
    audio = _speech_audio(20.0)
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        real_run = tdecode.DecodeLoop.run
        guard = threading.Lock()
        active = collections.Counter()
        seen = {"overlap": 0, "threads": collections.defaultdict(set)}

        def run(loop, *a, **k):
            with guard:
                active[id(loop)] += 1
                seen["overlap"] = max(seen["overlap"], active[id(loop)])
                seen["threads"][id(loop)].add(
                    threading.current_thread().name)
            try:
                time.sleep(0.002)
                return real_run(loop, *a, **k)
            finally:
                with guard:
                    active[id(loop)] -= 1
        mp.setattr(tdecode.DecodeLoop, "run", run)
        for name, worker in (("worker", "1"), ("serial", "0")):
            mp.setenv("MWX_FETCH_WORKER", worker)
            tconfig.clear_env_cache()
            seen["threads"].clear()
            result = pipe.transcribe(audio, batch_size=2, language="zh",
                                     temperature=LADDER)
            runs[name] = (result, dict(pipe.last_stats),
                          {k: set(v) for k, v in seen["threads"].items()},
                          seen["overlap"])
    tconfig.clear_env_cache()
    return runs


def test_sampled_ladder_worker_equals_serial(sampled_runs):
    (w, _, _, _), (s, _, _, _) = sampled_runs["worker"], sampled_runs["serial"]
    assert w == s
    assert w["segments"] and all(seg["temperature"] == LADDER[-1]
                                 for seg in w["segments"])


def test_last_stats_counts_equal(sampled_runs):
    w, s = sampled_runs["worker"][1], sampled_runs["serial"][1]
    assert {k: w[k] for k in COUNTS} == {k: s[k] for k in COUNTS}
    assert w["batches"] >= 3
    assert set(w["rung_rows"]) == set(range(len(LADDER)))
    assert w["decode_calls"] == w["batches"] * len(LADDER)
    for k in ("vad_s", "encode_s"):
        assert w[k] > 0.0 and s[k] > 0.0
    for st in (w, s):
        assert st["spans"]["dispatch"]["decode.loop"][0] > 0.0
        assert sum(role.get("finalize.batch", (0.0,))[0]
                   for role in st["spans"].values()) > 0.0


def test_threads_share_loops_one_run_at_a_time(sampled_runs):
    """The worker's retries and the dispatch thread's first rungs run the
    same loops (the same static buffers), and never two runs of one loop
    at once: ``BatchDecoder``'s lock serialises them."""
    _, _, threads, overlap = sampled_runs["worker"]
    main = threading.current_thread().name
    assert overlap == 1
    assert any({WORKER, main} <= names for names in threads.values())
    _, _, serial_threads, _ = sampled_runs["serial"]
    assert all(names == {main} for names in serial_threads.values())


# ---------------------------------------------------------------------------
# Failures: the error reaches the caller, nothing is left running
# ---------------------------------------------------------------------------

def _transcribe_in_thread(pipe, audio, timeout=120.0, **kw):
    """transcribe on a thread of its own, so that a deadlock fails the
    test instead of hanging it; returns the exception raised, or None."""
    box = {}

    def target():
        try:
            pipe.transcribe(audio, batch_size=2, language="zh", **kw)
        except BaseException as exc:  # noqa: BLE001 — handed to the test
            box["exc"] = exc
    t = threading.Thread(target=target, name="caller")
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "transcribe deadlocked"
    return box.get("exc")


@pytest.mark.parametrize("fail_at", [1, 2], ids=["first", "second"])
@pytest.mark.parametrize("mode", ["ladder", "timestamps"])
def test_failed_finalize_reaches_caller(monkeypatch, mode, fail_at):
    asr = {"without_timestamps": False} if mode == "timestamps" else {}
    pipe = load_model("test", device="cpu", language="zh", asr_options=asr)
    _env(monkeypatch, MWX_MAX_INFLIGHT_BATCHES="1")
    fin = _Finalizers(monkeypatch, fail_at=fail_at,
                      name=("timestamps_finalize" if mode == "timestamps"
                            else "decode_with_fallback"))
    assert not _fetch_threads()
    exc = _transcribe_in_thread(pipe, _speech_audio(20.0),
                                temperature=(0.0,))
    assert isinstance(exc, RuntimeError) and "planted" in str(exc)
    assert fin.threads and set(fin.threads) == {WORKER}
    # the worker stopped finalizing at the failure; dispatch stopped too
    assert len(fin.threads) == fail_at
    assert not _fetch_threads()


def test_failed_dispatch_leaves_no_thread(model, monkeypatch):
    real = TranscribePipeline._encode_windows
    calls = []

    def encode(pipe, windows):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("planted encode failure")
        return real(pipe, windows)
    monkeypatch.setattr(TranscribePipeline, "_encode_windows", encode)
    fin = _Finalizers(monkeypatch)
    exc = _transcribe_in_thread(model, _speech_audio(20.0),
                                temperature=(0.0,))
    assert isinstance(exc, RuntimeError) and "planted encode" in str(exc)
    assert len(calls) == 2 and fin.threads == [WORKER]
    assert not _fetch_threads()


# ---------------------------------------------------------------------------
# A mesh finalizes on the calling thread
# ---------------------------------------------------------------------------

def test_mesh_takes_the_serial_path(tmp_path, monkeypatch):
    """A one-rank gloo world's mesh keeps its groups, so every collective
    of the mesh path runs; the finalizes stay on the calling thread and
    the segments equal the meshless worker path's."""
    import torch.distributed as dist
    from manual_whisper_tpu_torch.parallel import make_mesh
    audio = _speech_audio(20.0)
    kw = dict(device="cpu", language="zh", compute_type="float32")
    ref = load_model("test", mesh=None, **kw).transcribe(
        audio, batch_size=2, language="zh", temperature=(0.0,))
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        pipe = load_model("test", mesh=make_mesh(1, 1), **kw)
        assert pipe.mesh is not None
        fin = _Finalizers(monkeypatch)
        got = pipe.transcribe(audio, batch_size=2, language="zh",
                              temperature=(0.0,))
    finally:
        dist.destroy_process_group()
    assert fin.threads and set(fin.threads) == {
        threading.current_thread().name}
    assert not _fetch_threads()
    assert _keys(got["segments"]) == _keys(ref["segments"])
    assert np.isfinite([s["avg_logprob"] for s in got["segments"]]).all()
    assert torch.distributed.is_initialized() is False
