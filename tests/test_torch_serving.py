"""PyTorch port: the job server, the backend over the port's pipeline, and
two decodes at once.

- The flows of ``tests/test_serving.py`` run against the JAX package's
  ``create_server`` and the port's, each over the same scripted backend:
  every response must be the same JSON apart from ids, ports and times.
- ``PipelineBackend(device="cpu")`` over the ``.synth_ckpt`` weights gives
  the JAX ``PipelineBackend``'s segments, post-processed output and
  Markdown on a WAV and a FLAC upload, and with word alignment and
  diarization asked for, the same result (words, times, scores,
  speakers) or the same degradation messages.
- ``transcribe_clip`` on a second thread while ``transcribe`` runs gives
  the results of each run alone, and each decoder is built once; the
  launch counters stay exact with threads counting and capturing at once.
"""

import collections
import json
import re
import shutil
import socket
import threading
import time
import urllib.error
import urllib.request

from pathlib import Path

import numpy as np
import pytest

import manual_whisper_tpu.pipeline as jpipeline_pkg
import manual_whisper_tpu.serving.server as jserver
import manual_whisper_tpu_torch.pipeline as tpipeline_pkg
import manual_whisper_tpu_torch.serving.server as tserver
from manual_whisper_tpu.audio import native as jnative
from manual_whisper_tpu.audio import write_wav
from manual_whisper_tpu.serving import jobs as jjobs
from manual_whisper_tpu.serving import second_pass as jsecond
from manual_whisper_tpu.text import post_process_segments as j_post
from manual_whisper_tpu.text.formatting import format_to_markdown as j_md
from manual_whisper_tpu_torch.audio import native as tnative
from manual_whisper_tpu_torch.audio import write_flac
from manual_whisper_tpu_torch.ops import _build
from manual_whisper_tpu_torch.serving import jobs as tjobs
from manual_whisper_tpu_torch.serving import second_pass as tsecond
from manual_whisper_tpu_torch.text import (format_to_markdown,
                                           post_process_segments)
from cpu_budget import one_torch_thread  # noqa: F401

PORT_LOAD_MODEL = tpipeline_pkg.load_model
IMPLS = {"jax": (jserver, jjobs, jsecond, jnative),
         "port": (tserver, tjobs, tsecond, tnative)}


class MockBackend:
    """Scripted backend of ``tests/test_serving.py``: NN% logs, canned
    segments."""

    def __init__(self, delay=0.0, fail=False, segments=None):
        self.delay = delay
        self.fail = fail
        self.segments = segments if segments is not None else [
            {"text": "大家好，今天开会", "start": 0.0, "end": 3.0},
            {"text": "请使用简体中文。", "start": 3.0, "end": 4.0},
        ]
        self.calls = []

    def transcribe(self, audio_path, language, progress, options=None):
        self.calls.append((audio_path, language))
        progress(25.0, "encoding")
        if self.delay:
            time.sleep(self.delay)
        if self.fail:
            raise RuntimeError("synthetic backend failure")
        progress(75.0, "decoding")
        return {"segments": [dict(s) for s in self.segments],
                "language": language}


class Ctx:
    """One running server of one implementation."""

    def __init__(self, impl, tmp_path, web_dir=None):
        self.server_mod = IMPLS[impl][0]
        self.backend = MockBackend()
        self.tmp = tmp_path / impl
        self.tmp.mkdir()
        self.srv = self.server_mod.create_server(
            self.backend, host="127.0.0.1", port=0,
            upload_dir=str(self.tmp / "uploads"), web_dir=web_dir)
        threading.Thread(target=self.srv.serve_forever, args=(0.05,),
                         daemon=True).start()
        self.base = f"http://127.0.0.1:{self.srv.server_address[1]}"

    def req(self, method, path, data=None, headers=None):
        req = urllib.request.Request(self.base + path, data=data,
                                     method=method, headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                return resp.status, json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read().decode())

    def upload_wav(self, seconds=0.1, name="a.wav"):
        path = self.tmp / name
        write_wav(path, np.zeros(int(16000 * seconds), np.float32))
        status, out = self.req("POST", "/api/upload", data=path.read_bytes(),
                               headers={"x-file-name": name})
        assert status == 200 and out["fileUrl"].startswith("http")
        return out["fileUrl"]

    def create(self, body):
        return self.req("POST", "/api/transcribe",
                        data=json.dumps(body).encode(),
                        headers={"Content-Type": "application/json"})

    def poll(self, job_id, until=("succeeded", "failed"), timeout=10.0,
             headers=None):
        deadline = time.time() + timeout
        while time.time() < deadline:
            status, out = self.req("GET", f"/api/transcribe?id={job_id}",
                                   headers=headers)
            assert status == 200
            if out["status"] in until:
                return out
            time.sleep(0.02)
        raise TimeoutError("job did not finish")

    def raw(self, payload: bytes, until: bytes = b"") -> bytes:
        host, port = self.srv.server_address[:2]
        with socket.create_connection((host, port), timeout=5) as sock:
            sock.sendall(payload)
            sock.settimeout(5)
            data = b""
            while not data or (until and until not in data):
                chunk = sock.recv(65536)
                if not chunk:
                    break
                data += chunk
        return data.split(b"\r\n", 1)[0]

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


_HEX = re.compile(r"[0-9a-f]{32}|[0-9a-f]{24}")
_PORT = re.compile(r"127\.0\.0\.1:\d+")


def _normalize(obj):
    if isinstance(obj, dict):
        return {k: ("<t>" if k in ("elapsedSec",) else _normalize(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_normalize(v) for v in obj]
    if isinstance(obj, str):
        return _PORT.sub("<host>", _HEX.sub("<id>", obj))
    return obj


# -- flows: each returns the responses it saw, in order ----------------------

def flow_full_job(c):
    file_url = c.upload_wav()
    status, created = c.create({"fileUrl": file_url, "language": "zh"})
    assert status == 201
    out = c.poll(created["id"])
    assert out["status"] == "succeeded"
    assert [s["text"] for s in out["output"]["json"]["segments"]] == \
        ["大家好，今天开会"]
    assert "[00:00:00 - 00:00:03] 大家好，今天开会" in out["output"]["markdown"]
    assert created["status"] in ("starting", "processing")
    return [file_url, status, sorted(created["progress"]), out,
            c.backend.calls[0][1]]


def flow_progress_from_logs(c):
    c.backend.delay = 0.6
    _, created = c.create({"fileUrl": c.upload_wav(), "language": "en"})
    mid = c.poll(created["id"], until=("processing",))
    deadline = time.time() + 2
    while mid["progress"]["percent"] != 25 and time.time() < deadline:
        mid = c.poll(created["id"], until=("processing",))
    assert mid["progress"]["percent"] == 25
    return [mid, c.poll(created["id"])]


def flow_failed_job(c):
    c.backend.fail = True
    _, created = c.create({"fileUrl": c.upload_wav()})
    out = c.poll(created["id"])
    assert out["status"] == "failed"
    assert "synthetic backend failure" in out["error"]
    return [out]


def flow_language_default(c):
    _, created = c.create({"fileUrl": c.upload_wav(), "language": "klingon"})
    return [c.poll(created["id"]), c.backend.calls[-1][1]]


def flow_post_validation(c):
    return [c.req("POST", "/api/transcribe", data=b"{}"),
            c.create({"fileUrl": "ftp://x"}),
            c.create({"fileUrl": "http://evil/other"})]


def flow_get_validation_and_ownership(c, monkeypatch):
    out = [c.req("GET", "/api/transcribe"),
           c.req("GET", "/api/transcribe?id=nonexistent")]
    monkeypatch.setenv("MWX_TRUST_PROXY", "true")
    _, created = c.create({"fileUrl": c.upload_wav()})
    out.append(c.req("GET", f"/api/transcribe?id={created['id']}",
                     headers={"x-forwarded-for": "10.9.9.9"}))
    c.poll(created["id"])
    return out


def flow_forwarded_for_ignored(c):
    _, created = c.create({"fileUrl": c.upload_wav()})
    return [c.poll(created["id"], headers={"x-forwarded-for": "10.9.9.9"})]


def flow_file_urls(c, monkeypatch):
    wav = c.tmp / "local.wav"
    write_wav(wav, np.zeros(1600, np.float32))
    out = [c.create({"fileUrl": f"file://{wav}"})]
    monkeypatch.setenv("MWX_ALLOW_LOCAL_FILE_URLS", "true")
    status, created = c.create({"fileUrl": f"file://{wav}"})
    return out + [status, c.poll(created["id"])]


def flow_slow_upload_times_out(c, monkeypatch):
    monkeypatch.setenv("MWX_UPLOAD_READ_TIMEOUT_SEC", "0.4")
    t0 = time.time()
    line = c.raw(b"POST /api/upload HTTP/1.1\r\nHost: x\r\n"
                 b"Content-Length: 1000000\r\n\r\n" + b"x" * 10)
    assert time.time() - t0 < 4.0
    return [line.decode()]


def flow_upload_content_length_cap(c):
    return [c.raw(b"POST /api/upload HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Length: 209715200\r\n\r\n",
                  until=b"Upload too large").decode()]


def flow_map_upload_error_table(c):
    f = c.server_mod.map_upload_error
    return [f(413), f(429), f(500), f(503, "boom"), f(422, "bad payload"),
            f(422), f(None, "x" * 300), f(), f(422, "y" * 200)]


def flow_active_job_cap(c):
    c.backend.delay = 1.0
    c.srv.app_state.store.max_active_per_ip = 1
    file_url = c.upload_wav()
    _, first = c.create({"fileUrl": file_url})
    out = [c.create({"fileUrl": file_url})]
    c.poll(first["id"])
    return out


def flow_post_rate_limit(c):
    c.srv.app_state.store.post_limit = 2
    return [c.req("POST", "/api/transcribe", data=b"{}") for _ in range(3)]


def flow_upload_validation(c):
    return [c.req("POST", "/api/upload", data=b""),
            c.req("GET", "/api/upload")]


def flow_shared_key_auth(c, monkeypatch):
    monkeypatch.setenv("ENFORCE_APP_SHARED_KEY", "true")
    monkeypatch.setenv("APP_SHARED_KEY", "sekret")
    return [c.req("POST", "/api/upload", data=b"xx"),
            c.req("POST", "/api/upload", data=b"xx",
                  headers={"x-app-key": "wrong"}),
            c.req("POST", "/api/upload", data=b"xx",
                  headers={"x-app-key": "sekret"}),
            c.req("POST", "/api/transcribe", data=b"{}"),
            c.req("POST", "/api/transcribe", data=b"{}",
                  headers={"Authorization": "Bearer sekret"})]


def flow_bearer_fails_closed(c, monkeypatch):
    monkeypatch.setenv("ENFORCE_APP_SHARED_KEY", "true")
    monkeypatch.delenv("APP_SHARED_KEY", raising=False)
    return [c.req("POST", "/api/transcribe", data=b"{}"),
            c.req("GET", "/api/transcribe?id=x")]


def flow_second_pass(c):
    c.backend.segments = [
        {"text": "正常内容", "start": 0.0, "end": 5.0},
        {"text": "请使用简体中文。", "start": 5.0, "end": 25.0},
    ]
    c.backend.transcribe_clip = lambda clip, language, vad_onset, \
        vad_offset, temperature: {"segments": [
            {"text": "补回的片段", "start": 0.5, "end": 2.0}]}
    _, created = c.create({"fileUrl": c.upload_wav(seconds=30.0)})
    pending = c.poll(created["id"], until=("processing",))
    while not pending["progress"].get("secondPass"):
        pending = c.poll(created["id"], until=("processing",))
    deadline = time.time() + 10
    while True:
        out = c.poll(created["id"])
        if "second_pass" in out.get("output", {}).get("json", {}):
            break
        assert time.time() < deadline, "second pass never resolved"
    assert out["output"]["json"]["second_pass"]["recovered_segments"] == 1
    return [pending, out]


def flow_m4a_rejected_without_decoders(c, monkeypatch):
    import manual_whisper_tpu.audio.io as jio
    import manual_whisper_tpu_torch.audio.io as tio
    monkeypatch.setattr(shutil, "which", lambda name: None)
    for io_mod, native_mod in ((jio, jnative), (tio, tnative)):
        monkeypatch.setattr(io_mod.shutil, "which", lambda name: None)
        monkeypatch.setattr(native_mod, "get_ffdec", lambda *a, **k: None)
    out = c.req("POST", "/api/upload", data=b"\x00" * 64,
                headers={"x-file-name": "meeting.m4a"})
    assert out[0] == 415 and "m4a" in out[1]["error"]
    return [out]


def flow_success_poll_cached(c, monkeypatch):
    _, created = c.create({"fileUrl": c.upload_wav()})
    first = c.poll(created["id"])
    calls = []
    real = c.server_mod.post_process_segments
    monkeypatch.setattr(c.server_mod, "post_process_segments",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    again = c.poll(created["id"])
    assert calls == [] and again == first
    return [again]


def flow_truncated_upload(c):
    import http.client
    host, port = c.srv.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=10)
    conn.putrequest("POST", "/api/upload")
    conn.putheader("Content-Length", "50000")
    conn.putheader("x-file-name", "a.wav")
    conn.endheaders()
    conn.send(b"\x00" * 1000)
    conn.sock.shutdown(1)
    resp = conn.getresponse()
    status = resp.status
    conn.close()
    assert not list(c.srv.app_state.upload_dir.glob("*"))
    return [status]


def flow_post_body_capped(c):
    return [c.req("POST", "/api/transcribe", data=b"x" * 100,
                  headers={"Content-Length": str(9 * 1024 ** 3)})]


def flow_upload_prune(c):
    c.upload_wav()
    state = c.srv.app_state
    fid = next(iter(state.uploads))
    state.upload_times[fid] -= 25 * 3600
    state.prune_uploads()
    return [len(state.uploads), list(state.upload_dir.glob("*"))]


def flow_slot_released_without_poll(c):
    c.srv.app_state.store.max_active_per_ip = 1
    file_url = c.upload_wav()
    c.create({"fileUrl": file_url})
    deadline = time.time() + 5
    while c.srv.app_state.store.active_count("127.0.0.1") > 0:
        assert time.time() < deadline, "active slot never released"
        time.sleep(0.02)
    return [c.create({"fileUrl": file_url})[0]]


FLOWS = {f.__name__[5:]: f for f in (
    flow_full_job, flow_progress_from_logs, flow_failed_job,
    flow_language_default, flow_post_validation,
    flow_get_validation_and_ownership, flow_forwarded_for_ignored,
    flow_file_urls, flow_slow_upload_times_out,
    flow_upload_content_length_cap, flow_map_upload_error_table,
    flow_active_job_cap, flow_post_rate_limit, flow_upload_validation,
    flow_shared_key_auth, flow_bearer_fails_closed, flow_second_pass,
    flow_m4a_rejected_without_decoders, flow_success_poll_cached,
    flow_truncated_upload, flow_post_body_capped, flow_upload_prune,
    flow_slot_released_without_poll)}


@pytest.mark.parametrize("name", sorted(FLOWS))
def test_flow_matches_jax_server(name, tmp_path, monkeypatch):
    flow = FLOWS[name]
    seen = {}
    for impl in ("jax", "port"):
        c = Ctx(impl, tmp_path)
        try:
            with monkeypatch.context() as mp:
                args = (c, mp) if "monkeypatch" in \
                    flow.__code__.co_varnames[:flow.__code__.co_argcount] \
                    else (c,)
                seen[impl] = _normalize(json.loads(json.dumps(
                    flow(*args), ensure_ascii=False, default=str)))
        finally:
            c.close()
    assert seen["port"] == seen["jax"]


def test_static_files_and_no_sibling_escape(tmp_path):
    import http.client
    web = tmp_path / "web"
    web.mkdir()
    (web / "index.html").write_text("<html>ok</html>")
    (tmp_path / "web-private").mkdir()
    (tmp_path / "web-private" / "secret.txt").write_text("TOP SECRET")
    seen = {}
    for impl in ("jax", "port"):
        c = Ctx(impl, tmp_path, web_dir=str(web))
        try:
            out = []
            for path in ("/", "/../web-private/secret.txt", "/nope.js"):
                conn = http.client.HTTPConnection(
                    "127.0.0.1", c.srv.server_address[1], timeout=10)
                conn.putrequest("GET", path)
                conn.endheaders()
                resp = conn.getresponse()
                out.append((resp.status, resp.getheader("Content-Type"),
                            resp.read().decode()))
                conn.close()
            seen[impl] = out
        finally:
            c.close()
    assert seen["port"] == seen["jax"]
    assert seen["port"][0][0] == 200 and seen["port"][1][0] == 404


def test_job_state_persistence_matches_jax(tmp_path):
    """Finished jobs and second-pass results survive a JobStore restart;
    interrupted ones come back failed: the port's store writes and reads
    the JAX store's files."""
    records = {}
    for impl in ("jax", "port"):
        jobs_mod = IMPLS[impl][1]
        state_dir = tmp_path / impl
        store = jobs_mod.JobStore(MockBackend(), state_dir=str(state_dir))
        job = store.create("1.2.3.4", "/tmp/a.wav", "zh")
        crashed = store.create("1.2.3.4", "/tmp/b.wav", "zh")
        deadline = time.time() + 5
        while crashed.status != "succeeded":
            assert time.time() < deadline
            time.sleep(0.02)
        job.second_pass_result = {
            "segments": [{"text": "补回", "start": 0.0, "end": 1.0}],
            "second_pass": {"enabled": True, "recovered_segments": 1}}
        store._persist(job)
        crashed.status = "processing"
        store._persist(crashed)
        restarted = jobs_mod.JobStore(MockBackend(), state_dir=str(state_dir))
        back, lost = restarted.get(job.id), restarted.get(crashed.id)
        assert back.status == "succeeded" and back.ip == "1.2.3.4"
        assert lost.status == "failed" and "restarted" in lost.error
        records[impl] = [
            {k: v for k, v in json.loads(p.read_text()).items()
             if k not in ("id", "audio_path", "created_at", "started_at",
                          "finished_at")}
            for p in sorted(state_dir.glob("*.json"),
                            key=lambda p: json.loads(p.read_text())
                            ["audio_path"])]
        # the other package's store reads these files the same way
        other = IMPLS["jax" if impl == "port" else "port"][1]
        again = other.JobStore(MockBackend(), state_dir=str(state_dir))
        assert again.get(job.id).second_pass_result == \
            back.second_pass_result
    assert records["port"] == records["jax"]


def test_second_pass_functions_match_jax():
    audio = np.zeros(16000 * 40, np.float32)
    primary = [{"text": "开头", "start": 0.0, "end": 2.0},
               {"text": "中间", "start": 12.0, "end": 13.0}]
    report = {"suspicious_ranges": [
        {"start": 0.0, "end": 1.0, "duration": 1.0},
        {"start": 10.0, "end": 22.0, "duration": 12.0},
        {"start": 25.0, "end": 38.0, "duration": 13.0}]}

    def clip_transcriber(clip, language, vad_onset, vad_offset, temperature,
                         batch_size=None, diarization=False,
                         use_initial_prompt=False):
        return {"segments": [{"text": "找回的内容", "start": 1.0, "end": 3.0},
                             {"text": "嗯", "start": 4.0, "end": 4.2}]}

    outs = {}
    for impl in ("jax", "port"):
        sp = IMPLS[impl][2]
        opts = sp.SecondPassOptions(max_ranges=2, range_pad_sec=1.2)
        outs[impl] = (sp.select_ranges(report, opts),
                      sp.run_second_pass(audio, "zh", primary, report,
                                         clip_transcriber, opts),
                      sp.merge_recovered(primary, [
                          {"text": "dup", "start": 1.0, "end": 1.9},
                          {"text": "new", "start": 30.0, "end": 31.0}]))
    assert outs["port"] == outs["jax"]
    assert outs["port"][1]["second_pass"]["recovered_segments"] == 2


def test_second_pass_options_from_env_match_jax(monkeypatch):
    monkeypatch.setenv("SECOND_PASS_BATCH_SIZE", "8")
    monkeypatch.setenv("SECOND_PASS_DIARIZATION", "true")
    monkeypatch.setenv("SECOND_PASS_USE_INITIAL_PROMPT", "yes")
    monkeypatch.setenv("SECOND_PASS_MAX_RANGES", "2")
    monkeypatch.setenv("SECOND_PASS_VAD_ONSET", "0.7")
    ours = tsecond.SecondPassOptions.from_env()
    assert vars(ours) == vars(jsecond.SecondPassOptions.from_env())
    assert ours.batch_size == 8 and ours.vad_onset == 0.7


def test_progress_payload_matches_jax():
    for status, logs in (("processing", ["loading model", "still"]),
                         ("processing", ["30% encoding"]),
                         ("succeeded", []), ("starting", [])):
        payloads = []
        for impl in ("jax", "port"):
            job = IMPLS[impl][1].Job(id="j", ip="1.1.1.1", language="zh",
                                     audio_path="", source_filename="")
            job.status, job.logs = status, list(logs)
            payloads.append(IMPLS[impl][0].build_progress_payload(job))
        assert payloads[0] == payloads[1]


def test_rate_limiter_matches_jax():
    ours, theirs = tjobs.RateLimiter(), jjobs.RateLimiter()
    times = [0.0, 1.0, 2.0, 30.0, 59.0, 61.5, 62.0, 130.0]
    assert [ours.check("k", 3, now=t) for t in times] == \
        [theirs.check("k", 3, now=t) for t in times]


# ---------------------------------------------------------------------------
# PipelineBackend over the port's pipeline (CPU, .synth_ckpt weights)
# ---------------------------------------------------------------------------

OPTS = {"max_new_tokens": 40, "suppress_blank": False}


@pytest.fixture(scope="module")
def synth():
    from manual_whisper_tpu.convert.from_hf import load_params
    params = load_params(".synth_ckpt")
    if params is None:
        pytest.skip("no committed synth checkpoint")
    return params


def _synth_audio(seed=123, n_utts=3):
    from manual_whisper_tpu.eval.synth import (render_file_with_times,
                                               sample_text)
    rng = np.random.default_rng(seed)
    utts = [sample_text(rng, 4, 8) for _ in range(n_utts)]
    audio, _ = render_file_with_times(utts, seed=seed)
    return audio


def _jax_backend(synth, monkeypatch):
    from manual_whisper_tpu.models import MODEL_CONFIGS as JCONFIGS
    from manual_whisper_tpu.models.vad import VadOptions as JVadOptions
    from manual_whisper_tpu.pipeline.transcribe import TranscribePipeline
    from manual_whisper_tpu.tokenizer import make_test_tokenizer

    def load(name, language=None, asr_options=None, vad_options=None, **kw):
        return TranscribePipeline(
            synth, JCONFIGS["test"], make_test_tokenizer(),
            asr_options={**asr_options, **OPTS},
            vad_options=JVadOptions(**vad_options), language=language)
    monkeypatch.setattr(jpipeline_pkg, "load_model", load)
    return jjobs.PipelineBackend(model_name="test")


def _port_backend(synth, monkeypatch, batch_size=None):
    from manual_whisper_tpu_torch.models import MODEL_CONFIGS

    def load(name, device, language=None, asr_options=None,
             vad_options=None):
        return PORT_LOAD_MODEL(synth, device=device, compute_type="float32",
                    cfg=MODEL_CONFIGS["test"], language=language,
                    asr_options={**asr_options, **OPTS},
                    vad_options=vad_options)
    monkeypatch.setattr(tpipeline_pkg, "load_model", load)
    return tjobs.PipelineBackend(model_name="test", batch_size=batch_size,
                                 device="cpu")


def _keys(segments):
    return [(s["text"], s["start"], s["end"]) for s in segments]


def test_pipeline_backend_matches_jax_on_wav_and_flac(synth, tmp_path,
                                                      monkeypatch):
    monkeypatch.delenv("HF_TOKEN", raising=False)
    audio = _synth_audio()
    wav, flac = tmp_path / "m.wav", tmp_path / "m.flac"
    write_wav(wav, audio, 16000)
    write_flac(flac, audio, 16000)
    jb, tb = _jax_backend(synth, monkeypatch), _port_backend(synth,
                                                             monkeypatch)
    assert tb.batch_size == jb.batch_size == 16
    assert tb.model.device.type == "cpu"
    for path in (wav, flac):
        logs = {"jax": [], "port": []}
        ref = jb.transcribe(str(path), "en",
                            lambda p, m: logs["jax"].append((p, m)))
        out = tb.transcribe(str(path), "en",
                            lambda p, m: logs["port"].append((p, m)))
        assert out["language"] == ref["language"] == "en"
        assert _keys(out["segments"]) == _keys(ref["segments"])
        assert out["segments"], "the synth checkpoint transcribed nothing"
        ours, theirs = (post_process_segments(out["segments"]),
                        j_post(ref["segments"]))
        assert _keys(ours["segments"]) == _keys(theirs["segments"])
        assert ours["stats"] == theirs["stats"]
        assert ours["quality_report"] == theirs["quality_report"]
        assert format_to_markdown(ours["segments"]) == \
            j_md(theirs["segments"])
        assert [p for p, _ in logs["port"]][-1] == 90.0


def _view(result):
    """What alignment and diarization produce: each segment's text, times,
    speaker and words (the decoder's float statistics are left out; the
    backend tests above hold the transcription itself)."""
    keep = ("text", "start", "end", "speaker", "words")
    return {"language": result["language"],
            "segments": [{k: s[k] for k in keep if k in s}
                         for s in result["segments"]],
            "word_segments": result.get("word_segments")}


def _late(logs):
    """The progress lines after the transcription (the earlier ones carry
    times)."""
    return [(p, m) for p, m in logs if p > 90.0]


def test_alignment_and_diarization_report_not_ported(synth, tmp_path,
                                                     monkeypatch):
    """ENABLE_ALIGNMENT and ENABLE_DIARIZATION with an empty registry: both
    backends report the same missing aligner ("alignment unavailable:
    ...") and go on; both diarize with the weightless flow (energy VAD
    windows, 40-mel statistics embeddings) to the same speakers, in the
    job and in a second-pass clip."""
    monkeypatch.setenv("ENABLE_ALIGNMENT", "true")
    monkeypatch.setenv("ENABLE_DIARIZATION", "true")
    wav = tmp_path / "m.wav"
    write_wav(wav, _synth_audio(7, n_utts=1), 16000)
    jb, tb = _jax_backend(synth, monkeypatch), _port_backend(synth,
                                                             monkeypatch)
    logs = {"jax": [], "port": []}
    ref = jb.transcribe(str(wav), "en", lambda p, m: logs["jax"].append((p, m)))
    out = tb.transcribe(str(wav), "en",
                        lambda p, m: logs["port"].append((p, m)))
    assert out["segments"]
    assert _late(logs["port"]) == _late(logs["jax"])
    msgs = dict(logs["port"])
    assert msgs[92.0].startswith("alignment unavailable: alignment "
                                 "checkpoint not found")
    assert msgs[95.0] == "diarizing speakers"
    assert "not ported" not in json.dumps(logs["port"])
    assert _view(out) == _view(ref)
    assert all("speaker" in s for s in out["segments"])
    clip = _synth_audio(7, n_utts=1)
    got = tb.transcribe_clip(clip, "en", 0.6, 0.42, diarization=True)
    assert _view(got) == _view(jb.transcribe_clip(clip, "en", 0.6, 0.42,
                                                  diarization=True))
    assert all("speaker" in s for s in got["segments"])


def test_align_and_diarization_job_flows_match_jax(synth, tmp_path,
                                                   monkeypatch):
    """A job asking for ``align`` and ``diarization`` with the repository's
    synthetic aligner in the registry (the JAX backend reads its orbax tree,
    the port its torch export) gives the JAX backend's result: the same
    words with the same times and scores, and the same speakers.  The
    registry holds no segmentation or embedding weights, so both diarize
    with the windows flow and 40-mel statistics (the JAX PyanNet's
    compiled scans cost minutes of CPU under the suite's workers; the
    segmentation flow is held in test_torch_diarize_pipeline.py)."""
    from manual_whisper_tpu_torch import config as tconfig
    from manual_whisper_tpu import config as jconfig
    weights = Path(__file__).resolve().parent.parent / ".weights"
    registry = tmp_path / "registry"
    registry.mkdir()
    name = "jonatasgrosman--wav2vec2-large-xlsr-53-english"
    (registry / name).symlink_to(weights / name)
    monkeypatch.delenv("ENABLE_ALIGNMENT", raising=False)
    monkeypatch.setenv("MWX_ALLOW_SYNTH_WEIGHTS", "1")
    wav = tmp_path / "m.wav"
    write_wav(wav, _synth_audio(21, n_utts=4), 16000)
    # the pipelines load with the empty registry, as the other backend
    # tests do; the aligner and the diarizer read it at job time
    jb, tb = _jax_backend(synth, monkeypatch), _port_backend(synth,
                                                             monkeypatch)
    monkeypatch.setenv("MWX_WEIGHTS_DIR", str(registry))
    jconfig.clear_env_cache()
    tconfig.clear_env_cache()
    options = {"align": True, "diarization": True}
    logs = {"jax": [], "port": []}
    ref = jb.transcribe(str(wav), "en",
                        lambda p, m: logs["jax"].append((p, m)), options)
    out = tb.transcribe(str(wav), "en",
                        lambda p, m: logs["port"].append((p, m)), options)
    assert _late(logs["port"]) == _late(logs["jax"])
    assert dict(logs["port"])[92.0] == "aligning word timestamps"
    assert dict(logs["port"])[95.0] == "diarizing speakers"
    assert _view(out) == _view(ref)
    words = [w for s in out["segments"] for w in s["words"]]
    assert words and all("speaker" in w for w in words)
    assert out["word_segments"]


def test_transcribe_clip_on_a_second_thread_changes_nothing(synth, tmp_path,
                                                            monkeypatch):
    """The second pass decodes on its own thread while the worker's job
    decodes: the same results as each alone, each decoder built once."""
    from manual_whisper_tpu_torch.models import decode as tdecode
    audio = _synth_audio(123)
    wav = tmp_path / "m.wav"
    write_wav(wav, audio, 16000)
    clip = _synth_audio(5, n_utts=1)
    built = collections.Counter()
    real_init = tdecode.BatchDecoder.__init__

    def counting_init(self, params, cfg, tokenizer, opts, device, **kw):
        built[(opts.temperatures, opts.initial_prompt)] += 1
        real_init(self, params, cfg, tokenizer, opts, device, **kw)
    monkeypatch.setattr(tdecode.BatchDecoder, "__init__", counting_init)

    alone = _port_backend(synth, monkeypatch, batch_size=2)
    main_ref = alone.transcribe(str(wav), "en", lambda p, m: None)
    clip_ref = alone.transcribe_clip(clip, "en", 0.6, 0.42)
    assert len(built) == 2 and set(built.values()) == {1}
    assert alone.model.last_stats["batches"] >= 1

    built.clear()
    tb = _port_backend(synth, monkeypatch, batch_size=2)
    clip_running, clip_out, stats = threading.Event(), {}, {}
    real_submit = tdecode.BatchDecoder.decode_submit

    def submit(self, *a, **k):
        if threading.current_thread().name == "second-pass":
            clip_running.set()
        return real_submit(self, *a, **k)
    monkeypatch.setattr(tdecode.BatchDecoder, "decode_submit", submit)

    def second_pass():
        clip_out["result"] = tb.transcribe_clip(clip, "en", 0.6, 0.42)
        stats["clip"] = tb.model.last_stats
    worker = threading.Thread(target=second_pass, name="second-pass")

    def progress(pct, msg):
        # after the main job's first batch, start the second pass and let
        # the main job go on only once the clip is decoding
        if msg.startswith("transcribed batch 1 ") and not worker.is_alive():
            worker.start()
            assert clip_running.wait(60)
    main_out = tb.transcribe(str(wav), "en", progress)
    stats["main"] = tb.model.last_stats
    worker.join(120)
    assert clip_running.is_set() and not worker.is_alive()
    assert stats["main"]["batches"] >= 2, "the main job had one batch"
    assert _keys(main_out["segments"]) == _keys(main_ref["segments"])
    assert _keys(clip_out["result"]["segments"]) == \
        _keys(clip_ref["segments"])
    assert len(built) == 2 and set(built.values()) == {1}
    assert stats["main"] is not stats["clip"]
    assert stats["clip"]["windows"] >= 1
    idle = []
    bystander = threading.Thread(
        target=lambda: idle.append(tb.model.last_stats))
    bystander.start()
    bystander.join()
    assert idle == [{}], "a thread that made no transcribe sees stats"


def test_decoder_made_once_under_racing_threads(synth, monkeypatch):
    tb = _port_backend(synth, monkeypatch)
    barrier = threading.Barrier(8)
    got = []

    def grab():
        barrier.wait()
        got.append(tb.model._decoder("en", (0.0,), None))
    threads = [threading.Thread(target=grab) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(got) == 8 and all(d is got[0] for d in got)
    assert len(tb.model._decoders) == 1


def test_launch_counts_exact_with_threads_counting_and_recording():
    """Wrappers on many threads lose no count; the launches one thread
    makes while it records a capture go into the capture's record only,
    and another thread's launches meanwhile stay in ``launches``."""
    before = collections.Counter(_build.launches)
    n_threads, per_thread = 8, 2000
    start = threading.Barrier(n_threads + 1)
    recorded = {}
    in_capture, counted = threading.Event(), threading.Event()

    def hammer():
        start.wait()
        for _ in range(per_thread):
            _build.count("test_kernel")

    def capture():
        with _build.recording() as record:
            in_capture.set()
            for _ in range(5):
                _build.count("test_kernel")
            assert counted.wait(10)
            recorded["record"] = record

    cap = threading.Thread(target=capture)
    cap.start()
    assert in_capture.wait(10)
    threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
    for t in threads:
        t.start()
    start.wait()
    for t in threads:
        t.join()
    counted.set()
    cap.join()
    ran = _build.launches - before
    try:
        assert ran["test_kernel"] == n_threads * per_thread
        assert recorded["record"] == collections.Counter(test_kernel=5)
        _build.add(recorded["record"])      # one replay
        assert (_build.launches - before)["test_kernel"] == \
            n_threads * per_thread + 5
    finally:
        del _build.launches["test_kernel"]


def test_pipeline_backend_needs_cuda_unless_cpu_is_asked_for(monkeypatch):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("WHISPER_MODEL", "test")
    with pytest.raises(RuntimeError, match="CUDA"):
        tjobs.PipelineBackend()
    backend = tjobs.PipelineBackend(device="cpu")
    assert backend.model.device.type == "cpu" and backend.batch_size == 16
