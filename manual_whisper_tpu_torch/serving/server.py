"""HTTP job server — the reference's web API contract on the port's GPU
backend (a copy of the JAX package's ``serving/server.py``; ``serve``
builds the port's ``PipelineBackend``).

    python -m manual_whisper_tpu_torch.serving.server [--model large-v3]
        [--host 0.0.0.0] [--port 8000] [--web-dir web]

Re-homes the two Vercel serverless functions so the ``web/`` frontend works
against this server with only a base-URL change (SURVEY.md §7 step 9):

- ``POST /api/upload``    — raw-body ingest, 100 MB cap, ``x-app-key``
  timing-safe auth (reference: web/api/upload.js:13-54,56-78)
- ``POST /api/transcribe``— job create: language validation, rate limit,
  per-IP active cap (reference: web/api/transcribe.js:115-150)
- ``GET  /api/transcribe?id=`` — poll: ownership, progress synthesis from
  "NN%" log lines, on success post-process + REAL second pass + Markdown
  (reference: transcribe.js:57-113; second pass is stubbed there :234-240)
- ``GET /``& static files — serves the web frontend directory when present.

stdlib ``ThreadingHTTPServer``: requests are I/O-bound; inference runs on
the JobStore's single worker (one card = one lane, queued jobs poll as
"starting"); a second pass runs on a thread of its own.

On a host with several GPUs ``serve`` runs on every one of them, as the
JAX server meshes every chip (``parallel/launch.py``): one process a GPU,
each loading the model with the same call; rank 0 serves HTTP and sends
every pipeline call to the other ranks through ``launch.Leader``, and they
follow.  The leader's lock takes one call at a time to the mesh, so there
a second pass waits for the job beside it (and a job for the second
pass), where one GPU decodes both at once.  Alignment and diarization run
on rank 0 only.  ``MWX_AUTO_MESH=false`` keeps to one GPU.
"""

from __future__ import annotations

import hmac
import json
import re
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional
from urllib.parse import parse_qs, urlparse

from .. import config
from ..text.formatting import format_to_markdown
from ..text.processor import post_process_segments
from .jobs import InferenceBackend, JobStore
from .second_pass import SecondPassOptions, run_second_pass

MAX_UPLOAD_BYTES = 100 * 1024 * 1024     # reference: upload.js:6
VALID_LANGUAGES = {"zh", "en", "zh+en"}  # reference: replicateClient.js:13
_PERCENT_RE = re.compile(r"(\d+)%")


class UploadTooLarge(Exception):
    """Body exceeded MAX_UPLOAD_BYTES mid-stream (reference:
    UPLOAD_TOO_LARGE, upload.js:103-131)."""


def _truncate(text: str, limit: int) -> str:
    text = str(text)
    return text if len(text) <= limit else text[: limit - 1] + "…"


def map_upload_error(status: Optional[int] = None, detail: str = "") -> tuple:
    """Backend-error -> user-facing zh-CN message (reference:
    mapUploadError, upload.js:138-168 — the Chinese-first error contract).

    The reference's 401/402 rows name Replicate billing/token problems that
    have no counterpart on a local GPU backend; they fall through to the
    generic 4xx row here.  Returns (status, message)."""
    status = int(status) if status else 0
    if status == 413:
        return 413, "传输文件过大（当前上限约 100MB）"
    if status == 429:
        return 429, "请求过于频繁，请稍后重试"
    if 500 <= status < 600:
        return status, "AI 处理服务暂时不可用，请稍后重试"
    if 400 <= status < 600:
        if detail:
            return status, f"数据处理失败：{_truncate(detail, 140)}"
        return status, "数据处理失败，请稍后重试"
    if detail:
        return 500, f"Upload failed: {_truncate(detail, 180)}"
    return 500, "Upload failed"


class AppState:
    def __init__(self, backend: InferenceBackend, upload_dir: Path,
                 web_dir: Optional[Path] = None):
        self.store = JobStore(backend)
        self.upload_dir = Path(upload_dir)
        self.upload_dir.mkdir(parents=True, exist_ok=True)
        self.web_dir = Path(web_dir) if web_dir else None
        self.uploads: dict = {}
        self.upload_times: dict = {}
        # handler threads insert while prune iterates — both under this
        self.uploads_lock = threading.Lock()
        self.second_pass_lock = threading.Lock()
        self.second_pass_running: set = set()

    def register_upload(self, file_id: str, path: str) -> None:
        with self.uploads_lock:
            self.uploads[file_id] = path
            self.upload_times[file_id] = time.time()

    def upload_path(self, file_id: str) -> Optional[str]:
        with self.uploads_lock:
            return self.uploads.get(file_id)

    def prune_uploads(self, ttl_sec: float = 24 * 3600.0) -> None:
        """Drop upload files + map entries older than the job TTL —
        without this every upload leaks ~100 MB of disk and a dict entry
        forever (job metadata already gets the same 24 h prune)."""
        now = time.time()
        with self.uploads_lock:
            dead = [fid for fid, ts in self.upload_times.items()
                    if now - ts > ttl_sec]
            paths = [self.uploads.pop(fid, None) for fid in dead]
            for fid in dead:
                self.upload_times.pop(fid, None)
        for path in paths:
            if path:
                Path(path).unlink(missing_ok=True)


def _timing_safe_equal(a: str, b: str) -> bool:
    return hmac.compare_digest(a.encode("utf-8"), b.encode("utf-8"))


def build_progress_payload(job) -> dict:
    """Percent from logs + 2-line tail (reference: buildProgressPayload,
    transcribe.js:211-232)."""
    status = job.status
    logs = "\n".join(job.logs)
    percent = 0
    if status == "succeeded":
        percent = 100
    elif status == "processing":
        matches = _PERCENT_RE.findall(logs)
        percent = int(matches[-1]) if matches else 50
    return {
        "percent": percent,
        "status": status,
        "elapsedSec": round(job.predict_time),
        "logsTail": [ln for ln in logs.split("\n")[-2:] if ln],
    }


class Handler(BaseHTTPRequestHandler):
    state: AppState = None  # injected by create_server
    protocol_version = "HTTP/1.1"

    # -- plumbing -------------------------------------------------------------
    def log_message(self, fmt, *args):  # quiet by default
        if config.get_bool("MWX_SERVER_VERBOSE", False):
            super().log_message(fmt, *args)

    def _json(self, status: int, payload: dict) -> None:
        body = json.dumps(payload, ensure_ascii=False).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _client_ip(self) -> str:
        # x-forwarded-for is client-supplied: honoring it unconditionally
        # lets callers bypass rate limits / the active-job cap and
        # impersonate job owners.  Trust it only when the operator has
        # explicitly declared a trusted reverse proxy in front.
        if config.get_bool("MWX_TRUST_PROXY", False):
            fwd = self.headers.get("x-forwarded-for")
            if fwd:
                return fwd.split(",")[0].strip()
        return self.client_address[0] or "127.0.0.1"

    # -- auth (two header schemes, faithful to each endpoint) -----------------
    def _check_upload_key(self) -> Optional[tuple]:
        """x-app-key scheme (reference: upload.js:56-78)."""
        if not config.get_bool("ENFORCE_APP_SHARED_KEY", False):
            return None
        shared = config.get_env("APP_SHARED_KEY")
        if not shared:
            return (500, "Missing APP_SHARED_KEY while "
                         "ENFORCE_APP_SHARED_KEY=true")
        incoming = self.headers.get("x-app-key")
        if not incoming:
            return (401, "Missing app key")
        if not _timing_safe_equal(incoming, shared):
            return (401, "Invalid app key")
        return None

    def _check_bearer_key(self) -> Optional[tuple]:
        """Authorization: Bearer scheme (reference: transcribe.js:185-192)."""
        if not config.get_bool("ENFORCE_APP_SHARED_KEY", False):
            return None
        shared = config.get_env("APP_SHARED_KEY")
        if not shared:
            # fail CLOSED like _check_upload_key: enforcement explicitly
            # on + key missing must not silently open the job API
            return (500, "Missing APP_SHARED_KEY while "
                         "ENFORCE_APP_SHARED_KEY=true")
        auth = self.headers.get("authorization")
        if not auth or not _timing_safe_equal(auth, f"Bearer {shared}"):
            return (401, "Unauthorized")
        return None

    # -- routes ----------------------------------------------------------------
    def do_POST(self):
        path = urlparse(self.path).path
        if path == "/api/upload":
            return self.handle_upload()
        if path == "/api/transcribe":
            return self.handle_transcribe_post()
        self._json(405, {"error": "Method not allowed"})

    def do_GET(self):
        parsed = urlparse(self.path)
        if parsed.path == "/api/transcribe":
            return self.handle_transcribe_get(parse_qs(parsed.query))
        if parsed.path == "/api/upload":
            return self._json(405, {"error": "Method not allowed"})
        return self.handle_static(parsed.path)

    # -- upload (C4) -------------------------------------------------------------
    def _read_body_capped(self, length: int) -> bytes:
        """Stream the request body in chunks under a socket read timeout
        (the reference streams chunks with a running total,
        upload.js:100-136; a one-shot ``rfile.read`` lets a slow-loris
        client pin a server thread indefinitely).

        Raises UploadTooLarge when ``length`` exceeds the cap (defense in
        depth — callers pre-check) and ConnectionError when the client
        disconnects before delivering ``length`` bytes: a truncated body
        must never be stored and acknowledged with 200 as valid audio."""
        if length > MAX_UPLOAD_BYTES:
            raise UploadTooLarge()
        timeout = config.get_float("MWX_UPLOAD_READ_TIMEOUT_SEC", 30.0)
        self.connection.settimeout(timeout)
        chunks: list = []
        remaining = length
        while remaining > 0:
            chunk = self.rfile.read(min(65536, remaining))
            if not chunk:
                raise ConnectionError(
                    f"client disconnected {remaining} bytes early")
            chunks.append(chunk)
            remaining -= len(chunk)
        return b"".join(chunks)

    def handle_upload(self):
        err = self._check_upload_key()
        if err:
            return self._json(err[0], {"error": err[1]})

        length = int(self.headers.get("content-length", 0) or 0)
        if length > MAX_UPLOAD_BYTES:
            return self._json(413,
                              {"error": "Upload too large (max 100MB)"})
        try:
            body = self._read_body_capped(length) if length else b""
        except UploadTooLarge:
            return self._json(413,
                              {"error": "Upload too large (max 100MB)"})
        except ConnectionError:
            self.close_connection = True
            return self._json(400, {"error": "Incomplete upload body"})
        except (TimeoutError, OSError):
            self.close_connection = True
            return self._json(408, {"error": "Upload read timed out"})
        if not body:
            return self._json(400, {"error": "Empty upload body"})

        filename = self.headers.get("x-file-name") or "audio_upload"
        # On an ffmpeg-less host, reject undecodable containers at upload
        # time with an actionable zh-CN message instead of failing the job
        # later with a stack (native decoders cover WAV+FLAC only; the
        # reference's default input is .m4a — VERDICT.md r2 #8).  WITH
        # ffmpeg present, accept any suffix — ffmpeg decodes a superset
        # of any fixed list, exactly like the reference's pipeline.
        import shutil as _shutil
        if not _shutil.which("ffmpeg"):
            from ..audio.io import (UnsupportedFormatError,
                                    decodable_suffixes)
            up_suffix = Path(filename).suffix.lower()
            if up_suffix and up_suffix not in decodable_suffixes():
                return self._json(
                    415, {"error": UnsupportedFormatError(up_suffix).zh})
        file_id = uuid.uuid4().hex
        suffix = Path(filename).suffix or ".bin"
        dest = self.state.upload_dir / f"{file_id}{suffix}"
        try:
            dest.write_bytes(body)
        except OSError as exc:
            status, message = map_upload_error(500, str(exc))
            return self._json(status, {"error": message})
        self.state.register_upload(file_id, str(dest))
        self.state.prune_uploads()

        host = self.headers.get("host", "127.0.0.1")
        file_url = f"http://{host}/api/files/{file_id}{suffix}"
        return self._json(200, {"fileUrl": file_url})

    def _resolve_file_url(self, file_url: str) -> Optional[str]:
        """Only URLs minted by the upload endpoint resolve.  ``file://``
        paths would let any remote client probe and transcribe arbitrary
        local files (the reference only accepts its own uploaded-file URLs,
        transcribe.js:131); they are gated behind an explicit trusted-mode
        flag for loopback CLI/test use."""
        m = re.search(r"/api/files/([0-9a-f]{32})", file_url or "")
        if m:
            path = self.state.upload_path(m.group(1))
            if path is not None:
                return path
        if (file_url and file_url.startswith("file://")
                and config.get_bool("MWX_ALLOW_LOCAL_FILE_URLS", False)):
            p = file_url[len("file://"):]
            return p if Path(p).exists() else None
        return None

    # -- transcribe create (C5 POST) ----------------------------------------------
    def handle_transcribe_post(self):
        self.state.store.prune()
        self.state.prune_uploads()
        err = self._check_bearer_key()
        if err:
            return self._json(err[0], {"error": err[1]})
        ip = self._client_ip()
        store = self.state.store

        if not store.rate.check(f"{ip}:post", store.post_limit):
            return self._json(429, {
                "error": "Rate limit exceeded. Try again in a minute."})
        if store.active_count(ip) >= store.max_active_per_ip:
            return self._json(429, {
                "error": f"Too many active jobs. Wait until one completes "
                         f"(max {store.max_active_per_ip})."})

        # JSON control body: tiny by contract — cap it and read under the
        # same socket timeout as uploads (an uncapped one-shot read lets
        # a client pin the thread or buffer gigabytes)
        length = int(self.headers.get("content-length", 0) or 0)
        if length > 1 << 20:
            return self._json(413, {"error": "Request body too large"})
        try:
            body = json.loads(self._read_body_capped(length) or b"{}")
        except (ValueError, OSError):
            body = {}
        file_url = body.get("fileUrl")
        req_language = body.get("language")
        override = (config.get_env("LANGUAGE") or "").strip() or None
        language = override or (
            req_language if isinstance(req_language, str)
            and req_language in VALID_LANGUAGES else "zh")

        if not file_url:
            return self._json(400, {"error": "Missing fileUrl"})
        allow_local = config.get_bool("MWX_ALLOW_LOCAL_FILE_URLS", False)
        if not str(file_url).startswith("http") \
                and not (allow_local and str(file_url).startswith("file://")):
            return self._json(400, {"error": "Invalid file URL"})
        audio_path = self._resolve_file_url(str(file_url))
        if audio_path is None:
            return self._json(400, {"error": "Unknown file URL"})

        job = store.create(ip, audio_path, language,
                           source_filename=body.get("sourceFilename") or "")
        return self._json(201, {
            "id": job.id,
            "status": job.status,
            "progress": build_progress_payload(job),
        })

    # -- transcribe poll (C5 GET) ---------------------------------------------------
    def handle_transcribe_get(self, query):
        self.state.store.prune()
        err = self._check_bearer_key()
        if err:
            return self._json(err[0], {"error": err[1]})
        ip = self._client_ip()
        store = self.state.store

        if not store.rate.check(f"{ip}:get", store.get_limit):
            return self._json(429, {
                "error": "Too many polling requests. Slow down and retry."})
        job_id = (query.get("id") or [None])[0]
        if not job_id:
            return self._json(400, {"error": "Missing id"})
        job = store.get(job_id)
        if job is None or job.ip != ip:
            # ownership check (reference: transcribe.js:64-65)
            return self._json(404, {"error": "Prediction not found"})

        store.release_if_done(job)
        progress = build_progress_payload(job)

        if job.status == "succeeded":
            return self._finish_success(job, progress)
        if job.status == "failed":
            return self._json(200, {"status": "failed", "id": job.id,
                                    "error": job.error,
                                    "progress": progress})
        return self._json(200, {"status": job.status, "id": job.id,
                                "progress": progress})

    def _finish_success(self, job, progress):
        # terminal responses are immutable: compute cleanup / second-pass
        # merge / Markdown once per job, not once per poll (a 1-hour
        # transcript's cleanup x 60 polls/min is real CPU on a 1-core
        # host; the reference has the same per-poll shape but trivial
        # processing, transcribe.js:57-113)
        cached = getattr(job, "_response_cache", None)
        if cached is not None:
            return self._json(200, cached)
        output = dict(job.output or {})
        segments = output.get("segments")
        if isinstance(segments, list):
            cleanup = getattr(job, "_cleanup_cache", None)
            if cleanup is None:
                cleanup = post_process_segments(segments)
                job._cleanup_cache = cleanup
            sp_opts = SecondPassOptions.from_env()
            sp_result = self._maybe_second_pass(job, cleanup, sp_opts)
            if sp_result.get("pending"):
                progress["percent"] = 97
                progress["status"] = "processing"
                progress["secondPass"] = sp_result["info"]
                return self._json(200, {"status": "processing",
                                        "id": job.id,
                                        "progress": progress})
            final_segments = sp_result["segments"]
            output["segments"] = final_segments
            output["cleanup_stats"] = cleanup["stats"]
            output["quality_report"] = cleanup["quality_report"]
            if sp_result.get("info") is not None:
                output["second_pass"] = sp_result["info"]
                progress["secondPass"] = sp_result["info"]
            progress["cleanup"] = output["cleanup_stats"]
            progress["quality"] = output["quality_report"]

        md = format_to_markdown(output.get("segments") or [])
        payload = {
            "status": "succeeded",
            "id": job.id,
            "progress": progress,
            "output": {"markdown": md, "json": output},
        }
        job._response_cache = payload
        return self._json(200, payload)

    def _maybe_second_pass(self, job, cleanup, opts: SecondPassOptions):
        """Real replacement for the reference's stub
        (transcribe.js:234-240): first success poll kicks the re-pass off
        async; polls return pending until it lands on the job."""
        from .second_pass import select_ranges

        if getattr(job, "second_pass_result", None) is not None:
            sp = job.second_pass_result
            return {"segments": sp["segments"], "info": sp["second_pass"]}

        backend = self.state.store.backend
        transcribe_clip = getattr(backend, "transcribe_clip", None)
        ranges = select_ranges(cleanup["quality_report"], opts)
        if (not opts.enabled or not ranges or transcribe_clip is None):
            return {"segments": cleanup["segments"], "info": None}

        with self.state.second_pass_lock:
            if job.id in self.state.second_pass_running:
                return {"pending": True,
                        "info": {"status": "running",
                                 "attempted_ranges": len(ranges)}}
            self.state.second_pass_running.add(job.id)

        store = self.state.store

        def work():
            try:
                from ..audio import load_audio
                audio = load_audio(job.audio_path)
                result = run_second_pass(
                    audio, job.language, cleanup["segments"],
                    cleanup["quality_report"], transcribe_clip, opts)
                job.second_pass_result = result
            except Exception as exc:
                job.second_pass_result = {
                    "segments": cleanup["segments"],
                    "second_pass": {"enabled": True, "error": str(exc),
                                    "attempted_ranges": len(ranges),
                                    "recovered_segments": 0}}
            finally:
                try:
                    # the executor's _persist ran at primary success,
                    # before this thread landed; re-persist so a restart
                    # still serves the merged result (VERDICT r2 weak #5)
                    store._persist(job)
                except Exception:
                    pass
                with self.state.second_pass_lock:
                    self.state.second_pass_running.discard(job.id)

        threading.Thread(target=work, daemon=True).start()
        return {"pending": True,
                "info": {"status": "running",
                         "attempted_ranges": len(ranges)}}

    # -- static frontend ------------------------------------------------------------
    def handle_static(self, path: str):
        web_dir = self.state.web_dir
        if web_dir is None:
            return self._json(404, {"error": "Not found"})
        rel = path.lstrip("/") or "index.html"
        target = (web_dir / rel).resolve()
        # is_relative_to, not startswith: a plain prefix check lets
        # 'GET /../web-private/x' escape to a sibling dir that shares
        # web_dir's name as a string prefix
        if not target.is_relative_to(web_dir.resolve()) \
                or not target.is_file():
            return self._json(404, {"error": "Not found"})
        ctype = {
            ".html": "text/html; charset=utf-8",
            ".js": "text/javascript; charset=utf-8",
            ".css": "text/css; charset=utf-8",
            ".svg": "image/svg+xml",
        }.get(target.suffix, "application/octet-stream")
        body = target.read_bytes()
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def create_server(backend: InferenceBackend, host: str = "127.0.0.1",
                  port: int = 8000, upload_dir: Optional[str] = None,
                  web_dir: Optional[str] = None) -> ThreadingHTTPServer:
    import tempfile
    state = AppState(
        backend,
        Path(upload_dir or tempfile.mkdtemp(prefix="mwx_uploads_")),
        Path(web_dir) if web_dir else None)

    handler = type("BoundHandler", (Handler,), {"state": state})
    server = ThreadingHTTPServer((host, port), handler)
    server.app_state = state
    return server


MODULE = "manual_whisper_tpu_torch.serving.server"


def serve(model_name: Optional[str] = None, host: str = "0.0.0.0",
          port: int = 8000, web_dir: Optional[str] = None) -> None:
    """CLI entry: run the job server on the port's pipeline on the card,
    on every GPU of the host (``launch.start_world``; its other ranks
    follow rank 0's calls)."""
    import contextlib
    from ..parallel.launch import Leader, follow, start_world
    from .jobs import PipelineBackend
    world = start_world(["-m", MODULE]
                        + (["--model", model_name] if model_name else []))
    with world or contextlib.nullcontext():
        backend = PipelineBackend(model_name=model_name,
                                  device="cuda" if world is None
                                  else world.device)
        if world is not None:
            if world.rank != 0:
                follow(backend.model, world)
                return
            backend.model = Leader(backend.model, world)
        _serve(backend, host, port, web_dir)


def _serve(backend, host: str, port: int, web_dir: Optional[str]) -> None:
    default_web = Path(__file__).resolve().parent.parent.parent / "web"
    server = create_server(
        backend, host=host, port=port,
        web_dir=web_dir or (str(default_web) if default_web.exists()
                            else None))
    # build+load the native audio libraries NOW with the full build
    # budget: on an ffmpeg-less host the upload handler consults
    # decodable_suffixes(), whose first call would otherwise compile the
    # C++ decoders inside a client's upload request (the lazy path keeps
    # only a short build cap, audio/native.py _LAZY_BUILD_TIMEOUT)
    try:
        from ..audio.io import decodable_suffixes
        from ..audio.native import warm_native_libs
        warm_native_libs()
        print(f"decodable without ffmpeg: {decodable_suffixes()}")
    except Exception as exc:
        print(f"native audio probe failed (serving continues): {exc}")
    if config.get_bool("MWX_WARMUP", True):
        def _warm():
            t0 = time.time()
            try:
                backend.warmup()
                print(f"warmup: decode chunks captured "
                      f"({time.time() - t0:.0f}s)")
            except Exception as exc:
                print(f"warmup failed (serving continues): {exc}")
        threading.Thread(target=_warm, daemon=True).start()
    print(f"manual-whisper GPU server listening on http://{host}:{port}")
    server.serve_forever()


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default=None)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--web-dir", default=None)
    args = parser.parse_args()
    serve(args.model, args.host, args.port, args.web_dir)
