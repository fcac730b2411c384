"""Job control plane: stores, rate limits, ownership, executor (port of
the JAX package's ``serving/jobs.py``).

Re-homes the reference's serverless control plane
(web/api/transcribe.js:17-31, 152-209): sliding-window rate limits
(6 POST/min, 60 GET/min), per-IP active-job cap (2), job ownership,
24 h TTL pruning — backed by a local GPU worker instead of Replicate
predictions (replicate.predictions.create/get, transcribe.js:134,68).
``InferenceBackend``, ``Job``, ``RateLimiter`` and ``JobStore`` are copies
of the JAX package's; ``PipelineBackend`` runs the port's pipeline on one
device (CUDA unless the caller asks for the CPU).

Jobs execute on a single worker thread: one card serializes inference
anyway, and queued jobs surface as the "starting" status the polling
contract already expects.  The server's second pass calls
``PipelineBackend.transcribe_clip`` from a thread of its own, so two
decodes can run at once (``pipeline/transcribe.py``).

Word alignment and diarization run where the JAX backend runs them, on
the backend's device; when either fails the job goes on without it and
logs the JAX messages ("alignment unavailable: ...", "diarization
unavailable: ...").
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Protocol, Set

from .. import config
from ..device import DeviceLike

RATE_LIMIT_WINDOW_SEC = 60.0
META_TTL_SEC = 24 * 60 * 60.0


class InferenceBackend(Protocol):
    """What the job executor needs: audio path + language -> result dict
    with {"segments": [...], "language": ...}."""

    def transcribe(self, audio_path: str, language: str,
                   progress: Callable[[float, str], None],
                   options: Optional[dict] = None) -> dict: ...


@dataclass
class Job:
    id: str
    ip: str
    language: str
    audio_path: str
    source_filename: str
    status: str = "starting"     # starting | processing | succeeded | failed
    logs: List[str] = field(default_factory=list)
    output: Optional[dict] = None
    error: Optional[str] = None
    created_at: float = field(default_factory=time.time)
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    options: dict = field(default_factory=dict)
    # merged second-pass output; persisted so a restart between primary
    # success and second-pass completion still serves the merged result
    second_pass_result: Optional[dict] = None

    @property
    def predict_time(self) -> float:
        if self.started_at is None:
            return 0.0
        end = self.finished_at or time.time()
        return end - self.started_at

    def log(self, message: str) -> None:
        self.logs.append(message)


class RateLimiter:
    """Sliding-window counter (reference: checkRateLimit,
    transcribe.js:167-177 — window resets rather than slides, kept)."""

    def __init__(self):
        self._state: Dict[str, tuple] = {}
        self._lock = threading.Lock()

    def check(self, key: str, limit: int, now: Optional[float] = None
              ) -> bool:
        now = now if now is not None else time.time()
        with self._lock:
            # drop expired windows occasionally: one entry per client IP
            # forever is an unbounded leak under address-sweeping traffic
            if len(self._state) > 4096:
                self._state = {k: v for k, v in self._state.items()
                               if now - v[0] <= RATE_LIMIT_WINDOW_SEC}
            start, count = self._state.get(key, (now, 0))
            if now - start > RATE_LIMIT_WINDOW_SEC:
                start, count = now, 0
            count += 1
            self._state[key] = (start, count)
            return count <= limit


class JobStore:
    """Owns jobs, rate limits and the single-worker executor.

    With ``state_dir`` (or $MWX_JOB_STATE_DIR) set, finished jobs persist
    as JSON and survive server restarts — the reference loses every job on
    a cold start (in-memory globalThis state, SURVEY.md §5
    checkpoint/resume: "a dead poll = lost job"); this closes that gap.
    In-flight jobs are not resumed (the poll contract reports them failed).
    """

    def __init__(self, backend: InferenceBackend,
                 post_limit: Optional[int] = None,
                 get_limit: Optional[int] = None,
                 max_active_per_ip: Optional[int] = None,
                 state_dir: Optional[str] = None):
        self.backend = backend
        self.post_limit = post_limit if post_limit is not None else \
            config.get_int("POST_RATE_LIMIT_PER_MIN", 6)
        self.get_limit = get_limit if get_limit is not None else \
            config.get_int("GET_RATE_LIMIT_PER_MIN", 60)
        self.max_active_per_ip = max_active_per_ip if max_active_per_ip \
            is not None else config.get_int("MAX_ACTIVE_JOBS_PER_IP", 2)

        self.rate = RateLimiter()
        self.jobs: Dict[str, Job] = {}
        self.active_by_ip: Dict[str, Set[str]] = {}
        self._lock = threading.Lock()
        self._queue: "queue.Queue[str]" = queue.Queue()

        state_dir = state_dir or config.get_env("MWX_JOB_STATE_DIR")
        self.state_dir = None
        if state_dir:
            from pathlib import Path
            self.state_dir = Path(state_dir)
            self.state_dir.mkdir(parents=True, exist_ok=True)
            self._restore_state()

        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- persistence -----------------------------------------------------------
    def _persist(self, job: Job) -> None:
        if self.state_dir is None:
            return
        import json
        payload = {
            "id": job.id, "ip": job.ip, "language": job.language,
            "audio_path": job.audio_path,
            "source_filename": job.source_filename,
            "status": job.status, "logs": job.logs[-50:],
            "output": job.output, "error": job.error,
            "created_at": job.created_at, "started_at": job.started_at,
            "finished_at": job.finished_at,
            "second_pass_result": job.second_pass_result,
        }
        tmp = self.state_dir / f".{job.id}.tmp"
        tmp.write_text(json.dumps(payload, ensure_ascii=False),
                       encoding="utf-8")
        tmp.replace(self.state_dir / f"{job.id}.json")

    def _restore_state(self) -> None:
        import json
        now = time.time()
        for path in sorted(self.state_dir.glob("*.json")):
            try:
                data = json.loads(path.read_text(encoding="utf-8"))
            except (ValueError, OSError):
                continue
            if now - data.get("created_at", 0) > META_TTL_SEC:
                path.unlink(missing_ok=True)
                continue
            job = Job(id=data["id"], ip=data["ip"],
                      language=data.get("language", "zh"),
                      audio_path=data.get("audio_path", ""),
                      source_filename=data.get("source_filename", ""),
                      status=data.get("status", "failed"),
                      logs=data.get("logs", []),
                      output=data.get("output"),
                      error=data.get("error"),
                      created_at=data.get("created_at", now))
            job.started_at = data.get("started_at")
            job.finished_at = data.get("finished_at")
            job.second_pass_result = data.get("second_pass_result")
            if job.status in ("starting", "processing"):
                # interrupted by the restart: surface as failed
                job.status = "failed"
                job.error = "server restarted while the job was running"
            self.jobs[job.id] = job

    # -- lifecycle -----------------------------------------------------------
    def prune(self, now: Optional[float] = None) -> None:
        """24 h TTL prune (reference: pruneState, transcribe.js:154-165)."""
        now = now if now is not None else time.time()
        with self._lock:
            dead = [jid for jid, job in self.jobs.items()
                    if now - job.created_at > META_TTL_SEC]
            for jid in dead:
                job = self.jobs.pop(jid)
                self.active_by_ip.get(job.ip, set()).discard(jid)
                if self.state_dir is not None:
                    (self.state_dir / f"{jid}.json").unlink(missing_ok=True)

    def active_count(self, ip: str) -> int:
        with self._lock:
            return len(self.active_by_ip.get(ip, set()))

    def create(self, ip: str, audio_path: str, language: str,
               source_filename: str = "", options: Optional[dict] = None
               ) -> Job:
        job = Job(id=uuid.uuid4().hex[:24], ip=ip, language=language,
                  audio_path=audio_path, source_filename=source_filename,
                  options=options or {})
        with self._lock:
            self.jobs[job.id] = job
            self.active_by_ip.setdefault(ip, set()).add(job.id)
        self._persist(job)
        self._queue.put(job.id)
        return job

    def get(self, job_id: str) -> Optional[Job]:
        with self._lock:
            return self.jobs.get(job_id)

    def release_if_done(self, job: Job) -> None:
        """reference: releaseIfDone, transcribe.js:204-209."""
        if job.status in ("succeeded", "failed", "canceled"):
            with self._lock:
                self.active_by_ip.get(job.ip, set()).discard(job.id)

    # -- executor --------------------------------------------------------------
    def _run(self) -> None:
        while True:
            job_id = self._queue.get()
            job = self.get(job_id)
            if job is None:
                continue
            job.status = "processing"
            job.started_at = time.time()
            job.log("0% starting transcription")

            def progress(pct: float, msg: str) -> None:
                job.log(f"{int(pct)}% {msg}")

            try:
                result = self.backend.transcribe(
                    job.audio_path, job.language, progress,
                    options=job.options)
                job.output = result
                job.status = "succeeded"
                job.log("100% done")
            except Exception as exc:  # surface as failed prediction
                # typed errors may carry a zh-CN user-facing message
                # (e.g. audio.io.UnsupportedFormatError)
                job.error = getattr(exc, "zh", None) or str(exc)
                job.status = "failed"
                job.log(f"error: {exc}")
                traceback.print_exc()
            finally:
                job.finished_at = time.time()
                self._persist(job)
                # free the per-IP active slot at completion: releasing
                # only on an owner poll (the reference's shape,
                # transcribe.js:204-209) locks an abandoned client out
                # with 429s until the 24 h TTL prune
                self.release_if_done(job)


def _serving_language(language: str) -> Optional[str]:
    lang = None if language in ("", "auto") else language
    return "zh" if lang == "zh+en" else lang


class PipelineBackend:
    """InferenceBackend over the port's pipeline on ``device`` (CUDA by
    default), mirroring what the Replicate whisperx container does
    remotely (SURVEY.md D8).  The same .env knobs as the JAX backend:
    WHISPER_MODEL, BATCH_SIZE (16), BEAM_SIZE, MWX_CKV_SCALE,
    USE_INITIAL_PROMPT / INITIAL_PROMPT / DOMAIN_TERMS, VAD_ONSET,
    VAD_OFFSET, LANGUAGE, TEMPERATURE."""

    def __init__(self, model_name: Optional[str] = None,
                 batch_size: Optional[int] = None,
                 device: DeviceLike = "cuda"):
        from ..pipeline import load_model
        from ..text.cleaning import INITIAL_PROMPT

        self.model_name = model_name or config.get_env(
            "WHISPER_MODEL", "large-v3")
        self.batch_size = batch_size or config.get_int("BATCH_SIZE", 16)
        asr_options = {"beam_size": config.get_int("BEAM_SIZE", 1),
                       "ckv_scale_bf16":
                           config.get_env("MWX_CKV_SCALE", "f32") == "bf16"}
        if config.get_bool("USE_INITIAL_PROMPT", False):
            prompt = config.get_env("INITIAL_PROMPT")
            if not prompt:
                # DOMAIN_TERMS rebuilds the prompt the way the reference
                # CLI does (transcribe.py:39-40: 术语参考 + 顿号-joined terms)
                terms = config.get_env("DOMAIN_TERMS")
                prompt = ("中文会议讨论记录，保持原意与术语准确。术语参考："
                          + "、".join(t.strip() for t in terms.split(",")
                                      if t.strip()) + "。"
                          ) if terms else INITIAL_PROMPT
            asr_options["initial_prompt"] = prompt
        self.model = load_model(
            self.model_name,
            device=device,
            language=None,
            asr_options=asr_options,
            vad_options={
                "vad_onset": config.get_float("VAD_ONSET", 0.50),
                "vad_offset": config.get_float("VAD_OFFSET", 0.36),
            })
        # the aligner and the diarizer run on the pipeline's device
        self.device = self.model.device

    def warmup(self) -> None:
        """Capture the serving batch's decode buckets ahead of the first
        job (at batch 16: 2, 4, 8 and 16 rows), as ``serve`` does in a
        background thread at start."""
        lang = config.get_env("LANGUAGE", "zh") or None
        self.model.warmup(batch_size=self.batch_size, language=lang,
                          temperature=config.get_float("TEMPERATURE", 0.0))

    def transcribe(self, audio_path: str, language: str,
                   progress: Callable[[float, str], None],
                   options: Optional[dict] = None) -> dict:
        from ..audio import load_audio
        options = options or {}
        audio = load_audio(audio_path)
        result = self.model.transcribe(
            audio, batch_size=self.batch_size,
            language=_serving_language(language),
            temperature=config.get_float("TEMPERATURE", 0.0),
            progress_callback=lambda pct, msg: progress(pct * 0.9, msg))

        if options.get("align") or config.get_bool("ENABLE_ALIGNMENT",
                                                   False):
            try:
                from ..models.align import align_result
                progress(92.0, "aligning word timestamps")
                result = align_result(result, audio,
                                      result.get("language", "zh"),
                                      device=self.device)
            except Exception as exc:
                progress(92.0, f"alignment unavailable: {exc}")

        hf_token = config.get_env("HF_TOKEN")
        diarize_on = config.get_bool("ENABLE_DIARIZATION",
                                     bool(hf_token))
        if options.get("diarization", diarize_on):
            try:
                from ..models.diarize import (DiarizationPipeline,
                                              assign_word_speakers)
                progress(95.0, "diarizing speakers")
                diarizer = DiarizationPipeline(use_auth_token=hf_token,
                                               device=self.device)
                diar_segments = diarizer(audio)
                result = assign_word_speakers(diar_segments, result)
            except Exception as exc:
                progress(95.0, f"diarization unavailable: {exc}")

        return result

    def transcribe_clip(self, clip, language: str, vad_onset: float,
                        vad_offset: float, temperature: float = 0.0,
                        batch_size: Optional[int] = None,
                        diarization: bool = False,
                        use_initial_prompt: bool = False) -> dict:
        """Second-pass hook (serving/second_pass.py): re-run a short clip
        with stricter VAD, one temperature and (by default) no prompt,
        optionally diarizing the recovered segments.

        VAD and prompt overrides flow through ``model.transcribe`` call
        arguments — the second pass runs on a daemon thread concurrently
        with the main job worker, so mutating shared pipeline state here
        would leak these settings into main-pass jobs."""
        from ..models.vad import VadOptions
        from ..text.cleaning import INITIAL_PROMPT
        prompt = None
        if use_initial_prompt:
            prompt = self.model.asr_options.get("initial_prompt") or \
                config.get_env("INITIAL_PROMPT", INITIAL_PROMPT)
        result = self.model.transcribe(
            clip, batch_size=batch_size or self.batch_size,
            language=_serving_language(language),
            temperature=(float(temperature),),
            vad_options=VadOptions(vad_onset=vad_onset,
                                   vad_offset=vad_offset),
            initial_prompt=prompt)
        if diarization:
            try:
                from ..models.diarize import (DiarizationPipeline,
                                              assign_word_speakers)
                diarizer = DiarizationPipeline(
                    use_auth_token=config.get_env("HF_TOKEN"),
                    device=self.device)
                result = assign_word_speakers(diarizer(clip), result)
            except Exception:
                pass  # recovered segments keep no speaker labels
        return result
