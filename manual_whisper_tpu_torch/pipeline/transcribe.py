"""End-to-end transcription pipeline (port of the JAX
``pipeline/transcribe.py``).

VAD segmentation (PyanNet on the pipeline's device when the registry
holds its checkpoint, else the energy VAD), 30 s chunk merging, bucketed
batching, int16 round trip, log-mel (K1), encoder (K2), batched greedy
decode with the temperature fallback ladder (K3, K4; K5 with int8 cross
K/V; with ``beam_size > 1`` beam search at its first rung), per-chunk
segment assembly; with ``compute_type="int8"`` every block matmul runs K6.
With ``asr_options={"without_timestamps": False}`` each batch decodes once
with the timestamp rules instead, and each window is cut into sub-segments
at its decoded timestamp pairs.  Keeps the whisperx-like surface: ``load_model(name,
device); model.transcribe(audio, batch_size, language)``.

As in the JAX pipeline, dispatch is streamed: the VAD yields speech
probabilities block by block, each block's final chunks join the queue,
and every full batch is encoded and its first rung decoded before the
next block is scored.  Each batch is then finalized (its first rung's
results read, the ladder's retries decoded, its segments assembled) on a
fetch worker thread, a FIFO consumer of a bounded queue of in-flight
batches (``MWX_MAX_INFLIGHT_BATCHES``, default 8), so the host work of one
batch overlaps the device work of the next; ``MWX_FETCH_WORKER=0`` (and
any mesh, see below) finalizes on the calling thread instead, over a
window of the same size.  Both paths give the same segments and counts:
each ``BatchDecoder`` runs one loop at a time on its static buffers, and
reseeds its sampling generator before each loop from the batch's dispatch
index, so sampled rungs do not depend on how the threads interleave.  A
failed finalize stops dispatch and re-raises on the calling thread after
the worker is joined; a failed dispatch joins the worker too.

``warmup`` runs one decode per batch bucket ahead of the first request:
on CUDA that captures each bucket's decode chunks as CUDA graphs, which
every later loop replays; on the CPU the chunks run eagerly.  A bucket
first used by a retry is captured on the fetch worker.  ``last_stats``
holds the phase times and counts of the calling thread's most recent
``transcribe`` call (``vad_s``: the VAD's blocks, binarization and
merging, on the calling thread; ``encode_s``: the encodes, on the calling
thread's clock up to an event recorded after each (on CUDA waited for,
so it is the encode's device time and that of work enqueued before it);
``windows``: real audio windows; ``rows``: batch rows, padding included;
``decode_calls`` and ``decode_steps`` as ``BatchDecoder.stats``;
``request``: the call's number in the process; ``kernel_shapes``: the
kernel launches the call made on both threads, replays included, by
(kernel, shape), as ``spans.launch_rows`` gives them, filled when the
call returns).

``last_stats["spans"][role][name]`` is ``[seconds, count]`` of each
program span (``spans.py``; ``spans.SPANS`` lists them) closed on one
thread: ``dispatch``, the calling thread (VAD blocks, chunking, the
encode's preparation, upload, launches and wait, each first-rung decode
loop and its parts, the hand-off to the in-flight window, and on the
serial path the finalizations), and ``fetch``, the fetch worker (each
batch's finalize, its wait for the results, text and gates, the
ladder's rungs and their decode loops).  A rung's ``decode.loop`` nests
in its ``finalize.retry``, so on the serial path ``decode.loop`` holds
the retries' loops too.  Each role's clock is its own thread's, so no
time is summed across threads.  Each thread binds its role's span dict
and the request's launch sink together (``spans.bind``).  While a
``torch.profiler`` trace records, each span is also an ``mwx.<name>``
annotation on the trace's clock, the root ``pipeline.transcribe`` with
the request's number as its argument.

Two threads may transcribe at once (the job server decodes a second pass
while its worker runs the next job): decoders are made under a lock, one
per (language, temperatures, prompt), and each ``BatchDecoder`` runs one
loop at a time on its own static buffers.

With a mesh (``parallel/mesh.py``; ``load_model(mesh="auto")`` builds one
over an initialised world of more than one process) the program is SPMD:
every rank runs the same VAD and chunking, every batch's rows are a
multiple of the data-parallel size, each rank encodes and decodes its
block of the rows on its weight shards, and the decoder gathers the
results, so every rank returns the whole transcription.  A mesh
finalizes on the calling thread: the retries' collectives from a second
thread would interleave with the dispatch thread's in an order that may
differ from rank to rank, and the ranks would wait on each other.  The
CLI and the job server start one process a GPU (``parallel/launch.py``):
rank 0 leads, and every call it makes reaches the other ranks in one
order.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import pickle
import threading
import time
import warnings
from pathlib import Path
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from .. import config
from ..audio import load_audio
from ..convert import (from_jax_pyannet, from_jax_tree,
                       load_segmentation_params)
from ..device import DeviceLike, compute_dtype, resolve_device
from ..from_hf import load_whisper_checkpoint
from ..models.decode import BatchDecoder, DecodingOptions
from ..models.vad import VadOptions, VoiceActivityDetector, binarize
from ..models.whisper import (MODEL_CONFIGS, WhisperConfig, decoder_forward,
                              encode, init_params)
from ..ops.mel import log_mel_spectrogram
from ..ops.quant import quantize_params
from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, axis_group, axis_rank,
                             axis_size, local_rows, make_mesh, shard_params)
from ..spans import bind, launch_rows, span
from ..tokenizer import WhisperTokenizer, make_test_tokenizer
from .chunking import SpeechChunk, batch_chunks, merge_chunks

ProgressFn = Callable[[float, str], None]

# "argument not given" sentinel for per-call overrides (None is meaningful:
# it disables the initial prompt)
_UNSET = object()

DEFAULT_TEMPERATURES = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)

# the number of each transcription in the process, the root span's argument
_requests = itertools.count(1)


class TranscribePipeline:
    """Loaded model + tokenizer + VAD on one device, ready to transcribe.

    ``params`` are the port's weights (``convert.from_jax_tree`` or
    ``models.whisper.init_params``), already on ``device``.  ``mesh`` (a
    ``parallel.make_mesh`` mesh) turns on data and tensor parallelism:
    the params are replaced by the rank's shards (``shard_params``) and
    every batch is split over the data dim (``data_parallel`` ranks)."""

    def __init__(self, params, cfg: WhisperConfig,
                 tokenizer: WhisperTokenizer,
                 vad: Optional[VoiceActivityDetector] = None,
                 asr_options: Optional[dict] = None,
                 vad_options: Optional[VadOptions] = None,
                 language: Optional[str] = None,
                 device: DeviceLike = "cuda", mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.data_parallel = 1
        self.model_group = None
        if mesh is not None:
            params = shard_params(params, mesh)
            self.data_parallel = axis_size(mesh, DATA_AXIS)
            self.model_group = axis_group(mesh, MODEL_AXIS)
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.vad = vad or VoiceActivityDetector()
        self.vad_options = vad_options or VadOptions()
        self.language = language
        self.asr_options = asr_options or {}
        self._decoders: Dict[tuple, BatchDecoder] = {}
        self._decoders_lock = threading.Lock()
        self._thread_stats = threading.local()
        # model window: 2 encoder frames per mel frame, 160 samples per mel
        # frame (30 s for real checkpoints; smaller for the test config)
        self.window_samples = cfg.n_audio_ctx * 2 * 160
        self.window_sec = self.window_samples / 16000.0

    @property
    def last_stats(self) -> dict:
        """Stats of this thread's most recent ``transcribe`` (empty when
        this thread made none)."""
        return getattr(self._thread_stats, "stats", {})

    # -- helpers ------------------------------------------------------------
    def _decoder(self, language: str, temperature,
                 initial_prompt=_UNSET) -> BatchDecoder:
        temps = (tuple(temperature) if isinstance(temperature, (list, tuple))
                 else (DEFAULT_TEMPERATURES if temperature == 0
                       else (float(temperature),)))
        if initial_prompt is _UNSET:
            initial_prompt = self.asr_options.get("initial_prompt")
        key = (language, temps, initial_prompt)
        with self._decoders_lock:
            if key in self._decoders:
                # least recently used goes first: a hit moves to the end
                self._decoders[key] = self._decoders.pop(key)
            else:
                while len(self._decoders) >= 8:
                    self._decoders.pop(next(iter(self._decoders)))
                # forward every DecodingOptions field present in
                # asr_options (the whisperx asr_options surface,
                # transcribe.py:111)
                fields = {f.name for f in dataclasses.fields(DecodingOptions)}
                passthrough = {k: v for k, v in self.asr_options.items()
                               if k in fields and k not in
                               ("language", "temperatures", "initial_prompt")}
                opts = DecodingOptions(language=language, temperatures=temps,
                                       initial_prompt=initial_prompt,
                                       **passthrough)
                self._decoders[key] = BatchDecoder(
                    self.params, self.cfg, self.tokenizer, opts, self.device,
                    mesh=self.mesh)
            return self._decoders[key]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _wait_for_stream(self) -> None:
        """Wait for the work this thread has enqueued so far, and not for
        what other threads enqueue after it (``torch.cuda.synchronize``
        would also wait for the fetch worker's queued retries)."""
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            done.synchronize()

    def _local(self, windows: np.ndarray) -> np.ndarray:
        """The rank's block of a batch's rows (all of them without a
        mesh)."""
        if self.mesh is None:
            return windows
        return local_rows(windows, self.data_parallel,
                          axis_rank(self.mesh, DATA_AXIS))

    def _encode_windows(self, windows: np.ndarray) -> torch.Tensor:
        """Host float windows -> encoder states.  Audio crosses to the
        device as int16 (native PCM width, half the bytes of f32)."""
        with span("encode.prep"):
            audio_i16 = np.clip(windows * 32768.0, -32768,
                                32767).astype(np.int16)
        with span("encode.upload"):
            audio = torch.from_numpy(audio_i16).to(self.device)
            audio = audio.to(torch.float32) * (1.0 / 32768.0)
        with span("encode.launch"):
            mel = log_mel_spectrogram(audio, n_mels=self.cfg.n_mels)
            return encode(self.params, mel, self.cfg, group=self.model_group)

    # -- public API ----------------------------------------------------------
    def detect_language(self, audio: np.ndarray) -> str:
        """Single-window language ID (softmax over language tokens after
        SOT), the LANGUAGE='' auto mode of the web tier."""
        window = np.zeros(self.window_samples, np.float32)
        clip = audio[: self.window_samples]
        window[: len(clip)] = clip
        xa = self._encode_windows(window[None])
        sot = torch.tensor([[self.tokenizer.special.sot]], device=self.device)
        logits, _ = decoder_forward(self.params, sot, xa, self.cfg,
                                    group=self.model_group)
        base = self.tokenizer.special.lang_base
        lang_logits = logits[0, 0, base:base + self.tokenizer.num_languages]
        return self.tokenizer.language_from_token(
            base + int(torch.argmax(lang_logits)))

    def warmup(self, batch_size: int = 8, language: Optional[str] = None,
               temperature=0.0,
               progress_callback: Optional[ProgressFn] = None) -> None:
        """Build ahead of time what the first request would otherwise
        build: for every batch bucket the chunk scheduler can emit (1, 2
        and 4 rows for batch 4), encode zero windows and run one T = 0
        decode, which builds the kernels and, on CUDA, captures that
        bucket's decode chunks (every rung replays them); with
        ``beam_size > 1`` that is the beam loop, and a T = 1.0 decode
        captures the greedy loop of the later rungs; in timestamp mode
        (``without_timestamps=False``) the timestamp loop.  Then language
        detection when no language is pinned, then both PyanNet block
        shapes (nothing for the energy VAD).  Port of the JAX
        ``TranscribePipeline.warmup``."""
        from .chunking import _bucket_for
        lang = language or self.language or "zh"
        decoder = self._decoder(lang, temperature)
        use_ts = not self.asr_options.get("without_timestamps", True)
        buckets = sorted({_bucket_for(max(1, batch_size >> k), batch_size,
                                      self.data_parallel)
                          for k in range(4)})
        for i, rows in enumerate(buckets):
            if progress_callback:
                progress_callback(100.0 * i / len(buckets),
                                  f"warmup: batch-{rows} decode loop")
            windows = np.zeros((rows, self.window_samples), np.float32)
            xa = self._encode_windows(self._local(windows))
            if use_ts:
                decoder.decode_with_timestamps(xa, [0.0] * rows,
                                               [self.window_sec] * rows)
                continue
            decoder.decode(xa, temperature=0.0)
            if decoder.opts.beam_size > 1:
                # the later rungs run the greedy loop
                decoder.decode(xa, temperature=1.0)
        if language is None and self.language is None:
            self.detect_language(np.zeros(1600, np.float32))
        self.vad.warmup()
        self._sync()
        if progress_callback:
            progress_callback(100.0, "warmup: done")

    def transcribe(self, audio: Union[str, Path, np.ndarray],
                   batch_size: int = 8,
                   language: Optional[str] = None,
                   chunk_size: Optional[float] = None,
                   temperature=0.0,
                   progress_callback: Optional[ProgressFn] = None,
                   verbose: bool = False,
                   vad_options: Optional[VadOptions] = None,
                   initial_prompt=_UNSET) -> dict:
        """Full pipeline; returns {"segments": [...], "language": lang}
        with the segment dict shape the reference consumes
        ({text, start, end}, transcribe.py:162-181)."""
        if isinstance(audio, (str, Path)):
            audio = load_audio(audio)
        audio = np.asarray(audio, np.float32)
        return self._transcribe_impl(audio, batch_size, language, chunk_size,
                                     temperature, progress_callback, verbose,
                                     vad_options, initial_prompt)

    def _transcribe_impl(self, audio, batch_size, language, chunk_size,
                         temperature, progress_callback, verbose,
                         vad_options=None, initial_prompt=_UNSET) -> dict:
        report_lock = threading.Lock()

        def report(pct, msg):
            # the fetch worker and the dispatch thread both report; the
            # lock keeps callbacks serialised, as a single thread made them
            with report_lock:
                if progress_callback:
                    progress_callback(pct, msg)
                if verbose:
                    print(f"[{pct:3.0f}%] {msg}")

        chunk_size = min(chunk_size or self.window_sec, self.window_sec)
        lang = language or self.language
        request = next(_requests)
        stats = {"vad_s": 0.0, "encode_s": 0.0,
                 "batches": 0, "windows": 0, "rows": 0, "token_rows": 0,
                 "decode_calls": 0, "decode_steps": 0, "beam_calls": 0,
                 "beam_steps": 0, "rung_rows": {}, "request": request,
                 "spans": {}, "kernel_shapes": []}
        self._thread_stats.stats = stats
        launches = collections.Counter()
        try:
            with bind(stats["spans"], "dispatch", launches), \
                    span("pipeline.transcribe", str(request)):
                return self._transcribe_phases(
                    audio, batch_size, lang, chunk_size, temperature, report,
                    vad_options, initial_prompt, stats, launches)
        finally:
            stats["kernel_shapes"] = launch_rows(launches)

    def _transcribe_phases(self, audio, batch_size, lang, chunk_size,
                           temperature, report, vad_options, initial_prompt,
                           stats, launches) -> dict:
        duration = len(audio) / 16000.0
        stats_lock = threading.Lock()
        segments: List[dict] = []
        decoder: Optional[BatchDecoder] = None
        use_ts = not self.asr_options.get("without_timestamps", True)
        counts = ("token_rows", "decode_calls", "decode_steps", "beam_calls",
                  "beam_steps")
        before: tuple = ()
        first_temp = 0.0
        # in-flight batches are bounded: each pins its encoder output on
        # the device; a mesh finalizes inline (see the module docstring)
        max_inflight = config.get_int("MWX_MAX_INFLIGHT_BATCHES", 8)
        use_worker = (config.get_bool("MWX_FETCH_WORKER", True)
                      and self.mesh is None)
        pending: List[tuple] = []
        n_done = 0
        n_dispatched = 0
        t0 = time.perf_counter()

        def finalize_one(item) -> None:
            nonlocal n_done
            group, xa, handle, batch_idx, rows = item
            with span("finalize.batch"):
                if use_ts:
                    # sub-chunk segments from the decoded timestamp pairs;
                    # padding rows get start and duration 0
                    pad = [0.0] * (rows - len(group))
                    found = decoder.timestamps_finalize(
                        handle, [ch.start for ch in group] + pad,
                        [ch.duration for ch in group] + pad)
                    new = [seg for row in found[:len(group)] for seg in row]
                else:
                    results = decoder.decode_with_fallback(
                        xa, first=handle, n_valid=len(group),
                        rng_tag=batch_idx)
                    new = [_segment(ch, res)
                           for ch, res in zip(group, results)
                           if res.text and not decoder.is_no_speech(res)]
                segments.extend(new)
            n_done += 1
            pct = 5.0 + 90.0 * min(group[-1].end / max(duration, 1e-9), 1.0)
            report(pct, f"transcribed batch {n_done} "
                        f"({time.perf_counter() - t0:.1f}s)")

        import queue as queue_mod
        inflight: queue_mod.Queue = queue_mod.Queue(maxsize=max_inflight)
        worker_err: List[BaseException] = []
        worker: Optional[threading.Thread] = None

        def drain():
            # on an error keep taking items without finalizing them, so
            # the producer never blocks on a full queue; the first error
            # re-raises on the calling thread after the join
            with bind(stats["spans"], "fetch", launches):
                while True:
                    item = inflight.get()
                    if item is None:
                        return
                    if not worker_err:
                        try:
                            finalize_one(item)
                        except BaseException as exc:  # noqa: BLE001
                            worker_err.append(exc)    # re-raised

        def dispatch(group: List[SpeechChunk]) -> None:
            # the decoder (and language detection) waits for the first
            # batch, so audio without speech never reaches the device
            nonlocal lang, decoder, before, first_temp, n_dispatched, worker
            if decoder is None:
                if not lang:
                    lang = self.detect_language(audio)
                    report(2.0, f"detected language: {lang}")
                decoder = self._decoder(lang, temperature, initial_prompt)
                before = ({k: decoder.stats[k] for k in counts},
                          dict(decoder.stats["rung_rows"]))
                first_temp = (decoder.opts.temperatures[0]
                              if decoder.opts.temperatures else 0.0)
            with span("chunks.batch"):
                batches = batch_chunks(audio, group, batch_size,
                                       window_samples=self.window_samples,
                                       divisor=self.data_parallel)
            for windows, grp in batches:
                if worker_err:      # the worker failed: dispatch no more
                    return
                t_enc = time.perf_counter()
                xa = self._encode_windows(self._local(windows))
                with span("encode.wait"):
                    self._wait_for_stream()
                t_dec = time.perf_counter()
                # rng_tag: the batch's dispatch index, so sampled rungs
                # draw the same noise however the worker's retries
                # interleave with later dispatches
                handle = (decoder.timestamps_submit(xa) if use_ts else
                          decoder.decode_submit(xa, first_temp,
                                                rng_tag=n_dispatched * 16))
                item = (grp, xa, handle, n_dispatched, len(windows))
                n_dispatched += 1
                with stats_lock:
                    stats["encode_s"] += t_dec - t_enc
                    stats["batches"] += 1
                    stats["windows"] += len(grp)
                    stats["rows"] += len(windows)
                if use_worker and worker is None:
                    worker = threading.Thread(target=drain, daemon=True,
                                              name="mwx-fetch")
                    worker.start()
                with span("inflight.wait"):
                    if use_worker:
                        inflight.put(item)   # blocks at max_inflight
                    else:
                        pending.append(item)
                # the serial path finalizes here what the worker would,
                # each under its own finalize.batch
                while len(pending) > max_inflight:
                    finalize_one(pending.pop(0))

        report(0.0, "voice activity detection")
        # Streamed dispatch, as the JAX pipeline: chunks are final block by
        # block of the VAD, and each full batch is encoded and its first
        # rung decoded as soon as it exists, before the VAD scores the next
        # block; the worker finalizes batches meanwhile.
        opts = vad_options or self.vad_options
        blocks = self.vad.iter_speech_probs(audio)
        queue: List[SpeechChunk] = []
        emitted = 0
        try:
            while not worker_err:
                t_vad = time.perf_counter()
                block = next(blocks, None)
                if block is not None:
                    with span("vad.segments"):
                        probs, frame_dur, is_last = block
                        regions = [(max(0.0, s), min(duration, e)) for s, e
                                   in binarize(probs, frame_dur, opts)]
                        if not is_last and regions:
                            # the last region may still extend or merge
                            # with speech in the next block; chunks
                            # touching it aren't final yet
                            regions = regions[:-1]
                        chunks_all = merge_chunks(regions, chunk_size)
                        # greedy merging is prefix-stable over the
                        # (append-only) finalized regions, except its last
                        # chunk, which may absorb the next region
                        final = chunks_all if is_last else chunks_all[:-1]
                        queue.extend(final[emitted:])
                        emitted = len(final)
                stats["vad_s"] += time.perf_counter() - t_vad
                if block is None:
                    if queue:
                        dispatch(queue)
                    break
                while len(queue) >= batch_size:
                    dispatch(queue[:batch_size])
                    queue = queue[batch_size:]
        finally:
            # sentinel and join whatever happened: a dispatch that raises
            # after the worker started must not leave it parked on
            # inflight.get(), holding its batches' encoder outputs; the
            # worker drains without finalizing once it has failed, so the
            # put cannot block for long
            if worker is not None:
                inflight.put(None)
                worker.join()

        if worker_err:
            raise worker_err[0]
        if n_dispatched == 0:
            report(100.0, "no speech detected")
            return {"segments": [], "language": lang or "zh"}
        while pending:
            finalize_one(pending.pop(0))
        for k in counts:
            stats[k] = decoder.stats[k] - before[0][k]
        stats["rung_rows"] = {
            rung: n - before[1].get(rung, 0)
            for rung, n in sorted(decoder.stats["rung_rows"].items())
            if n - before[1].get(rung, 0)}
        report(100.0, f"transcribed {n_done} batches "
                      f"({time.perf_counter() - t0:.1f}s)")
        return {"segments": segments, "language": lang}


def _segment(ch: SpeechChunk, res) -> dict:
    return {"text": res.text,
            "start": round(ch.start, 3),
            "end": round(ch.end, 3),
            "avg_logprob": res.avg_logprob,
            "no_speech_prob": res.no_speech_prob,
            "compression_ratio": res.compression_ratio,
            "temperature": res.temperature}


def _find_weights_dir(name: str) -> Optional[Path]:
    """HF checkpoint discovery: ``$MWX_WEIGHTS_DIR/<name>``, else ``name``
    as a directory, whichever holds a ``config.json``."""
    root = config.weights_dir()
    if root:
        cand = Path(root) / name
        if (cand / "config.json").exists():
            return cand
    if (Path(name) / "config.json").exists():
        return Path(name)
    return None


def _auto_mesh():
    """The default mesh (JAX ``_auto_mesh``): over an initialised world of
    more than one process, a (data, model) mesh of every rank; else None.

    Knobs: MWX_AUTO_MESH=false disables; MWX_MODEL_PARALLEL sets the TP
    width (default 1, pure data parallel); MWX_DATA_PARALLEL caps the
    device count (a cap below the world raises in ``make_mesh``: every
    process of the world runs the program)."""
    if not config.get_bool("MWX_AUTO_MESH", True):
        return None
    if not (torch.distributed.is_available()
            and torch.distributed.is_initialized()):
        return None
    n = torch.distributed.get_world_size()
    mp = config.get_int("MWX_MODEL_PARALLEL", 1)
    dp_cap = config.get_int("MWX_DATA_PARALLEL", 0)
    if dp_cap:
        n = min(n, dp_cap * mp)
    if n <= 1 or n % mp != 0:
        return None
    return make_mesh(n, model_parallel=mp)


def load_model(name: Union[str, dict] = "large-v3",
               device: DeviceLike = "cuda",
               compute_type: str = "bfloat16",
               language: Optional[str] = None,
               asr_options: Optional[dict] = None,
               vad_options: Optional[dict] = None,
               cfg: Optional[WhisperConfig] = None,
               mesh="auto",
               ) -> TranscribePipeline:
    """whisperx.load_model-style entry (reference: transcribe.py:107-113).

    ``name`` is looked up as the JAX ``load_model`` does: first an HF
    Whisper checkpoint under ``$MWX_WEIGHTS_DIR/<name>`` (or at the path
    ``name``), with its tokenizer when ``vocab.json`` is there; else a
    ``MODEL_CONFIGS`` name (seeded random weights: needs
    ``MWX_ALLOW_RANDOM_WEIGHTS=1`` except for ``test``).  It may also be an
    in-memory JAX param tree of numpy arrays, which then needs ``cfg``.
    Runs on ``device`` (CUDA by default; raises when CUDA is absent),
    PyanNet VAD included when the registry holds its checkpoint.
    ``compute_type``: bfloat16 (default; float16 maps here), float32, or
    int8: bf16 activations with every block matmul weight quantized to
    int8 (``ops.quant.quantize_params``; a tree already quantized passes
    through), as the JAX ``load_model`` does.  ``mesh``: "auto" (default)
    builds one over an initialised world of more than one process
    (``_auto_mesh``); pass a ``parallel.make_mesh`` mesh or None to
    override."""
    dev = resolve_device(device)
    dtype = compute_dtype(compute_type)
    tokenizer = None
    if isinstance(name, dict):
        if cfg is None:
            raise ValueError("load_model(param_tree) needs cfg=WhisperConfig")
        cfg = cfg.with_dtype(dtype)
        params = from_jax_tree(name, cfg, dev)
    elif (weights_dir := _find_weights_dir(name)) is not None:
        params, cfg = load_whisper_checkpoint(weights_dir, dev, dtype)
        if (weights_dir / "vocab.json").exists():
            tokenizer = WhisperTokenizer.from_dir(
                weights_dir, num_languages=cfg.num_languages,
                language=language or "zh")
    elif name in MODEL_CONFIGS:
        if name != "test" and not config.get_bool(
                "MWX_ALLOW_RANDOM_WEIGHTS", False):
            raise FileNotFoundError(
                f"no weights found for {name!r}: set MWX_WEIGHTS_DIR to a "
                "directory containing an HF Whisper checkpoint "
                f"('{name}/config.json' + model.safetensors), or set "
                "MWX_ALLOW_RANDOM_WEIGHTS=1 for synthetic-weight runs")
        cfg = MODEL_CONFIGS[name].with_dtype(dtype)
        params = init_params(cfg, dev, seed=0)
    else:
        raise KeyError(f"unknown model {name!r}; options: "
                       f"{sorted(MODEL_CONFIGS)}, a checkpoint path or a "
                       "param tree")
    if compute_type == "int8":
        params = quantize_params(params)
    if tokenizer is None:
        tokenizer = make_test_tokenizer(cfg.num_languages)
    vad_opts = VadOptions(**vad_options) if vad_options else VadOptions()
    if isinstance(mesh, str) and mesh == "auto":
        mesh = _auto_mesh()
    return TranscribePipeline(params, cfg, tokenizer, vad=_load_vad(dev),
                              asr_options=asr_options,
                              vad_options=vad_opts, language=language,
                              device=dev, mesh=mesh)


def _load_vad(device: torch.device) -> VoiceActivityDetector:
    """PyanNet on ``device`` from the registry's segmentation checkpoint,
    as the JAX ``load_model`` does; else the energy VAD, with the JAX
    package's warning, since speech boundaries (and every window, segment
    and timestamp after them) differ between the two."""
    try:
        tree = load_segmentation_params()
        if tree is not None:
            return VoiceActivityDetector(from_jax_pyannet(tree, device))
        reason = "no pyannote segmentation checkpoint in MWX_WEIGHTS_DIR"
    except (OSError, RuntimeError, KeyError, ValueError,
            pickle.UnpicklingError) as exc:
        reason = f"segmentation weights failed to load: {exc}"
    warnings.warn(
        f"VAD falling back to energy heuristics ({reason}); speech "
        "boundaries and downstream timestamps will differ from pyannote "
        "segmentation on real audio", RuntimeWarning, stacklevel=3)
    return VoiceActivityDetector()
