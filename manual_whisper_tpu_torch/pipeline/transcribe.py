"""End-to-end transcription pipeline (port of the JAX
``pipeline/transcribe.py``).

VAD segmentation, 30 s chunk merging, bucketed batching, int16 round trip,
log-mel (K1), encoder (K2), batched greedy decode with the temperature
fallback ladder (K3, K4; K5 with int8 cross K/V), per-chunk segment
assembly; with ``compute_type="int8"`` every block matmul runs K6.  Keeps the
whisperx-like surface: ``load_model(name, device); model.transcribe(audio,
batch_size, language)``.

``warmup`` runs one decode per batch bucket ahead of the first request:
on CUDA that captures each bucket's decode chunks as CUDA graphs, which
every later loop replays; on the CPU the chunks run eagerly.  Each batch
is finalized as soon as it is decoded (the JAX package's fetch worker
overlaps device and host work; that is not ported: its second thread
would replay the same static buffers).  ``last_stats``
holds the phase times and counts of the most recent ``transcribe`` call
(``windows``: real audio windows; ``rows``: batch rows, padding included;
``decode_calls`` and ``decode_steps`` as ``BatchDecoder.stats``);
on CUDA each phase ends in a synchronisation so its time is the device's.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from pathlib import Path
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from .. import config
from ..audio import load_audio
from ..convert import from_jax_tree
from ..device import DeviceLike, compute_dtype, resolve_device
from ..models.decode import BatchDecoder, DecodingOptions
from ..models.vad import VadOptions, VoiceActivityDetector, binarize
from ..models.whisper import (MODEL_CONFIGS, WhisperConfig, decoder_forward,
                              encode, init_params)
from ..ops.mel import log_mel_spectrogram
from ..ops.quant import quantize_params
from ..tokenizer import WhisperTokenizer, make_test_tokenizer
from .chunking import SpeechChunk, batch_chunks, merge_chunks

ProgressFn = Callable[[float, str], None]

# "argument not given" sentinel for per-call overrides (None is meaningful:
# it disables the initial prompt)
_UNSET = object()

DEFAULT_TEMPERATURES = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)


class TranscribePipeline:
    """Loaded model + tokenizer + VAD on one device, ready to transcribe.

    ``params`` are the port's weights (``convert.from_jax_tree`` or
    ``models.whisper.init_params``), already on ``device``."""

    def __init__(self, params, cfg: WhisperConfig,
                 tokenizer: WhisperTokenizer,
                 vad: Optional[VoiceActivityDetector] = None,
                 asr_options: Optional[dict] = None,
                 vad_options: Optional[VadOptions] = None,
                 language: Optional[str] = None,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.vad = vad or VoiceActivityDetector()
        self.vad_options = vad_options or VadOptions()
        self.language = language
        self.asr_options = asr_options or {}
        self._decoders: Dict[tuple, BatchDecoder] = {}
        # model window: 2 encoder frames per mel frame, 160 samples per mel
        # frame (30 s for real checkpoints; smaller for the test config)
        self.window_samples = cfg.n_audio_ctx * 2 * 160
        self.window_sec = self.window_samples / 16000.0
        self.last_stats: dict = {}

    # -- helpers ------------------------------------------------------------
    def _decoder(self, language: str, temperature,
                 initial_prompt=_UNSET) -> BatchDecoder:
        temps = (tuple(temperature) if isinstance(temperature, (list, tuple))
                 else (DEFAULT_TEMPERATURES if temperature == 0
                       else (float(temperature),)))
        if initial_prompt is _UNSET:
            initial_prompt = self.asr_options.get("initial_prompt")
        key = (language, temps, initial_prompt)
        if key not in self._decoders:
            while len(self._decoders) >= 8:
                self._decoders.pop(next(iter(self._decoders)))
            # forward every DecodingOptions field present in asr_options
            # (the whisperx asr_options surface, transcribe.py:111)
            fields = {f.name for f in dataclasses.fields(DecodingOptions)}
            passthrough = {k: v for k, v in self.asr_options.items()
                           if k in fields and k not in
                           ("language", "temperatures", "initial_prompt")}
            opts = DecodingOptions(language=language, temperatures=temps,
                                   initial_prompt=initial_prompt,
                                   **passthrough)
            self._decoders[key] = BatchDecoder(
                self.params, self.cfg, self.tokenizer, opts, self.device)
        return self._decoders[key]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _encode_windows(self, windows: np.ndarray) -> torch.Tensor:
        """Host float windows -> encoder states.  Audio crosses to the
        device as int16 (native PCM width, half the bytes of f32)."""
        audio_i16 = np.clip(windows * 32768.0, -32768, 32767).astype(np.int16)
        audio = torch.from_numpy(audio_i16).to(self.device)
        audio = audio.to(torch.float32) * (1.0 / 32768.0)
        mel = log_mel_spectrogram(audio, n_mels=self.cfg.n_mels)
        return encode(self.params, mel, self.cfg)

    # -- public API ----------------------------------------------------------
    def detect_language(self, audio: np.ndarray) -> str:
        """Single-window language ID (softmax over language tokens after
        SOT), the LANGUAGE='' auto mode of the web tier."""
        window = np.zeros(self.window_samples, np.float32)
        clip = audio[: self.window_samples]
        window[: len(clip)] = clip
        xa = self._encode_windows(window[None])
        sot = torch.tensor([[self.tokenizer.special.sot]], device=self.device)
        logits, _ = decoder_forward(self.params, sot, xa, self.cfg)
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
        bucket's decode chunks (every rung replays them); then language
        detection when no language is pinned.  The port raises for the
        timestamp and beam decoders, and its energy VAD builds nothing.
        Port of the JAX ``TranscribePipeline.warmup``."""
        from .chunking import _bucket_for
        lang = language or self.language or "zh"
        decoder = self._decoder(lang, temperature)
        buckets = sorted({_bucket_for(max(1, batch_size >> k), batch_size)
                          for k in range(4)})
        for i, rows in enumerate(buckets):
            if progress_callback:
                progress_callback(100.0 * i / len(buckets),
                                  f"warmup: batch-{rows} decode loop")
            windows = np.zeros((rows, self.window_samples), np.float32)
            decoder.decode(self._encode_windows(windows), temperature=0.0)
        if language is None and self.language is None:
            self.detect_language(np.zeros(1600, np.float32))
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

        def report(pct, msg):
            if progress_callback:
                progress_callback(pct, msg)
            if verbose:
                print(f"[{pct:3.0f}%] {msg}")

        chunk_size = min(chunk_size or self.window_sec, self.window_sec)
        lang = language or self.language
        duration = len(audio) / 16000.0
        stats = {"vad_s": 0.0, "encode_s": 0.0, "decode_s": 0.0,
                 "batches": 0, "windows": 0, "rows": 0, "token_rows": 0,
                 "decode_calls": 0, "decode_steps": 0, "rung_rows": {}}
        self.last_stats = stats
        segments: List[dict] = []
        decoder: Optional[BatchDecoder] = None
        t0 = time.time()

        report(0.0, "voice activity detection")
        opts = vad_options or self.vad_options
        t_vad = time.perf_counter()
        regions: List[tuple] = []
        for probs, frame_dur, _ in self.vad.iter_speech_probs(audio):
            regions = [(max(0.0, s), min(duration, e))
                       for s, e in binarize(probs, frame_dur, opts)]
        chunks = merge_chunks(regions, chunk_size)
        stats["vad_s"] = time.perf_counter() - t_vad

        if not chunks:
            report(100.0, "no speech detected")
            return {"segments": [], "language": lang or "zh"}

        if not lang:
            lang = self.detect_language(audio)
            report(2.0, f"detected language: {lang}")
        decoder = self._decoder(lang, temperature, initial_prompt)
        counts = ("token_rows", "decode_calls", "decode_steps")
        before = ({k: decoder.stats[k] for k in counts},
                  dict(decoder.stats["rung_rows"]))
        first_temp = (decoder.opts.temperatures[0]
                      if decoder.opts.temperatures else 0.0)

        for batch_idx, (windows, group) in enumerate(batch_chunks(
                audio, chunks, batch_size,
                window_samples=self.window_samples)):
            t_enc = time.perf_counter()
            xa = self._encode_windows(windows)
            self._sync()
            t_dec = time.perf_counter()
            stats["encode_s"] += t_dec - t_enc
            first = decoder.decode_submit(xa, first_temp,
                                          rng_tag=batch_idx * 16)
            results = decoder.decode_with_fallback(
                xa, first=first, n_valid=len(group), rng_tag=batch_idx)
            stats["decode_s"] += time.perf_counter() - t_dec
            stats["batches"] += 1
            stats["windows"] += len(group)
            stats["rows"] += len(windows)
            for ch, res in zip(group, results):
                if decoder.is_no_speech(res) or not res.text:
                    continue
                segments.append(_segment(ch, res))
            pct = 5.0 + 90.0 * min(group[-1].end / max(duration, 1e-9), 1.0)
            report(pct, f"transcribed batch {batch_idx + 1} "
                        f"({time.time() - t0:.1f}s)")

        for k in counts:
            stats[k] = decoder.stats[k] - before[0][k]
        stats["rung_rows"] = {
            rung: n - before[1].get(rung, 0)
            for rung, n in sorted(decoder.stats["rung_rows"].items())
            if n - before[1].get(rung, 0)}
        report(100.0, f"transcribed {stats['batches']} batches "
                      f"({time.time() - t0:.1f}s)")
        return {"segments": segments, "language": lang}


def _segment(ch: SpeechChunk, res) -> dict:
    return {"text": res.text,
            "start": round(ch.start, 3),
            "end": round(ch.end, 3),
            "avg_logprob": res.avg_logprob,
            "no_speech_prob": res.no_speech_prob,
            "compression_ratio": res.compression_ratio,
            "temperature": res.temperature}


def load_model(name: Union[str, dict] = "large-v3",
               device: DeviceLike = "cuda",
               compute_type: str = "bfloat16",
               language: Optional[str] = None,
               asr_options: Optional[dict] = None,
               vad_options: Optional[dict] = None,
               cfg: Optional[WhisperConfig] = None,
               ) -> TranscribePipeline:
    """whisperx.load_model-style entry (reference: transcribe.py:107-113).

    ``name`` is a ``MODEL_CONFIGS`` name (seeded random weights: needs
    ``MWX_ALLOW_RANDOM_WEIGHTS=1`` except for ``test``) or an in-memory
    JAX param tree of numpy arrays, which then needs ``cfg``.  Runs on
    ``device`` (CUDA by default; raises when CUDA is absent).
    ``compute_type``: bfloat16 (default; float16 maps here), float32, or
    int8: bf16 activations with every block matmul weight quantized to
    int8 (``ops.quant.quantize_params``; a tree already quantized passes
    through), as the JAX ``load_model`` does."""
    dev = resolve_device(device)
    dtype = compute_dtype(compute_type)
    if isinstance(name, dict):
        if cfg is None:
            raise ValueError("load_model(param_tree) needs cfg=WhisperConfig")
        cfg = cfg.with_dtype(dtype)
        params = from_jax_tree(name, cfg, dev)
    elif name in MODEL_CONFIGS:
        if name != "test" and not config.get_bool(
                "MWX_ALLOW_RANDOM_WEIGHTS", False):
            raise FileNotFoundError(
                f"no weights for {name!r}: the PyTorch port loads no "
                "checkpoint files yet; set MWX_ALLOW_RANDOM_WEIGHTS=1 for "
                "synthetic-weight runs")
        cfg = MODEL_CONFIGS[name].with_dtype(dtype)
        params = init_params(cfg, dev, seed=0)
    else:
        raise KeyError(f"unknown model {name!r}; options: "
                       f"{sorted(MODEL_CONFIGS)} or a param tree")
    if compute_type == "int8":
        params = quantize_params(params)
    tokenizer = make_test_tokenizer(cfg.num_languages)

    root = config.weights_dir()
    if root and (Path(root) / "pyannote-segmentation-3.0").exists():
        warnings.warn(
            "the registry holds pyannote-segmentation-3.0, but PyanNet VAD "
            "is not ported yet: using the energy VAD; speech boundaries and "
            "timestamps will differ from the JAX pipeline on real audio",
            RuntimeWarning, stacklevel=2)
    vad_opts = VadOptions(**vad_options) if vad_options else VadOptions()
    return TranscribePipeline(params, cfg, tokenizer,
                              asr_options=asr_options,
                              vad_options=vad_opts, language=language,
                              device=dev)
