"""Second-pass re-transcription of suspicious removed ranges (a copy of
the JAX package's ``serving/second_pass.py``).

The reference *specifies* this subsystem in config and docs
(SECOND_PASS_* envs, web/.env.example:38-47; prose web/README.md:120-121)
but ships a stub (maybeResolveSecondPass, web/api/transcribe.js:234-240).
This is the real implementation, consuming the inputs the quality report
already produces (suspicious_ranges, processor.js:258-264):

for each suspicious range (padded by SECOND_PASS_RANGE_PAD_SEC), re-run
the pipeline with stricter VAD (0.60/0.42 defaults) and no initial prompt,
clean the recovered segments, and merge anything that survives back into
the primary transcript in time order.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np

from .. import config
from ..text.processor import PostProcessOptions, post_process_segments

SAMPLE_RATE = 16000

# transcribe_clip(audio_clip, language, vad_onset, vad_offset, temperature)
#   -> {"segments": [{text, start, end}, ...]} with clip-relative times
ClipTranscriber = Callable[..., dict]


@dataclasses.dataclass(frozen=True)
class SecondPassOptions:
    """Knobs and defaults from the reference's web/.env.example:38-47."""
    enabled: bool = True
    max_ranges: int = 4
    min_range_sec: float = 1.5
    range_pad_sec: float = 1.2
    batch_size: int = 16
    temperature: float = 0.0
    vad_onset: float = 0.60
    vad_offset: float = 0.42
    diarization: bool = False
    use_initial_prompt: bool = False

    @classmethod
    def from_env(cls) -> "SecondPassOptions":
        return cls(
            enabled=config.get_bool("ENABLE_SECOND_PASS", True),
            max_ranges=config.get_int("SECOND_PASS_MAX_RANGES", 4),
            min_range_sec=config.get_float("SECOND_PASS_MIN_RANGE_SEC", 1.5),
            range_pad_sec=config.get_float("SECOND_PASS_RANGE_PAD_SEC", 1.2),
            batch_size=config.get_int("SECOND_PASS_BATCH_SIZE", 16),
            temperature=config.get_float("SECOND_PASS_TEMPERATURE", 0.0),
            vad_onset=config.get_float("SECOND_PASS_VAD_ONSET", 0.60),
            vad_offset=config.get_float("SECOND_PASS_VAD_OFFSET", 0.42),
            diarization=config.get_bool("SECOND_PASS_DIARIZATION", False),
            use_initial_prompt=config.get_bool(
                "SECOND_PASS_USE_INITIAL_PROMPT", False),
        )


def select_ranges(quality_report: dict,
                  opts: SecondPassOptions) -> List[dict]:
    """Pick the suspicious ranges worth re-transcribing."""
    ranges = [r for r in quality_report.get("suspicious_ranges", [])
              if r.get("duration", 0.0) >= opts.min_range_sec]
    return ranges[: opts.max_ranges]


def run_second_pass(audio: np.ndarray, language: str,
                    primary_segments: List[dict], quality_report: dict,
                    transcribe_clip: ClipTranscriber,
                    opts: Optional[SecondPassOptions] = None,
                    post_opts: Optional[PostProcessOptions] = None) -> dict:
    """Re-transcribe suspicious ranges and merge recovered segments.

    Returns {"segments": merged, "second_pass": info-dict}; info carries
    the attempted ranges and per-range recovered counts for the UI
    (surfaced as progress.secondPass / output.second_pass in the job API).
    """
    opts = opts or SecondPassOptions.from_env()
    ranges = select_ranges(quality_report, opts)
    info = {
        "enabled": opts.enabled,
        "attempted_ranges": len(ranges),
        "recovered_segments": 0,
        "ranges": [],
    }
    if not opts.enabled or not ranges:
        return {"segments": primary_segments, "second_pass": info}

    # forward the optional knobs only when the transcriber accepts them
    # (mock transcribers in tests keep the minimal 5-arg signature)
    import inspect
    try:
        sig = inspect.signature(transcribe_clip)
        accepted = set(sig.parameters)
        takes_kwargs = any(p.kind is inspect.Parameter.VAR_KEYWORD
                           for p in sig.parameters.values())
    except (TypeError, ValueError):
        accepted, takes_kwargs = set(), False
    extra = {"batch_size": opts.batch_size,
             "diarization": opts.diarization,
             "use_initial_prompt": opts.use_initial_prompt}
    if not takes_kwargs:
        extra = {k: v for k, v in extra.items() if k in accepted}

    duration = len(audio) / SAMPLE_RATE
    recovered_all: List[dict] = []
    for r in ranges:
        start = max(0.0, float(r["start"]) - opts.range_pad_sec)
        end = min(duration, float(r["end"]) + opts.range_pad_sec)
        clip = audio[int(start * SAMPLE_RATE): int(end * SAMPLE_RATE)]
        entry = {"start": r["start"], "end": r["end"], "recovered": 0}
        if len(clip) >= SAMPLE_RATE // 4:
            result = transcribe_clip(
                clip, language=language,
                vad_onset=opts.vad_onset, vad_offset=opts.vad_offset,
                temperature=opts.temperature, **extra)
            cleaned = post_process_segments(
                result.get("segments", []), post_opts)
            for seg in cleaned["segments"]:
                seg = dict(seg)
                seg["start"] = round(seg["start"] + start, 3)
                seg["end"] = round(seg["end"] + start, 3)
                seg["second_pass"] = True
                recovered_all.append(seg)
                entry["recovered"] += 1
        info["ranges"].append(entry)

    info["recovered_segments"] = len(recovered_all)
    merged = merge_recovered(primary_segments, recovered_all)
    return {"segments": merged, "second_pass": info}


def merge_recovered(primary: Sequence[dict],
                    recovered: Sequence[dict]) -> List[dict]:
    """Insert recovered segments in time order, dropping any that overlap
    existing speech by more than half their duration (the primary result
    stays authoritative where it has content)."""
    merged = [dict(s) for s in primary]
    for seg in recovered:
        dur = max(seg["end"] - seg["start"], 1e-6)
        overlap = 0.0
        for p in merged:
            overlap += max(0.0, min(seg["end"], p["end"])
                           - max(seg["start"], p["start"]))
        if overlap / dur <= 0.5:
            merged.append(seg)
    merged.sort(key=lambda s: (s.get("start", 0.0), s.get("end", 0.0)))
    return merged
