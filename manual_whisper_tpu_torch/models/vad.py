"""Voice activity detection: the energy VAD (port of the JAX ``models/vad.py``).

- ``energy_vad_probs``: dependency-free adaptive energy VAD (numpy).
- ``binarize``: onset/offset hysteresis + min-duration rules (pyannote
  ``Binarize`` semantics) on host numpy.
- ``VoiceActivityDetector``: the pipeline's VAD surface; yields once.

PyanNet segmentation (SincNet + BiLSTM) is not ported yet; ``load_model``
warns when the registry holds its checkpoint, so the gap is visible.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

SAMPLE_RATE = 16000


def energy_vad_probs(audio: np.ndarray, hop: int = 160,
                     win: int = 400) -> Tuple[np.ndarray, float]:
    """Adaptive log-energy speech probabilities.

    Returns (probs [n_frames], frame_duration_sec).  Noise floor / speech
    ceiling are the 10th/90th percentiles of frame log-energy, so the
    mapping adapts to recording level.
    """
    audio = np.asarray(audio, np.float32)
    n_frames = max(0, (len(audio) - win) // hop + 1)
    if n_frames == 0:
        return np.zeros(0, np.float32), hop / SAMPLE_RATE
    # O(n) sliding energy via cumulative sum (a [n_frames, win] gather
    # costs ~150 MB of indices per hour of audio)
    csum = np.concatenate([[0.0], np.cumsum(audio.astype(np.float64) ** 2)])
    starts = hop * np.arange(n_frames)
    frame_energy = (csum[starts + win] - csum[starts]) / win
    energy = np.log10(frame_energy + 1e-10)
    padded = np.pad(energy, 2, mode="edge")
    smooth = np.convolve(padded, np.ones(5) / 5, mode="valid")
    floor = np.percentile(smooth, 10)
    ceil = np.percentile(smooth, 90)
    if ceil - floor < 0.5:  # < half a decade of dynamic range: no speech
        return np.zeros_like(smooth, dtype=np.float32), hop / SAMPLE_RATE
    span = max(ceil - floor, 1.0)
    probs = np.clip((smooth - floor) / span, 0.0, 1.0)
    return probs.astype(np.float32), hop / SAMPLE_RATE


@dataclasses.dataclass(frozen=True)
class VadOptions:
    """Knob names/defaults from the reference (transcribe.py:43-46;
    second-pass variants web/.env.example:44-45)."""
    vad_onset: float = 0.5
    vad_offset: float = 0.363
    min_duration_on: float = 0.0
    min_duration_off: float = 0.0
    pad_onset: float = 0.0
    pad_offset: float = 0.0


def binarize(probs: np.ndarray, frame_duration: float,
             opts: VadOptions = VadOptions()) -> List[Tuple[float, float]]:
    """Hysteresis binarisation (pyannote Binarize semantics): a region
    triggers when prob > onset and ends when prob < offset; then short gaps
    (< min_duration_off) are filled and short regions (< min_duration_on)
    dropped."""
    probs = np.asarray(probs, np.float32)
    n = len(probs)
    if n == 0:
        return []
    # vectorised hysteresis: active state = (most recent onset/offset event
    # was an onset).  Python-loop version cost ~4 s per hour of audio.
    events = np.zeros(n, np.int8)
    events[probs > opts.vad_onset] = 1
    events[probs < opts.vad_offset] = -1
    idx = np.arange(n)
    has_event = events != 0
    last_event_idx = np.maximum.accumulate(np.where(has_event, idx, -1))
    active = np.zeros(n, bool)
    valid = last_event_idx >= 0
    active[valid] = events[last_event_idx[valid]] == 1

    edges = np.diff(active.astype(np.int8))
    starts = list(np.nonzero(edges == 1)[0] + 1)
    ends = list(np.nonzero(edges == -1)[0] + 1)
    if active[0]:
        starts.insert(0, 0)
    if active[-1]:
        ends.append(n)
    regions: List[Tuple[float, float]] = [
        (s * frame_duration, e * frame_duration)
        for s, e in zip(starts, ends)]

    if opts.pad_onset or opts.pad_offset:
        regions = [(max(0.0, s - opts.pad_onset), e + opts.pad_offset)
                   for s, e in regions]

    if opts.min_duration_off > 0 and regions:
        merged = [list(regions[0])]
        for s, e in regions[1:]:
            if s - merged[-1][1] < opts.min_duration_off:
                merged[-1][1] = e
            else:
                merged.append([s, e])
        regions = [tuple(r) for r in merged]

    if opts.min_duration_on > 0:
        regions = [r for r in regions if r[1] - r[0] >= opts.min_duration_on]
    return regions


class VoiceActivityDetector:
    """VAD surface used by the pipeline (energy VAD)."""

    def iter_speech_probs(self, audio: np.ndarray):
        """Yield ``(probs, frame_duration, is_last)``; the energy VAD is one
        numpy pass, so it yields once."""
        probs, frame_dur = energy_vad_probs(np.asarray(audio, np.float32))
        yield probs, frame_dur, True

    def speech_probs(self, audio: np.ndarray) -> Tuple[np.ndarray, float]:
        return energy_vad_probs(np.asarray(audio, np.float32))

    def __call__(self, audio: np.ndarray,
                 opts: "VadOptions" = None) -> List[Tuple[float, float]]:
        probs, frame_dur = self.speech_probs(audio)
        duration = len(audio) / SAMPLE_RATE
        return [(max(0.0, s), min(duration, e))
                for s, e in binarize(probs, frame_dur, opts or VadOptions())]
