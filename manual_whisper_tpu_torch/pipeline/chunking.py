"""VAD-segment -> 30 s chunk scheduling with static shapes.

WhisperX's long-audio strategy (SURVEY.md §2.3): cut speech into <= 30 s
chunks and batch them; there is no sequence parallelism because Whisper's
window is fixed.  Every chunk is padded to the full 30 s window (Whisper's
feature extractor needs that anyway) and batches are padded to a small
power-of-two ladder of sizes.  Copied from the JAX package, where the ladder
bounds the number of compiled XLA programs; the port keeps it so that its
batches, retries and results match the JAX pipeline's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

SAMPLE_RATE = 16000
CHUNK_LENGTH_SEC = 30.0
N_SAMPLES = int(CHUNK_LENGTH_SEC * SAMPLE_RATE)


@dataclasses.dataclass
class SpeechChunk:
    """One <= 30 s window of merged speech regions."""
    start: float
    end: float
    regions: List[Tuple[float, float]]

    @property
    def duration(self) -> float:
        return self.end - self.start


def merge_chunks(regions: Sequence[Tuple[float, float]],
                 chunk_size: float = CHUNK_LENGTH_SEC,
                 ) -> List[SpeechChunk]:
    """Greedily merge consecutive speech regions into <= chunk_size windows.

    Regions longer than chunk_size are split.  Mirrors WhisperX's
    merge_chunks scheduling (the batching unit behind
    ``model.transcribe(audio, batch_size=...)``, transcribe.py:123).
    """
    split: List[Tuple[float, float]] = []
    for s, e in regions:
        while e - s > chunk_size:
            split.append((s, s + chunk_size))
            s += chunk_size
        if e > s:
            split.append((s, e))

    chunks: List[SpeechChunk] = []
    cur_start = None
    cur_end = None
    cur_regions: List[Tuple[float, float]] = []
    for s, e in split:
        if cur_start is None:
            cur_start, cur_end, cur_regions = s, e, [(s, e)]
        elif e - cur_start <= chunk_size:
            cur_end = e
            cur_regions.append((s, e))
        else:
            chunks.append(SpeechChunk(cur_start, cur_end, cur_regions))
            cur_start, cur_end, cur_regions = s, e, [(s, e)]
    if cur_start is not None:
        chunks.append(SpeechChunk(cur_start, cur_end, cur_regions))
    return chunks


def pad_audio_window(audio: np.ndarray, start: float, end: float,
                     window_samples: int = N_SAMPLES) -> np.ndarray:
    """Extract [start, end) seconds and zero-pad to the static window."""
    s = int(round(start * SAMPLE_RATE))
    e = int(round(end * SAMPLE_RATE))
    clip = audio[s:min(e, len(audio))]
    out = np.zeros(window_samples, np.float32)
    out[: min(len(clip), window_samples)] = clip[:window_samples]
    return out


def _bucket_for(n: int, batch_size: int, divisor: int = 1) -> int:
    """Smallest bucket >= n from {bs, bs/2, bs/4, bs/8} (power-of-two
    ladder).  Full batches compile once; a small trailing batch uses a
    smaller program instead of padding all the way up (a 1-chunk tail in a
    batch-16 program would waste 15/16 of its decode FLOPs).

    ``divisor`` rounds every bucket up to a multiple (the data-parallel
    mesh size: GSPMD requires the batch axis to divide evenly across the
    ``data`` axis)."""
    buckets = sorted({max(1, batch_size >> k) for k in range(4)})
    if divisor > 1:
        buckets = sorted({-(-b // divisor) * divisor for b in buckets})
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def batch_chunks(audio: np.ndarray, chunks: Sequence[SpeechChunk],
                 batch_size: int, window_samples: int = N_SAMPLES,
                 divisor: int = 1,
                 ) -> List[Tuple[np.ndarray, List[SpeechChunk]]]:
    """Group chunks into bucketed batches of padded windows.

    Every batch shape comes from a small static ladder so XLA compiles a
    handful of programs total; padding rows are dropped by the caller
    (len(chunk_list) < rows marks them).  ``divisor`` keeps every batch
    shape divisible by the data-parallel mesh size.
    """
    batches = []
    for i in range(0, len(chunks), batch_size):
        group = list(chunks[i:i + batch_size])
        rows = _bucket_for(len(group), batch_size, divisor)
        arr = np.zeros((rows, window_samples), np.float32)
        for j, ch in enumerate(group):
            arr[j] = pad_audio_window(audio, ch.start, ch.end,
                                      window_samples)
        batches.append((arr, group))
    return batches
