"""Sample-rate conversion (host CPU).

The reference delegates decode+resample to ffmpeg
(``whisperx.load_audio``, reference: transcribe.py:117) which uses a
polyphase windowed-sinc resampler.  This is the numpy equivalent, copied
from the JAX package; ``audio/native.py`` binds its C++ twin
(``native/mwx_audio.cpp``), which ``load_audio`` runs first.
Decode/resample is host work; the device path starts at the log-mel kernel.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np


@lru_cache(maxsize=32)
def _polyphase_filter(up: int, down: int, half_width: int = 24,
                      beta: float = 8.555) -> np.ndarray:
    """Kaiser-windowed sinc filter bank, one row per output phase.

    Returns weights of shape [up, 2*half_width] where row p holds the taps
    for fractional offset p/up (in input samples), low-passed at
    ``min(1, up/down)`` of input Nyquist.
    """
    cutoff = min(1.0, up / down)
    taps = np.arange(-half_width, half_width, dtype=np.float64)
    weights = np.empty((up, 2 * half_width), dtype=np.float64)
    for phase in range(up):
        frac = phase / up
        t = taps - frac + 1.0  # sinc centered between floor index offsets
        x = t * cutoff
        sinc = np.sinc(x) * cutoff
        window = np.kaiser(2 * half_width * 16 + 1, beta)
        # Sample the Kaiser window at the tap positions (window spans
        # [-half_width, half_width]).
        wpos = (t / half_width + 1.0) * (len(window) - 1) / 2.0
        widx = np.clip(wpos, 0, len(window) - 1)
        lo = np.floor(widx).astype(np.int64)
        hi = np.minimum(lo + 1, len(window) - 1)
        wfrac = widx - lo
        win = window[lo] * (1 - wfrac) + window[hi] * wfrac
        w = sinc * win
        weights[phase] = w / max(w.sum(), 1e-12)
    return weights.astype(np.float32)


def resample_poly(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Resample 1-D float audio from sr_in to sr_out (polyphase sinc)."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim != 1:
        raise ValueError(f"expected mono 1-D audio, got shape {audio.shape}")
    if sr_in == sr_out or audio.size == 0:
        return audio

    g = math.gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    weights = _polyphase_filter(up, down)
    half_width = weights.shape[1] // 2        # single source of truth

    n_out = int(math.ceil(audio.size * up / down))
    pad = half_width
    padded = np.pad(audio, (pad, pad + 1))
    tap_offsets = np.arange(2 * half_width, dtype=np.int64) - half_width + 1

    # Bounded-memory chunks: the gathered [n, 2*half_width] frame/weight
    # temporaries cost ~800 bytes per output sample — materialized all at
    # once, an hour of 44.1 kHz audio would need tens of GB
    out = np.empty(n_out, np.float32)
    chunk = 1 << 18   # ~200 MB of temporaries per chunk, independent of n
    for lo in range(0, n_out, chunk):
        j = np.arange(lo, min(lo + chunk, n_out), dtype=np.int64)
        # Output j sits at input position j*down/up = base + phase/up.
        pos_num = j * down
        base = pos_num // up
        phase = (pos_num % up).astype(np.int64)
        # Gather tap windows: taps cover input indices base-half_width+1+k
        idx = base[:, None] + tap_offsets[None, :] + pad
        frames = padded[idx]                  # [n, 2*half_width]
        out[lo: lo + len(j)] = np.einsum("nk,nk->n", frames,
                                         weights[phase])
    return out


def to_mono(audio: np.ndarray) -> np.ndarray:
    """Average channels to mono (ffmpeg `-ac 1` equivalent)."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        return audio.astype(np.float32)
    return audio.mean(axis=1).astype(np.float32)
