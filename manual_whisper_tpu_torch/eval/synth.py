"""Deterministic synthetic speech: a tone-coded language with known text.

A copy of the JAX package's ``eval/synth.py`` (numpy only), kept
here because importing that package pulls in JAX.

The reference's quality is defined by real checkpoints the build cannot
download here (transcribe.py:107-113 pulls from the HF hub), so quality
numbers need ground truth that exists *inside* the repo.  This module
defines an artificial language — each word is a fixed two-tone chord —
plus renderers for utterances, multi-utterance files (VAD/chunking
exercise), and multi-speaker conversations with RTTM truth (diarization
exercise).  tools/train_synth*.py train the `test` Whisper config, the
PyanNet VAD, the speaker embedder and a tiny wav2vec2-CTC aligner on it;
tools/run_synth_eval.py then measures WER/CER/DER (+ word-timing MAE/F1)
through the FULL pipeline, giving real, regressable metrics
(EVAL_r{N}.json) instead of asserted ones.

Corpus v2 (round 3, VERDICT r2 #4 — the 10-word corpus saturated at
WER 0.02 / DER 0.0): 56-word lexicon, 4-8-word utterances, 2-4 speakers
with overlapping turns, and an SNR knob for clean/10 dB/0 dB sweeps.

Everything is seeded and pure-numpy: corpora regenerate bit-identically.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SAMPLE_RATE = 16000

# 13 base frequencies on a ~1.28x log grid, all inside the 80-mel / 8 kHz
# front end.  Each word is an unordered two-tone chord drawn from the
# grid with index distance >= 2, so any chord decomposes uniquely and the
# mel front end resolves both components everywhere on the grid.
_FREQS: Tuple[float, ...] = tuple(
    round(190.0 * 1.28 ** k, 1) for k in range(13))

_ONSETS = "bdklmnprstfghv"          # 14 onsets x 4 vowels = 56 names
_VOWELS = "aeio"


def _make_lexicon() -> Dict[str, Tuple[float, float]]:
    pairs = [(i, j) for i, j in itertools.combinations(range(len(_FREQS)), 2)
             if j - i >= 2]
    pairs.sort(key=lambda p: (p[0] + p[1], p[0]))
    names = [o + v for o in _ONSETS for v in _VOWELS]
    return {names[k]: (_FREQS[i], _FREQS[j])
            for k, (i, j) in enumerate(pairs[: len(names)])}


WORDS: Dict[str, Tuple[float, float]] = _make_lexicon()
WORD_LIST = list(WORDS)

# words whose tones stay <= ~1.1 kHz: the conversation register band that
# survives ring-modulation to disjoint speaker bands (see _speaker_voice)
LOW_WORDS: Tuple[str, ...] = tuple(
    w for w, (f1, f2) in WORDS.items() if f2 <= 1100.0)

WORD_SEC = 0.24          # voiced part
GAP_SEC = 0.06           # intra-utterance gap between words
NOISE = 0.002            # additive noise floor (the "clean" condition)


def _tone(freqs: Sequence[float], seconds: float,
          sr: int = SAMPLE_RATE) -> np.ndarray:
    t = np.arange(int(seconds * sr)) / sr
    x = sum(np.sin(2 * np.pi * f * t) for f in freqs) / len(freqs)
    # Hann envelope keeps word boundaries click-free and VAD-friendly
    env = np.hanning(len(t)) ** 0.5
    return (0.45 * x * env).astype(np.float32)


def _babble(rng: np.random.Generator, n_samples: int,
            n_streams: int = 4, sr: int = SAMPLE_RATE) -> np.ndarray:
    """Speech-shaped interference: ``n_streams`` independent streams of
    random lexicon words (each at a random level and random inter-word
    gap), summed.  Unlike white noise this is NON-STATIONARY and lives in
    exactly the band the target words occupy, so it defeats any purely
    spectral separation — the discriminative mid-band condition VERDICT
    r4 #6 asked for (white-noise SNR0 saturates to filler loops)."""
    out = np.zeros(n_samples, np.float32)
    for _ in range(n_streams):
        cursor = int(rng.integers(0, int(0.3 * sr)))
        level = float(rng.uniform(0.3, 1.0))
        while cursor < n_samples:
            w = WORD_LIST[int(rng.integers(0, len(WORD_LIST)))]
            tone = _tone(WORDS[w], WORD_SEC, sr) * level
            end = min(cursor + len(tone), n_samples)
            out[cursor:end] += tone[: end - cursor]
            cursor = end + int(rng.uniform(0.02, 0.25) * sr)
    return out


def _add_noise(audio: np.ndarray, rng: np.random.Generator,
               snr_db: Optional[float],
               noise_kind: str = "white") -> np.ndarray:
    """Additive noise: the fixed NOISE floor when ``snr_db`` is None (the
    historical "clean" condition), else ``noise_kind`` ("white" or
    "babble") scaled to the requested signal-to-noise ratio over the
    whole file."""
    if snr_db is None:
        return audio + NOISE * rng.standard_normal(len(audio)).astype(
            np.float32)
    sig_power = float(np.mean(audio.astype(np.float64) ** 2)) or 1e-12
    noise_power = sig_power / (10.0 ** (snr_db / 10.0))
    if noise_kind == "babble":
        noise = _babble(rng, len(audio)).astype(np.float64)
        cur = float(np.mean(noise ** 2)) or 1e-12
        noise *= np.sqrt(noise_power / cur)
    elif noise_kind == "white":
        noise = np.sqrt(noise_power) * rng.standard_normal(len(audio))
    else:
        raise ValueError(f"unknown noise_kind {noise_kind!r}")
    return (audio + noise.astype(np.float32)).astype(np.float32)


def render_utterance(words: Sequence[str], seed: int = 0,
                     sr: int = SAMPLE_RATE) -> np.ndarray:
    """words -> waveform (words separated by short gaps, noise floor)."""
    rng = np.random.default_rng(seed)
    parts = []
    for w in words:
        parts.append(_tone(WORDS[w], WORD_SEC, sr))
        parts.append(np.zeros(int(GAP_SEC * sr), np.float32))
    audio = np.concatenate(parts[:-1]) if parts else np.zeros(0, np.float32)
    return audio + NOISE * rng.standard_normal(len(audio)).astype(np.float32)


def sample_text(rng: np.random.Generator,
                min_words: int = 4, max_words: int = 8) -> List[str]:
    n = int(rng.integers(min_words, max_words + 1))
    return [WORD_LIST[int(i)] for i in rng.integers(0, len(WORD_LIST), n)]


def make_corpus(n: int, seed: int = 0, min_words: int = 4,
                max_words: int = 8) -> List[Tuple[np.ndarray, str]]:
    """n seeded (audio, transcript) pairs of single utterances."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        words = sample_text(rng, min_words, max_words)
        out.append((render_utterance(words, seed=seed * 100003 + i),
                    " ".join(words)))
    return out


def render_file_with_times(utterances: Sequence[Sequence[str]],
                           seed: int = 0, gap_sec: float = 0.5,
                           sr: int = SAMPLE_RATE,
                           snr_db: Optional[float] = None,
                           noise_kind: str = "white",
                           ) -> Tuple[np.ndarray,
                                      List[Tuple[str, float, float]]]:
    """Multi-utterance file -> (audio, [(word, start, end), ...]).

    Word times serve two consumers: tools/train_synth.py cuts training
    windows with the PRODUCT's own VAD + chunk merger so the model sees
    exactly the window layouts inference produces, and the word-timing
    eval (word MAE / F1) scores wav2vec2 forced alignment against them.
    ``snr_db``: None = clean noise floor; a value = that global SNR."""
    rng = np.random.default_rng(seed)
    parts = [np.zeros(int(0.25 * sr), np.float32)]
    words_t: List[Tuple[str, float, float]] = []
    cursor = 0.25
    for i, words in enumerate(utterances):
        wav = render_utterance(words, seed=seed * 7919 + i, sr=sr)
        for j, w in enumerate(words):
            start = cursor + j * (WORD_SEC + GAP_SEC)
            words_t.append((w, round(start, 4), round(start + WORD_SEC, 4)))
        parts.append(wav)
        parts.append(np.zeros(int(gap_sec * sr), np.float32))
        cursor += len(wav) / sr + gap_sec
    audio = np.concatenate(parts)
    return _add_noise(audio, rng, snr_db, noise_kind), words_t


def render_file(utterances: Sequence[Sequence[str]], seed: int = 0,
                gap_sec: float = 0.5, sr: int = SAMPLE_RATE,
                snr_db: Optional[float] = None,
                ) -> Tuple[np.ndarray, str]:
    """Multi-utterance file with silence gaps (exercises VAD + chunking).

    Returns (audio, full transcript)."""
    audio, words_t = render_file_with_times(utterances, seed=seed,
                                            gap_sec=gap_sec, sr=sr,
                                            snr_db=snr_db)
    return audio, " ".join(w for w, _, _ in words_t)


# ---------------------------------------------------------------------------
# Multi-speaker conversations (diarization ground truth)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Turn:
    start: float
    end: float
    speaker: str
    words: List[str]


# ring-modulation carriers per speaker slot: 0 Hz (clean register) plus
# three carriers inside the band tools/train_synth_embed.py samples its
# training voices from (1.5-7.8 kHz), so every conversation voice is
# in-distribution for the trained embedder.  With LOW_WORDS content
# (<= 1.1 kHz) the modulated bands stay essentially disjoint.
_SPEAKER_CARRIERS: Tuple[float, ...] = (0.0, 4500.0, 2400.0, 6300.0)


def _speaker_voice(audio: np.ndarray, speaker: int,
                   sr: int = SAMPLE_RATE) -> np.ndarray:
    """Give each speaker a distinct spectral register via ring
    modulation, the same voice mechanism the embedding trainer uses.
    Between-speaker separation then dominates within-speaker content
    variance, as register does for real voices."""
    carrier = _SPEAKER_CARRIERS[speaker % len(_SPEAKER_CARRIERS)]
    if carrier == 0.0:
        return audio
    t = np.arange(len(audio)) / sr
    return (audio * np.cos(2 * np.pi * carrier * t)).astype(np.float32)


def render_conversation(n_turns: int = 8, seed: int = 0,
                        gap_sec: float = 0.45, sr: int = SAMPLE_RATE,
                        n_speakers: int = 2,
                        overlap_prob: float = 0.0,
                        snr_db: Optional[float] = None,
                        ) -> Tuple[np.ndarray, List[Turn]]:
    """Round-robin ``n_speakers`` conversation -> (audio, reference turns).

    Turns run 6-10 words (~2-3 s) — meeting-like lengths that the 3 s
    sliding embedding windows of DiarizationPipeline can capture as
    single-speaker; sub-second turns would put both voices in every
    window and measure the fixture, not the pipeline.

    ``overlap_prob``: chance that a turn starts before the previous one
    ends (cut-in by up to ~40% of the previous turn, capped at 1 s) —
    overlapping speech is summed and the RTTM truth reflects the actual
    overlapping intervals (the powerset segmentation head models two
    simultaneous speakers, so DER can hold it to account)."""
    rng = np.random.default_rng(seed)
    turns: List[Turn] = []
    placed: List[Tuple[float, np.ndarray]] = []   # (start sec, waveform)
    cursor = 0.3
    prev_end = 0.3
    for i in range(n_turns):
        spk = i % n_speakers
        words = [LOW_WORDS[int(j)]
                 for j in rng.integers(0, len(LOW_WORDS),
                                       int(rng.integers(6, 11)))]
        wav = render_utterance(words, seed=seed * 31337 + i, sr=sr)
        wav = _speaker_voice(wav, spk, sr)
        dur = len(wav) / sr
        start = cursor
        if turns and overlap_prob > 0 and rng.random() < overlap_prob:
            prev = turns[-1]
            cut_in = min(1.0, 0.4 * (prev.end - prev.start))
            start = max(prev.start + 0.2, prev.end - cut_in)
        turns.append(Turn(start=round(start, 3), end=round(start + dur, 3),
                          speaker=f"SPEAKER_{spk:02d}", words=words))
        placed.append((start, wav))
        prev_end = max(prev_end, start + dur)
        cursor = prev_end + gap_sec
    total = int((prev_end + 0.3) * sr)
    audio = np.zeros(total, np.float32)
    for start, wav in placed:
        lo = int(start * sr)
        audio[lo: lo + len(wav)] += wav
    return _add_noise(audio, rng, snr_db), turns


def turns_to_rttm(turns: Sequence[Turn]) -> List[dict]:
    """Reference-turn dicts in the shape eval.metrics.der consumes."""
    return [{"start": t.start, "end": t.end, "speaker": t.speaker}
            for t in turns]
