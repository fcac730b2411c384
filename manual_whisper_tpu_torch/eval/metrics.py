"""Accuracy metrics: WER / CER / DER.

A copy of the JAX package's ``eval/metrics.py`` (numpy and ``re`` only), kept
here because importing that package pulls in JAX.

BASELINE.json's parity targets are "WER + DER parity vs WhisperX"; the
reference publishes no numbers and ships no evaluation code (SURVEY.md §6),
so the metric implementations live here and the harness
(tools/run_parity.py) runs them whenever converted weights + reference
audio are available.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np


def _edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance (iterative DP, O(len(ref)*len(hyp)))."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        r = ref[i - 1]
        for j in range(1, m + 1):
            cost = 0 if r == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1,        # deletion
                         cur[j - 1] + 1,     # insertion
                         prev[j - 1] + cost)  # substitution
        prev = cur
    return prev[m]


_PUNCT_RE = re.compile(r"[^\w\s'一-鿿]", re.UNICODE)


def _normalize(text: str) -> str:
    """Lowercase, strip punctuation; keep intra-word apostrophes so
    contractions stay one token ("don't" must not count as two words)."""
    t = _PUNCT_RE.sub(" ", (text or "").lower())
    return " ".join(w.strip("'") for w in t.split() if w.strip("'"))


def wer(reference: str, hypothesis: str) -> float:
    """Word error rate over whitespace/word tokens (latin-script styles)."""
    ref = _normalize(reference).split()
    hyp = _normalize(hypothesis).split()
    if not ref:
        return 0.0 if not hyp else 1.0
    return _edit_distance(ref, hyp) / len(ref)


def cer(reference: str, hypothesis: str) -> float:
    """Character error rate (the WER analogue for zh/ja/ko scripts)."""
    ref = [c for c in _normalize(reference) if not c.isspace()]
    hyp = [c for c in _normalize(hypothesis) if not c.isspace()]
    if not ref:
        return 0.0 if not hyp else 1.0
    return _edit_distance(ref, hyp) / len(ref)


# ---------------------------------------------------------------------------
# Diarization error rate
# ---------------------------------------------------------------------------

def _hungarian(cost: np.ndarray) -> List[Tuple[int, int]]:
    """Minimal-cost assignment (O(n^3) Hungarian; speaker counts are tiny)."""
    cost = np.asarray(cost, np.float64)
    n = max(cost.shape)
    padded = np.full((n, n), cost.max() + 1.0 if cost.size else 1.0)
    padded[: cost.shape[0], : cost.shape[1]] = cost

    u = np.zeros(n + 1)
    v = np.zeros(n + 1)
    p = np.zeros(n + 1, np.int64)
    way = np.zeros(n + 1, np.int64)
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(n + 1, np.inf)
        used = np.zeros(n + 1, bool)
        while True:
            used[j0] = True
            i0, delta, j1 = p[j0], np.inf, 0
            for j in range(1, n + 1):
                if not used[j]:
                    cur = padded[i0 - 1, j - 1] - u[i0] - v[j]
                    if cur < minv[j]:
                        minv[j] = cur
                        way[j] = j0
                    if minv[j] < delta:
                        delta = minv[j]
                        j1 = j
            for j in range(n + 1):
                if used[j]:
                    u[p[j]] += delta
                    v[j] -= delta
                else:
                    minv[j] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    pairs = []
    for j in range(1, n + 1):
        i = int(p[j])
        if i >= 1 and i - 1 < cost.shape[0] and j - 1 < cost.shape[1]:
            pairs.append((i - 1, j - 1))
    return pairs


def der(reference: Sequence[dict], hypothesis: Sequence[dict],
        collar: float = 0.25, frame: float = 0.01) -> float:
    """Diarization error rate with optimal speaker mapping.

    Segments: [{start, end, speaker}].  Frame-based scoring at ``frame``
    resolution with a +-collar no-score zone around reference boundaries
    (standard NIST-style scoring).  DER = (miss + false alarm + speaker
    confusion) / reference speech time.
    """
    if not reference:
        return 0.0 if not hypothesis else 1.0
    end_time = max(max(s["end"] for s in reference),
                   max((s["end"] for s in hypothesis), default=0.0))
    n = int(np.ceil(end_time / frame)) + 1

    ref_spk = sorted({s["speaker"] for s in reference})
    hyp_spk = sorted({s["speaker"] for s in hypothesis})
    ref_act = np.zeros((len(ref_spk), n), bool)
    hyp_act = np.zeros((len(hyp_spk), n), bool)
    for s in reference:
        ref_act[ref_spk.index(s["speaker"]),
                int(s["start"] / frame): int(s["end"] / frame)] = True
    for s in hypothesis:
        hyp_act[hyp_spk.index(s["speaker"]),
                int(s["start"] / frame): int(s["end"] / frame)] = True

    # collar: exclude frames near reference boundaries
    score_mask = np.ones(n, bool)
    half = int(collar / frame)
    for s in reference:
        for t in (s["start"], s["end"]):
            c = int(t / frame)
            score_mask[max(0, c - half): c + half] = False

    # optimal speaker mapping by overlap (maximize agreement)
    overlap = (ref_act[:, None, :] & hyp_act[None, :, :]).sum(-1)
    pairs = _hungarian(-overlap.astype(np.float64))
    mapping: Dict[int, int] = {h: r for r, h in pairs}

    # NIST speaker-counted scoring: per frame, errors count SPEAKERS, not
    # a binarized any-speech flag — otherwise overlapping speech (the v2
    # corpus's overlap_prob conditions) is invisible: a diarizer that
    # never predicts overlap would score DER 0 while missing the second
    # speaker on every overlapped frame.
    n_ref = ref_act.sum(0).astype(np.int64)
    n_hyp = hyp_act.sum(0).astype(np.int64)
    n_ref[~score_mask] = 0
    n_hyp[~score_mask] = 0

    # per-frame count of reference speakers matched by their mapped
    # hypothesis speaker being active
    mapped_match = np.zeros(n, np.int64)
    for j, r in mapping.items():
        if 0 <= r < len(ref_spk):
            mapped_match += (ref_act[r] & hyp_act[j]) & score_mask

    miss = float(np.maximum(n_ref - n_hyp, 0).sum())
    fa = float(np.maximum(n_hyp - n_ref, 0).sum())
    confusion = float((np.minimum(n_ref, n_hyp) - mapped_match
                       ).clip(min=0).sum())

    total_ref = float(n_ref.sum())
    if total_ref == 0:
        return 0.0 if fa == 0 else 1.0
    return (miss + fa + confusion) / total_ref


def _align_word_sequences(ref_words: Sequence[str], hyp_words: Sequence[str]
                          ) -> List[Tuple[int, int]]:
    """Edit-distance alignment of two word sequences; returns matched
    (ref_idx, hyp_idx) pairs where the words are equal (substitutions,
    insertions and deletions produce no pair)."""
    n, m = len(ref_words), len(hyp_words)
    dp = np.zeros((n + 1, m + 1), np.int32)
    dp[:, 0] = np.arange(n + 1)
    dp[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            cost = 0 if ref_words[i - 1] == hyp_words[j - 1] else 1
            dp[i, j] = min(dp[i - 1, j] + 1, dp[i, j - 1] + 1,
                           dp[i - 1, j - 1] + cost)
    pairs: List[Tuple[int, int]] = []
    i, j = n, m
    while i > 0 and j > 0:
        if (dp[i, j] == dp[i - 1, j - 1]
                and ref_words[i - 1] == hyp_words[j - 1]):
            pairs.append((i - 1, j - 1))
            i, j = i - 1, j - 1
        elif dp[i, j] == dp[i - 1, j - 1] + 1:
            i, j = i - 1, j - 1
        elif dp[i, j] == dp[i - 1, j] + 1:
            i -= 1
        else:
            j -= 1
    pairs.reverse()
    return pairs


def word_timing_scores(reference: Sequence[Tuple[str, float, float]],
                       hypothesis: Sequence[dict],
                       tolerance: float = 0.08) -> Dict[str, float]:
    """Word-timestamp accuracy of forced alignment (VERDICT r2 #3).

    ``reference``: [(word, start_sec, end_sec)] ground truth (the synth
    renderer emits exact times, eval/synth.py render_file_with_times).
    ``hypothesis``: whisperx-schema word dicts [{word, start, end, ...}]
    (models/align.py output).  Words are matched by edit-distance
    alignment on the word sequence; timing is scored on matched pairs:

    - mae_start / mae_end: mean absolute boundary error (seconds)
    - f1: a matched word is a *hit* when both |d(start)| and |d(end)|
      are <= ``tolerance``; precision = hits/|hyp|, recall = hits/|ref|.
    """
    ref_w = [w for w, _, _ in reference]
    hyp_w = [str(h.get("word", "")).strip() for h in hypothesis]
    pairs = _align_word_sequences(ref_w, hyp_w)
    if not pairs:
        # None, not inf: json.dumps(inf) emits non-standard 'Infinity'
        # that strict parsers/jq reject in EVAL artifacts
        return {"matched": 0, "mae_start": None,
                "mae_end": None, "precision": 0.0, "recall": 0.0,
                "f1": 0.0}
    d_start, d_end, hits = [], [], 0
    for ri, hi in pairs:
        _, rs, re_ = reference[ri]
        hs = float(hypothesis[hi].get("start", 0.0))
        he = float(hypothesis[hi].get("end", 0.0))
        d_start.append(abs(hs - rs))
        d_end.append(abs(he - re_))
        if d_start[-1] <= tolerance and d_end[-1] <= tolerance:
            hits += 1
    precision = hits / max(len(hypothesis), 1)
    recall = hits / max(len(reference), 1)
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return {"matched": len(pairs),
            "mae_start": float(np.mean(d_start)),
            "mae_end": float(np.mean(d_end)),
            "precision": round(precision, 4), "recall": round(recall, 4),
            "f1": round(f1, 4)}
