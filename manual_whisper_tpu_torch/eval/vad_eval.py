"""VAD boundary-quality metrics (VERDICT r1 item 8).

A copy of the JAX package's ``eval/vad_eval.py`` (numpy only), kept
here because importing that package pulls in JAX.

The reference's chunk boundaries come from pyannote segmentation
(reference: transcribe.py:43-46); when no converted segmentation
checkpoint is present this framework falls back to energy VAD, whose
boundaries differ on real audio — and every downstream timestamp moves
with them.  This module quantifies that drift:

- ``boundary_f1``: precision/recall/F1 of predicted region boundaries
  against reference boundaries within a time tolerance (the standard
  segmentation-boundary metric).
- ``region_overlap_stats``: frame-level speech/non-speech agreement plus
  the per-boundary timestamp deltas between two VAD outputs.
- ``compare_vad_paths``: run two VAD callables on the same audio and
  report both views — the harness `tools/run_eval.py`-style code and the
  startup warning in pipeline.load_model use this evidence.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

Region = Tuple[float, float]


def _boundaries(regions: Sequence[Region], kind: str) -> List[float]:
    """Onsets ("start") or offsets ("end") of the regions — matched
    separately: an onset matching an offset is not agreement (pred
    [(0,1)] vs ref [(1,2)] share zero speech frames yet share the
    timestamp 1.0)."""
    idx = 0 if kind == "start" else 1
    return sorted(float(r[idx]) for r in regions)


def _greedy_match(p: List[float], r: List[float], tolerance: float) -> int:
    matched = 0
    used = [False] * len(r)
    for t in p:
        best, best_d = -1, tolerance
        for i, u in enumerate(r):
            if used[i]:
                continue
            d = abs(t - u)
            if d <= best_d:
                best, best_d = i, d
        if best >= 0:
            used[best] = True
            matched += 1
    return matched


def boundary_f1(pred: Sequence[Region], ref: Sequence[Region],
                tolerance: float = 0.2) -> Dict[str, float]:
    """Greedy one-to-one boundary matching within ``tolerance`` seconds;
    onsets match onsets and offsets match offsets."""
    n_p = 2 * len(pred)
    n_r = 2 * len(ref)
    matched = sum(
        _greedy_match(_boundaries(pred, k), _boundaries(ref, k), tolerance)
        for k in ("start", "end"))
    precision = matched / n_p if n_p else (1.0 if not n_r else 0.0)
    recall = matched / n_r if n_r else (1.0 if not n_p else 0.0)
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return {"precision": precision, "recall": recall, "f1": f1,
            "matched": matched, "pred_boundaries": n_p,
            "ref_boundaries": n_r}


def region_overlap_stats(pred: Sequence[Region], ref: Sequence[Region],
                         duration: float, step: float = 0.01
                         ) -> Dict[str, float]:
    """Frame-level agreement between two region sets over [0, duration]."""
    n = max(1, int(round(duration / step)))
    t = (np.arange(n) + 0.5) * step

    def mask(regions):
        m = np.zeros(n, bool)
        for s, e in regions:
            m |= (t >= s) & (t < e)
        return m

    a, b = mask(pred), mask(ref)
    agree = float(np.mean(a == b))
    union = float(np.sum(a | b))
    iou = float(np.sum(a & b)) / union if union else 1.0
    return {"frame_agreement": agree, "speech_iou": iou,
            "pred_speech_sec": float(np.sum(a)) * step,
            "ref_speech_sec": float(np.sum(b)) * step}


def timestamp_deltas(pred: Sequence[Region], ref: Sequence[Region],
                     max_match: float = 1.0) -> Dict[str, float]:
    """Per-boundary |delta| stats for boundaries matched within
    ``max_match`` seconds (how far downstream timestamps move)."""
    deltas = []
    for kind in ("start", "end"):   # onsets vs onsets, offsets vs offsets
        p = _boundaries(pred, kind)
        r = _boundaries(ref, kind)
        used = [False] * len(r)
        for t in p:
            best, best_d = -1, max_match
            for i, u in enumerate(r):
                if used[i]:
                    continue
                d = abs(t - u)
                if d <= best_d:
                    best, best_d = i, d
            if best >= 0:
                used[best] = True
                deltas.append(best_d)
    if not deltas:
        return {"mean_abs_delta": float("nan"),
                "max_abs_delta": float("nan"), "n_matched": 0}
    return {"mean_abs_delta": float(np.mean(deltas)),
            "max_abs_delta": float(np.max(deltas)),
            "n_matched": len(deltas)}


def compare_vad_paths(audio: np.ndarray,
                      vad_a: Callable[[np.ndarray], Sequence[Region]],
                      vad_b: Callable[[np.ndarray], Sequence[Region]],
                      sample_rate: int = 16000,
                      tolerance: float = 0.2) -> Dict[str, Dict]:
    """Run two VAD paths on the same audio and report the drift between
    them (boundary F1 of a vs b, frame agreement, timestamp deltas)."""
    regions_a = list(vad_a(audio))
    regions_b = list(vad_b(audio))
    duration = len(audio) / sample_rate
    return {
        "a_regions": regions_a,
        "b_regions": regions_b,
        "boundary": boundary_f1(regions_a, regions_b, tolerance),
        "overlap": region_overlap_stats(regions_a, regions_b, duration),
        "deltas": timestamp_deltas(regions_a, regions_b),
    }
