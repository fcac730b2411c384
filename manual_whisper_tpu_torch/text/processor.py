"""Web-path segment post-processor (a copy of the JAX package's
``text/processor.py``).

Behavior-faithful port of the reference's serverless processor
(reference: web/api/lib/processor.js).  The ``cleanup_stats`` and
``quality_report`` JSON blocks are part of the output contract — field
names and rounding must match (processor.js:53-62, 234-266).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from .. import config

# Reference: processor.js:16-22
PROMPT_LEAK_REGEXES = [
    re.compile(r"请使用简体中文[。.!！?？]*"),
    re.compile(r"请用简体中文[。.!！?？]*"),
    re.compile(r"术语参考[:：][^。!?！？\n]*"),
    re.compile(r"中文会议讨论记录[:：]?"),
    re.compile(r"语文会议讨论记录[:：]?"),
]

# Reference: processor.js:24-28
HALLUCINATION_FRAGMENT_REGEXES = [
    re.compile(r"请不吝点赞\s*订阅\s*转发\s*打赏支持[^。!?！？\n]*"),
    re.compile(r"点赞\s*订阅\s*转发\s*打赏支持[^。!?！？\n]*"),
    re.compile(r"明镜与点点栏目"),
]

# Reference: processor.js:30-35 (JS .test == Python re.search)
HALLUCINATION_ONLY_REGEXES = [
    re.compile(r"^(术语参考|中文会议讨论记录|语文会议讨论记录)"),
    re.compile(r"^请不吝点赞"),
    re.compile(r"^点赞订阅转发打赏支持"),
    re.compile(r"明镜与点点栏目"),
]

# Reference: processor.js:37
NOISE_FILLERS = {"嗯", "啊", "哦", "呃", "额", "哈", "哎"}

# Reference: processor.js:39-48 (superset of the CLI table: adds 唯一表识)
DEFAULT_TERM_REPLACEMENTS: Dict[str, str] = {
    "搜码二维码": "收款二维码",
    "收码二维码": "收款二维码",
    "文艺标识": "唯一标识",
    "唯一表识": "唯一标识",
    "AAP": "APP",
    "AP里面": "APP里面",
    "AP里": "APP里",
    "不信支付法": "支付宝支付法",
}

_COMPACT_RE = re.compile(r"[，。！？,.!?、\s]")
_LOOP_RE = re.compile(r"(.{2,20}?)\1{3,}")
_PUNCT_DEDUP_RE = re.compile(r"([，。！？,.!?])\1{1,}")
_EDGE_PUNCT_RE = re.compile(r"^[，。！？,.!?、\s]+|[，。！？,.!?、\s]+$")
_WS_RE = re.compile(r"\s+")


def _round2(v: float) -> float:
    """JS Math.round(v*100)/100 (half away from zero for positives)."""
    return math.floor(v * 100 + 0.5) / 100


def _round4(v: float) -> float:
    return math.floor(v * 10000 + 0.5) / 10000


def _to_finite_number(v, fallback: float) -> float:
    try:
        n = float(v)
    except (TypeError, ValueError):
        return fallback
    if math.isfinite(n):
        return n
    return fallback


@dataclass
class PostProcessOptions:
    """Knobs of the web processor (reference: processor.js:6-14, env-driven)."""

    strip_prompt_leak: bool = True
    strip_hallucination: bool = True
    merge_adjacent_segments: bool = True
    drop_short_noise: bool = True
    max_merge_gap_sec: float = 0.6
    drop_noise_max_sec: float = 1.2
    drop_noise_max_chars: int = 2
    min_warn_removed_span_sec: float = 10.0
    min_warn_coverage_ratio: float = 0.85
    term_replacements: Dict[str, str] = field(
        default_factory=lambda: dict(DEFAULT_TERM_REPLACEMENTS))

    @classmethod
    def from_env(cls) -> "PostProcessOptions":
        """Resolve options from env like the module-level consts in
        processor.js:6-14 and resolveTermReplacements() :331-338."""
        merged = dict(DEFAULT_TERM_REPLACEMENTS)
        merged.update(config.parse_replacement_map_from_json(
            config.get_env("TERM_REPLACEMENTS_JSON")))
        merged.update(config.parse_replacement_map_from_pairs(
            config.get_env("TERM_REPLACEMENTS")))
        return cls(
            strip_prompt_leak=config.get_bool("STRIP_PROMPT_LEAK", True),
            strip_hallucination=config.get_bool("STRIP_HALLUCINATION", True),
            merge_adjacent_segments=config.get_bool("MERGE_ADJACENT_SEGMENTS", True),
            drop_short_noise=config.get_bool("DROP_SHORT_NOISE", True),
            max_merge_gap_sec=config.get_float("MAX_MERGE_GAP_SEC", 0.6),
            drop_noise_max_sec=config.get_float("DROP_NOISE_MAX_SEC", 1.2),
            drop_noise_max_chars=config.get_int("DROP_NOISE_MAX_CHARS", 2),
            min_warn_removed_span_sec=config.get_float("MIN_WARN_REMOVED_SPAN_SEC", 10),
            min_warn_coverage_ratio=config.get_float("MIN_WARN_COVERAGE_RATIO", 0.85),
            term_replacements=merged,
        )


def _clean_segment_text(raw_text, opts: PostProcessOptions):
    """Reference: processor.js:138-168 (cleanSegmentText)."""
    text = raw_text if isinstance(raw_text, str) else ""
    prompt_fragments_removed = 0
    hallucination_fragments_removed = 0

    text = _WS_RE.sub(" ", text).strip()
    text = _LOOP_RE.sub(r"\1", text).strip()

    if opts.strip_prompt_leak:
        for rx in PROMPT_LEAK_REGEXES:
            before = text
            text = rx.sub("", text)
            if text != before:
                prompt_fragments_removed += 1

    if opts.strip_hallucination:
        for rx in HALLUCINATION_FRAGMENT_REGEXES:
            before = text
            text = rx.sub("", text)
            if text != before:
                hallucination_fragments_removed += 1

    for src, dst in opts.term_replacements.items():
        if src and dst:
            text = text.replace(src, dst)

    text = _PUNCT_DEDUP_RE.sub(r"\1", text)
    text = _EDGE_PUNCT_RE.sub("", text)
    text = _WS_RE.sub(" ", text).strip()
    return text, prompt_fragments_removed, hallucination_fragments_removed


def _is_prompt_leak_text(text: str) -> bool:
    """Reference: processor.js:185-189."""
    compact = _COMPACT_RE.sub("", text)
    if compact in ("请使用简体中文", "请用简体中文"):
        return True
    return bool(re.search(r"^(术语参考|中文会议讨论记录|语文会议讨论记录)", compact))


def _is_hallucination_text(text: str, opts: PostProcessOptions) -> bool:
    """Reference: processor.js:191-199."""
    if not opts.strip_hallucination:
        return False
    compact = _COMPACT_RE.sub("", text)
    if len(compact) == 0:
        return True
    for rx in HALLUCINATION_ONLY_REGEXES:
        if rx.search(compact) or rx.search(text):
            return True
    return False


def _should_drop_noise_segment(text: str, duration: float,
                               opts: PostProcessOptions) -> bool:
    """Reference: processor.js:201-208."""
    if not opts.drop_short_noise:
        return False
    compact = _COMPACT_RE.sub("", text)
    if len(compact) == 0:
        return True
    if (duration <= opts.drop_noise_max_sec
            and len(compact) <= opts.drop_noise_max_chars
            and compact in NOISE_FILLERS):
        return True
    if duration <= 0.3 and len(compact) <= 1:
        return True
    return False


def _merge_adjacent_segments(segments: List[dict], max_gap_sec: float):
    """Reference: processor.js:210-232."""
    if len(segments) <= 1:
        return segments, 0
    result: List[dict] = []
    current = dict(segments[0])
    merged_count = 0
    for nxt in segments[1:]:
        gap = nxt["start"] - current["end"]
        same_speaker = current.get("speaker") == nxt.get("speaker")
        if same_speaker and gap <= max_gap_sec:
            current["text"] = current["text"] + " " + nxt["text"]
            current["end"] = nxt["end"]
            merged_count += 1
        else:
            result.append(current)
            current = dict(nxt)
    result.append(current)
    return result, merged_count


def _sum_speech_seconds(segments) -> float:
    """Reference: processor.js:268-277."""
    if not isinstance(segments, (list, tuple)):
        return 0.0
    total = 0.0
    for seg in segments:
        seg = seg or {}
        start = _to_finite_number(seg.get("start"), 0.0)
        end = _to_finite_number(seg.get("end"), start)
        total += max(0.0, end - start)
    return total


def _merge_ranges(ranges: Sequence[dict], max_gap_sec: float) -> List[dict]:
    """Reference: processor.js:279-299."""
    if not ranges:
        return []
    sorted_ranges = sorted(
        (
            {
                "start": _to_finite_number(r.get("start"), 0.0),
                "end": max(_to_finite_number(r.get("start"), 0.0),
                           _to_finite_number(r.get("end"), r.get("start"))),
                "reasons": [r.get("reason") or "unknown"],
            }
            for r in ranges
        ),
        key=lambda item: item["start"],
    )
    merged = [sorted_ranges[0]]
    for cur in sorted_ranges[1:]:
        prev = merged[-1]
        if cur["start"] - prev["end"] <= max_gap_sec:
            prev["end"] = max(prev["end"], cur["end"])
            for reason in cur["reasons"]:
                if reason not in prev["reasons"]:
                    prev["reasons"].append(reason)
            continue
        merged.append(cur)
    for item in merged:
        item["duration"] = max(0.0, item["end"] - item["start"])
    return merged


def _format_timestamp(seconds: float) -> str:
    """Reference: processor.js:301-307 (HH from floor(s/3600), MM/SS UTC)."""
    total = int(seconds)
    hh = int(seconds // 3600)
    mm = (total % 3600) // 60
    ss = total % 60
    return f"{hh:02d}:{mm:02d}:{ss:02d}"


def _push_removed_range(collector: List[dict], start, end, reason: str) -> None:
    """Reference: processor.js:309-313."""
    s = _to_finite_number(start, 0.0)
    e = max(s, _to_finite_number(end, s))
    collector.append({"start": s, "end": e,
                      "duration": max(0.0, e - s), "reason": reason})


def _build_quality_report(input_segments, output_segments, removed_ranges,
                          stats, opts: PostProcessOptions) -> dict:
    """Reference: processor.js:234-266 — field names are contract.

    Note: output_segments are the POST-merge segments (processor.js:111
    passes finalSegments), whose spans absorb the <=0.6 s merge gaps —
    so coverage_ratio can read slightly high and mask the low-coverage
    warning.  Kept as-is: the reference computes it the same way and the
    two implementations must agree on the emitted numbers."""
    input_speech_sec = _sum_speech_seconds(input_segments)
    output_speech_sec = _sum_speech_seconds(output_segments)
    removed_speech_sec = max(0.0, input_speech_sec - output_speech_sec)
    coverage_ratio = (output_speech_sec / input_speech_sec
                      if input_speech_sec > 0 else 1.0)

    suspicious = [
        item for item in _merge_ranges(
            [r for r in removed_ranges
             if r["reason"] in ("hallucination", "prompt")],
            1.2,
        )
        if item["duration"] >= opts.min_warn_removed_span_sec
    ]

    warnings: List[str] = []
    if stats["removed_hallucination_segments"] > 0:
        warnings.append(
            f"检测并移除了 {stats['removed_hallucination_segments']} 条疑似幻觉片段")
    if coverage_ratio < opts.min_warn_coverage_ratio:
        warnings.append(
            f"清理后语音覆盖率偏低 ({coverage_ratio * 100:.1f}%)，建议人工复核")
    if suspicious:
        spans = ", ".join(
            f"{_format_timestamp(item['start'])}-{_format_timestamp(item['end'])}"
            for item in suspicious[:4])
        warnings.append(f"检测到可疑丢失时间段：{spans}")

    return {
        "input_speech_sec": _round2(input_speech_sec),
        "output_speech_sec": _round2(output_speech_sec),
        "removed_speech_sec": _round2(removed_speech_sec),
        "coverage_ratio": _round4(coverage_ratio),
        "suspicious_ranges": [
            {
                "start": item["start"],
                "end": item["end"],
                "duration": _round2(item["duration"]),
                "reason": "+".join(item["reasons"]),
            }
            for item in suspicious
        ],
        "warnings": warnings,
    }


def post_process_segments(segments: Sequence[dict],
                          opts: Optional[PostProcessOptions] = None) -> dict:
    """Clean/classify/merge segments and build the quality report.

    Reference: processor.js:52-113 (postProcessSegments).  Returns a dict
    with keys ``segments``, ``stats``, ``quality_report``, ``removed_ranges``.
    """
    if opts is None:
        opts = PostProcessOptions.from_env()

    stats = {
        "input_segments": len(segments),
        "output_segments": 0,
        "removed_prompt_only_segments": 0,
        "removed_hallucination_segments": 0,
        "removed_noise_segments": 0,
        "cleaned_prompt_fragments": 0,
        "cleaned_hallucination_fragments": 0,
        "merged_segments": 0,
    }
    removed_ranges: List[dict] = []
    cleaned: List[dict] = []

    for seg in segments:
        seg = seg or {}
        text, prompt_removed, hallu_removed = _clean_segment_text(
            seg.get("text"), opts)
        stats["cleaned_prompt_fragments"] += prompt_removed
        stats["cleaned_hallucination_fragments"] += hallu_removed

        start = _to_finite_number(seg.get("start"), 0.0)
        end = _to_finite_number(seg.get("end"), start)
        duration = max(0.0, end - start)

        if not text or _is_prompt_leak_text(text):
            if not text and hallu_removed > 0:
                stats["removed_hallucination_segments"] += 1
                _push_removed_range(removed_ranges, start, end, "hallucination")
            else:
                stats["removed_prompt_only_segments"] += 1
                _push_removed_range(removed_ranges, start, end, "prompt")
            continue

        if _is_hallucination_text(text, opts):
            stats["removed_hallucination_segments"] += 1
            _push_removed_range(removed_ranges, start, end, "hallucination")
            continue

        if _should_drop_noise_segment(text, duration, opts):
            stats["removed_noise_segments"] += 1
            _push_removed_range(removed_ranges, start, end, "noise")
            continue

        out = dict(seg)
        out.update({"text": text, "start": start, "end": end})
        cleaned.append(out)

    final_segments = cleaned
    if opts.merge_adjacent_segments:
        final_segments, merged_count = _merge_adjacent_segments(
            cleaned, opts.max_merge_gap_sec)
        stats["merged_segments"] = merged_count

    stats["output_segments"] = len(final_segments)
    quality_report = _build_quality_report(
        segments, final_segments, removed_ranges, stats, opts)
    return {
        "segments": final_segments,
        "stats": stats,
        "quality_report": quality_report,
        "removed_ranges": removed_ranges,
    }
