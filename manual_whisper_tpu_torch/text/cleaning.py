"""CLI-path text cleaning.

Behavior-faithful port of the reference CLI cleaner
(reference: transcribe.py:38-95 — PROMPT_LEAK_PATTERNS, TERM_REPLACEMENTS,
remove_hallucination_loops, clean_segment_text) and the drop-empty-segment
loop (transcribe.py:156-181).  These regex tables are part of the output
contract: raw ASR output may differ slightly across backends, but the
cleaning must behave identically.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Tuple

# Reference: transcribe.py:39-40
DOMAIN_TERMS = [
    "微信", "支付宝", "二维码", "收款码", "小程序", "公众号", "NFC",
    "Node ID", "UID", "UIA", "ADNA", "APP", "H5",
]
INITIAL_PROMPT = (
    "中文会议讨论记录，保持原意与术语准确。术语参考："
    + "、".join(DOMAIN_TERMS) + "。"
)

# Reference: transcribe.py:48-51
PROMPT_LEAK_PATTERNS = [
    r"请使用简体中文[。.!！?？]*",
    r"请用简体中文[。.!！?？]*",
]

# Reference: transcribe.py:53-61
TERM_REPLACEMENTS: Dict[str, str] = {
    "搜码二维码": "收款二维码",
    "收码二维码": "收款二维码",
    "文艺标识": "唯一标识",
    "AAP": "APP",
    "AP里面": "APP里面",
    "AP里": "APP里",
    "不信支付法": "支付宝支付法",
}


def remove_hallucination_loops(text: str, max_repeat: int = 3) -> str:
    """Collapse phrases repeated more than ``max_repeat`` times.

    Reference: transcribe.py:74-79 — pattern ``(.{2,20}?)\\1{3,}`` replaced
    by a single occurrence of the phrase.
    """
    pattern = r"(.{2,20}?)\1{" + str(max_repeat) + r",}"
    return re.sub(pattern, r"\1", text)


def clean_segment_text(
    text: Optional[str],
    term_replacements: Optional[Dict[str, str]] = None,
) -> str:
    """Clean one segment's text the CLI way (reference: transcribe.py:82-95)."""
    cleaned = text or ""
    cleaned = cleaned.strip()
    cleaned = remove_hallucination_loops(cleaned)

    for pattern in PROMPT_LEAK_PATTERNS:
        cleaned = re.sub(pattern, "", cleaned)

    replacements = TERM_REPLACEMENTS if term_replacements is None else term_replacements
    for src, dst in replacements.items():
        cleaned = cleaned.replace(src, dst)

    cleaned = re.sub(r"([，。！？,.!?])\1+", r"\1", cleaned)
    cleaned = re.sub(r"^[，。！？,.!?、\s]+|[，。！？,.!?、\s]+$", "", cleaned).strip()
    return cleaned


def clean_result_segments(
    segments: Iterable[dict],
    term_replacements: Optional[Dict[str, str]] = None,
) -> Tuple[List[dict], int, int]:
    """Post-process loop over segments (reference: transcribe.py:156-181).

    Returns (kept_segments, cleaned_count, dropped_prompt_count); empty
    post-clean segments are dropped, modified ones counted.
    """
    cleaned_segments: List[dict] = []
    cleaned_count = 0
    dropped_prompt_count = 0
    for segment in segments:
        original = segment.get("text", "")
        cleaned = clean_segment_text(original, term_replacements)
        if not cleaned:
            dropped_prompt_count += 1
            continue
        if cleaned != original:
            cleaned_count += 1
        segment = dict(segment)
        segment["text"] = cleaned
        cleaned_segments.append(segment)
    return cleaned_segments, cleaned_count, dropped_prompt_count
