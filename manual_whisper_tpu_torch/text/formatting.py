"""Transcript output formatting — byte-compatible with the reference.

Two Markdown dialects exist in the reference and both are kept:

- CLI: ``format_transcript`` writes a header block + speaker headings +
  ``[HH:MM:SS - HH:MM:SS] text`` lines and a JSON twin file
  (reference: transcribe.py:186-226, format_timestamp :64-71).
- Web: ``formatToMarkdown`` with the ``# 录音转写`` header
  (reference: web/api/lib/processor.js:115-134).
"""

from __future__ import annotations

import json
from datetime import timedelta
from pathlib import Path
from typing import List, Optional


def format_timestamp(seconds: float) -> str:
    """Seconds -> HH:MM:SS (reference: transcribe.py:64-71)."""
    td = timedelta(seconds=seconds)
    total_seconds = int(td.total_seconds())
    hours = total_seconds // 3600
    minutes = (total_seconds % 3600) // 60
    secs = total_seconds % 60
    return f"{hours:02d}:{minutes:02d}:{secs:02d}"


def render_transcript_markdown(result: dict, audio_file: str,
                               audio_duration: float, total_time: float,
                               model_size: str, compute_type: str,
                               device: str) -> str:
    """CLI Markdown body (reference: transcribe.py:190-215)."""
    lines: List[str] = []
    lines.append("# 会议录音转写\n\n")
    lines.append(f"**源文件**: {audio_file}  \n")
    lines.append(f"**音频时长**: {audio_duration/60:.1f} 分钟  \n")
    lines.append(f"**模型**: {model_size} | **精度**: {compute_type} | **设备**: {device}  \n")
    lines.append(f"**转写总耗时**: {total_time:.0f}s\n\n")
    lines.append("---\n\n")

    current_speaker = None
    for segment in result.get("segments", []):
        start = segment.get("start", 0)
        end = segment.get("end", 0)
        text = segment.get("text", "").strip()
        speaker = segment.get("speaker", "")
        if not text:
            continue
        timestamp = f"[{format_timestamp(start)} - {format_timestamp(end)}]"
        if speaker and speaker != current_speaker:
            lines.append(f"\n### {speaker}\n\n")
            current_speaker = speaker
        lines.append(f"{timestamp} {text}\n\n")
    return "".join(lines)


def format_transcript(result: dict, audio_file: str, output_file: str,
                      audio_duration: float, total_time: float,
                      model_size: str = "large-v3",
                      compute_type: str = "bfloat16",
                      device: str = "tpu",
                      quiet: bool = False) -> str:
    """Write Markdown + JSON twin (reference: transcribe.py:186-226)."""
    if not quiet:
        print(f"📄 生成文档: {output_file}")

    md = render_transcript_markdown(result, audio_file, audio_duration,
                                    total_time, model_size, compute_type,
                                    device)
    Path(output_file).write_text(md, encoding="utf-8")

    # with_suffix, not str.replace: '.md' can occur anywhere in the path
    # (v1.mdx_rec_transcript.md, /notes.md/x.md), and a non-.md output
    # name must not make the JSON overwrite the Markdown
    json_file = str(Path(output_file).with_suffix(".json"))
    with open(json_file, "w", encoding="utf-8") as f:
        json.dump(result, f, ensure_ascii=False, indent=2)

    if not quiet:
        print(f"✅ 转写稿: {output_file}")
        print(f"✅ JSON: {json_file}")
    return json_file


def _web_format_timestamp(seconds: float) -> str:
    """Reference: processor.js:301-307."""
    total = int(seconds)
    hh = int(seconds // 3600)
    mm = (total % 3600) // 60
    ss = total % 60
    return f"{hh:02d}:{mm:02d}:{ss:02d}"


def format_to_markdown(segments: Optional[List[dict]]) -> str:
    """Web Markdown body (reference: processor.js:115-134)."""
    md = "# 录音转写\n\n"
    current_speaker = None
    for seg in segments or []:
        text = (seg.get("text") or "").strip()
        if not text:
            continue
        start = _web_format_timestamp(seg.get("start", 0))
        end = _web_format_timestamp(seg.get("end", 0))
        speaker = seg.get("speaker")
        if speaker and speaker != current_speaker:
            md += f"\n### {speaker}\n\n"
            current_speaker = speaker
        md += f"[{start} - {end}] {text}\n\n"
    return md
