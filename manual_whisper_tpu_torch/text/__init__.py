from .cleaning import (
    DOMAIN_TERMS,
    INITIAL_PROMPT,
    PROMPT_LEAK_PATTERNS,
    TERM_REPLACEMENTS,
    clean_segment_text,
    clean_result_segments,
    remove_hallucination_loops,
)
from .formatting import format_timestamp, format_transcript, format_to_markdown
from .processor import PostProcessOptions, post_process_segments

__all__ = [
    "DOMAIN_TERMS",
    "INITIAL_PROMPT",
    "PROMPT_LEAK_PATTERNS",
    "TERM_REPLACEMENTS",
    "clean_segment_text",
    "clean_result_segments",
    "remove_hallucination_loops",
    "format_timestamp",
    "format_transcript",
    "format_to_markdown",
    "PostProcessOptions",
    "post_process_segments",
]
