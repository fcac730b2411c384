"""Whisper's token layout and greedy decoding rules, written from OpenAI's
``tokenizer.py`` and ``decoding.py`` for a byte-level vocabulary (token id
= byte value, ``base_vocab`` = 256), the vocabulary the benchmark serves.

After the base ranks come ``<|endoftext|>``, ``<|startoftranscript|>``,
one token per language, translate, transcribe, ``<|startoflm|>``,
``<|startofprev|>``, ``<|nospeech|>``, ``<|notimestamps|>`` and the
timestamp tokens.  A greedy transcription without timestamps may pick any
base token except OpenAI's non-speech symbols, or end-of-text; at the
first step neither a blank nor end-of-text (``suppress_blank``).
"""

from __future__ import annotations

from typing import List

import numpy as np

# OpenAI Whisper's language order; only the index of the language used
# matters here
LANGUAGE_ORDER = ("en", "zh", "de", "es", "ru", "ko", "fr", "ja")

NON_SPEECH_SYMBOLS = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』') + [
    "<<", ">>", "<<<", ">>>", "--", "---", "-(", "-[", "('", "(\"", "((",
    "))", "(((", ")))", "[[", "]]", "{{", "}}", "♪♪", "♪♪♪"]
MISCELLANEOUS = "♩♪♫♬♭♮♯"


def specials(base_vocab: int, num_languages: int) -> dict:
    eot = base_vocab
    lang_base = eot + 2
    translate = lang_base + num_languages
    return {"eot": eot, "sot": eot + 1, "lang_base": lang_base,
            "translate": translate, "transcribe": translate + 1,
            "sot_prev": translate + 3, "no_speech": translate + 4,
            "no_timestamps": translate + 5,
            "timestamp_begin": translate + 6}


def _encode(text: str) -> List[int]:
    return list(text.encode("utf-8"))


def prefix(prompt: str, language: str, base_vocab: int, num_languages: int,
           n_text_ctx: int) -> List[int]:
    """``<|startofprev|>`` + the prompt's last n_text_ctx // 2 - 1 tokens
    (when there is a prompt), then
    ``<|startoftranscript|><|lang|><|transcribe|><|notimestamps|>``."""
    sp = specials(base_vocab, num_languages)
    prev = [sp["sot_prev"]] + _encode(" " + prompt.strip())[
        -(n_text_ctx // 2 - 1):] if prompt else []
    lang = sp["lang_base"] + LANGUAGE_ORDER.index(language)
    return prev + [sp["sot"], lang, sp["transcribe"], sp["no_timestamps"]]


def non_speech(base_vocab: int) -> List[int]:
    """OpenAI's ``non_speech_tokens`` over a byte vocabulary: a symbol's
    token where it is one token, the first token of a musical sign, never
    the bare space."""
    out = set()
    for sym in NON_SPEECH_SYMBOLS + list(MISCELLANEOUS):
        for ids in (_encode(sym), _encode(" " + sym)):
            if not ids or ids[0] == _encode(" ")[0]:
                continue
            if len(ids) == 1 or sym in MISCELLANEOUS:
                out.add(ids[0])
    return sorted(t for t in out if t < base_vocab)


def allowed(n_vocab: int, base_vocab: int, first: bool) -> np.ndarray:
    """Boolean mask [n_vocab] of the tokens greedy decoding may pick."""
    mask = np.zeros(n_vocab, bool)
    mask[:base_vocab + 1] = True            # base tokens and end-of-text
    mask[non_speech(base_vocab)] = False
    if first:
        mask[_encode(" ")[0]] = False
        mask[base_vocab] = False
    return mask
