"""Whisper special-token scheme on top of byte-level BPE.

The reference's ASR backends (faster-whisper / Replicate WhisperX container)
all use OpenAI Whisper's token layout: after the base BPE ranks come
``<|endoftext|>``, ``<|startoftranscript|>``, one token per language,
task tokens, ``<|startoflm|>``, ``<|startofprev|>``, ``<|nospeech|>``,
``<|notimestamps|>`` and 1501 timestamp tokens at 0.02 s resolution.
large-v3 adds Cantonese (``yue``), shifting everything after the language
block by one.  IDs are computed from the base-vocab size so the same code
serves real checkpoints and tiny test vocabs.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from .bpe import ByteLevelBPE, bytes_to_unicode

# Canonical ordered language list (OpenAI Whisper); the first 99 are used by
# all multilingual checkpoints, the 100th ("yue") only by large-v3.
LANGUAGES: Dict[str, str] = {
    "en": "english", "zh": "chinese", "de": "german", "es": "spanish",
    "ru": "russian", "ko": "korean", "fr": "french", "ja": "japanese",
    "pt": "portuguese", "tr": "turkish", "pl": "polish", "ca": "catalan",
    "nl": "dutch", "ar": "arabic", "sv": "swedish", "it": "italian",
    "id": "indonesian", "hi": "hindi", "fi": "finnish", "vi": "vietnamese",
    "he": "hebrew", "uk": "ukrainian", "el": "greek", "ms": "malay",
    "cs": "czech", "ro": "romanian", "da": "danish", "hu": "hungarian",
    "ta": "tamil", "no": "norwegian", "th": "thai", "ur": "urdu",
    "hr": "croatian", "bg": "bulgarian", "lt": "lithuanian", "la": "latin",
    "mi": "maori", "ml": "malayalam", "cy": "welsh", "sk": "slovak",
    "te": "telugu", "fa": "persian", "lv": "latvian", "bn": "bengali",
    "sr": "serbian", "az": "azerbaijani", "sl": "slovenian", "kn": "kannada",
    "et": "estonian", "mk": "macedonian", "br": "breton", "eu": "basque",
    "is": "icelandic", "hy": "armenian", "ne": "nepali", "mn": "mongolian",
    "bs": "bosnian", "kk": "kazakh", "sq": "albanian", "sw": "swahili",
    "gl": "galician", "mr": "marathi", "pa": "punjabi", "si": "sinhala",
    "km": "khmer", "sn": "shona", "yo": "yoruba", "so": "somali",
    "af": "afrikaans", "oc": "occitan", "ka": "georgian", "be": "belarusian",
    "tg": "tajik", "sd": "sindhi", "gu": "gujarati", "am": "amharic",
    "yi": "yiddish", "lo": "lao", "uz": "uzbek", "fo": "faroese",
    "ht": "haitian creole", "ps": "pashto", "tk": "turkmen", "nn": "nynorsk",
    "mt": "maltese", "sa": "sanskrit", "lb": "luxembourgish", "my": "myanmar",
    "bo": "tibetan", "tl": "tagalog", "mg": "malagasy", "as": "assamese",
    "tt": "tatar", "haw": "hawaiian", "ln": "lingala", "ha": "hausa",
    "ba": "bashkir", "jw": "javanese", "su": "sundanese", "yue": "cantonese",
}

MAX_TIMESTAMP_TOKENS = 1501  # <|0.00|> .. <|30.00|> at 0.02 s steps
TIME_PRECISION = 0.02


@dataclass(frozen=True)
class SpecialTokens:
    """Computed special-token IDs for a given base-vocab size."""

    eot: int
    sot: int
    lang_base: int          # first language token (= sot + 1)
    n_languages: int
    translate: int
    transcribe: int
    sot_lm: int
    sot_prev: int
    no_speech: int
    no_timestamps: int
    timestamp_begin: int
    n_vocab: int

    @classmethod
    def build(cls, base_vocab_size: int, num_languages: int = 100
              ) -> "SpecialTokens":
        eot = base_vocab_size
        sot = eot + 1
        lang_base = sot + 1
        translate = lang_base + num_languages
        transcribe = translate + 1
        sot_lm = transcribe + 1
        sot_prev = sot_lm + 1
        no_speech = sot_prev + 1
        no_timestamps = no_speech + 1
        timestamp_begin = no_timestamps + 1
        return cls(
            eot=eot, sot=sot, lang_base=lang_base, n_languages=num_languages,
            translate=translate, transcribe=transcribe, sot_lm=sot_lm,
            sot_prev=sot_prev, no_speech=no_speech,
            no_timestamps=no_timestamps, timestamp_begin=timestamp_begin,
            n_vocab=timestamp_begin + MAX_TIMESTAMP_TOKENS,
        )


class WhisperTokenizer:
    """BPE + special-token handling for the Whisper decode loop.

    ``num_languages=100`` matches large-v3/large-v3-turbo (n_vocab 51866);
    ``99`` matches tiny..large-v2 (n_vocab 51865).
    """

    def __init__(self, bpe: ByteLevelBPE, num_languages: int = 100,
                 language: str = "zh", task: str = "transcribe"):
        self.bpe = bpe
        self.num_languages = num_languages
        base_size = self._base_vocab_size(bpe)
        self.special = SpecialTokens.build(base_size, num_languages)
        self.language = language
        self.task = task
        self._lang_codes = list(LANGUAGES.keys())[:num_languages]

    @staticmethod
    def _base_vocab_size(bpe: ByteLevelBPE) -> int:
        """Base ranks = entries below <|endoftext|> (HF vocab.json includes
        specials; raw OpenAI vocabs do not)."""
        eot = bpe.vocab.get("<|endoftext|>")
        if eot is not None:
            return eot
        return len(bpe.vocab)

    # -- loading -----------------------------------------------------------
    @classmethod
    def from_dir(cls, path, **kw) -> "WhisperTokenizer":
        path = Path(path)
        bpe = ByteLevelBPE.from_dir(path)
        # Infer language count from config if present.
        num_languages = kw.pop("num_languages", None)
        if num_languages is None:
            import json
            cfg = path / "tokenizer_meta.json"
            if cfg.exists():
                num_languages = json.loads(cfg.read_text()).get(
                    "num_languages", 100)
            else:
                # infer from the HF added-tokens table: large-v3 adds
                # <|yue|> (100 languages), earlier multilingual models
                # stop at 99.  Silently assuming 100 would shift every
                # special token by one for tiny..large-v2 dirs (e.g.
                # timestamp_begin 50365 vs 50364) with no error.
                added = path / "added_tokens.json"
                if added.exists():
                    toks = json.loads(added.read_text())
                    num_languages = 100 if "<|yue|>" in toks else 99
                else:
                    raise ValueError(
                        f"cannot infer the tokenizer's language count "
                        f"from {path} (no tokenizer_meta.json or "
                        "added_tokens.json): pass num_languages "
                        "explicitly (99 for tiny..large-v2, 100 for "
                        "large-v3) — special-token ids differ between "
                        "the two layouts")
        return cls(bpe, num_languages=num_languages, **kw)

    # -- special-token helpers ----------------------------------------------
    def language_token(self, code: str) -> int:
        code = code.lower()
        if code not in self._lang_codes:
            raise KeyError(f"unknown language code: {code!r}")
        return self.special.lang_base + self._lang_codes.index(code)

    def language_from_token(self, token_id: int) -> str:
        idx = token_id - self.special.lang_base
        if not 0 <= idx < self.num_languages:
            raise ValueError(f"not a language token: {token_id}")
        return self._lang_codes[idx]

    @property
    def all_language_tokens(self) -> List[int]:
        return [self.special.lang_base + i for i in range(self.num_languages)]

    def sot_sequence(self, language: Optional[str] = None,
                     task: Optional[str] = None,
                     without_timestamps: bool = True) -> List[int]:
        """``<|startoftranscript|><|lang|><|task|>[<|notimestamps|>]``."""
        sp = self.special
        seq = [sp.sot, self.language_token(language or self.language)]
        seq.append(sp.translate if (task or self.task) == "translate"
                   else sp.transcribe)
        if without_timestamps:
            seq.append(sp.no_timestamps)
        return seq

    def prompt_sequence(self, prompt_text: str, max_len: int = 223
                        ) -> List[int]:
        """``<|startofprev|>`` + trailing prompt tokens (faster-whisper keeps
        at most half the text context for the previous-text condition)."""
        toks = self.bpe.encode(" " + prompt_text.strip())
        return [self.special.sot_prev] + toks[-max_len:]

    def timestamp_token(self, seconds: float) -> int:
        step = int(round(seconds / TIME_PRECISION))
        step = max(0, min(MAX_TIMESTAMP_TOKENS - 1, step))
        return self.special.timestamp_begin + step

    def timestamp_from_token(self, token_id: int) -> float:
        return (token_id - self.special.timestamp_begin) * TIME_PRECISION

    def is_timestamp(self, token_id: int) -> bool:
        return token_id >= self.special.timestamp_begin

    def non_speech_tokens(self) -> List[int]:
        """Tokens suppressed during decoding (OpenAI's suppress list:
        symbols/sound-effect markers that encourage hallucination)."""
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
        symbols += ["<<", ">>", "<<<", ">>>", "--", "---", "-(", "-[", "('",
                    "(\"", "((", "))", "(((", ")))", "[[", "]]", "{{", "}}",
                    "♪♪", "♪♪♪"]
        miscellaneous = set("♩♪♫♬♭♮♯")
        # OpenAI semantics (tokenizer.py non_speech_tokens): the leading
        # tokens of " -"/" '" are suppressed, and for the miscellaneous
        # music symbols the first token is suppressed even when the
        # symbol byte-encodes to multiple tokens — dropping them
        # under-suppresses the sound-effect hallucination markers.
        # Byte-fallback guard: on BPE vocabs " -" is ONE token, but a
        # byte-level tokenizer (make_test_tokenizer) encodes it as
        # [space, '-'] — suppressing the bare space token would ban the
        # word separator itself and destroy every decode.
        space = self.bpe.encode(" ")
        space_tok = space[0] if len(space) == 1 else None
        result = set()
        for t in (" -", " '"):
            ids = self.bpe.encode(t)
            if ids and ids[0] != space_tok:
                result.add(ids[0])
        for symbol in symbols + list(miscellaneous):
            for ids in [self.bpe.encode(symbol),
                        self.bpe.encode(" " + symbol)]:
                if not ids or ids[0] == space_tok:
                    continue
                if len(ids) == 1 or symbol in miscellaneous:
                    result.add(ids[0])
        return sorted(result)

    # -- encode / decode -----------------------------------------------------
    def encode(self, text: str) -> List[int]:
        return self.bpe.encode(text)

    def decode(self, ids: Sequence[int]) -> str:
        """Decode, skipping all special tokens."""
        kept = [i for i in ids if i < self.special.eot]
        return self.bpe.decode(kept)

    def decode_with_timestamps(self, ids: Sequence[int]) -> str:
        parts: List[str] = []
        run: List[int] = []
        for i in ids:
            if i >= self.special.timestamp_begin:
                if run:
                    parts.append(self.bpe.decode(run))
                    run = []
                parts.append(f"<|{self.timestamp_from_token(i):.2f}|>")
            elif i < self.special.eot:
                run.append(i)
        if run:
            parts.append(self.bpe.decode(run))
        return "".join(parts)

    def split_to_word_tokens(self, ids: Sequence[int]
                             ) -> List[Tuple[str, List[int]]]:
        """Group text tokens into display words: space-delimited for
        latin scripts, per-codepoint-boundary for languages without word
        spaces (OpenAI split_tokens_on_unicode — the leading-space rule
        never fires on CJK text and would return one giant 'word')."""
        # OpenAI's unicode-split set exactly (ko is space-delimited and
        # splits on spaces like latin scripts)
        if (self.language or "").lower() in \
                {"zh", "ja", "th", "lo", "my", "yue"}:
            return self._split_tokens_on_unicode(ids)
        words: List[Tuple[str, List[int]]] = []
        current: List[int] = []
        for tid in ids:
            if tid >= self.special.eot:
                continue
            piece = self.bpe.decode([tid])
            if piece.startswith(" ") and current:
                words.append((self.bpe.decode(current), current))
                current = []
            current.append(tid)
        if current:
            words.append((self.bpe.decode(current), current))
        return words

    def _split_tokens_on_unicode(self, ids: Sequence[int]
                                 ) -> List[Tuple[str, List[int]]]:
        """Emit a word at every point the accumulated byte-level tokens
        decode to whole codepoints (no dangling UTF-8 prefix), per
        OpenAI's split_tokens_on_unicode."""
        ids = [int(i) for i in ids if i < self.special.eot]
        decoded_full = self.bpe.decode(ids)
        replacement = "�"
        words: List[Tuple[str, List[int]]] = []
        current: List[int] = []
        offset = 0
        for tid in ids:
            current.append(tid)
            decoded = self.bpe.decode(current)
            pos = decoded.find(replacement)
            if pos == -1 or (offset + pos < len(decoded_full)
                             and decoded_full[offset + pos] == replacement):
                words.append((decoded, current))
                offset += len(decoded)
                current = []
        if current:
            words.append((self.bpe.decode(current), current))
        return words


def make_test_tokenizer(num_languages: int = 100) -> WhisperTokenizer:
    """Tiny offline tokenizer: 256 byte tokens as the base vocab.

    Round-trips arbitrary UTF-8 text without vocab downloads; used by unit
    tests and synthetic-weight benchmarks.
    """
    byte_vocab = {ch: i for i, ch in
                  enumerate(bytes_to_unicode()[b] for b in range(256))}
    bpe = ByteLevelBPE(byte_vocab, [])
    return WhisperTokenizer(bpe, num_languages=num_languages)
