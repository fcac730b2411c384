r"""Byte-level BPE (GPT-2 style), as used by Whisper's text tokenizer.

The reference delegates tokenization to faster-whisper/CTranslate2's bundled
tokenizer (dependency of whisperx, reference: requirements.txt:1); this is a
from-scratch implementation compatible with HF ``vocab.json``/``merges.txt``
files.  Pure host-side code, copied from the JAX package.

The GPT-2 pre-tokenizer (``_PRETOKENIZE_PATTERN``, which the JAX package
runs with the third-party ``regex`` module) is a hand-written scanner here,
``pretokenize``, so the port needs no ``regex``.  Its character classes
come from ``unicodedata``: ``\p{L}`` is a general category L*, ``\p{N}`` is
N*, and ``\s`` is ``str.isspace()`` without U+001C..U+001F (which ``regex``
does not count as whitespace).  It gives ``regex``'s splits on every code
point assigned in ``unicodedata.unidata_version``; code points assigned
only in a newer Unicode (``regex`` may carry a newer table) can differ.
"""

from __future__ import annotations

import json
import unicodedata
from functools import lru_cache
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

# GPT-2 pre-tokenization pattern (also used by Whisper's multilingual BPE);
# ``pretokenize`` gives its ``regex.findall`` splits.
_PRETOKENIZE_PATTERN = (
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)

_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
_SPACE, _LETTER, _NUMBER, _OTHER = range(4)


def _kind(ch: str) -> int:
    if ch.isspace() and not "\x1c" <= ch <= "\x1f":
        return _SPACE
    cat = unicodedata.category(ch)[0]
    return _LETTER if cat == "L" else _NUMBER if cat == "N" else _OTHER


def pretokenize(text: str) -> List[str]:
    """GPT-2's pre-tokenizer: the pieces ``regex.findall`` gives for
    ``_PRETOKENIZE_PATTERN``, found by trying its alternatives in order at
    each position."""
    kinds = [_kind(ch) for ch in text]
    n = len(text)
    out: List[str] = []
    i = 0
    while i < n:
        if text[i] == "'":
            hit = next((c for c in _CONTRACTIONS if text.startswith(c, i)),
                       None)
            if hit:
                out.append(hit)
                i += len(hit)
                continue
        # " ?\p{L}+", " ?\p{N}+", " ?[^\s\p{L}\p{N}]+": an optional
        # leading space, then a run of one class
        j = i + 1 if text[i] == " " and i + 1 < n \
            and kinds[i + 1] != _SPACE else i
        if kinds[j] != _SPACE:
            end = j + 1
            while end < n and kinds[end] == kinds[j]:
                end += 1
        else:
            end = i + 1
            while end < n and kinds[end] == _SPACE:
                end += 1
            # "\s+(?!\S)" leaves the run's last space to the next piece
            # when a non-space follows; "\s+" takes a single one
            if end < n and end - i > 1:
                end -= 1
        out.append(text[i:end])
        i = end
    return out


@lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode mapping."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class ByteLevelBPE:
    """Encoder/decoder over a ``vocab.json`` + ``merges.txt`` pair."""

    def __init__(self, vocab: Dict[str, int],
                 merges: Iterable[Tuple[str, str]]):
        self.vocab = dict(vocab)
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._bpe_cache: Dict[str, List[str]] = {}

    # -- loading ----------------------------------------------------------
    @classmethod
    def from_dir(cls, path) -> "ByteLevelBPE":
        path = Path(path)
        vocab = json.loads((path / "vocab.json").read_text(encoding="utf-8"))
        merges: List[Tuple[str, str]] = []
        merges_file = path / "merges.txt"
        if merges_file.exists():
            for line in merges_file.read_text(encoding="utf-8").splitlines():
                if not line or line.startswith("#version"):
                    continue
                parts = line.split(" ")
                if len(parts) == 2:
                    merges.append((parts[0], parts[1]))
        return cls(vocab, merges)

    def save(self, path) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        (path / "vocab.json").write_text(
            json.dumps(self.vocab, ensure_ascii=False), encoding="utf-8")
        ordered = sorted(self.bpe_ranks.items(), key=lambda kv: kv[1])
        (path / "merges.txt").write_text(
            "#version: 0.2\n" + "\n".join(f"{a} {b}" for (a, b), _ in ordered)
            + "\n", encoding="utf-8")

    # -- BPE core ----------------------------------------------------------
    def _bpe(self, token: str) -> List[str]:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word: List[str] = list(token)
        if not word:
            return []
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = new_word
        self._bpe_cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        unk = self.vocab.get("<unk>")
        for chunk in pretokenize(text):
            mapped = "".join(self.byte_encoder[b]
                             for b in chunk.encode("utf-8"))
            for piece in self._bpe(mapped):
                tid = self.vocab.get(piece)
                if tid is None:
                    # unknown merge result: fall back to per-byte tokens
                    for ch in piece:
                        cid = self.vocab.get(ch, unk)
                        if cid is not None:
                            ids.append(cid)
                else:
                    ids.append(tid)
        return ids

    def decode(self, ids: Iterable[int], errors: str = "replace") -> str:
        text = "".join(self.inv_vocab.get(i, "") for i in ids)
        data = bytearray()
        for ch in text:
            b = self.byte_decoder.get(ch)
            if b is not None:
                data.append(b)
            else:
                data.extend(ch.encode("utf-8"))
        return data.decode("utf-8", errors=errors)

    def __len__(self) -> int:
        return len(self.vocab)
