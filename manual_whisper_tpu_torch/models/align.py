"""wav2vec2-CTC forced alignment -> word-level timestamps (port of the JAX
``models/align.py``).

Replaces ``whisperx.load_align_model`` / ``whisperx.align`` (reference:
transcribe.py:130-131; align failure falls back to segment timestamps).
Flow per Whisper segment:

1. run the wav2vec2 CTC model (``models/wav2vec2.py``) on the segment's
   audio, on the card unless the caller asks for the CPU;
2. Viterbi-align the segment text to the CTC log-probs with the classic
   blank-interleaved trellis (host numpy, float64);
3. map aligned char spans to seconds and group into words (per-char for
   zh-style scripts, whitespace groups otherwise).

Output schema matches whisperx: segments gain ``words``
[{word, start, end, score}] and a flat ``word_segments`` list is returned,
which downstream speaker assignment consumes.

``ctc_viterbi_align``, ``START_BACKOFF_SEC``, ``extend_span_starts``,
``_tokenize_chars`` and ``_group_words`` are copies of the JAX package's
(numpy and Python only).  The batching is the JAX package's: clips padded
to a length ladder of 2, 4, 8, 15 and 30 s, eight rows a forward, every
forward launched before any result is fetched, each fetched once.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import config
from ..device import DeviceLike, resolve_device
from .wav2vec2 import (Wav2Vec2, Wav2Vec2Config, frames_for_samples,
                       init_wav2vec2_params)

SAMPLE_RATE = 16000

# Language -> HF checkpoint the reference stack uses via whisperx's
# DEFAULT_ALIGN_MODELS (zh call site: transcribe.py:130).
DEFAULT_ALIGN_MODELS: Dict[str, str] = {
    "zh": "jonatasgrosman/wav2vec2-large-xlsr-53-chinese-zh-cn",
    # whisperx's en default (torchaudio WAV2VEC2_ASR_BASE_960H) is the
    # group-norm/post-LN variant this stable-LN implementation cannot
    # convert; the XLSR-53 English fine-tune is the stable-LN equivalent
    "en": "jonatasgrosman/wav2vec2-large-xlsr-53-english",
    "ja": "jonatasgrosman/wav2vec2-large-xlsr-53-japanese",
    "fr": "jonatasgrosman/wav2vec2-large-xlsr-53-french",
    "de": "jonatasgrosman/wav2vec2-large-xlsr-53-german",
    "es": "jonatasgrosman/wav2vec2-large-xlsr-53-spanish",
}

# Scripts aligned per character (no whitespace word boundaries).
CHAR_ALIGNED_LANGUAGES = {"zh", "ja", "ko", "yue", "th", "lo", "my"}


@dataclasses.dataclass
class AlignModel:
    """An aligner on one device (CUDA unless the caller asks for the CPU).

    ``params`` is the JAX package's wav2vec2 tree (numpy leaves), turned
    into ``model``, a ``Wav2Vec2`` on ``device``, once at construction."""
    params: dataclasses.InitVar[Any]
    cfg: Wav2Vec2Config
    vocab: Dict[str, int]        # char -> CTC label id
    blank_id: int
    language: str
    device: DeviceLike = "cuda"
    model: Wav2Vec2 = dataclasses.field(init=False, repr=False)

    def __post_init__(self, params):
        from ..convert import from_jax_wav2vec2
        self.device = resolve_device(self.device)
        self.model = from_jax_wav2vec2(params, self.cfg, self.device)

    @property
    def frame_duration(self) -> float:
        return 320.0 / SAMPLE_RATE   # total conv stride


def ctc_viterbi_align(log_probs: np.ndarray, targets: List[int],
                      blank_id: int
                      ) -> Tuple[List[Tuple[int, int, float]], float]:
    """Viterbi forced alignment of ``targets`` to CTC ``log_probs`` [T, V].

    Classic blank-interleaved state machine (states = 2N+1).  Returns
    ([(start_frame, end_frame_exclusive, score) per target], total_logprob).
    Score is the mean label probability over the token's frames.
    """
    T, _ = log_probs.shape
    N = len(targets)
    if N == 0 or T == 0:
        return [], float("-inf")

    S = 2 * N + 1
    labels = np.empty(S, np.int64)
    labels[0::2] = blank_id
    labels[1::2] = targets

    NEG = -1e30
    delta = np.full((T, S), NEG, np.float64)
    psi = np.zeros((T, S), np.int8)   # 0: stay, 1: from s-1, 2: from s-2

    delta[0, 0] = log_probs[0, blank_id]
    delta[0, 1] = log_probs[0, labels[1]]

    same_as_two_back = np.zeros(S, bool)
    same_as_two_back[2:] = labels[2:] == labels[:-2]

    for t in range(1, T):
        stay = delta[t - 1]
        from1 = np.concatenate(([NEG], delta[t - 1, :-1]))
        from2 = np.concatenate(([NEG, NEG], delta[t - 1, :-2]))
        # skip transition only into non-blank states with a different label
        from2 = np.where((np.arange(S) % 2 == 1) & ~same_as_two_back,
                         from2, NEG)
        best = np.maximum(np.maximum(stay, from1), from2)
        psi[t] = np.where(best == from2, 2, np.where(best == from1, 1, 0))
        delta[t] = best + log_probs[t, labels]

    # end in final blank or final label
    end_state = S - 1 if delta[T - 1, S - 1] >= delta[T - 1, S - 2] else S - 2
    total = float(delta[T - 1, end_state])

    # backtrack.  int(...) before subtracting: under NumPy 2 weak
    # promotion `python_int - int8_scalar` casts the python int TO int8,
    # which overflows once the trellis has >63 labels (S > 127) — e.g.
    # end_state 224 on a 112-char zh segment
    path = np.empty(T, np.int64)
    s = end_state
    for t in range(T - 1, -1, -1):
        path[t] = s
        s -= int(psi[t, s])

    spans: List[Tuple[int, int, float]] = []
    for j in range(N):
        state = 2 * j + 1
        frames = np.nonzero(path == state)[0]
        if len(frames) == 0:
            spans.append((-1, -1, 0.0))
            continue
        start, end = int(frames[0]), int(frames[-1]) + 1
        score = float(np.exp(log_probs[frames, labels[state]]).mean())
        spans.append((start, end, score))
    return spans, total


# How far (seconds) a label's start may extend back over preceding blank
# frames toward the previous label's span end.  Trained CTC models are
# PEAKY: each label fires a 1-2 frame spike near the END of its acoustic
# realization, with blank carrying the onset frames — so raw Viterbi span
# starts run systematically late while span ends are accurate.  The
# previous label's span end is the only reliable onset anchor in the
# posteriors; the cap keeps long true silences (which the anchor cannot
# distinguish from emission delay) from being swallowed into the next
# word.  The cap is an env knob (MWX_ALIGN_START_BACKOFF_SEC), as in the
# JAX package.
START_BACKOFF_SEC = 0.08


def start_backoff_sec() -> float:
    """The configured peaky-CTC start-anchor cap (seconds)."""
    return config.get_float("MWX_ALIGN_START_BACKOFF_SEC",
                            START_BACKOFF_SEC)


def extend_span_starts(spans: List[Tuple[int, int, float]],
                       frame_duration: float,
                       max_backoff_sec: float = START_BACKOFF_SEC
                       ) -> List[Tuple[int, int, float]]:
    """Pull each aligned span's start back toward the previous aligned
    span's end, by at most ``max_backoff_sec`` (see START_BACKOFF_SEC).
    Unaligned spans (start < 0) pass through and do not anchor."""
    backoff = max(0, int(round(max_backoff_sec / frame_duration)))
    out: List[Tuple[int, int, float]] = []
    prev_end = 0
    for f0, f1, score in spans:
        if f0 < 0:
            out.append((f0, f1, score))
            continue
        new_f0 = max(prev_end, f0 - backoff, 0)
        out.append((min(new_f0, f0), f1, score))
        prev_end = f1
    return out


def _tokenize_chars(text: str, vocab: Dict[str, int]
                    ) -> Tuple[List[int], List[int]]:
    """Map characters to CTC labels; returns (label_ids, char_indices).
    Characters missing from the vocab (punctuation etc.) are skipped and
    interpolated afterwards, like whisperx."""
    ids: List[int] = []
    idx: List[int] = []
    for i, ch in enumerate(text):
        key = ch
        if key == " ":
            key = "|"
        cand = vocab.get(key, vocab.get(key.upper(),
                                        vocab.get(key.lower())))
        if cand is not None:
            ids.append(cand)
            idx.append(i)
    return ids, idx


# one fixed row count per wav2vec2 forward and a coarse length ladder
# (seconds), as in the JAX package: at most len(_ALIGN_LEN_BUCKETS_SEC)
# shapes for the whole process
_ALIGN_ROW_BUCKETS = (8,)
_ALIGN_LEN_BUCKETS_SEC = (2, 4, 8, 15, 30)


def _row_bucket(n: int) -> int:
    for b in _ALIGN_ROW_BUCKETS:
        if n <= b:
            return b
    return _ALIGN_ROW_BUCKETS[-1]


def _len_bucket(n_samples: int) -> int:
    for sec in _ALIGN_LEN_BUCKETS_SEC:
        if n_samples <= sec * SAMPLE_RATE:
            return sec * SAMPLE_RATE
    return _ALIGN_LEN_BUCKETS_SEC[-1] * SAMPLE_RATE


def _prepare(segments: List[dict], model: AlignModel, audio: np.ndarray):
    """Phase 1 of ``align``: per-segment prep; alignable clips grouped by
    padded length.  Segments longer than the largest length bucket are
    split into equal <= 30 s pieces with the text divided proportionally by
    character (snapped to word boundaries for space-delimited scripts);
    pieces with no labels or an infeasible trellis (2N + 1 > frames) are
    skipped and keep segment timestamps.  Returns (prep, seg_pieces,
    groups)."""
    cap_samples = _ALIGN_LEN_BUCKETS_SEC[-1] * SAMPLE_RATE
    prep: List[dict] = []
    seg_pieces: List[List[int]] = []   # segment index -> prep indices
    groups: Dict[int, List[int]] = {}
    for seg in segments:
        text = (seg.get("text") or "").strip()
        s_start = float(seg.get("start", 0.0))
        s_end = float(seg.get("end", s_start))
        s_idx = int(s_start * SAMPLE_RATE)
        e_idx = min(int(s_end * SAMPLE_RATE), len(audio))
        n_pieces = max(1, -(-(e_idx - s_idx) // cap_samples))
        chars_per = len(text) / n_pieces
        cuts = [0]
        for k in range(1, n_pieces):
            c = int(k * chars_per)
            if model.language not in CHAR_ALIGNED_LANGUAGES and text:
                left = text.rfind(" ", 0, c)
                right = text.find(" ", c)
                cands = [p for p in (left, right) if p != -1]
                if cands:
                    c = min(cands, key=lambda p: abs(p - c))
            cuts.append(max(c, cuts[-1]))
        cuts.append(len(text))
        my_prep: List[int] = []
        for k in range(n_pieces):
            p_lo = s_idx + (e_idx - s_idx) * k // n_pieces
            p_hi = s_idx + (e_idx - s_idx) * (k + 1) // n_pieces
            p_start = p_lo / SAMPLE_RATE
            p_text = text[cuts[k]: cuts[k + 1]].strip()
            clip = np.asarray(audio[p_lo:p_hi], np.float32)[:cap_samples]
            n_frames = frames_for_samples(len(clip))
            labels: List[int] = []
            char_idx: List[int] = []
            if p_text and n_frames >= 2:
                labels, char_idx = _tokenize_chars(p_text, model.vocab)
            if not labels:
                continue
            if 2 * len(labels) + 1 > n_frames:
                continue      # infeasible CTC trellis: every path is -inf
            norm = (clip - clip.mean()) / np.sqrt(clip.var() + 1e-7)
            bucket = _len_bucket(len(norm))
            padded = np.zeros(bucket, np.float32)
            padded[: len(norm)] = norm
            groups.setdefault(bucket, []).append(len(prep))
            my_prep.append(len(prep))
            prep.append({"row": padded, "n_samples": len(norm),
                         "n_frames": n_frames,
                         "labels": labels, "char_idx": char_idx,
                         "start": p_start, "text": p_text})
        seg_pieces.append(my_prep)
    return prep, seg_pieces, groups


def forward_batch(model: AlignModel, batch: np.ndarray,
                  n_valid: np.ndarray) -> torch.Tensor:
    """One padded wav2vec2 forward on the model's device: ``[rows,
    bucket]`` normalised audio and each row's real sample count -> log-probs
    ``[rows, frames, vocab]`` (left on the device; nothing waits for it)."""
    dev = model.device
    with torch.inference_mode():
        return model.model(torch.from_numpy(batch).to(dev),
                           torch.from_numpy(n_valid).to(dev))


def align(segments: List[dict], model: AlignModel, audio: np.ndarray,
          return_char_alignments: bool = False) -> dict:
    """whisperx.align-compatible: attach word timings to segments.

    ``segments``: [{text, start, end}]; returns {"segments": [...],
    "word_segments": [...]}.  Every batched forward is launched before any
    result is fetched; each batch comes to the host once, as float64."""
    out_segments: List[dict] = []
    word_segments: List[dict] = []
    prep, seg_pieces, groups = _prepare(segments, model, audio)

    # phase 2: launch every batched forward before fetching any
    pending: Dict[int, Tuple[Any, int]] = {}   # prep index -> (out, row)
    for bucket, idxs in groups.items():
        for lo in range(0, len(idxs), _ALIGN_ROW_BUCKETS[-1]):
            chunk = idxs[lo: lo + _ALIGN_ROW_BUCKETS[-1]]
            rows = _row_bucket(len(chunk))
            batch = np.zeros((rows, bucket), np.float32)
            n_valid = np.zeros(rows, np.int32)
            for r, pi in enumerate(chunk):
                batch[r] = prep[pi]["row"]
                n_valid[r] = prep[pi]["n_samples"]
            out = forward_batch(model, batch, n_valid)
            for r, pi in enumerate(chunk):
                pending[pi] = (out, r)

    # phase 3: fetch + trellis in original order; each batch once
    fetched: Dict[int, np.ndarray] = {}
    for si, seg in enumerate(segments):
        seg_out = dict(seg)
        seg_out["words"] = []
        if not seg_pieces[si]:
            out_segments.append(seg_out)
            continue
        words: List[dict] = []
        chars: List[dict] = []
        for pi in seg_pieces[si]:
            info = prep[pi]
            out, r = pending[pi]
            arr = fetched.get(id(out))
            if arr is None:
                arr = out.cpu().numpy().astype(np.float64)
                fetched[id(out)] = arr
            log_probs = arr[r, : info["n_frames"]]
            p_start, text = info["start"], info["text"]
            labels, char_idx = info["labels"], info["char_idx"]

            spans, _ = ctc_viterbi_align(log_probs, labels, model.blank_id)

            fd = model.frame_duration
            spans = extend_span_starts(spans, fd, start_backoff_sec())
            char_times: List[Optional[Tuple[float, float, float]]] = \
                [None] * len(text)
            for (f0, f1, score), ci in zip(spans, char_idx):
                if f0 < 0:
                    continue
                char_times[ci] = (p_start + f0 * fd, p_start + f1 * fd,
                                  score)

            words.extend(_group_words(text, char_times, model.language))
            if return_char_alignments:
                chars.extend(
                    {"char": text[i], "start": ct[0], "end": ct[1],
                     "score": round(ct[2], 3)}
                    for i, ct in enumerate(char_times) if ct is not None)
        for w in words:
            word_segments.append(w)
        seg_out["words"] = words
        if words:
            seg_out["start"] = words[0]["start"]
            seg_out["end"] = words[-1]["end"]
        if return_char_alignments:
            seg_out["chars"] = chars
        out_segments.append(seg_out)

    return {"segments": out_segments, "word_segments": word_segments}


def _group_words(text: str, char_times, language: str) -> List[dict]:
    """Chars -> word dicts.  Char-aligned scripts: one word per character;
    otherwise whitespace-delimited groups."""
    words: List[dict] = []

    def emit(chars: List[int]):
        timed = [char_times[i] for i in chars if char_times[i] is not None]
        if not timed:
            return
        word = "".join(text[i] for i in chars).strip()
        if not word:
            return
        words.append({
            "word": word,
            "start": round(min(t[0] for t in timed), 3),
            "end": round(max(t[1] for t in timed), 3),
            "score": round(float(np.mean([t[2] for t in timed])), 3),
        })

    if language in CHAR_ALIGNED_LANGUAGES:
        for i, ch in enumerate(text):
            if not ch.isspace():
                emit([i])
    else:
        current: List[int] = []
        for i, ch in enumerate(text):
            if ch.isspace():
                if current:
                    emit(current)
                    current = []
            else:
                current.append(i)
        if current:
            emit(current)
    return words


def load_align_model(language_code: str, device: DeviceLike = "cuda",
                     model_name: Optional[str] = None) -> AlignModel:
    """whisperx.load_align_model surface (transcribe.py:130), on ``device``.

    Looks under $MWX_WEIGHTS_DIR/<model_name with '/' -> '--'>, in the JAX
    package's order, for its orbax ``jax/`` tree plus ``align_meta.json``
    (config fields, char vocab, blank id; ``from_hf.load_params``), then
    for the port's export of that tree (``pytorch_model.bin`` in HF
    ``Wav2Vec2ForCTC`` keys plus ``align_meta.json``), then for an HF
    checkpoint directory (``config.json``, ``model.safetensors`` or
    ``pytorch_model.bin``, ``vocab.json``); raises (caught by the CLI's
    degradation ladder) when none is there, unless
    MWX_ALLOW_RANDOM_WEIGHTS selects a tiny random aligner."""
    from ..convert import convert_wav2vec2_state_dict
    from ..from_hf import load_params, read_state_dict
    name = model_name or DEFAULT_ALIGN_MODELS.get(language_code)
    if name is None:
        raise KeyError(f"no default alignment model for {language_code!r}")
    root = config.weights_dir()
    path = Path(root) / name.replace("/", "--") if root else None
    if path is not None and (path / "align_meta.json").exists():
        meta = json.loads((path / "align_meta.json").read_text(
            encoding="utf-8"))
        cfg = Wav2Vec2Config(**meta["config"])
        tree = None
        if (path / "jax").exists():
            tree = load_params(path / "jax")
        elif (path / "pytorch_model.bin").exists():
            tree = convert_wav2vec2_state_dict(
                torch.load(str(path / "pytorch_model.bin"),
                           map_location="cpu", weights_only=True), cfg)
        if tree is not None:
            config.warn_if_synth_checkpoint(path, "alignment wav2vec2")
            return AlignModel(tree, cfg=cfg,
                              vocab={k: int(v) for k, v
                                     in meta["vocab"].items()},
                              blank_id=int(meta["blank_id"]),
                              language=language_code, device=device)
    if path is None or not (path / "config.json").exists():
        if config.get_bool("MWX_ALLOW_RANDOM_WEIGHTS", False):
            # benchmarks/tests: exercise the wav2vec2 + CTC-trellis compute
            # path with a tiny random model (timestamps are meaningless)
            return _random_align_model(language_code, device)
        if root is None:
            raise FileNotFoundError(
                "MWX_WEIGHTS_DIR not set; cannot load alignment model "
                f"{name!r}")
        raise FileNotFoundError(f"alignment checkpoint not found: {path}")

    hf_cfg = json.loads((path / "config.json").read_text())
    cfg = Wav2Vec2Config(
        vocab_size=int(hf_cfg["vocab_size"]),
        hidden=int(hf_cfg["hidden_size"]),
        n_layers=int(hf_cfg["num_hidden_layers"]),
        n_heads=int(hf_cfg["num_attention_heads"]),
        ffn=int(hf_cfg["intermediate_size"]),
        conv_dim=int(hf_cfg["conv_dim"][-1]),
        pos_conv_kernel=int(hf_cfg["num_conv_pos_embeddings"]),
        pos_conv_groups=int(hf_cfg["num_conv_pos_embedding_groups"]),
    )
    params = convert_wav2vec2_state_dict(read_state_dict(path), cfg)
    vocab = json.loads((path / "vocab.json").read_text(encoding="utf-8"))
    blank = vocab.get("<pad>", vocab.get("[PAD]", 0))
    return AlignModel(params, cfg=cfg, vocab=vocab, blank_id=int(blank),
                      language=language_code, device=device)


def _random_align_model(language_code: str,
                        device: DeviceLike = "cuda") -> AlignModel:
    """Tiny random-weight AlignModel covering common zh chars + pinyin
    letters so _tokenize_chars finds labels (gated behind
    MWX_ALLOW_RANDOM_WEIGHTS, mirroring pipeline load_model); its weights
    come from a torch.Generator seeded with 0."""
    chars = list("的一是了我不人在他有这上们来到时大地为子中你说生国年着"
                 "就那和要她出也得里后自以会家可下而过天去能对小多然于心"
                 "abcdefghijklmnopqrstuvwxyz ")
    vocab = {"<pad>": 0, "|": 1}
    for ch in chars:
        vocab.setdefault(ch, len(vocab))
    cfg = dataclasses.replace(Wav2Vec2Config.tiny_test(),
                              vocab_size=len(vocab))
    params = init_wav2vec2_params(torch.Generator().manual_seed(0), cfg)
    return AlignModel(params, cfg=cfg, vocab=vocab, blank_id=0,
                      language=language_code, device=device)


def align_result(result: dict, audio: np.ndarray, language: str,
                 model: Optional[AlignModel] = None,
                 device: DeviceLike = "cuda") -> dict:
    """CLI-facing: align all segments of a transcribe() result (reference
    flow: transcribe.py:130-131); loads the language's aligner on
    ``device`` unless ``model`` is given."""
    model = model or load_align_model(language, device)
    aligned = align(result.get("segments", []), model, audio)
    out = dict(result)
    out["segments"] = aligned["segments"]
    out["word_segments"] = aligned["word_segments"]
    return out
