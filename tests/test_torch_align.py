"""PyTorch port: forced alignment against the JAX package.

The same wav2vec2 tree (the repository's synthetic aligner, or a seeded
random ``tiny_test`` tree) and the same seeded audio and segments go
through ``manual_whisper_tpu.models.align`` and
``manual_whisper_tpu_torch.models.align`` (``device="cpu"``).  Held equal:
``ctc_viterbi_align`` spans and totals (float64 numpy on both sides, so
exactly, including a trellis of more than 63 labels); ``align`` and
``align_result`` word for word (text, start, end and score, which both
round to 3 decimals) on seeded synthetic files, on a segment over 30 s that
is split into pieces, and on an infeasible trellis; the span and grouping
helpers; ``load_align_model`` from the orbax tree, from the committed
export and from an HF directory; the zh fallback's error.
"""

import json
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from manual_whisper_tpu import config as jconfig
from manual_whisper_tpu.convert.from_hf import load_params
from manual_whisper_tpu.eval.synth import render_file_with_times, sample_text
from manual_whisper_tpu.models import align as jalign
from manual_whisper_tpu.models import wav2vec2 as jw2v
from manual_whisper_tpu_torch import config as tconfig
from manual_whisper_tpu_torch.models import align as talign
from manual_whisper_tpu_torch.models import wav2vec2 as tw2v
from cpu_budget import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
WEIGHTS = ROOT / ".weights"
ALIGN_DIR = WEIGHTS / "jonatasgrosman--wav2vec2-large-xlsr-53-english"
SR = 16000


def _tcfg(jcfg):
    return tw2v.Wav2Vec2Config(**{f: getattr(jcfg, f) for f in (
        "vocab_size", "hidden", "n_layers", "n_heads", "ffn", "conv_dim",
        "pos_conv_kernel", "pos_conv_groups")})


@pytest.fixture(scope="module")
def aligner_tree():
    tree = load_params(ALIGN_DIR / "jax")
    if tree is None:
        pytest.skip("no synthetic aligner in the repository")
    meta = json.loads((ALIGN_DIR / "align_meta.json").read_text())
    return jax.tree.map(np.asarray, tree), meta


def _pair(tree, meta, language):
    jcfg = jw2v.Wav2Vec2Config(**meta["config"])
    vocab = {k: int(v) for k, v in meta["vocab"].items()}
    jm = jalign.AlignModel(params=tree, cfg=jcfg, vocab=vocab,
                           blank_id=int(meta["blank_id"]), language=language)
    tm = talign.AlignModel(tree, cfg=_tcfg(jcfg), vocab=vocab,
                           blank_id=int(meta["blank_id"]), language=language,
                           device="cpu")
    return jm, tm


def _synth_segments(seed, n_utts=3):
    rng = np.random.default_rng(seed)
    utts = [sample_text(rng, 3, 6) for _ in range(n_utts)]
    audio, words_t = render_file_with_times(utts, seed=seed)
    segments, i = [], 0
    for utt in utts:
        times = words_t[i: i + len(utt)]
        i += len(utt)
        segments.append({"text": " " + " ".join(utt),
                         "start": round(max(0.0, times[0][1] - 0.15), 3),
                         "end": round(times[-1][2] + 0.15, 3)})
    return audio, segments, words_t


# ---------------------------------------------------------------------------
# The copied host code
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,n,v", [(40, 5, 8), (120, 30, 12), (300, 80, 24),
                                   (200, 99, 6)])
def test_ctc_viterbi_align_equal(t, n, v):
    rng = np.random.default_rng(t + n)
    logits = rng.standard_normal((t, v)) * 3
    log_probs = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    targets = [int(x) for x in rng.integers(1, v, n)]
    targets[n // 2] = targets[n // 2 - 1]      # a repeated label
    got = talign.ctc_viterbi_align(log_probs, targets, 0)
    ref = jalign.ctc_viterbi_align(log_probs, targets, 0)
    assert got == ref
    assert len(got[0]) == n


def test_ctc_viterbi_degenerate_equal():
    lp = np.log(np.full((4, 3), 1 / 3))
    assert talign.ctc_viterbi_align(lp, [], 0) == \
        jalign.ctc_viterbi_align(lp, [], 0)
    assert talign.ctc_viterbi_align(lp[:0], [1], 0) == \
        jalign.ctc_viterbi_align(lp[:0], [1], 0)


def test_span_and_word_helpers_equal(monkeypatch):
    spans = [(3, 5, 0.9), (-1, -1, 0.0), (9, 10, 0.5), (10, 14, 0.7),
             (30, 31, 0.2)]
    for cap in (0.0, 0.04, 0.08, 0.3):
        assert talign.extend_span_starts(spans, 0.02, cap) == \
            jalign.extend_span_starts(spans, 0.02, cap)
    vocab = {"<pad>": 0, "|": 1, "a": 2, "B": 3, "你": 4}
    for text in ("ab ba", "A你b, c", ""):
        assert talign._tokenize_chars(text, vocab) == \
            jalign._tokenize_chars(text, vocab)
    text = "ab  cd 你好"
    times = [(0.1 * i, 0.1 * i + 0.05, 0.5 + 0.01 * i) if i % 3 else None
             for i in range(len(text))]
    for lang in ("en", "zh"):
        assert talign._group_words(text, times, lang) == \
            jalign._group_words(text, times, lang)
    monkeypatch.setenv("MWX_ALIGN_START_BACKOFF_SEC", "0.12")
    jconfig.clear_env_cache()
    tconfig.clear_env_cache()
    assert talign.start_backoff_sec() == jalign.start_backoff_sec() == 0.12
    assert talign.START_BACKOFF_SEC == jalign.START_BACKOFF_SEC
    assert talign.DEFAULT_ALIGN_MODELS == jalign.DEFAULT_ALIGN_MODELS
    assert talign.CHAR_ALIGNED_LANGUAGES == jalign.CHAR_ALIGNED_LANGUAGES
    for n in (1, 8, 9):
        assert talign._row_bucket(n) == jalign._row_bucket(n)
    for n in (1, 32000, 32001, 200000, 480000, 900000):
        assert talign._len_bucket(n) == jalign._len_bucket(n)


# ---------------------------------------------------------------------------
# align / align_result on the synthetic aligner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,language", [(0, "en"), (1, "en"), (2, "zh")])
def test_align_equal_on_synthetic_files(aligner_tree, seed, language):
    tree, meta = aligner_tree
    jm, tm = _pair(tree, meta, language)
    audio, segments, _ = _synth_segments(seed)
    for chars in (False, True):
        ref = jalign.align(segments, jm, audio, return_char_alignments=chars)
        got = talign.align(segments, tm, audio, return_char_alignments=chars)
        assert got == ref
    assert sum(len(s["words"]) for s in got["segments"]) > 5


def test_align_segment_over_30s_and_infeasible_trellis(aligner_tree):
    tree, meta = aligner_tree
    jm, tm = _pair(tree, meta, "en")
    parts, texts = [], []
    for seed in range(11):
        audio, segments, _ = _synth_segments(10 + seed, n_utts=2)
        parts.append(audio)
        texts += [s["text"].strip() for s in segments]
    audio = np.concatenate(parts)
    assert len(audio) > 35 * SR
    segments = [
        {"text": " " + " ".join(texts), "start": 0.0,
         "end": round(len(audio) / SR, 3)},
        # 0.3 s of audio cannot hold 40 labels (2N + 1 > frames)
        {"text": " " + " ".join(texts[:3]), "start": 1.0, "end": 1.3},
        {"text": "", "start": 2.0, "end": 3.0}]
    ref = jalign.align(segments, jm, audio)
    got = talign.align(segments, tm, audio)
    assert got == ref
    assert len(got["segments"][0]["words"]) > 20
    assert got["segments"][1]["words"] == []


def test_align_result_equal(aligner_tree):
    tree, meta = aligner_tree
    jm, tm = _pair(tree, meta, "en")
    audio, segments, _ = _synth_segments(3)
    result = {"segments": segments, "language": "en"}
    ref = jalign.align_result(result, audio, "en", model=jm)
    got = talign.align_result(result, audio, "en", model=tm)
    assert got == ref
    assert set(got) == {"segments", "language", "word_segments"}


def test_align_random_tiny_equal():
    """A seeded random tiny_test tree over a zh vocabulary, char-aligned."""
    jcfg = jw2v.Wav2Vec2Config.tiny_test()
    tree = tw2v.init_wav2vec2_params(torch.Generator().manual_seed(0),
                                     _tcfg(jcfg))
    vocab = {"<pad>": 0, "|": 1, "你": 2, "好": 3, "世": 4, "界": 5,
             "h": 6, "i": 7}
    jm = jalign.AlignModel(params=tree, cfg=jcfg, vocab=vocab, blank_id=0,
                           language="zh")
    tm = talign.AlignModel(tree, cfg=_tcfg(jcfg), vocab=vocab, blank_id=0,
                           language="zh", device="cpu")
    rng = np.random.default_rng(0)
    audio = (0.1 * rng.standard_normal(SR * 3)).astype(np.float32)
    segments = [{"text": "你好世界", "start": 0.2, "end": 1.4},
                {"text": "", "start": 1.5, "end": 1.6},
                {"text": "好 hi", "start": 1.8, "end": 2.6}]
    assert talign.align(segments, tm, audio) == \
        jalign.align(segments, jm, audio)


# ---------------------------------------------------------------------------
# load_align_model
# ---------------------------------------------------------------------------

def _registry(monkeypatch, root):
    monkeypatch.setenv("MWX_WEIGHTS_DIR", str(root))
    jconfig.clear_env_cache()
    tconfig.clear_env_cache()


def _registry_with(tmp_path, *names):
    """A registry whose aligner directory links only ``names`` of the
    repository's."""
    d = tmp_path / ALIGN_DIR.name
    d.mkdir()
    for name in names:
        (d / name).symlink_to(ALIGN_DIR / name)
    return tmp_path


def test_load_align_model_reads_the_export(aligner_tree, tmp_path,
                                           monkeypatch):
    tree, meta = aligner_tree
    _registry(monkeypatch, _registry_with(
        tmp_path, "pytorch_model.bin", "align_meta.json", "SYNTH_TRAINED"))
    monkeypatch.delenv("MWX_ALLOW_SYNTH_WEIGHTS", raising=False)
    with pytest.warns(RuntimeWarning, match="synthetic"):
        tm = talign.load_align_model("en", device="cpu")
    assert tm.device == torch.device("cpu")
    assert tm.vocab == meta["vocab"] and tm.blank_id == meta["blank_id"]
    monkeypatch.setenv("MWX_ALLOW_SYNTH_WEIGHTS", "1")
    _registry(monkeypatch, WEIGHTS)       # the JAX package reads jax/
    jm = jalign.load_align_model("en")
    audio, segments, _ = _synth_segments(4)
    assert talign.align(segments, tm, audio) == \
        jalign.align(segments, jm, audio)


def test_load_align_model_reads_the_jax_tree(aligner_tree, tmp_path,
                                             monkeypatch):
    """A registry whose aligner is only the orbax ``jax/`` tree and
    ``align_meta.json`` (no torch export): the port reads it as the JAX
    package does, warns about the synthetic-data marker as it does, and
    aligns alike."""
    tree, meta = aligner_tree
    _registry(monkeypatch, _registry_with(
        tmp_path, "jax", "align_meta.json", "SYNTH_TRAINED"))
    monkeypatch.delenv("MWX_ALLOW_SYNTH_WEIGHTS", raising=False)
    with pytest.warns(RuntimeWarning, match="synthetic"):
        tm = talign.load_align_model("en", device="cpu")
    with pytest.warns(RuntimeWarning, match="synthetic"):
        jm = jalign.load_align_model("en")
    assert tm.vocab == meta["vocab"] and tm.blank_id == meta["blank_id"]
    audio, segments, _ = _synth_segments(4)
    assert talign.align(segments, tm, audio) == \
        jalign.align(segments, jm, audio)


def test_load_align_model_reads_hf_directory(tmp_path, monkeypatch):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf_cfg = transformers.Wav2Vec2Config(
        vocab_size=8, hidden_size=32, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=64, conv_dim=[16] * 7,
        conv_kernel=[10, 3, 3, 3, 3, 2, 2], conv_stride=[5, 2, 2, 2, 2, 2, 2],
        num_conv_pos_embeddings=8, num_conv_pos_embedding_groups=2,
        do_stable_layer_norm=True, feat_extract_norm="layer",
        conv_bias=True)
    hf = transformers.Wav2Vec2ForCTC(hf_cfg).eval()
    d = tmp_path / "org--w2v"
    hf.save_pretrained(str(d))
    vocab = {"<pad>": 0, "|": 1, "a": 2, "b": 3, "c": 4, "d": 5, "e": 6,
             "f": 7}
    (d / "vocab.json").write_text(json.dumps(vocab))
    _registry(monkeypatch, tmp_path)
    tm = talign.load_align_model("en", device="cpu", model_name="org/w2v")
    jm = jalign.load_align_model("en", model_name="org/w2v")
    assert tm.cfg == _tcfg(jm.cfg) and tm.vocab == jm.vocab
    rng = np.random.default_rng(1)
    audio = (0.1 * rng.standard_normal(SR * 2)).astype(np.float32)
    segs = [{"text": "ab cafe", "start": 0.1, "end": 1.9}]
    assert talign.align(segs, tm, audio) == jalign.align(segs, jm, audio)


def test_zh_fallback_error_matches_jax(tmp_path, monkeypatch):
    """The zh default aligner is not in the registry: both raise the same
    FileNotFoundError (the CLI then keeps segment timestamps), unless
    MWX_ALLOW_RANDOM_WEIGHTS selects the tiny random aligner."""
    _registry(monkeypatch, tmp_path)
    monkeypatch.delenv("MWX_ALLOW_RANDOM_WEIGHTS", raising=False)
    with pytest.raises(FileNotFoundError) as got:
        talign.load_align_model("zh", device="cpu")
    with pytest.raises(FileNotFoundError) as ref:
        jalign.load_align_model("zh")
    assert str(got.value) == str(ref.value)
    assert "alignment checkpoint not found" in str(got.value)
    with pytest.raises(KeyError):
        talign.load_align_model("xx", device="cpu")
    monkeypatch.setenv("MWX_ALLOW_RANDOM_WEIGHTS", "1")
    tconfig.clear_env_cache()
    tm = talign.load_align_model("zh", device="cpu")
    jm = jalign.load_align_model("zh")
    assert tm.vocab == jm.vocab and tm.cfg == _tcfg(jm.cfg)
    audio = (0.1 * np.random.default_rng(2).standard_normal(SR * 2)
             ).astype(np.float32)
    out = talign.align([{"text": "我们说 abc", "start": 0.0, "end": 2.0}],
                       tm, audio)
    assert [w["word"] for w in out["word_segments"]] == list("我们说abc")


def test_align_model_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(RuntimeError, match="CUDA"):
            talign._random_align_model("zh")
