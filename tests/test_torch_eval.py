"""PyTorch port: the copies of ``eval/`` (metrics, synthetic corpora, VAD
boundary metrics) equal the JAX package's functions.

The port keeps its own copies because importing ``manual_whisper_tpu``
pulls in JAX.  Each copy gets the same seeded (and Hypothesis) inputs as
the original; outputs must be equal exactly (arrays bit for bit, floats
and dicts with ``==``).
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from manual_whisper_tpu.eval import metrics as jmetrics
from manual_whisper_tpu.eval import synth as jsynth
from manual_whisper_tpu.eval import vad_eval as jvad_eval
from manual_whisper_tpu_torch.eval import metrics as tmetrics
from manual_whisper_tpu_torch.eval import synth as tsynth
from manual_whisper_tpu_torch.eval import vad_eval as tvad_eval


def _same(a, b):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b)
    else:
        assert a == b


@pytest.mark.parametrize("seed", range(3))
def test_wer_cer_equal_on_seeded_text(seed):
    rng = np.random.default_rng(seed)
    ref = " ".join(jsynth.sample_text(rng, 4, 12))
    hyp = " ".join(jsynth.sample_text(rng, 3, 12))
    for name in ("wer", "cer"):
        _same(getattr(jmetrics, name)(ref, hyp),
              getattr(tmetrics, name)(ref, hyp))


_WORDS = st.lists(st.sampled_from(["ba", "de", "ko", "你", "好", "x,", "Y"]),
                  max_size=12)


@settings(max_examples=60, deadline=None)
@given(_WORDS, _WORDS)
def test_wer_cer_equal_on_hypothesis_text(ref, hyp):
    for name in ("wer", "cer"):
        _same(getattr(jmetrics, name)(" ".join(ref), " ".join(hyp)),
              getattr(tmetrics, name)(" ".join(ref), " ".join(hyp)))


@pytest.mark.parametrize("n_speakers,overlap", [(2, 0.0), (3, 0.3),
                                                (4, 0.5)])
def test_render_conversation_and_der_equal(n_speakers, overlap):
    kw = dict(n_turns=6, seed=n_speakers, n_speakers=n_speakers,
              overlap_prob=overlap)
    ja, jturns = jsynth.render_conversation(**kw)
    ta, tturns = tsynth.render_conversation(**kw)
    _same(ja, ta)
    assert [vars(t) for t in jturns] == [vars(t) for t in tturns]
    ref = jsynth.turns_to_rttm(jturns)
    _same(ref, tsynth.turns_to_rttm(tturns))
    # a hypothesis with shifted edges and a merged speaker
    rng = np.random.default_rng(n_speakers)
    hyp = [{"start": max(0.0, s["start"] + float(rng.uniform(-0.3, 0.3))),
            "end": s["end"] + float(rng.uniform(-0.3, 0.3)),
            "speaker": s["speaker"] if s["speaker"] != "SPEAKER_01"
            else "SPEAKER_00"} for s in ref]
    for collar in (0.0, 0.25):
        _same(jmetrics.der(ref, hyp, collar=collar),
              tmetrics.der(ref, hyp, collar=collar))


_SEGS = st.lists(st.tuples(st.floats(0, 20), st.floats(0.05, 3),
                           st.integers(0, 3)), max_size=8)


@settings(max_examples=60, deadline=None)
@given(_SEGS, _SEGS)
def test_der_equal_on_hypothesis_segments(ref, hyp):
    def segs(items):
        return [{"start": s, "end": s + d, "speaker": f"S{k}"}
                for s, d, k in items]
    _same(jmetrics.der(segs(ref), segs(hyp)),
          tmetrics.der(segs(ref), segs(hyp)))


@pytest.mark.parametrize("seed", range(3))
def test_render_file_with_times_and_word_timing_equal(seed):
    rng = np.random.default_rng(seed)
    utts = [jsynth.sample_text(rng, 3, 6) for _ in range(3)]
    snr = None if seed == 0 else 10.0
    ja, jt = jsynth.render_file_with_times(utts, seed=seed, snr_db=snr)
    ta, tt = tsynth.render_file_with_times(utts, seed=seed, snr_db=snr)
    _same(ja, ta)
    _same(jt, tt)
    _same(jsynth.render_file(utts, seed=seed),
          tsynth.render_file(utts, seed=seed))
    hyp = [{"word": w, "start": s + 0.01 * (i % 5), "end": e - 0.02}
           for i, (w, s, e) in enumerate(jt) if i % 4 != 1]
    for tol in (0.02, 0.08):
        _same(jmetrics.word_timing_scores(jt, hyp, tol),
              tmetrics.word_timing_scores(tt, hyp, tol))


def test_corpus_and_lexicon_equal():
    assert jsynth.WORDS == tsynth.WORDS
    assert jsynth.LOW_WORDS == tsynth.LOW_WORDS
    for (ja, jtext), (ta, ttext) in zip(jsynth.make_corpus(4, seed=3),
                                        tsynth.make_corpus(4, seed=3)):
        _same(ja, ta)
        assert jtext == ttext


_REGIONS = st.lists(st.tuples(st.floats(0, 30), st.floats(0.01, 4)),
                    max_size=8).map(
    lambda xs: sorted((s, s + d) for s, d in xs))


@settings(max_examples=60, deadline=None)
@given(_REGIONS, _REGIONS, st.floats(0.05, 0.5))
def test_vad_eval_equal_on_hypothesis_regions(pred, ref, tol):
    _same(jvad_eval.boundary_f1(pred, ref, tol),
          tvad_eval.boundary_f1(pred, ref, tol))
    _same(jvad_eval.region_overlap_stats(pred, ref, 35.0),
          tvad_eval.region_overlap_stats(pred, ref, 35.0))
    _same(jvad_eval.timestamp_deltas(pred, ref),
          tvad_eval.timestamp_deltas(pred, ref))


def test_compare_vad_paths_equal():
    audio = np.zeros(16000 * 10, np.float32)
    a = lambda x: [(0.5, 2.0), (3.1, 7.7)]           # noqa: E731
    b = lambda x: [(0.4, 2.2), (3.0, 5.0), (5.5, 7.6)]  # noqa: E731
    _same(jvad_eval.compare_vad_paths(audio, a, b),
          tvad_eval.compare_vad_paths(audio, a, b))
