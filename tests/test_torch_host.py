"""PyTorch port: the host-side copies (tokenizer, audio, VAD, chunking,
text, config) behave exactly like the JAX package's modules."""

import sys

import numpy as np
import pytest

from manual_whisper_tpu import config as jconfig
from manual_whisper_tpu.audio import io as jio
from manual_whisper_tpu.audio.resample import resample_poly as j_resample
from manual_whisper_tpu.models import vad as jvad
from manual_whisper_tpu.pipeline import chunking as jchunk
from manual_whisper_tpu.text import cleaning as jclean
from manual_whisper_tpu.tokenizer import ByteLevelBPE as JBPE
from manual_whisper_tpu.tokenizer import make_test_tokenizer as j_tokenizer
from manual_whisper_tpu_torch import config as tconfig
from manual_whisper_tpu_torch.audio import io as tio
from manual_whisper_tpu_torch.audio.resample import resample_poly
from manual_whisper_tpu_torch.models import vad as tvad
from manual_whisper_tpu_torch.pipeline import chunking as tchunk
from manual_whisper_tpu_torch.text import cleaning as tclean
from manual_whisper_tpu_torch.tokenizer import ByteLevelBPE
from manual_whisper_tpu_torch.tokenizer import make_test_tokenizer

TEXTS = ["hello world", "中文会议讨论记录", " -'x ♪♪ (a)", "", "  tabs\tand\n"]


def test_test_tokenizer_matches_jax():
    tk, jtk = make_test_tokenizer(), j_tokenizer()
    import dataclasses
    assert dataclasses.asdict(tk.special) == dataclasses.asdict(jtk.special)
    assert tk.non_speech_tokens() == jtk.non_speech_tokens()
    assert tk.sot_sequence("zh") == jtk.sot_sequence("zh")
    for text in TEXTS:
        ids = tk.encode(text)
        assert ids == jtk.encode(text)
        assert tk.decode(ids) == jtk.decode(ids)
        assert tk.prompt_sequence(text) == jtk.prompt_sequence(text)


def _merge_vocab():
    from manual_whisper_tpu.tokenizer.bpe import bytes_to_unicode
    chars = [bytes_to_unicode()[b] for b in range(256)]
    vocab = {c: i for i, c in enumerate(chars)}
    merges = [("h", "e"), ("he", "l"), ("Ġ", "w")]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    return vocab, merges


def test_bpe_with_merges_matches_jax():
    vocab, merges = _merge_vocab()
    ours, ref = ByteLevelBPE(vocab, merges), JBPE(vocab, merges)
    for text in TEXTS + ["hel hello, world 42!"]:
        assert ours.encode(text) == ref.encode(text)


def test_bpe_with_merges_needs_regex(monkeypatch):
    """It needs no ``regex`` any more: with the module made unimportable, a
    vocabulary with merges encodes as the JAX package's (which uses
    ``regex``) does."""
    vocab, merges = _merge_vocab()
    texts = TEXTS + ["it's 12 o'clock", "a  b\x1c c"]
    expected = [JBPE(vocab, merges).encode(t) for t in texts]
    monkeypatch.setitem(sys.modules, "regex", None)
    assert [ByteLevelBPE(vocab, merges).encode(t) for t in texts] == expected
    # a merge-free byte vocab too
    assert make_test_tokenizer().encode("hi") == [ord("h"), ord("i")]


@pytest.mark.parametrize("sr,channels", [(16000, 1), (44100, 2), (8000, 1)])
def test_load_audio_matches_numpy_path(tmp_path, sr, channels):
    import struct
    rng = np.random.default_rng(sr)
    data = (0.3 * rng.standard_normal((sr // 2, channels))).astype(np.float32)
    pcm = (data * 32767).astype("<i2").tobytes()
    header = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(pcm),
                         b"WAVE", b"fmt ", 16, 1, channels, sr,
                         sr * 2 * channels, 2 * channels, 16, b"data",
                         len(pcm))
    path = tmp_path / "x.wav"
    path.write_bytes(header + pcm)
    from manual_whisper_tpu.audio.resample import to_mono
    samples, got_sr = jio.decode_wav_bytes(path.read_bytes())
    mono = to_mono(samples)
    ref = mono if got_sr == 16000 else j_resample(mono, got_sr, 16000)
    out = tio.load_audio(path)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_unsupported_suffix_raises_zh_message(tmp_path, monkeypatch):
    """With neither the ffmpeg CLI nor the FFmpeg shim, a compressed
    container raises the JAX package's zh-CN error."""
    from manual_whisper_tpu_torch.audio import native as tnative
    monkeypatch.setattr(tio.shutil, "which", lambda name: None)
    monkeypatch.setattr(tnative, "get_ffdec", lambda *a, **k: None)
    path = tmp_path / "a.mp3"
    path.write_bytes(b"\x00" * 16)
    with pytest.raises(tio.UnsupportedFormatError) as info:
        tio.load_audio(path)
    assert info.value.zh == jio.UnsupportedFormatError(".mp3").zh


def test_resample_matches_jax():
    x = np.random.default_rng(0).standard_normal(4410).astype(np.float32)
    np.testing.assert_array_equal(resample_poly(x, 44100, 16000),
                                  j_resample(x, 44100, 16000))


def test_energy_vad_and_binarize_match_jax():
    rng = np.random.default_rng(1)
    t = np.arange(16000 * 6) / 16000
    audio = (0.002 * rng.standard_normal(len(t))
             + 0.3 * np.sin(2 * np.pi * 220 * t)
             * (np.sin(2 * np.pi * 0.7 * t) > 0)).astype(np.float32)
    p, fd = tvad.energy_vad_probs(audio)
    jp, jfd = jvad.energy_vad_probs(audio)
    np.testing.assert_array_equal(p, jp)
    assert fd == jfd
    for kw in ({}, {"min_duration_on": 0.2, "min_duration_off": 0.3,
                    "pad_onset": 0.05, "pad_offset": 0.05}):
        assert tvad.binarize(p, fd, tvad.VadOptions(**kw)) == \
            jvad.binarize(jp, jfd, jvad.VadOptions(**kw))
    assert tvad.VoiceActivityDetector()(audio) == \
        jvad.VoiceActivityDetector()(audio)


def test_chunking_matches_jax():
    rng = np.random.default_rng(2)
    starts = np.cumsum(rng.uniform(0.2, 9.0, 20))
    regions = [(float(s), float(s + d)) for s, d in
               zip(starts, rng.uniform(0.1, 40.0, 20))]
    audio = rng.standard_normal(16000 * 10).astype(np.float32)
    ours = tchunk.merge_chunks(regions, 30.0)
    ref = jchunk.merge_chunks(regions, 30.0)
    assert [(c.start, c.end, c.regions) for c in ours] == \
        [(c.start, c.end, c.regions) for c in ref]
    for n in range(1, 17):
        assert tchunk._bucket_for(n, 16) == jchunk._bucket_for(n, 16)
    short = tchunk.merge_chunks([(0.1, 2.0), (3.0, 4.5)], 3.0)
    for (a, ga), (b, gb) in zip(
            tchunk.batch_chunks(audio, short, 4, window_samples=48000),
            jchunk.batch_chunks(audio, jchunk.merge_chunks(
                [(0.1, 2.0), (3.0, 4.5)], 3.0), 4, window_samples=48000)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("text", [
    "请使用简体中文。好的好的好的好的好的", "AAP里面的搜码二维码,,", "  ，。你好！！  "])
def test_cleaning_matches_jax(text):
    assert tclean.clean_segment_text(text) == jclean.clean_segment_text(text)


def test_config_env_layer_matches_jax(tmp_path, monkeypatch):
    (tmp_path / ".env").write_text("A_KEY=A_KEY='v1'\nB_FLAG=yes\nN=7\n")
    monkeypatch.chdir(tmp_path)
    for mod in (tconfig, jconfig):
        mod.clear_env_cache()
    assert tconfig.get_env("A_KEY") == jconfig.get_env("A_KEY") == "v1"
    assert tconfig.get_bool("B_FLAG") is jconfig.get_bool("B_FLAG") is True
    assert tconfig.get_int("N", 0) == jconfig.get_int("N", 0) == 7
    assert tconfig.get_float("MISSING", 1.5) == 1.5
    tconfig.clear_env_cache()
