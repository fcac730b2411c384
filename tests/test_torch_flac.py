"""The port's native FLAC decoder on the cases of ``tests/test_flac.py``:
each stream, encoded by the port's ``encode_flac``, must decode to what a
16-bit round trip of the input gives and to the JAX package's samples
bit for bit, and a stream the JAX decoder refuses the port refuses too.

Both libraries are loaded once the tests run, not while the module is
imported: every test worker imports the test files, and the JAX
package's lazy ``make`` runs under a per-process lock only, so builds in
several workers at once can fail and its loader caches the failure.  The
``lib`` fixture loads both under the cross-process lock of
``tests/test_torch_audio.py``'s ``ffdec`` fixture, clears a cached
failure of the JAX loader and retries with the full build budget, and
skips only where g++ cannot build them."""

import fcntl
import shutil
import time
from pathlib import Path

import numpy as np
import pytest

from manual_whisper_tpu.audio import io as jio
from manual_whisper_tpu.audio import native as jnative
from manual_whisper_tpu_torch.audio import (SAMPLE_RATE, encode_flac,
                                            load_audio, write_flac)
from manual_whisper_tpu_torch.audio import io as tio
from manual_whisper_tpu_torch.audio import native as tnative
from manual_whisper_tpu_torch.audio.flacenc import _BitWriter

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def lib():
    lock_dir = ROOT / "manual_whisper_tpu_torch" / "_kernels"
    lock_dir.mkdir(parents=True, exist_ok=True)
    with open(lock_dir / "ffdec-test.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        ours = tnative.get_lib()
        theirs = jnative.get_lib()
        if theirs is None:
            jnative._lib, jnative._load_attempted = None, False
            theirs = jnative.get_lib()
    if ours is None or theirs is None:
        pytest.skip("a native audio library did not build (no g++)")


def decode(data: bytes):
    """The port's decode of ``data``, held equal to the JAX package's."""
    ours, theirs = (tnative.native_decode_flac(data),
                    jnative.native_decode_flac(data))
    assert ours[1] == theirs[1]
    np.testing.assert_array_equal(ours[0], theirs[0])
    return ours


def quantized(x):
    """What a 16-bit FLAC round trip should give back for float input."""
    return np.round(np.clip(x, -1, 1) * 32767).astype(np.float32) / 32768.0


def noise(n, seed=0, amp=0.3):
    rng = np.random.default_rng(seed)
    return (amp * rng.standard_normal(n)).clip(-1, 1).astype(np.float32)


@pytest.mark.parametrize("predictor",
                         ["fixed0", "fixed1", "fixed2", "lpc", "verbatim"])
def test_mono_roundtrip_predictors(predictor):
    x = noise(12000, seed=1)
    dec, sr = decode(encode_flac(x, 16000, predictor=predictor))
    assert sr == 16000 and len(dec) == len(x)
    np.testing.assert_allclose(dec, quantized(x), atol=1e-7)


def test_constant_subframe_silence():
    dec, _ = decode(encode_flac(np.zeros(5000, np.float32), 16000))
    assert len(dec) == 5000 and np.abs(dec).max() == 0.0


@pytest.mark.parametrize("mode",
                         ["independent", "left_side", "right_side",
                          "mid_side"])
def test_stereo_decorrelation_downmix(mode):
    n = 9000
    stereo = np.stack([noise(n, seed=2), noise(n, seed=3, amp=0.2)], axis=1)
    dec, sr = decode(encode_flac(stereo, 16000, stereo_mode=mode))
    assert sr == 16000 and len(dec) == n
    np.testing.assert_allclose(dec, quantized(stereo).mean(axis=1),
                               atol=1e-7)


def test_partial_last_block_and_uncommon_size():
    # 3000 is no coded block size (explicit 16-bit size), and the stream
    # is no multiple of it (short final frame)
    x = noise(7001, seed=4)
    dec, _ = decode(encode_flac(x, 16000, block_size=3000))
    assert len(dec) == 7001
    np.testing.assert_allclose(dec, quantized(x), atol=1e-7)


def test_rice_escape_on_incompressible_residual():
    x = np.empty(4096, np.float32)
    x[0::2], x[1::2] = 0.999, -0.999
    dec, _ = decode(encode_flac(x, 16000, predictor="fixed2"))
    np.testing.assert_allclose(dec, quantized(x), atol=1e-7)


def test_many_frames_utf8_numbers():
    # more than 128 frames: multi-byte UTF-8 frame numbers
    x = noise(192 * 130, seed=5, amp=0.1)
    dec, _ = decode(encode_flac(x, 16000, block_size=192))
    assert len(dec) == len(x)
    np.testing.assert_allclose(dec, quantized(x), atol=1e-7)


def test_load_audio_flac_resamples(tmp_path):
    sr_in = 32000
    t = np.arange(sr_in) / sr_in
    x = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    path = tmp_path / "tone.flac"
    write_flac(path, x, sr_in)
    y = load_audio(path)
    assert y.dtype == np.float32 and abs(len(y) - SAMPLE_RATE) <= 1
    np.testing.assert_array_equal(y, jio.load_audio(path))
    spec = np.abs(np.fft.rfft(y * np.hanning(len(y))))
    freqs = np.fft.rfftfreq(len(y), 1 / SAMPLE_RATE)
    assert abs(freqs[np.argmax(spec)] - 440) < 2


def test_load_audio_flac_native_path(tmp_path):
    x = noise(SAMPLE_RATE, seed=6)
    path = tmp_path / "n.flac"
    write_flac(path, x, SAMPLE_RATE)
    assert tio._load(path)[1] == "native-flac"
    np.testing.assert_allclose(load_audio(path), quantized(x), atol=1e-7)


def test_malformed_stream_raises():
    bad = b"fLaC" + b"\x00" * 16
    for native in (tnative, jnative):
        with pytest.raises(ValueError):
            native.native_decode_flac(bad)


def test_decodable_suffixes_advertises_flac(monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda _: None)
    assert ".flac" in tio.decodable_suffixes()


def test_huge_streaminfo_total_rejected_fast():
    """A 36-bit STREAMINFO total of all ones is refused at once, as the
    JAX decoder refuses it, and drives no allocation of gigabytes."""
    si = _BitWriter()
    si.bits(4096, 16); si.bits(4096, 16)
    si.bits(0, 24); si.bits(0, 24)
    si.bits(16000, 20); si.bits(0, 3); si.bits(15, 5)
    si.bits((1 << 36) - 1, 36)
    si.bits(0, 64); si.bits(0, 64)
    body = si.getvalue()
    stream = b"fLaC" + bytes([0x80]) + len(body).to_bytes(3, "big") + body
    for native in (tnative, jnative):
        t0 = time.time()
        with pytest.raises(ValueError):
            native.native_decode_flac(stream)
        assert time.time() - t0 < 1.0


def test_streaming_stream_with_trailing_junk():
    """A total of 0 (a streaming encoder's) and tag bytes after the last
    frame: the decoded audio is kept."""
    x = noise(6000, seed=7)
    s = bytearray(encode_flac(x, 16000))
    # STREAMINFO bytes 18..25 hold sr(20)|ch(3)|bps(5)|total(36): zero the
    # total (low nibble of byte 21 and bytes 22-25)
    s[21] &= 0xF0
    s[22:26] = b"\x00\x00\x00\x00"
    s += b"APETAGEX" * 4
    dec, sr = decode(bytes(s))
    assert sr == 16000 and len(dec) == 6000
    np.testing.assert_allclose(dec, quantized(x), atol=1e-7)
