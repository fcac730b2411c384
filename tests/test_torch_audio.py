"""PyTorch port: the native audio frontend against the JAX package's.

The port builds its own copies of ``mwx_audio.cpp``, ``mwx_flac.cpp`` and
``mwx_ffdec.cpp`` into ``manual_whisper_tpu_torch/_kernels/``; on the same
bytes they must give the JAX package's libraries' samples exactly: WAV at
every sample format, FLAC at every predictor, stereo mode and odd block
size of ``tests/test_flac.py`` (encoded by the port's ``encode_flac``,
which must write the JAX encoder's bytes), the resampler, and the FFmpeg
shim on mp3, m4a and ogg fixtures and on a 16-channel planar stream.
``load_audio`` takes the same routes; with the ffmpeg CLI and the FFmpeg
shim taken away, ``decodable_suffixes`` and the zh-CN error are the JAX
package's.  Two processes building into one empty directory at once both
load a whole library.
"""

import fcntl
import os
import shutil
import struct
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from manual_whisper_tpu.audio import encode_flac as j_encode_flac
from manual_whisper_tpu.audio import io as jio
from manual_whisper_tpu.audio import native as jnative
from manual_whisper_tpu_torch.audio import encode_flac, write_flac
from manual_whisper_tpu_torch.audio import io as tio
from manual_whisper_tpu_torch.audio import native as tnative

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).parent / "fixtures"

native_only = pytest.mark.skipif(
    tnative.get_lib() is None or jnative.get_lib() is None,
    reason="a native audio library did not build (no g++)")


@pytest.fixture(scope="module")
def ffdec():
    """Both packages' libmwx_ffdec, built once the tests run, not while
    the module is imported: test workers import ``tests/test_audio.py`` at
    collection, and each of them then runs the JAX package's lazy ``make``
    (20 s, a per-process lock only), which can fail while another runs
    and caches the failure.  Under a lock across processes, this builds
    the port's library and loads the JAX one; where the JAX loader returns
    its cached failure, it is cleared and the build retried with the full
    budget.  Skips only where FFmpeg cannot build."""
    lock_dir = ROOT / "manual_whisper_tpu_torch" / "_kernels"
    lock_dir.mkdir(parents=True, exist_ok=True)
    with open(lock_dir / "ffdec-test.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        ours = tnative.get_ffdec(build_timeout=120.0)
        theirs = jnative.get_ffdec()
        if theirs is None:
            jnative._ffdec_attempted = False
            theirs = jnative.get_ffdec(build_timeout=120.0)
    if ours is None or theirs is None:
        pytest.skip("libmwx_ffdec not built (no FFmpeg headers or "
                    "libraries)")


ffdec_only = pytest.mark.usefixtures("ffdec")


def _noise(n, seed=0, amp=0.3, channels=1):
    rng = np.random.default_rng(seed)
    x = amp * rng.standard_normal((n, channels))
    return x.clip(-1, 1).astype(np.float32)


def _wav_bytes(x: np.ndarray, sr: int, fmt: str) -> bytes:
    """RIFF/WAVE of x [n, ch] in ``fmt``: pcm8/16/24/32 or float32/64."""
    n, ch = x.shape
    if fmt == "pcm8":
        raw, code, bits = (np.round(x * 127) + 128).astype(np.uint8), 1, 8
    elif fmt == "pcm16":
        raw, code, bits = np.round(x * 32767).astype("<i2"), 1, 16
    elif fmt == "pcm24":
        v = np.round(x * 8388607).astype("<i4").reshape(-1)
        b = v.view(np.uint8).reshape(-1, 4)[:, :3]
        raw, code, bits = b, 1, 24
    elif fmt == "pcm32":
        raw, code, bits = np.round(x * 2147483000).astype("<i4"), 1, 32
    elif fmt == "float32":
        raw, code, bits = x.astype("<f4"), 3, 32
    else:
        raw, code, bits = x.astype("<f8"), 3, 64
    data = np.ascontiguousarray(raw).tobytes()
    align = ch * bits // 8
    header = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(data),
                         b"WAVE", b"fmt ", 16, code, ch, sr, sr * align,
                         align, bits, b"data", len(data))
    return header + data


WAV_FORMATS = ["pcm8", "pcm16", "pcm24", "pcm32", "float32", "float64"]


@native_only
@pytest.mark.parametrize("fmt", WAV_FORMATS)
@pytest.mark.parametrize("channels,sr", [(1, 8000), (2, 16000), (1, 24000),
                                         (2, 44100), (1, 48000)])
def test_wav_decode_and_load_match_jax(tmp_path, fmt, channels, sr):
    data = _wav_bytes(_noise(sr // 5, seed=sr + channels, channels=channels),
                      sr, fmt)
    t, j = tnative.native_decode_wav(data), jnative.native_decode_wav(data)
    assert t[1] == j[1] == sr
    np.testing.assert_array_equal(t[0], j[0])
    ts, tsr = tio.decode_wav_bytes(data)
    js, jsr = jio.decode_wav_bytes(data)
    assert tsr == jsr
    np.testing.assert_array_equal(ts, js)
    path = tmp_path / "x.wav"
    path.write_bytes(data)
    out = tio.load_audio(path)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, jio.load_audio(path))


@native_only
@pytest.mark.parametrize("sr_in,sr_out", [(44100, 16000), (48000, 16000),
                                          (8000, 16000), (22050, 16000),
                                          (32000, 16000), (16000, 8000)])
def test_native_resample_bit_equal(sr_in, sr_out):
    x = _noise(sr_in // 3, seed=sr_in)[:, 0]
    t = tnative.native_resample(x, sr_in, sr_out)
    np.testing.assert_array_equal(t, jnative.native_resample(x, sr_in,
                                                             sr_out))
    # and within float32 rounding of the numpy resampler behind it
    np.testing.assert_allclose(t, tio.resample_poly(x, sr_in, sr_out),
                               atol=1e-5)


FLAC_CASES = {
    **{f"mono-{p}": (dict(predictor=p), 1, 12000)
       for p in ("fixed0", "fixed1", "fixed2", "lpc", "verbatim")},
    **{f"stereo-{m}": (dict(stereo_mode=m), 2, 9000)
       for m in ("independent", "left_side", "right_side", "mid_side")},
    "odd-block-3000": (dict(block_size=3000), 1, 7001),
    "many-frames-192": (dict(block_size=192), 1, 192 * 130),
    "silence": ({}, 1, 5000),
    "rice-escape": (dict(predictor="fixed2"), 1, 4096),
}


def _flac_input(case, channels, n):
    if case == "silence":
        return np.zeros(n, np.float32)
    if case == "rice-escape":
        x = np.empty(n, np.float32)
        x[0::2], x[1::2] = 0.999, -0.999
        return x
    x = _noise(n, seed=len(case), amp=0.2, channels=channels)
    return x[:, 0] if channels == 1 else x


@native_only
@pytest.mark.parametrize("case", sorted(FLAC_CASES))
def test_flac_encode_and_decode_match_jax(case):
    kwargs, channels, n = FLAC_CASES[case]
    x = _flac_input(case, channels, n)
    data = encode_flac(x, 16000, **kwargs)
    assert data == j_encode_flac(x, 16000, **kwargs)
    t, j = tnative.native_decode_flac(data), jnative.native_decode_flac(data)
    assert t[1] == j[1] == 16000 and len(t[0]) == n
    np.testing.assert_array_equal(t[0], j[0])


@native_only
def test_flac_load_audio_resamples_as_jax(tmp_path):
    x = _noise(44100 // 2, seed=3, channels=2)
    path = tmp_path / "s.flac"
    write_flac(path, x, 44100)
    out = tio.load_audio(path)
    assert abs(len(out) - 8000) <= 1
    np.testing.assert_array_equal(out, jio.load_audio(path))


@native_only
def test_malformed_flac_raises_as_jax(tmp_path, monkeypatch):
    bad = b"fLaC" + b"\x00" * 16
    with pytest.raises(ValueError, match="mwx_decode_flac failed"):
        tnative.native_decode_flac(bad)
    path = tmp_path / "bad.flac"
    path.write_bytes(bad)
    monkeypatch.setattr(tio.shutil, "which", lambda name: None)
    monkeypatch.setattr(jio.shutil, "which", lambda name: None)
    with pytest.raises(ValueError) as t_err:
        tio.load_audio(path)
    with pytest.raises(ValueError) as j_err:
        jio.load_audio(path)
    assert str(t_err.value) == str(j_err.value)


@ffdec_only
@pytest.mark.parametrize("fmt,codec,ext", [("mp3", "libmp3lame", "mp3"),
                                           ("ipod", "aac", "m4a"),
                                           ("ogg", "libvorbis", "ogg")])
def test_ffdec_fixtures_match_jax(tmp_path, fmt, codec, ext):
    sr = 16000
    t = np.arange(int(1.5 * sr)) / sr
    tone = (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    data = tnative.native_encode_fixture(tone, sr, fmt, codec)
    ours, theirs = (tnative.native_decode_any(data),
                    jnative.native_decode_any(data))
    assert ours[1] == theirs[1]
    np.testing.assert_array_equal(ours[0], theirs[0])
    # the JAX package's encoder's bytes decode the same through the port
    jdata = jnative.native_encode_fixture(tone, sr, fmt, codec)
    np.testing.assert_array_equal(tnative.native_decode_any(jdata)[0],
                                  jnative.native_decode_any(jdata)[0])
    path = tmp_path / f"t.{ext}"
    path.write_bytes(data)
    out = tio.load_audio(path)
    assert abs(len(out) - len(tone)) < sr // 4
    np.testing.assert_array_equal(out, jio.load_audio(path))


@ffdec_only
@pytest.mark.parametrize("name", ["tone.m4a", "tone.mp3", "tone_16ch.m4a"])
def test_ffdec_committed_fixtures_match_jax(name):
    """``tone_16ch.m4a`` holds 16 planar channels (more than
    AVFrame::data[] has): both decoders read them through extended_data
    and give the same downmix."""
    data = (FIXTURES / name).read_bytes()
    ours, theirs = (tnative.native_decode_any(data),
                    jnative.native_decode_any(data))
    assert ours[1] == theirs[1] == 16000
    np.testing.assert_array_equal(ours[0], theirs[0])
    assert np.isfinite(ours[0]).all() and np.abs(ours[0]).max() > 0.01


@ffdec_only
def test_ffdec_garbage_raises_as_jax(tmp_path, monkeypatch):
    path = tmp_path / "bad.mp3"
    path.write_bytes(b"\x00\x01garbage that is not audio" * 40)
    monkeypatch.setattr(tio.shutil, "which", lambda name: None)
    monkeypatch.setattr(jio.shutil, "which", lambda name: None)
    with pytest.raises(ValueError, match="malformed|unsupported") as t_err:
        tio.load_audio(path)
    with pytest.raises(ValueError) as j_err:
        jio.load_audio(path)
    assert str(t_err.value) == str(j_err.value)


@ffdec_only
def test_decodable_suffixes_with_ffdec_match_jax(tmp_path):
    assert tio.decodable_suffixes() == jio.decodable_suffixes()
    assert ".m4a" in tio.decodable_suffixes()
    path = tmp_path / "a.m4a"
    path.write_bytes(tnative.native_encode_fixture(
        _noise(16000)[:, 0], 16000, "ipod", "aac"))
    audio, route = tio._load(path)
    assert route == "ffdec"
    np.testing.assert_array_equal(audio, jio.load_audio(path))


@native_only
def test_without_ffmpeg_and_ffdec_suffixes_and_error_match_jax(
        tmp_path, monkeypatch):
    for io_mod, native_mod in ((tio, tnative), (jio, jnative)):
        monkeypatch.setattr(io_mod.shutil, "which", lambda name: None)
        monkeypatch.setattr(native_mod, "get_ffdec", lambda *a, **k: None)
    assert tio.decodable_suffixes() == jio.decodable_suffixes() \
        == (".wav", ".flac")
    tio.write_wav(tmp_path / "a.wav", _noise(8000)[:, 0])
    write_flac(tmp_path / "a.flac", _noise(8000)[:, 0])
    assert [tio._load(tmp_path / f"a{s}")[1] for s in (".wav", ".flac")] \
        == ["native-wav", "native-flac"]
    path = tmp_path / "meeting.m4a"
    path.write_bytes(b"\x00" * 64)
    with pytest.raises(tio.UnsupportedFormatError) as t_err:
        tio.load_audio(path)
    with pytest.raises(jio.UnsupportedFormatError) as j_err:
        jio.load_audio(path)
    assert t_err.value.zh == j_err.value.zh
    assert str(t_err.value) == str(j_err.value)
    assert t_err.value.suffix == ".m4a"


@native_only
def test_load_reports_the_numpy_route_when_the_native_wav_decoder_fails(
        tmp_path, monkeypatch):
    path = tmp_path / "a.wav"
    path.write_bytes(_wav_bytes(_noise(12000, channels=2), 24000, "pcm24"))
    native_out, native_route = tio._load(path)

    def broken(data):
        raise RuntimeError("native decoder failed")
    monkeypatch.setattr(tnative, "native_decode_wav", broken)
    audio, route = tio._load(path)
    assert (native_route, route) == ("native-wav", "numpy-wav")
    np.testing.assert_allclose(audio, native_out, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(audio, tio.load_audio(path))


def test_missing_file_raises():
    with pytest.raises(FileNotFoundError):
        tio.load_audio("/nonexistent/file.flac")


@native_only
def test_native_libraries_are_the_ports_own_builds():
    """Built from the port's sources into the port's ``_kernels/``, named
    by a hash of sources and flags; the sources are the JAX package's
    apart from their header comments."""
    lib = tnative.library_path("mwx_audio")
    assert lib.parent == ROOT / "manual_whisper_tpu_torch" / "_kernels"
    assert lib.exists() and lib.name.startswith("libmwx_audio-")
    for src in ("mwx_audio.cpp", "mwx_flac.cpp", "mwx_ffdec.cpp"):
        ours = (tnative.SOURCE_DIR / src).read_text().splitlines()
        theirs = (ROOT / "manual_whisper_tpu" / "native" / src
                  ).read_text().splitlines()
        body = [ln for ln in ours if not ln.startswith("//")]
        assert body == [ln for ln in theirs if not ln.startswith("//")]
    ffdec = (tnative.SOURCE_DIR / "mwx_ffdec.cpp").read_text()
    assert "frame->extended_data" in ffdec


@native_only
def test_two_processes_build_into_an_empty_dir_at_once(tmp_path):
    build_dir = tmp_path / "build"
    code = textwrap.dedent(f"""
        import struct
        import sys
        from pathlib import Path
        from manual_whisper_tpu_torch.audio import native
        native.BUILD_DIR = Path({str(build_dir)!r})
        lib = native.get_lib()
        ffdec = native.get_ffdec(build_timeout=120.0)
        wav = struct.pack("<4sI4s4sIHHIIHH4sIhh", b"RIFF", 40, b"WAVE",
                          b"fmt ", 16, 1, 1, 16000, 32000, 2, 16, b"data",
                          4, 16384, -16384)
        x, sr = native.native_decode_wav(wav)
        print(lib is not None, ffdec is not None, sr, x.tolist())
        sys.exit(0 if lib is not None else 1)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split()[0] == "True" and "16000 [0.5, -0.5]" in out
    assert outs[0][0].split()[1] == outs[1][0].split()[1]
    names = sorted(p.name for p in build_dir.iterdir())
    assert [n for n in names if n.startswith(".")] == []
    assert sum(n.startswith("libmwx_audio-") for n in names) == 1
