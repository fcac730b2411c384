"""Audio decode frontend (port of the JAX package's ``audio/io.py``).

Replaces the reference's ``whisperx.load_audio`` (ffmpeg subprocess decode
to 16 kHz mono f32, reference: transcribe.py:117-118), with the JAX
package's routes in its order:

- ``.wav``: the native decoder (``libmwx_audio``), the numpy decoder
  behind it (PCM 8/16/24/32-bit int and float32/64);
- ``.flac``: the native FLAC decoder (``native/mwx_flac.cpp``);
- other containers (m4a/mp3/ogg/opus..., reference README.md:90): the
  in-process C++ shim over the system FFmpeg libraries
  (``native/mwx_ffdec.cpp``);
- then the ffmpeg CLI when it exists, else ``UnsupportedFormatError`` with
  the zh-CN message.

Resampling to 16 kHz runs the native polyphase resampler, the numpy
``resample_poly`` behind it.  All of this is host work; the device path
starts at the log-mel kernel.
"""

from __future__ import annotations

import shutil
import struct
import subprocess
from pathlib import Path

import numpy as np

from .resample import resample_poly, to_mono

SAMPLE_RATE = 16000  # WhisperX fixed rate (reference: transcribe.py:118)

# containers ffmpeg decodes for the reference (README.md:90, main.js:106)
FFMPEG_SUFFIXES = (".m4a", ".mp3", ".flac", ".ogg", ".aac", ".wma",
                   ".webm", ".mp4", ".amr", ".opus")


class UnsupportedFormatError(RuntimeError):
    """Raised when a container can't be decoded on this host.

    Carries the zh-CN user-facing message (``zh``) the serving tier
    surfaces — the reference's default input is an .m4a
    (reference transcribe.py:239), so an ffmpeg-less host must tell the
    user *why* and *what to do*, not stack-trace."""

    def __init__(self, suffix: str):
        self.suffix = suffix
        self.zh = (f"当前服务器未安装 ffmpeg，无法解码 {suffix} 文件；"
                   "请先将音频转换为 WAV 格式（16kHz 单声道最佳）再上传，"
                   "或在服务器上安装 ffmpeg")
        super().__init__(
            f"cannot decode {suffix!r}: built-in decoders support .wav and "
            ".flac; install ffmpeg for m4a/mp3/ogg/... (the reference "
            "pipeline also requires ffmpeg for these formats)")


def decodable_suffixes() -> tuple:
    """Audio suffixes this host can decode right now."""
    from .native import get_ffdec, get_lib
    if shutil.which("ffmpeg") or get_ffdec() is not None:
        return (".wav",) + FFMPEG_SUFFIXES
    if get_lib() is not None:
        return (".wav", ".flac")
    return (".wav",)


def decode_wav_bytes(data: bytes):
    """Parse a RIFF/WAVE blob -> (float32 samples [n, ch], sample_rate).

    Supports PCM (8/16/24/32-bit) and IEEE float (32/64-bit), plus
    WAVE_FORMAT_EXTENSIBLE wrappers of both.
    """
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")

    fmt = None
    fmt_body = b""
    raw = None
    pos = 12
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8: pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            if len(body) < 16:
                raise ValueError("truncated fmt chunk")
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            fmt_body = body
        elif chunk_id == b"data":
            if chunk_size > len(data) - pos - 8:
                raise ValueError(
                    f"truncated data chunk: header declares {chunk_size} "
                    f"bytes, {len(data) - pos - 8} remain — refusing to "
                    "silently decode partial audio")
            raw = body
        pos += 8 + chunk_size + (chunk_size & 1)
    if fmt is None or raw is None:
        raise ValueError("missing fmt/data chunk")

    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == 0xFFFE:
        # WAVE_FORMAT_EXTENSIBLE: the real format tag is the first two
        # bytes of the SubFormat GUID at offset 24 of the fmt body
        # (16 base + cbSize 2 + validBits 2 + channelMask 4)
        if len(fmt_body) >= 26:
            (audio_format,) = struct.unpack_from("<H", fmt_body, 24)
        else:
            raise ValueError("truncated WAVE_FORMAT_EXTENSIBLE fmt chunk")

    if audio_format == 1:  # PCM
        if bits == 16:
            samples = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            samples = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            samples = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8)
            n = len(b) // 3
            b = b[: n * 3].reshape(n, 3)
            vals = (b[:, 0].astype(np.int32)
                    | (b[:, 1].astype(np.int32) << 8)
                    | (b[:, 2].astype(np.int32) << 16))
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            samples = vals.astype(np.float32) / 8388608.0
        else:
            raise ValueError(f"unsupported PCM bit depth: {bits}")
    elif audio_format == 3:  # IEEE float
        if bits == 32:
            samples = np.frombuffer(raw, dtype="<f4").astype(np.float32)
        elif bits == 64:
            samples = np.frombuffer(raw, dtype="<f8").astype(np.float32)
        else:
            raise ValueError(f"unsupported float bit depth: {bits}")
    else:
        raise ValueError(f"unsupported WAV format code: {audio_format}")

    if channels > 1:
        usable = (len(samples) // channels) * channels
        samples = samples[:usable].reshape(-1, channels)
    return samples, sample_rate


def write_wav(path, audio: np.ndarray, sample_rate: int = SAMPLE_RATE) -> None:
    """Write mono float32 audio as 16-bit PCM WAV (test/bench fixture maker)."""
    audio = np.clip(np.asarray(audio, dtype=np.float32), -1.0, 1.0)
    pcm = (audio * 32767.0).astype("<i2").tobytes()
    header = struct.pack(
        "<4sI4s4sIHHIIHH4sI",
        b"RIFF", 36 + len(pcm), b"WAVE", b"fmt ", 16, 1, 1,
        sample_rate, sample_rate * 2, 2, 16, b"data", len(pcm))
    Path(path).write_bytes(header + pcm)


def _ffmpeg_decode(path: str, sample_rate: int) -> np.ndarray:
    cmd = [
        "ffmpeg", "-nostdin", "-threads", "0", "-i", str(path),
        "-f", "s16le", "-ac", "1", "-acodec", "pcm_s16le",
        "-ar", str(sample_rate), "-",
    ]
    try:
        out = subprocess.run(cmd, capture_output=True, check=True).stdout
    except subprocess.CalledProcessError as exc:
        raise RuntimeError(
            f"ffmpeg failed to decode {path}: "
            f"{exc.stderr.decode(errors='replace')[-500:]}") from exc
    return np.frombuffer(out, dtype="<i2").astype(np.float32) / 32768.0


def _resample(mono: np.ndarray, sr: int, sample_rate: int) -> np.ndarray:
    if sr == sample_rate:
        return mono.astype(np.float32)
    # C++ polyphase first (same algorithm, no multi-hundred-MB numpy
    # gather temporaries); numpy when the library isn't built
    from .native import native_resample
    out = native_resample(mono, sr, sample_rate)
    if out is None:
        out = resample_poly(mono, sr, sample_rate)
    return out.astype(np.float32)


def load_audio(path, sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Decode any supported audio file -> 16 kHz mono float32
    (``whisperx.load_audio`` surface, transcribe.py:117)."""
    return _load(path, sample_rate)[0]


def _load(path, sample_rate: int = SAMPLE_RATE):
    """``load_audio``, and the route that decoded the file:
    ``native-wav``, ``numpy-wav``, ``native-flac``, ``ffdec`` or
    ``ffmpeg-cli``."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(str(path))
    suffix = path.suffix.lower()

    if suffix == ".wav":
        try:
            from .native import native_decode_wav
            decoded = native_decode_wav(path.read_bytes())
        except Exception:
            decoded = None
        route = "native-wav"
        if decoded is not None:
            samples, sr = decoded
        else:
            route = "numpy-wav"
            try:
                samples, sr = decode_wav_bytes(path.read_bytes())
            except ValueError:
                # malformed/truncated RIFF: ffmpeg decodes more liberal
                # variants (streaming writers leave size fields 0 or
                # 0xFFFFFFFF)
                if shutil.which("ffmpeg"):
                    return (_ffmpeg_decode(str(path), sample_rate),
                            "ffmpeg-cli")
                raise
        return _resample(to_mono(samples), sr, sample_rate), route

    if suffix == ".flac":
        from .native import native_decode_flac
        try:
            decoded = native_decode_flac(path.read_bytes())
        except ValueError as exc:
            if shutil.which("ffmpeg"):
                decoded = None       # malformed stream: let ffmpeg try
            else:
                # with the native decoder present, 'install ffmpeg' is
                # the wrong message — the file itself is bad
                raise ValueError(
                    f"cannot decode {path.name}: the FLAC stream is "
                    f"malformed or unsupported ({exc}); re-export the "
                    "file (FLAC 文件已损坏或无法解析，请重新导出后再上传)"
                ) from exc
        if decoded is not None:
            mono, sr = decoded
            return _resample(mono, sr, sample_rate), "native-flac"

    if suffix in FFMPEG_SUFFIXES:
        from .native import native_decode_any
        try:
            decoded = native_decode_any(path.read_bytes())
        except ValueError as exc:
            if shutil.which("ffmpeg"):
                decoded = None       # malformed stream: let the CLI try
            else:
                raise ValueError(
                    f"cannot decode {path.name}: the stream is malformed "
                    f"or unsupported ({exc}); re-export the file "
                    "(音频文件已损坏或无法解析，请重新导出后再上传)"
                ) from exc
        if decoded is not None:
            mono, sr = decoded
            return _resample(mono, sr, sample_rate), "ffdec"

    if shutil.which("ffmpeg"):
        return _ffmpeg_decode(str(path), sample_rate), "ffmpeg-cli"

    raise UnsupportedFormatError(path.suffix or "(no extension)")
