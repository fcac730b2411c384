"""Audio decode frontend (WAV only in this slice of the port).

Copies ``decode_wav_bytes``/``write_wav`` and the zh-CN unsupported-format
message from the JAX package's ``audio/io.py``.  ``.wav`` is decoded in
numpy (PCM 8/16/24/32-bit int and float32/64), downmixed and resampled to
16 kHz mono float32.  The C++ FLAC/FFmpeg decoders are not ported yet, so
every other suffix raises ``UnsupportedFormatError``.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from .resample import resample_poly, to_mono

SAMPLE_RATE = 16000  # WhisperX fixed rate (reference: transcribe.py:118)


class UnsupportedFormatError(RuntimeError):
    """Raised when a container can't be decoded on this host.

    Carries the zh-CN user-facing message (``zh``) the serving tier
    surfaces — the reference's default input is an .m4a
    (reference transcribe.py:239), so an ffmpeg-less host must tell the
    user *why* and *what to do*, not stack-trace (VERDICT.md r2 #8)."""

    def __init__(self, suffix: str):
        self.suffix = suffix
        self.zh = (f"当前服务器未安装 ffmpeg，无法解码 {suffix} 文件；"
                   "请先将音频转换为 WAV 格式（16kHz 单声道最佳）再上传，"
                   "或在服务器上安装 ffmpeg")
        super().__init__(
            f"cannot decode {suffix!r}: the PyTorch port decodes .wav "
            "only; convert the file to WAV first")


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


def load_audio(path, sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Decode a WAV file -> 16 kHz mono float32 (``whisperx.load_audio``
    surface)."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(str(path))
    if path.suffix.lower() != ".wav":
        raise UnsupportedFormatError(path.suffix or "(no extension)")
    samples, sr = decode_wav_bytes(path.read_bytes())
    mono = to_mono(samples)
    if sr != sample_rate:
        mono = resample_poly(mono, sr, sample_rate)
    return mono.astype(np.float32)
