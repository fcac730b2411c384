"""Log-mel spectrogram frontend (Whisper feature extraction).

Port of the JAX package's ``ops/mel.py`` + ``ops/mel_pallas.py``: Hann-400 /
hop-160 real DFT, slaney mel filterbank, log10, then the per-sample
dynamic-range normalisation (max-8 clamp, (x+4)/4).

- ``unnormalized_log_mel`` is the wrapper of kernel K1 (``csrc/mel.cu``,
  replacing ``_mel_kernel`` of ``ops/mel_pallas.py``).  On a CUDA tensor it
  launches the kernel, which builds the frames itself from the audio
  (reflect padding by index, hop 160), so no ``[B, F, 400]`` frame tensor
  is written; it takes any frame count.  On a CPU tensor it runs the plain
  version ``unnormalized_log_mel_plain`` (reflect pad, framing, two f32
  matmuls), which follows the JAX XLA path.
- The global-max normalisation stays a torch reduction outside the kernel.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE          # 480000
N_FRAMES = N_SAMPLES // HOP_LENGTH              # 3000
N_FREQS = N_FFT // 2 + 1                        # 201


def _hz_to_mel_slaney(freq):
    freq = np.asarray(freq, dtype=np.float64)
    min_log_hz = 1000.0
    min_log_mel = 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    return np.where(freq >= min_log_hz,
                    min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) * logstep,
                    mels)


def _mel_to_hz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    freqs = 200.0 * mels / 3.0
    return np.where(mels >= min_log_mel,
                    1000.0 * np.exp(logstep * (mels - min_log_mel)),
                    freqs)


@functools.lru_cache(maxsize=8)
def mel_filter_bank(n_mels: int = 80, n_freqs: int = N_FREQS,
                    sample_rate: int = SAMPLE_RATE,
                    f_min: float = 0.0, f_max: Optional[float] = None
                    ) -> np.ndarray:
    """Slaney-scale, slaney-normalised triangular filterbank [n_freqs, n_mels]
    (copied from the JAX package; float64, call sites cast)."""
    if f_max is None:
        f_max = sample_rate / 2.0
    fft_freqs = np.linspace(0, sample_rate / 2.0, n_freqs)
    mel_min = _hz_to_mel_slaney(f_min)
    mel_max = _hz_to_mel_slaney(f_max)
    mel_points = np.linspace(mel_min, mel_max, n_mels + 2)
    hz_points = _mel_to_hz_slaney(mel_points)

    fdiff = np.diff(hz_points)
    ramps = hz_points[None, :] - fft_freqs[:, None]   # [n_freqs, n_mels+2]
    lower = -ramps[:, :-2] / fdiff[None, :-1]
    upper = ramps[:, 2:] / fdiff[None, 1:]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    # slaney normalisation: scale each filter to ~constant energy per channel
    enorm = 2.0 / (hz_points[2:n_mels + 2] - hz_points[:n_mels])
    fb *= enorm[None, :]
    return fb


@functools.lru_cache(maxsize=2)
def _dft_window_matrix() -> np.ndarray:
    """Hann-window-fused real DFT matrix [N_FFT, 2*N_FREQS] (cos | -sin)."""
    window = np.hanning(N_FFT + 1)[:-1]  # periodic hann (torch.hann_window)
    k = np.arange(N_FFT)[:, None]
    f = np.arange(N_FREQS)[None, :]
    angle = -2.0 * np.pi * k * f / N_FFT
    mat = np.concatenate([np.cos(angle), np.sin(angle)], axis=1)
    return window[:, None] * mat


@functools.lru_cache(maxsize=8)
def _constants(n_mels: int, device: torch.device):
    """(DFT [400, 402], filterbank [201, n_mels]) as f32 tensors on device."""
    dft = torch.from_numpy(_dft_window_matrix().astype(np.float32))
    filters = torch.from_numpy(mel_filter_bank(n_mels).astype(np.float32))
    return dft.to(device), filters.to(device)


def _frame(audio: torch.Tensor, n_frames: int) -> torch.Tensor:
    """[B, T] -> reflect-padded overlapping frames [B, n_frames, N_FFT]."""
    pad = N_FFT // 2
    padded = F.pad(audio[:, None, :], (pad, pad), mode="reflect")[:, 0]
    return padded.unfold(-1, N_FFT, HOP_LENGTH)[:, :n_frames]


def unnormalized_log_mel_plain(audio: torch.Tensor, n_mels: int = 80
                               ) -> torch.Tensor:
    """Plain PyTorch version of K1: [B, T] f32 -> raw log10-mel
    [B, T//160, n_mels] (the JAX XLA path: frames @ DFT, power, @ filters,
    log10(max(x, 1e-10)), all in f32)."""
    n_frames = audio.shape[-1] // HOP_LENGTH
    dft, filters = _constants(n_mels, audio.device)
    spec = _frame(audio, n_frames) @ dft
    re, im = spec[..., :N_FREQS], spec[..., N_FREQS:]
    power = re * re + im * im
    return torch.log10(torch.clamp(power @ filters, min=1e-10))


def unnormalized_log_mel(audio: torch.Tensor, n_mels: int = 80
                         ) -> torch.Tensor:
    """[B, T] f32 -> raw log10-mel [B, T//160, n_mels].

    Kernel K1 on a CUDA tensor, the plain version on a CPU tensor."""
    if audio.ndim != 2:
        raise ValueError(f"audio must be [B, T], got {tuple(audio.shape)}")
    if audio.device.type == "cpu":
        return unnormalized_log_mel_plain(audio, n_mels)
    batch, n_samples = audio.shape
    if n_samples <= N_FFT // 2:
        raise ValueError(f"audio of {n_samples} samples is too short for "
                         "the 200-sample reflect padding")
    n_frames = n_samples // HOP_LENGTH
    dft, filters = _constants(n_mels, audio.device)
    _build.require(audio, "audio", torch.float32, (batch, n_samples),
                   audio.device)
    out = torch.empty(batch, n_frames, n_mels, dtype=torch.float32,
                      device=audio.device)
    lib = _build.library("mel")
    err = lib.mwx_log_mel(audio.data_ptr(), dft.data_ptr(),
                          filters.data_ptr(), out.data_ptr(), batch,
                          n_samples, n_frames, n_mels,
                          _build.stream_of(audio))
    _build.check(err, "mel kernel")
    _build.launches["mel"] += 1
    return out


def normalize_log_mel(log_spec: torch.Tensor) -> torch.Tensor:
    """Whisper dynamic-range normalisation (per sample)."""
    max_val = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, max_val - 8.0)
    return (log_spec + 4.0) / 4.0


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = 80
                        ) -> torch.Tensor:
    """Audio [B, T] (or [T]) f32 -> normalised log-mel [B, n_mels, T//160]."""
    squeeze = audio.ndim == 1
    audio = audio.to(torch.float32)
    if squeeze:
        audio = audio[None]
    out = normalize_log_mel(unnormalized_log_mel(audio.contiguous(), n_mels))
    out = out.transpose(-1, -2)
    return out[0] if squeeze else out
