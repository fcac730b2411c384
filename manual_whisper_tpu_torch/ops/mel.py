"""Log-mel spectrogram frontend (Whisper feature extraction).

Port of the JAX package's ``ops/mel.py`` + ``ops/mel_pallas.py``: Hann-400 /
hop-160 real DFT, slaney mel filterbank, log10, then the per-sample
dynamic-range normalisation (max-8 clamp, (x+4)/4).

- ``unnormalized_log_mel`` is the wrapper of kernel K1 (``csrc/mel.cu``,
  replacing ``_mel_kernel`` of ``ops/mel_pallas.py``).  On a CUDA tensor it
  launches the kernel, which builds the frames itself from the audio
  (reflect padding by index, hop 160), so no ``[B, F, 400]`` frame tensor
  is written; it takes any frame count.  The kernel multiplies by the
  DFT folded twice by symmetry (taps k and 400 - k, bins f and 200 - f;
  ``folded_dft``, packed for the tile the kernel reports) and sums the
  filterbank from a table of its nonzeros (``MelConstants``), all taken
  from the f32 values the plain version reads.  On a CPU tensor
  it runs the plain version
  ``unnormalized_log_mel_plain`` (reflect pad, framing, two f32 matmuls),
  which follows the JAX XLA path.
- The global-max normalisation stays a torch reduction outside the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..spans import count
from . import _build

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE          # 480000
N_FRAMES = N_SAMPLES // HOP_LENGTH              # 3000
N_FREQS = N_FFT // 2 + 1                        # 201
MAX_KERNEL_MELS = 128                           # K1's band table: bands
MAX_KERNEL_BAND = 32                            # and bins a band


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


def band_table(filters: np.ndarray):
    """The nonzeros of a filterbank ``[201, n_mels]``, band by band: int32
    ``[n_mels, 4]`` rows (first bin, bins, offset of the first weight, the
    widest band's bins) and the weights of every band packed in one f32
    vector.  A slaney band's nonzeros are one run of bins (a triangle)."""
    table = np.zeros((filters.shape[1], 4), np.int32)
    packed = []
    offset = 0
    for m in range(filters.shape[1]):
        nz = np.flatnonzero(filters[:, m])
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if len(nz) else (0, 0)
        table[m, :3] = (lo, hi - lo, offset)
        packed.append(filters[lo:hi, m])
        offset += hi - lo
    table[:, 3] = table[:, 1].max()
    return table, np.concatenate(packed).astype(np.float32)


def pack_folded(fold: np.ndarray, tn: int, gx: int) -> np.ndarray:
    """Columns of a folded DFT half ``[rows <= 200, cols <= tn * gx]`` as K1
    reads them: ``[200, planes * gx * 4]`` with planes = ceil(tn / 4),
    column ``g * tn + s`` of a row at plane ``s // 4``, group ``g``, lane
    ``s % 4``, so the ``tn`` constants of thread group ``g`` are float4s
    ``gx * 16`` bytes apart.  Rows and lanes past the data are zero."""
    planes = -(-tn // 4)
    out = np.zeros((N_FFT // 2, planes, gx, 4), np.float32)
    f = np.arange(fold.shape[1])
    g, s = f // tn, f % tn
    out[:fold.shape[0], s // 4, g, s % 4] = fold
    return out.reshape(N_FFT // 2, planes * gx * 4)


class MelConstants(NamedTuple):
    """K1's constants on one device, f32 tensors but ``bands`` (int32).

    ``dft`` [400, 402] and ``filters`` [201, n_mels] are what the plain
    version multiplies by; ``bands``/``weights`` are
    ``band_table(filters)``, the filterbank's nonzeros as the kernel sums
    them."""
    dft: torch.Tensor
    filters: torch.Tensor
    bands: torch.Tensor
    weights: torch.Tensor
    widest: int                 # the widest band's bins


KERNEL_COLS = N_FFT // 4 + 1                    # 101: bins 0..100


@functools.lru_cache(maxsize=1)
def folded_dft():
    """The plain version's f32 DFT values folded by the window's symmetry:
    ``cos_fold`` [200, 201] is rows 1..200 of the cosine half, ``sin_fold``
    [199, 201] rows 1..199 of the sine half (the periodic Hann window is
    zero at tap 0 and symmetric about tap 200, so taps k and 400 - k share
    a row).  Row k of bin 200 - f is (-1)^k times bin f's, negated for the
    sine, so K1 reads columns 0..100 only."""
    dft = _dft_window_matrix().astype(np.float32)
    half = N_FFT // 2
    return dft[1:half + 1, :N_FREQS], dft[1:half, N_FREQS:]


@functools.lru_cache(maxsize=8)
def _constants(n_mels: int, device: torch.device) -> MelConstants:
    """The constants for ``n_mels`` bands on ``device``, made once."""
    dft = _dft_window_matrix().astype(np.float32)
    filters = mel_filter_bank(n_mels).astype(np.float32)
    bands, weights = band_table(filters)
    return MelConstants(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                          for a in (dft, filters, bands, weights)),
                        widest=int(bands[0, 3]))


@functools.lru_cache(maxsize=4)
def packed_folds(tn: int, gx: int):
    """Columns 0..100 of ``folded_dft()`` packed for a kernel tile of ``tn``
    frequencies a thread and ``gx`` threads along them (``pack_folded``)."""
    return tuple(pack_folded(f[:, :KERNEL_COLS], tn, gx)
                 for f in folded_dft())


def kernel_tile(fn) -> tuple:
    """(tn, gx) that a K1 build's tile entry ``fn`` (``mwx_log_mel_tile``
    or a variant's) reports."""
    tile = (ctypes.c_int * 2)()
    _build.check(fn(tile), "mel tile")
    return tile[0], tile[1]


@functools.lru_cache(maxsize=8)
def _kernel_folds(device: torch.device):
    """The packed folds for the shipped kernel's tile, on ``device``."""
    tile = kernel_tile(_build.library("mel").mwx_log_mel_tile)
    return tuple(torch.from_numpy(p).to(device) for p in packed_folds(*tile))


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
    c = _constants(n_mels, audio.device)
    spec = _frame(audio, n_frames) @ c.dft
    re, im = spec[..., :N_FREQS], spec[..., N_FREQS:]
    power = re * re + im * im
    return torch.log10(torch.clamp(power @ c.filters, min=1e-10))


def unnormalized_log_mel_f64(audio: torch.Tensor, n_mels: int = 80
                             ) -> torch.Tensor:
    """The plain version's steps in float64, from float64 constants: the
    reference that the kernel's and the plain version's float32 rounding
    are measured against.  Returns float64."""
    audio = audio.to(torch.float64)
    spec = _frame(audio, audio.shape[-1] // HOP_LENGTH) @ torch.from_numpy(
        _dft_window_matrix()).to(audio.device)
    power = spec[..., :N_FREQS] ** 2 + spec[..., N_FREQS:] ** 2
    filters = torch.from_numpy(mel_filter_bank(n_mels)).to(audio.device)
    return torch.log10(torch.clamp(power @ filters, min=1e-10))


def unnormalized_log_mel(audio: torch.Tensor, n_mels: int = 80
                         ) -> torch.Tensor:
    """[B, T] f32 -> raw log10-mel [B, T//160, n_mels].

    Kernel K1 on a CUDA tensor (counted as (B, T, n_mels)), the plain
    version on a CPU tensor.  The
    kernel's build follows the filterbank's widest band: up to 16 bins (80
    and 128 mels) or up to 32 (40 mels, widest 28); wider raises."""
    if audio.ndim != 2:
        raise ValueError(f"audio must be [B, T], got {tuple(audio.shape)}")
    if audio.device.type == "cpu":
        return unnormalized_log_mel_plain(audio, n_mels)
    batch, n_samples = audio.shape
    if n_samples <= N_FFT // 2:
        raise ValueError(f"audio of {n_samples} samples is too short for "
                         "the 200-sample reflect padding")
    n_frames = n_samples // HOP_LENGTH
    c = _constants(n_mels, audio.device)
    if n_mels > MAX_KERNEL_MELS or c.widest > MAX_KERNEL_BAND:
        raise ValueError(f"the kernel takes at most {MAX_KERNEL_MELS} bands "
                         f"of at most {MAX_KERNEL_BAND} bins, got {n_mels} "
                         f"of up to {c.widest}")
    _build.require(audio, "audio", torch.float32, (batch, n_samples),
                   audio.device)
    out = torch.empty(batch, n_frames, n_mels, dtype=torch.float32,
                      device=audio.device)
    cos_packed, sin_packed = _kernel_folds(audio.device)
    err = _build.library("mel").mwx_log_mel(
        audio.data_ptr(), cos_packed.data_ptr(), sin_packed.data_ptr(),
        c.bands.data_ptr(), c.weights.data_ptr(), out.data_ptr(), batch,
        n_samples, n_frames, n_mels, c.widest, _build.stream_of(audio))
    _build.check(err, "mel kernel")
    count("mel", (batch, n_samples, n_mels))
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
