"""Voice activity detection (port of the JAX ``models/vad.py``).

- ``PyanNet``: the pyannote ``segmentation-3.0`` architecture (SincNet
  frontend -> 4-layer BiLSTM -> FC -> 7-class powerset over 3 speakers)
  as a torch module; speech probability = 1 - P(no speaker).  Weights
  arrive through ``convert.from_jax_pyannet`` (the JAX package's param
  tree) or ``convert.load_segmentation_params`` (a pyannote state dict).
- ``energy_vad_probs``: dependency-free adaptive energy VAD (numpy), used
  when the registry holds no segmentation checkpoint the port can read.
- ``binarize``: onset/offset hysteresis + min-duration rules (pyannote
  ``Binarize`` semantics) on host numpy.
- ``VoiceActivityDetector``: the pipeline's VAD surface, yielding speech
  probabilities block by block (``iter_speech_probs``).

PyanNet runs on the device of its weights, the pipeline's device.  The JAX
package pins it to the host CPU (``vad_compute_device``) because the TPU
backend takes minutes to compile the BiLSTM's eight ``lax.scan``s; CUDA
runs the LSTM as cuDNN calls with nothing to compile, so the port has no
such knob.  On CUDA the convolutions, the LSTM and the linear layers run
with TF32 off, set for each forward (one at a time in the process) and
restored after it: cuDNN allows TF32 by default, and TF32's 10-bit
mantissa on the 251-tap sinc filters would move probabilities near the
0.5 / 0.363 hysteresis thresholds, and with them region edges, away from
the CPU's.

PyanNet has no Pallas kernel in the JAX package (its convs and scans are
XLA), so its convolutions and LSTM stay library calls here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..spans import span

SAMPLE_RATE = 16000


# ---------------------------------------------------------------------------
# Energy VAD (the fallback without segmentation weights)
# ---------------------------------------------------------------------------

def energy_vad_probs(audio: np.ndarray, hop: int = 160,
                     win: int = 400) -> Tuple[np.ndarray, float]:
    """Adaptive log-energy speech probabilities.

    Returns (probs [n_frames], frame_duration_sec).  Noise floor / speech
    ceiling are the 10th/90th percentiles of frame log-energy, so the
    mapping adapts to recording level.
    """
    audio = np.asarray(audio, np.float32)
    n_frames = max(0, (len(audio) - win) // hop + 1)
    if n_frames == 0:
        return np.zeros(0, np.float32), hop / SAMPLE_RATE
    # O(n) sliding energy via cumulative sum (a [n_frames, win] gather
    # costs ~150 MB of indices per hour of audio)
    csum = np.concatenate([[0.0], np.cumsum(audio.astype(np.float64) ** 2)])
    starts = hop * np.arange(n_frames)
    frame_energy = (csum[starts + win] - csum[starts]) / win
    energy = np.log10(frame_energy + 1e-10)
    padded = np.pad(energy, 2, mode="edge")
    smooth = np.convolve(padded, np.ones(5) / 5, mode="valid")
    floor = np.percentile(smooth, 10)
    ceil = np.percentile(smooth, 90)
    if ceil - floor < 0.5:  # < half a decade of dynamic range: no speech
        return np.zeros_like(smooth, dtype=np.float32), hop / SAMPLE_RATE
    span = max(ceil - floor, 1.0)
    probs = np.clip((smooth - floor) / span, 0.0, 1.0)
    return probs.astype(np.float32), hop / SAMPLE_RATE


# ---------------------------------------------------------------------------
# PyanNet (pyannote segmentation-3.0 architecture)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PyanNetConfig:
    sinc_filters: int = 80
    sinc_kernel: int = 251
    sinc_stride: int = 10
    conv_channels: int = 60
    conv_kernel: int = 5
    lstm_hidden: int = 128
    lstm_layers: int = 4
    linear_dim: int = 128
    n_classes: int = 7          # powerset over 3 speakers, card <= 2
    window_sec: float = 10.0

    @property
    def frames_per_window(self) -> int:
        """Output frames of ``PyanNet`` for one window: sinc conv (VALID)
        -> pool3 -> twice (conv VALID k=conv_kernel -> pool3); 589 for
        10 s windows."""
        n = int(self.window_sec * SAMPLE_RATE)
        n = (n - self.sinc_kernel) // self.sinc_stride + 1
        n //= 3
        for _ in range(2):
            n = (n - self.conv_kernel + 1) // 3
        return n


def sinc_filters(low_hz: torch.Tensor, band_hz: torch.Tensor, kernel: int,
                 sample_rate: int = SAMPLE_RATE,
                 min_low_hz: float = 50.0,
                 min_band_hz: float = 50.0) -> torch.Tensor:
    """SincNet band-pass filters ``[n_filters, 1, kernel]`` (torch's conv
    layout) from the learned (low_hz, band_hz) parameters, in float32 and
    in the JAX function's order of operations."""
    low_hz = low_hz.to(torch.float32).reshape(-1)
    band_hz = band_hz.to(torch.float32).reshape(-1)
    low = min_low_hz + torch.abs(low_hz)
    high = torch.clamp(low + min_band_hz + torch.abs(band_hz),
                       min_low_hz, sample_rate / 2)
    n = (kernel - 1) // 2
    t = torch.arange(-n, 0, dtype=torch.float32) / sample_rate
    n_lin = torch.linspace(0.0, kernel / 2 - 1, n, dtype=torch.float32)
    window = 0.54 - 0.46 * torch.cos(2 * math.pi * n_lin / kernel)

    f_times_t_low = torch.outer(low, t) * 2 * math.pi
    f_times_t_high = torch.outer(high, t) * 2 * math.pi
    band_pass_left = ((torch.sin(f_times_t_high) - torch.sin(f_times_t_low))
                      / (t[None, :] * math.pi)) * window[None, :]
    band_pass_center = 2 * (high - low).reshape(-1, 1)
    band_pass_right = torch.flip(band_pass_left, dims=[1])
    band_pass = torch.cat(
        [band_pass_left, band_pass_center, band_pass_right], dim=1)
    band_pass = band_pass / (2 * (high - low)).reshape(-1, 1)
    return band_pass[:, None, :].contiguous()


def _instance_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm1d over time for ``[B, C, T]`` tensors: the population
    variance, ``eps`` inside the rsqrt."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * gamma[:, None] + beta[:, None]


# the TF32 switches are process-wide: one block at a time sets and
# restores them, so a block on another thread (the server's second pass)
# neither runs with TF32 on nor leaves it off
_tf32_lock = threading.Lock()


@contextlib.contextmanager
def _no_tf32(device: torch.device) -> Iterator[None]:
    """float32 convolutions, LSTM and matmuls for the block; the previous
    settings come back after it."""
    if device.type != "cuda":
        yield
        return
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul
    with _tf32_lock:
        saved = matmul.allow_tf32
        matmul.allow_tf32 = False
        try:
            with cudnn.flags(enabled=cudnn.enabled,
                             benchmark=cudnn.benchmark,
                             deterministic=cudnn.deterministic,
                             allow_tf32=False):
                yield
        finally:
            matmul.allow_tf32 = saved


class PyanNet(nn.Module):
    """audio ``[B, T]`` -> powerset log-probs ``[B, frames, n_classes]``.

    NCT activations, torch ``[out, in, k]`` conv weights; the sinc filters
    are materialised from ``sinc_low_hz`` and ``sinc_band_hz`` once, at
    load time (``convert.from_jax_pyannet``), into the ``sinc`` buffer.
    The BiLSTM is one ``nn.LSTM`` (gate order i, f, g, o, as the JAX
    scan); sequences are never packed, so the reverse direction runs over
    a window's zero tail as ``lax.scan(reverse=True)`` does."""

    def __init__(self, cfg: PyanNetConfig = PyanNetConfig()):
        super().__init__()
        self.cfg = cfg
        f, c, h = cfg.sinc_filters, cfg.conv_channels, cfg.lstm_hidden
        self.sinc_low_hz = nn.Parameter(torch.zeros(f, 1))
        self.sinc_band_hz = nn.Parameter(torch.zeros(f, 1))
        self.register_buffer("sinc", torch.zeros(f, 1, cfg.sinc_kernel))
        self.in_norm_g = nn.Parameter(torch.ones(1))
        self.in_norm_b = nn.Parameter(torch.zeros(1))
        self.norm0_g = nn.Parameter(torch.ones(f))
        self.norm0_b = nn.Parameter(torch.zeros(f))
        self.conv1 = nn.Conv1d(f, c, cfg.conv_kernel)
        self.norm1_g = nn.Parameter(torch.ones(c))
        self.norm1_b = nn.Parameter(torch.zeros(c))
        self.conv2 = nn.Conv1d(c, c, cfg.conv_kernel)
        self.norm2_g = nn.Parameter(torch.ones(c))
        self.norm2_b = nn.Parameter(torch.zeros(c))
        self.lstm = nn.LSTM(c, h, num_layers=cfg.lstm_layers,
                            bidirectional=True, batch_first=True)
        self.fc1 = nn.Linear(2 * h, cfg.linear_dim)
        self.fc2 = nn.Linear(cfg.linear_dim, cfg.linear_dim)
        self.cls = nn.Linear(cfg.linear_dim, cfg.n_classes)
        self.requires_grad_(False)
        self.eval()

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        """In the module's dtype: float32 (``.double()`` gives a float64
        reference)."""
        cfg = self.cfg
        x = audio.to(self.sinc.dtype)[:, None, :]           # [B, 1, T]
        with _no_tf32(x.device):
            x = _instance_norm(x, self.in_norm_g, self.in_norm_b)
            x = F.conv1d(x, self.sinc, stride=cfg.sinc_stride)
            x = F.max_pool1d(torch.abs(x), 3, 3)
            x = F.leaky_relu(_instance_norm(x, self.norm0_g, self.norm0_b),
                             0.01)
            for conv, g, b in ((self.conv1, self.norm1_g, self.norm1_b),
                               (self.conv2, self.norm2_g, self.norm2_b)):
                x = F.max_pool1d(conv(x), 3, 3)
                x = F.leaky_relu(_instance_norm(x, g, b), 0.01)
            x, _ = self.lstm(x.transpose(1, 2))            # [B, T', 2H]
            x = F.leaky_relu(self.fc1(x), 0.01)
            x = F.leaky_relu(self.fc2(x), 0.01)
            return F.log_softmax(self.cls(x), dim=-1)


def init_pyannet_params(generator: torch.Generator,
                        cfg: PyanNetConfig = PyanNetConfig()) -> Dict:
    """Random PyanNet params in the JAX package's tree layout (numpy
    leaves; ``convert.from_jax_pyannet`` makes the module), drawn from
    ``generator`` with the JAX init's scales: normal / sqrt(fan_in) for
    the dense and conv weights, zero biases, unit norms, the sinc bands
    spread on a quadratic frequency scale."""
    def normal(*shape, fan_in):
        w = torch.randn(*shape, generator=generator, dtype=torch.float32)
        return (w / math.sqrt(fan_in)).numpy()

    f, c, h = cfg.sinc_filters, cfg.conv_channels, cfg.lstm_hidden
    k = cfg.conv_kernel
    zeros = lambda n: np.zeros(n, np.float32)      # noqa: E731
    ones = lambda n: np.ones(n, np.float32)        # noqa: E731
    lstm = []
    for i in range(cfg.lstm_layers):
        din = c if i == 0 else 2 * h
        lstm.append({
            "w_ih": normal(4 * h, din, fan_in=4 * h),
            "w_hh": normal(4 * h, h, fan_in=4 * h),
            "b_ih": zeros(4 * h), "b_hh": zeros(4 * h),
            "w_ih_rev": normal(4 * h, din, fan_in=4 * h),
            "w_hh_rev": normal(4 * h, h, fan_in=4 * h),
            "b_ih_rev": zeros(4 * h), "b_hh_rev": zeros(4 * h),
        })
    mel_like = np.linspace(0, 1, f)
    return {
        "sinc_low_hz": (30 + 7700 * mel_like ** 2).reshape(-1, 1)
        .astype(np.float32),
        "sinc_band_hz": np.full((f, 1), 100.0, np.float32),
        "in_norm": {"g": ones(1), "b": zeros(1)},
        "norm0": {"g": ones(f), "b": zeros(f)},
        "conv1_w": normal(k, f, c, fan_in=k * f), "conv1_b": zeros(c),
        "norm1": {"g": ones(c), "b": zeros(c)},
        "conv2_w": normal(k, c, c, fan_in=k * c), "conv2_b": zeros(c),
        "norm2": {"g": ones(c), "b": zeros(c)},
        "lstm": lstm,
        "fc1_w": normal(2 * h, cfg.linear_dim, fan_in=2 * h),
        "fc1_b": zeros(cfg.linear_dim),
        "fc2_w": normal(cfg.linear_dim, cfg.linear_dim,
                        fan_in=cfg.linear_dim),
        "fc2_b": zeros(cfg.linear_dim),
        "cls_w": normal(cfg.linear_dim, cfg.n_classes,
                        fan_in=cfg.linear_dim),
        "cls_b": zeros(cfg.n_classes),
    }


# powerset class -> active speakers (segmentation-3.0 layout)
POWERSET_CLASSES: Tuple[Tuple[int, ...], ...] = (
    (), (0,), (1,), (2,), (0, 1), (0, 2), (1, 2))


def powerset_to_speech_prob(log_probs) -> np.ndarray:
    """[..., 7] powerset log-probs -> P(any speech) = 1 - P(empty set)."""
    return 1.0 - np.exp(np.asarray(log_probs)[..., 0])


def powerset_to_speaker_activity(log_probs: np.ndarray) -> np.ndarray:
    """[..., 7] -> binary per-speaker activity [..., 3] via ARGMAX
    (pyannote-3.x's Powerset.to_multilabel: the winning class alone decides
    which speakers are active)."""
    cls = np.argmax(np.asarray(log_probs), axis=-1)
    table = np.zeros((len(POWERSET_CLASSES), 3), np.float32)
    for ci, spks in enumerate(POWERSET_CLASSES):
        table[ci, list(spks)] = 1.0
    return table[cls]


PYANNET_CHUNK = 16        # windows per forward (the main block)
PYANNET_CHUNK_SMALL = 4   # the block of short inputs (a 30 s file: 4 windows)


def pyannet_forward_chunked(model: PyanNet, rows: np.ndarray) -> np.ndarray:
    """[N, window] audio rows -> [N, frames, n_classes] log-probs (host
    numpy), through forwards of PYANNET_CHUNK or PYANNET_CHUNK_SMALL rows
    zero-padded, as the JAX package's fixed programs run them (each row is
    scored on its own, so the padding rows change nothing)."""
    cfg = model.cfg
    n = len(rows)
    if n == 0:
        return np.zeros((0, cfg.frames_per_window, cfg.n_classes),
                        np.float32)
    device = model.sinc.device
    out: List[np.ndarray] = []
    lo = 0
    while lo < n:
        remaining = n - lo
        rows_bucket = (PYANNET_CHUNK_SMALL
                       if remaining <= PYANNET_CHUNK_SMALL
                       else PYANNET_CHUNK)
        chunk = np.zeros((rows_bucket, rows.shape[1]), np.float32)
        m = min(rows_bucket, remaining)
        chunk[:m] = rows[lo: lo + m]
        with torch.inference_mode():
            lp = model(torch.from_numpy(chunk).to(device))
        out.append(lp[:m].cpu().numpy())
        lo += m
    return np.concatenate(out, axis=0)


# ---------------------------------------------------------------------------
# Binarization (hysteresis) — host side
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VadOptions:
    """Knob names/defaults from the reference (transcribe.py:43-46;
    second-pass variants web/.env.example:44-45)."""
    vad_onset: float = 0.5
    vad_offset: float = 0.363
    min_duration_on: float = 0.0
    min_duration_off: float = 0.0
    pad_onset: float = 0.0
    pad_offset: float = 0.0


def binarize(probs: np.ndarray, frame_duration: float,
             opts: VadOptions = VadOptions()) -> List[Tuple[float, float]]:
    """Hysteresis binarisation (pyannote Binarize semantics): a region
    triggers when prob > onset and ends when prob < offset; then short gaps
    (< min_duration_off) are filled and short regions (< min_duration_on)
    dropped."""
    probs = np.asarray(probs, np.float32)
    n = len(probs)
    if n == 0:
        return []
    # vectorised hysteresis: active state = (most recent onset/offset event
    # was an onset).  Python-loop version cost ~4 s per hour of audio.
    events = np.zeros(n, np.int8)
    events[probs > opts.vad_onset] = 1
    events[probs < opts.vad_offset] = -1
    idx = np.arange(n)
    has_event = events != 0
    last_event_idx = np.maximum.accumulate(np.where(has_event, idx, -1))
    active = np.zeros(n, bool)
    valid = last_event_idx >= 0
    active[valid] = events[last_event_idx[valid]] == 1

    edges = np.diff(active.astype(np.int8))
    starts = list(np.nonzero(edges == 1)[0] + 1)
    ends = list(np.nonzero(edges == -1)[0] + 1)
    if active[0]:
        starts.insert(0, 0)
    if active[-1]:
        ends.append(n)
    regions: List[Tuple[float, float]] = [
        (s * frame_duration, e * frame_duration)
        for s, e in zip(starts, ends)]

    if opts.pad_onset or opts.pad_offset:
        regions = [(max(0.0, s - opts.pad_onset), e + opts.pad_offset)
                   for s, e in regions]

    if opts.min_duration_off > 0 and regions:
        merged = [list(regions[0])]
        for s, e in regions[1:]:
            if s - merged[-1][1] < opts.min_duration_off:
                merged[-1][1] = e
            else:
                merged.append([s, e])
        regions = [tuple(r) for r in merged]

    if opts.min_duration_on > 0:
        regions = [r for r in regions if r[1] - r[0] >= opts.min_duration_on]
    return regions


class VoiceActivityDetector:
    """VAD surface used by the pipeline: probs + binarize.

    Runs PyanNet when given the module (on the device of its weights),
    else the energy VAD."""

    def __init__(self, model: Optional[PyanNet] = None):
        self.model = model
        self.cfg = model.cfg if model is not None else PyanNetConfig()

    def warmup(self) -> None:
        """Run both block shapes (PYANNET_CHUNK_SMALL and PYANNET_CHUNK
        rows) once, so cuDNN's set-up and plan choice happen before the
        first request; no-op for the energy fallback."""
        if self.model is None:
            return
        window = int(self.cfg.window_sec * SAMPLE_RATE)
        for rows in (PYANNET_CHUNK_SMALL, PYANNET_CHUNK):
            pyannet_forward_chunked(self.model,
                                    np.zeros((rows, window), np.float32))

    def iter_speech_probs(self, audio: np.ndarray,
                          block_windows: int = PYANNET_CHUNK):
        """Yield ``(probs_so_far, frame_duration, is_last)`` per block of
        ``block_windows`` PyanNet windows.

        PyanNet scores each window independently, so cumulative per-block
        probabilities equal the all-at-once result; the pipeline dispatches
        the batches each block completes before the next block runs.  The
        last block is trimmed to the frames the audio covers; the energy
        fallback yields once."""
        audio = np.asarray(audio, np.float32)
        if self.model is None:
            probs, frame_dur = energy_vad_probs(audio)
            yield probs, frame_dur, True
            return
        window = int(self.cfg.window_sec * SAMPLE_RATE)
        n = len(audio)
        n_windows = max(1, int(np.ceil(n / window)))
        parts: List[np.ndarray] = []
        for lo in range(0, n_windows, block_windows):
            # the span closes before the yield: the caller's work between
            # blocks is not the VAD's
            with span("vad.pyannet"):
                m = min(block_windows, n_windows - lo)
                block = np.zeros((m, window), np.float32)
                avail = audio[lo * window: (lo + m) * window]
                block.reshape(-1)[: len(avail)] = avail
                log_probs = pyannet_forward_chunked(self.model, block)
                speech = powerset_to_speech_prob(log_probs)
                parts.append(speech.reshape(-1))
                frame_dur = self.cfg.window_sec / speech.shape[1]
                flat = np.concatenate(parts) if len(parts) > 1 else parts[0]
                is_last = lo + m >= n_windows
                if is_last:
                    valid = int(np.ceil(n / SAMPLE_RATE / frame_dur))
                    flat = flat[:valid]
            yield flat, frame_dur, is_last

    def speech_probs(self, audio: np.ndarray) -> Tuple[np.ndarray, float]:
        probs, frame_dur = np.zeros(0, np.float32), 0.01
        for probs, frame_dur, _ in self.iter_speech_probs(audio):
            pass
        return probs, frame_dur

    def __call__(self, audio: np.ndarray,
                 opts: VadOptions = VadOptions()
                 ) -> List[Tuple[float, float]]:
        probs, frame_dur = self.speech_probs(audio)
        duration = len(audio) / SAMPLE_RATE
        return [(max(0.0, s), min(duration, e))
                for s, e in binarize(probs, frame_dur, opts)]
