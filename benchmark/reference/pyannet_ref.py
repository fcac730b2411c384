"""Plain float32 PyanNet (pyannote ``segmentation-3.0``: SincNet, a
4-layer BiLSTM, two linear layers and a 7-class powerset head), read from
a pyannote state dict, and the voice-activity steps after it.

Written from pyannote.audio's ``PyanNet`` and asteroid's ``ParamSincFB``:
instance norm of the waveform, 80 learned band-pass sinc filters (251
taps, stride 10), |.| and max-pool 3, instance norm, leaky ReLU; two
5-tap convolutions with max-pool 3, instance norm and leaky ReLU; the
BiLSTM over time; leaky ReLU linears; log-softmax.  Speech probability
is 1 - P(no speaker).  Audio is cut into back-to-back 10 s windows, the
last zero-padded, and each window is scored on its own.

``binarize``, ``merge_chunks`` and ``pad_window`` follow pyannote's
``Binarize`` hysteresis (onset 0.5, offset 0.363) and WhisperX's greedy
merge of speech regions into windows of at most 30 s.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .whisper_ref import no_tf32

SAMPLE_RATE = 16000
WINDOW_S = 10.0


class PyanNetRef(nn.Module):
    def __init__(self, sd: Dict[str, torch.Tensor]):
        super().__init__()
        self.sd = {k: v.float() for k, v in sd.items()}
        lstm_prefix = ("lstm.lstm." if "lstm.lstm.weight_ih_l0" in sd
                       else "lstm.")
        layers = 0
        while f"{lstm_prefix}weight_ih_l{layers}" in sd:
            layers += 1
        hidden = sd[f"{lstm_prefix}weight_hh_l0"].shape[1]
        self.lstm = nn.LSTM(sd[f"{lstm_prefix}weight_ih_l0"].shape[1], hidden,
                            num_layers=layers, bidirectional=True,
                            batch_first=True)
        self.lstm.load_state_dict({k[len(lstm_prefix):]: v.float()
                                   for k, v in sd.items()
                                   if k.startswith(lstm_prefix)})
        self.lstm.requires_grad_(False)

    def to(self, device):
        self.sd = {k: v.to(device) for k, v in self.sd.items()}
        self.lstm = self.lstm.to(device)
        return self

    def filters(self) -> torch.Tensor:
        """The 80 band-pass filters [80, 1, 251]."""
        sd = self.sd
        low = 50.0 + sd["sincnet.conv1d.0.low_hz_"].abs()
        high = torch.clamp(low + 50.0 + sd["sincnet.conv1d.0.band_hz_"].abs(),
                           50.0, SAMPLE_RATE / 2)
        band = (high - low)[:, 0]
        half = 125
        n = 2 * math.pi * torch.arange(-half, 0, dtype=torch.float32,
                                       device=low.device) / SAMPLE_RATE
        win = 0.54 - 0.46 * torch.cos(
            2 * math.pi * torch.linspace(0, 251 / 2 - 1, half,
                                         device=low.device) / 251)
        left = ((torch.sin(high * n) - torch.sin(low * n)) / (n / 2)) * win
        centre = 2 * band[:, None]
        right = torch.flip(left, dims=[1])
        bp = torch.cat([left, centre, right], dim=1) / (2 * band[:, None])
        return bp[:, None, :]

    @staticmethod
    def _inorm(x, g, b):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5) * g[:, None] + b[:, None]

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        """[B, 160000] -> powerset log-probs [B, frames, 7]."""
        sd = self.sd
        x = self._inorm(audio[:, None, :].float(),
                        sd["sincnet.wav_norm1d.weight"],
                        sd["sincnet.wav_norm1d.bias"])
        x = F.max_pool1d(F.conv1d(x, self.filters(), stride=10).abs(), 3, 3)
        x = F.leaky_relu(self._inorm(x, sd["sincnet.norm1d.0.weight"],
                                     sd["sincnet.norm1d.0.bias"]), 0.01)
        for i in (1, 2):
            x = F.conv1d(x, sd[f"sincnet.conv1d.{i}.weight"],
                         sd[f"sincnet.conv1d.{i}.bias"])
            x = F.leaky_relu(self._inorm(F.max_pool1d(x, 3, 3),
                                         sd[f"sincnet.norm1d.{i}.weight"],
                                         sd[f"sincnet.norm1d.{i}.bias"]),
                             0.01)
        x, _ = self.lstm(x.transpose(1, 2))
        for i in (0, 1):
            x = F.leaky_relu(x @ sd[f"linear.{i}.weight"].t()
                             + sd[f"linear.{i}.bias"], 0.01)
        x = x @ sd["classifier.weight"].t() + sd["classifier.bias"]
        return torch.log_softmax(x, dim=-1)


def load(path: str, device) -> PyanNetRef:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return PyanNetRef(sd).to(device)


def speech_probs(model: PyanNetRef, audio: np.ndarray, device,
                 rows: int = 16, tf32: bool = False
                 ) -> Tuple[np.ndarray, float]:
    """Speech probability per frame of the whole recording, and the frame
    length in seconds.  ``tf32`` computes in TF32 (the control)."""
    win = int(WINDOW_S * SAMPLE_RATE)
    n = len(audio)
    n_win = max(1, -(-n // win))
    padded = np.zeros(n_win * win, np.float32)
    padded[:n] = audio
    blocks = padded.reshape(n_win, win)
    out = []
    for lo in range(0, n_win, rows):
        x = torch.from_numpy(blocks[lo:lo + rows]).to(device)
        if tf32:
            matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
            saved = (matmul.allow_tf32, cudnn.allow_tf32)
            matmul.allow_tf32 = cudnn.allow_tf32 = True
            try:
                with torch.no_grad():
                    lp = model(x)
            finally:
                matmul.allow_tf32, cudnn.allow_tf32 = saved
        else:
            with no_tf32(), torch.no_grad():
                lp = model(x)
        out.append((1.0 - lp[..., 0].exp()).double().cpu().numpy())
    probs = np.concatenate(out, axis=0)
    frame = WINDOW_S / probs.shape[1]
    flat = probs.reshape(-1)
    return flat[: int(np.ceil(n / SAMPLE_RATE / frame))], frame


def binarize(probs: np.ndarray, frame: float, onset: float = 0.5,
             offset: float = 0.363) -> List[Tuple[float, float]]:
    """Hysteresis: a region starts where the probability rises above
    ``onset`` and ends where it falls below ``offset``."""
    regions, active, start = [], False, 0
    for i, p in enumerate(np.asarray(probs, np.float32)):
        if not active and p > onset:
            active, start = True, i
        elif active and p < offset:
            active = False
            regions.append((start * frame, i * frame))
    if active:
        regions.append((start * frame, len(probs) * frame))
    return regions


def merge_chunks(regions, chunk: float = 30.0) -> List[Tuple[float, float]]:
    """Regions longer than ``chunk`` split; then consecutive regions merged
    greedily while the window from the first start stays within it."""
    split = []
    for s, e in regions:
        while e - s > chunk:
            split.append((s, s + chunk))
            s += chunk
        if e > s:
            split.append((s, e))
    out: List[List[float]] = []
    for s, e in split:
        if out and e - out[-1][0] <= chunk:
            out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def windows_of(probs: np.ndarray, frame: float, duration: float,
               chunk: float = 30.0) -> List[Tuple[float, float]]:
    """The windows that speech probabilities give a recording."""
    regions = [(max(0.0, s), min(duration, e))
               for s, e in binarize(probs, frame)]
    return merge_chunks(regions, chunk)


def pad_window(audio: np.ndarray, start: float, end: float,
               samples: int) -> np.ndarray:
    """[start, end) seconds of ``audio``, zero-padded to ``samples``."""
    s = int(round(start * SAMPLE_RATE))
    e = int(round(end * SAMPLE_RATE))
    clip = audio[s:min(e, len(audio))][:samples]
    out = np.zeros(samples, np.float32)
    out[: len(clip)] = clip
    return out
