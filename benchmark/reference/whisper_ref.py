"""Plain float32 Whisper (OpenAI's published architecture), the yardstick
that the served tokens are judged against.

Written from the paper and the published ``config.json`` alone: log-mel
(Hann 400, hop 160, slaney mel filterbank, log10, max - 8 clamp,
(x + 4) / 4), two GELU convolutions, sinusoidal positions, pre-LayerNorm
encoder blocks, and a decoder run teacher-forced over the whole token
sequence at once, with no cache, no kernels and no batching tricks.
Every product runs in float32 with TF32 off (``no_tf32``).

Weights are the benchmark's own dict (``harness.weights``): matmul
weights ``[in, out]`` used as ``x @ w``, convolutions ``[out, in, 3]``,
blocks as lists of dicts.  The reference reads them and casts each to
float32 as it uses it, so it never holds a float32 copy of the model.

One departure from the paper, as the pipeline under test feeds its
model: audio crosses to the model as 16-bit PCM (``pcm16``).

``rounded_products`` computes every linear product (the blocks' and the
logits') from operands rounded by a function it is given: the output
check's controls (``benchmark/controls/``) put a lower precision in the
program's place through it.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """float32 products and convolutions in full float32 for the block."""
    matmul = torch.backends.cuda.matmul
    cudnn = torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32)
    matmul.allow_tf32 = False
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


_ROUND: List[Optional[Callable[[torch.Tensor], torch.Tensor]]] = [None]


@contextlib.contextmanager
def rounded_products(round_operand: Callable[[torch.Tensor], torch.Tensor]
                     ) -> Iterator[None]:
    """Every linear product of the block from operands passed through
    ``round_operand`` (float32 in, float32 out)."""
    _ROUND[0] = round_operand
    try:
        yield
    finally:
        _ROUND[0] = None


def _q(x: torch.Tensor) -> torch.Tensor:
    return x if _ROUND[0] is None else _ROUND[0](x)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _q(x) @ _q(w.float())


def pcm16(audio: torch.Tensor) -> torch.Tensor:
    """Float audio through 16-bit PCM and back (clip, truncate toward 0)."""
    scaled = torch.clamp(audio * 32768.0, -32768.0, 32767.0)
    return torch.trunc(scaled) / 32768.0


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    f = np.asarray(f, np.float64)
    lin = 3.0 * f / 200.0
    log = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    lin = 200.0 * m / 3.0
    log = 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0))
    return np.where(m >= 15.0, log, lin)


def mel_filters(n_mels: int) -> np.ndarray:
    """Slaney-normalised triangular filters ``[n_mels, 201]`` (librosa's
    ``filters.mel(sr=16000, n_fft=400, n_mels=n_mels)``)."""
    freqs = np.linspace(0.0, SAMPLE_RATE / 2, N_FFT // 2 + 1)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SAMPLE_RATE / 2),
                                 n_mels + 2))
    out = np.zeros((n_mels, len(freqs)))
    for i in range(n_mels):
        lo, mid, hi = pts[i], pts[i + 1], pts[i + 2]
        rise = (freqs - lo) / (mid - lo)
        fall = (hi - freqs) / (hi - mid)
        out[i] = np.maximum(0.0, np.minimum(rise, fall)) * 2.0 / (hi - lo)
    return out


def log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """[B, N] float32 audio -> normalised log-mel [B, n_mels, N // 160]."""
    window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float32,
                               device=audio.device)
    spec = torch.stft(audio.float(), N_FFT, HOP, window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    power = spec[..., :-1].abs() ** 2                     # [B, 201, frames]
    fb = torch.from_numpy(mel_filters(n_mels)).float().to(audio.device)
    mel = torch.clamp(fb @ power, min=1e-10).log10()
    mel = torch.maximum(mel, mel.amax(dim=(-2, -1), keepdim=True) - 8.0)
    return (mel + 4.0) / 4.0


def sinusoids(length: int, channels: int) -> torch.Tensor:
    """The encoder's fixed positions: [sin | cos] over log-spaced
    timescales from 1 to 10000."""
    inc = math.log(10000) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float64))
    t = torch.arange(length, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1).float()


def _f(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def _ln(x: torch.Tensor, p: Dict) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * _f(p["g"]) + _f(p["b"])


def _heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.view(b, t, n_head, d // n_head).transpose(1, 2)


def _attention(q, k, v, n_head: int, causal: bool = False) -> torch.Tensor:
    q, k, v = (_heads(z, n_head) for z in (q, k, v))
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if causal:
        t, s = scores.shape[-2:]
        mask = torch.ones(t, s, dtype=torch.bool,
                          device=q.device).triu(s - t + 1)
        scores = scores.masked_fill(mask, float("-inf"))
    out = torch.softmax(scores, dim=-1) @ v
    b, h, t, dh = out.shape
    return out.transpose(1, 2).reshape(b, t, h * dh)


def _self_attn(x, a, n_head, causal=False):
    q = _mm(x, a["q_w"]) + _f(a["q_b"])
    k = _mm(x, a["k_w"])
    v = _mm(x, a["v_w"]) + _f(a["v_b"])
    return _mm(_attention(q, k, v, n_head, causal), a["o_w"]) + _f(a["o_b"])


def _cross_attn(x, xa, a, n_head):
    q = _mm(x, a["q_w"]) + _f(a["q_b"])
    k = _mm(xa, a["k_w"])
    v = _mm(xa, a["v_w"]) + _f(a["v_b"])
    return _mm(_attention(q, k, v, n_head), a["o_w"]) + _f(a["o_b"])


def _mlp(x, m):
    h = F.gelu(_mm(x, m["fc1_w"]) + _f(m["fc1_b"]))
    return _mm(h, m["fc2_w"]) + _f(m["fc2_b"])


def encoder(w: Dict, mel: torch.Tensor, n_head: int) -> torch.Tensor:
    """mel [B, n_mels, 2 T] -> audio states [B, T, d]."""
    enc = w["encoder"]
    x = F.gelu(F.conv1d(mel, _f(enc["conv1_w"]), _f(enc["conv1_b"]),
                        padding=1))
    x = F.gelu(F.conv1d(x, _f(enc["conv2_w"]), _f(enc["conv2_b"]),
                        stride=2, padding=1))
    x = x.transpose(1, 2)
    x = x + sinusoids(x.shape[1], x.shape[2]).to(x.device)
    for blk in enc["blocks"]:
        x = x + _self_attn(_ln(x, blk["ln1"]), blk["attn"], n_head)
        x = x + _mlp(_ln(x, blk["ln2"]), blk["mlp"])
    return _ln(x, enc["ln_post"])


def decoder_logits(w: Dict, tokens: torch.Tensor, xa: torch.Tensor,
                   n_head: int, first: int) -> torch.Tensor:
    """Teacher-forced decoder over ``tokens`` [B, L] attending to ``xa``;
    logits [B, L - first, vocab] of positions first .. L - 1 (each
    predicts the token after it)."""
    dec = w["decoder"]
    emb = _f(dec["tok_emb"])
    x = emb[tokens] + _f(dec["pos_emb"])[: tokens.shape[1]]
    for blk in dec["blocks"]:
        x = x + _self_attn(_ln(x, blk["ln1"]), blk["attn"], n_head,
                           causal=True)
        x = x + _cross_attn(_ln(x, blk["lnx"]), xa, blk["xattn"], n_head)
        x = x + _mlp(_ln(x, blk["ln2"]), blk["mlp"])
    x = _ln(x[:, first:], dec["ln"])
    return _mm(x, emb.t())


def window_logits(w: Dict, cfg: Dict, windows: torch.Tensor,
                  sequences: Sequence[List[int]], first: int
                  ) -> List[torch.Tensor]:
    """Audio windows [B, N] float32 and, per row, the prefix followed by
    the served tokens -> per row, the logits [len - 1 - first, vocab] of
    positions ``first`` on (position i predicts token i + 1)."""
    with no_tf32():
        mel = log_mel(pcm16(windows.float()), cfg["num_mel_bins"])
        xa = encoder(w, mel, cfg["encoder_attention_heads"])
        out = []
        for i, seq in enumerate(sequences):
            toks = torch.tensor([seq[:-1]], dtype=torch.long,
                                device=windows.device)
            out.append(decoder_logits(w, toks, xa[i:i + 1],
                                      cfg["decoder_attention_heads"],
                                      first)[0])
        return out
