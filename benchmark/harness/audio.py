"""Seeded synthetic speech: harmonic bursts with pauses over a low noise
floor, so that the voice-activity detector finds many regions.  The
bursts' timing and pitch come from ``numpy.random.default_rng(seed)``;
the noise and the rendering run on the device in a few calls a burst.
Parameters (seconds, Hz, amplitudes) come from the traffic mix."""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

SAMPLE_RATE = 16000

DEFAULT_SPEECH = {"burst_s": [0.3, 2.0], "pause_s": [0.2, 1.2],
                  "f0_hz": [110.0, 260.0], "noise": 0.003, "level": 0.25,
                  "tremolo_hz": 4.0, "lead_s": 0.5}


def synthetic_speech(seconds: float, seed: int, device,
                     params: Dict = DEFAULT_SPEECH) -> np.ndarray:
    """``seconds`` of 16 kHz mono float32 audio from ``seed``."""
    p = {**DEFAULT_SPEECH, **params}
    rng = np.random.default_rng(seed)
    n = int(seconds * SAMPLE_RATE)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = p["noise"] * torch.randn(n, generator=gen, device=device)
    cursor = p["lead_s"]
    ramp = torch.arange(int(p["burst_s"][1] * SAMPLE_RATE) + 1,
                        device=device, dtype=torch.float64) / SAMPLE_RATE
    while cursor < seconds - 1.0:
        dur = float(rng.uniform(*p["burst_s"]))
        m = int(min(dur, seconds - cursor) * SAMPLE_RATE)
        f0 = float(rng.uniform(*p["f0_hz"]))
        tt = ramp[:m]
        burst = sum(torch.sin(2 * math.pi * f0 * k * tt) / k
                    for k in (1, 2, 3))
        env = torch.sin(math.pi * tt / (m / SAMPLE_RATE)) * (
            0.5 + 0.5 * torch.sin(2 * math.pi * p["tremolo_hz"] * tt))
        s = int(cursor * SAMPLE_RATE)
        out[s:s + m] += (p["level"] * burst * env).float()
        cursor += dur + float(rng.uniform(*p["pause_s"]))
    return out.cpu().numpy()
