"""The yardstick's arithmetic: the card's peaks, the least time each kernel
could take at its launch shape, and the model FLOPs a transcription
needs.

Peaks: one NVIDIA H100 SXM at its full 700 W, NVIDIA's data sheet, dense
rates: 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32 outside
them, 3.35 TB/s of HBM.  A kernel's bound is the larger of its operations
over the peak and its bytes over the bandwidth, each input byte counted
read once and each output byte written once.
"""

from __future__ import annotations

from typing import Dict, Iterable

BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float, peak: float) -> float:
    return max(ops / peak, nbytes / HBM_BYTES_PER_S)


def flash_attention_bound_s(rows: int, heads: int, t: int, dh: int,
                            elem: int = 2) -> float:
    """K2, one launch: encoder self-attention over ``t`` positions; q, k,
    v read and the output written once; 4 rows heads t^2 dh operations at
    the bf16 tensor-core rate."""
    return bound_s(4.0 * rows * heads * t * t * dh,
                   4.0 * rows * heads * t * dh * elem, BF16_FLOPS)


def cross_attention_bound_s(rows: int, heads: int, n: int, dh: int,
                            elem: int = 2) -> float:
    """K4, one launch: a q_len = 1 attention over ``n`` cross positions;
    K and V read once, q read and the output written once; 4 FLOP per
    (key, dim) at the float32 rate (the kernel's softmax and sums)."""
    return bound_s(4.0 * rows * heads * n * dh,
                   elem * (2.0 * rows * heads * n * dh
                           + 2.0 * rows * heads * dh), F32_FLOPS)


def encoder_flops(cfg: Dict) -> float:
    """One 30 s window through the encoder: both convolutions, and per
    block the q, k, v, o and MLP products and the two attention products."""
    d, t = cfg["d_model"], cfg["max_source_positions"]
    mels, f = cfg["num_mel_bins"], cfg["encoder_ffn_dim"]
    convs = 2.0 * (2 * t) * mels * d * 3 + 2.0 * t * d * d * 3
    block = 2.0 * t * (4 * d * d + 2 * d * f) + 4.0 * t * t * d
    return convs + cfg["encoder_layers"] * block


def decoder_row_flops(cfg: Dict, prefix: int, served: int) -> float:
    """One window's decoding: cross K/V from the audio states, the prefill
    of ``prefix`` tokens with the logits of its last position, and one
    step for each served token after the first (its self-attention over
    the positions so far, its cross-attention over the audio, the logits
    over the vocabulary)."""
    d, t, v = cfg["d_model"], cfg["max_source_positions"], cfg["vocab_size"]
    f = cfg["decoder_ffn_dim"]
    layers = cfg["decoder_layers"]
    per_token = 2.0 * (6 * d * d + 2 * d * f)          # q k v o, xq xo, MLP
    cross_kv = layers * 2.0 * t * 2 * d * d
    prefill = layers * (prefix * per_token + 2.0 * d * prefix * (prefix + 1)
                        + 4.0 * prefix * t * d) + 2.0 * d * v
    steps = 0.0
    for j in range(1, served):
        pos = prefix + j                                # positions attended
        steps += (layers * (per_token + 4.0 * pos * d + 4.0 * t * d)
                  + 2.0 * d * v)
    return cross_kv + prefill + steps


def model_flops(cfg: Dict, prefix: int, served_per_window: Iterable[int]
                ) -> float:
    """FLOPs that these real windows and their served tokens need."""
    served = list(served_per_window)
    return (len(served) * encoder_flops(cfg)
            + sum(decoder_row_flops(cfg, prefix, n) for n in served))
