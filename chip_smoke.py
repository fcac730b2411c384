#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --rows decode_self_attention,int8_matmul

With ``--rows`` only phase 1 and the named kernels' checks and timed rows
run (for work on one kernel; the names are ``mel``, ``flash_attention``,
``decode_self_attention``, ``decode_cross_attention``,
``decode_cross_attention_int8`` and ``int8_matmul``); no result line is
printed.

Phases (any failure exits non-zero; no phase's exception is swallowed):

1. Print the card (``nvidia-smi``), torch and CUDA versions; build the
   CUDA kernels K1-K6 from ``manual_whisper_tpu_torch/csrc`` with nvcc;
   load large-v3 at full width and depth with seeded random weights in
   bf16 and read the decode attentions' shapes from it.  The int8 model
   (``compute_type="int8"``, ``int8_cross_kv=True``) is loaded in its turn
   in phase 4, after the bf16 model is freed.
2. Hold each kernel against its plain PyTorch version on the card at the
   main paths' large-v3 shapes, with the tolerance printed beside it, and
   time kernel, plain version and one PyTorch library call (a yardstick
   the port never calls) with CUDA graphs of repeated launches over enough
   input copies to exceed the 50 MB L2 cache.  K1 is timed at B=4
   windows of 30 s, 128 mels, and checked after the normalisation there and
   on rows of zeros, quiet noise and DC plus a faint 7 kHz tone (a
   ``kernel_check`` line); kernel and plain version are held against a
   float64 reference on rows of a steep spectral tilt (a second
   ``kernel_check`` line, both errors); its bound is the function's (an
   FFT's operations, or the bytes, which bind), the bounds of the work the
   kernel's twice-folded DFT does, of the DFT folded once and of the dense
   product stand beside it on the row's line, and a ``library_route`` line
   times ``torch.stft`` -> ``abs()**2`` -> ``@`` filters -> ``log10``
   (four calls, so not the row's ``library_ms``).  K2 is timed at the
   encoder's T=1500, dh=64 (a ``kernel_check`` line holds it against the
   plain version at ragged query and key tiles and at dh=32).  K3 is timed
   over the positions the decode loop visits (and checked at slots that
   leave some of its blocks without keys), K4 and K5 at the full cross
   length (K5 with f32 scales; bf16 scales and batch 16 on extra lines;
   K4 and K5 also checked at lengths that leave some of their blocks
   without keys), K6 at a decode
   step's M=4 with K, N = 1280, 5120 (on extra lines the other decode
   shapes and every M > 8 shape of the int8 path: M = 4 x 1500 and
   M = 4 x 193, each with 1280x1280, 1280x5120 and 5120x1280; two
   ``kernel_check`` lines hold ragged tiles and the matvec at M in {1, 2,
   3, 5, 8} against the plain version);
   K3 and K4 also at batch 16 (extra).
3. Run the tiny ``test`` config through the port on the card and on the
   CPU (plain versions), in bf16 and in int8 (int8 weights and int8 cross
   K/V on bf16 activations): encoder output and the logits of a prefill
   plus three decode steps must agree within tolerance, and faults run on
   the card (bf16: a dropped encoder layer, a dropped decoder layer, half
   the cross length; int8: one layer's weight scales on the wrong output
   channels, one layer's cross-K/V scales dropped or swapped between K
   and V) must each exceed it.
4. The main paths: ``warmup(batch_size=4, language="zh")`` (timed alone
   as ``warmup_s``; it captures the decode chunks of batch buckets 1, 2
   and 4 as CUDA graphs, ``capture_s``), then ``transcribe`` of about 75 s
   of seeded amplitude-modulated audio at batch 4, language zh, with the
   CLI's options and the full temperature ladder, with the bf16 model and
   then with the int8 model.  Launch counters are zeroed just before each
   ``transcribe`` and read just after: bf16 must launch K1-K4 and not
   K5/K6; int8 must launch K1, K2, K3, K5 and K6 and not K4, each exactly
   as often as the batches, decode loops and steps in ``last_stats`` imply
   (a replay adds the launches its capture recorded), and every decode
   step must have run inside a replayed chunk.  Then a ``graph_vs_eager``
   line: one batch-4 loop at T = 0 and one at T = 0.2, replayed against
   the same chunks run eagerly, tokens and lengths equal, sum_logprob
   within SUM_LP_TOL, ms per token row of each.
5. Where the time goes: ``torch.profiler`` over one batch-4 encoder pass
   and 16 eager decode steps of each model (device-busy share, top
   kernels), and over one replay of the 16-step chunk beside the same
   chunk run eagerly and the cross K/V and the prefill of a loop, run right
   after that model's phase 4; before phase 3, the host time to issue one
   call of K6 (through ``mm``) and K5 against the bf16 step's cuBLAS
   matmul and K4.

The kernels line gives each kernel's launches on the main path that
runs it (K1-K4 bf16, K5 and K6 int8; the int8 path's K1-K3 counts are on
its ``main_path`` line).  The line before the last is
``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA it exits 2 and prints no
result.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from manual_whisper_tpu_torch.ops import _build
from manual_whisper_tpu_torch.ops.attention import (attention_plain,
                                                    flash_attention)
from manual_whisper_tpu_torch.ops.decode_attention import (
    attend_int8_plain, attend_plain, decode_cross_attention,
    decode_cross_attention_int8, decode_self_attention)
from manual_whisper_tpu_torch.ops.mel import (log_mel_spectrogram,
                                              mel_filter_bank,
                                              normalize_log_mel,
                                              unnormalized_log_mel,
                                              unnormalized_log_mel_f64,
                                              unnormalized_log_mel_plain)
from manual_whisper_tpu_torch.ops.quant import (int8_matmul,
                                                int8_matmul_plain,
                                                quantize_weight)

# published H100 SXM peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12        # non-tensor-core float32
BF16_FLOPS = 989e12      # bf16 tensor cores
L2_BYTES = 50 * 2 ** 20

# (atol, rtol): |kernel - plain| <= atol + rtol * |plain| elementwise
TOL = {"mel": (1e-3, 0.0),                   # normalised log-mel, both f32
       # bf16 outputs: the kernels keep P and the sums in f32, the plain
       # versions round P to bf16 (one bf16 ulp is 2^-8 relative)
       "flash_attention": (1e-2, 1e-2),
       "decode_self_attention": (1e-2, 1e-2),
       "decode_cross_attention": (1e-2, 1e-2),
       "decode_cross_attention_int8": (1e-2, 1e-2),
       # bf16 output of an f32 sum of exact products: one bf16 rounding
       "int8_matmul": (1e-2, 1e-2),
       # test config in bf16, card vs CPU: rounding differs per op.  On an
       # H100 the errors were 0.031 (encoder, 2 bf16 ulps at |x| < 4; std
       # 1.0) and 0.0047 (logits; std 0.16); the limits sit about 3x above
       # them, and below the faults phase 3 runs (smallest: half the cross
       # length, logits off by 0.099)
       "encoder": (0.1, 0.0),
       "logits": (0.015, 0.0),
       # the test config in int8 (int8 weights and cross K/V, bf16
       # activations), card vs CPU: on an H100 the errors were 0.031
       # (encoder) and 0.0048 (logits; std 0.16), as in bf16, so the same
       # limits; the faults phase 3 runs exceed them (smallest: the last
       # layer's cross-K/V scales swapped, logits off by 0.067)
       "encoder_int8": (0.1, 0.0),
       "logits_int8": (0.015, 0.0)}

SOURCES = {
    "mel": ("manual_whisper_tpu_torch/csrc/mel.cu",
            "manual_whisper_tpu/ops/mel_pallas.py:33"),
    "flash_attention": ("manual_whisper_tpu_torch/csrc/flash_attention.cu",
                        "manual_whisper_tpu/ops/attention.py:32"),
    "decode_self_attention": (
        "manual_whisper_tpu_torch/csrc/decode_attention.cu",
        "manual_whisper_tpu/ops/decode_attention.py:204"),
    "decode_cross_attention": (
        "manual_whisper_tpu_torch/csrc/decode_attention.cu",
        "manual_whisper_tpu/ops/decode_attention.py:150"),
    "decode_cross_attention_int8": (
        "manual_whisper_tpu_torch/csrc/decode_attention.cu",
        "manual_whisper_tpu/ops/decode_attention.py:80"),
    "int8_matmul": ("manual_whisper_tpu_torch/csrc/int8_matmul.cu",
                    "manual_whisper_tpu/ops/quant.py:102"),
}
BF16_KERNELS = ("mel", "flash_attention", "decode_self_attention",
                "decode_cross_attention")
INT8_KERNELS = ("mel", "flash_attention", "decode_self_attention",
                "decode_cross_attention_int8", "int8_matmul")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def graph_ms(fn, arg_sets, iters: int = 20) -> float:
    """Device time of one call: a CUDA graph of ``iters`` calls cycling
    through ``arg_sets`` (copies sized to defeat L2), replayed and timed
    with CUDA events."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 3
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * iters)
    del graph
    return ms


def copies_for(nbytes: int) -> int:
    return max(1, math.ceil(3 * L2_BYTES / max(nbytes, 1)))


def bound(ops: float, nbytes: float, peak: float):
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def compare(name: str, out: torch.Tensor, ref: torch.Tensor) -> float:
    """Max abs error of out vs ref; raises past TOL[name]."""
    atol, rtol = TOL[name]
    out, ref = out.float(), ref.float()
    excess = float(((out - ref).abs() - atol - rtol * ref.abs()).max())
    err = max_err(out, ref)
    if not math.isfinite(err) or excess > 0:
        raise AssertionError(f"{name}: max abs error {err} exceeds "
                             f"atol {atol} + rtol {rtol} * |ref|")
    return err


def _decode_bound(b, h, dh, n):
    """Bound of one q_len = 1 attention over n positions: K and V read
    once, q read and the output written once (bf16); 4 FLOP per (key, dim)."""
    return bound(4.0 * b * h * n * dh, 2.0 * (2 * b * h * n * dh
                                            + 2 * b * h * dh), F32_FLOPS)


def self_attention_row(randn, dev, b, h, dh, t_max, timed_pos, checks):
    """K3 vs its plain version at every pos in ``checks`` (a sharp softmax:
    keys scaled 3x), then timed over one call per pos in ``timed_pos``,
    each on its own K/V copy."""
    q = randn((b, h, 1, dh))
    k = randn((b, h, t_max, dh), scale=3.0)
    v = randn((b, h, t_max, dh))
    err = 0.0
    for pos in checks:
        pos_t = torch.full((1,), pos, dtype=torch.int32, device=dev)
        err = max(err, compare("decode_self_attention",
                               decode_self_attention(q, k, v, pos_t),
                               attend_plain(q, k, v, pos + 1)))
    reps = max(1, math.ceil(copies_for(2 * k.numel() * 2) / len(timed_pos)))
    sets = [(randn((b, h, 1, dh)), randn((b, h, t_max, dh)),
             randn((b, h, t_max, dh)),
             torch.full((1,), pos, dtype=torch.int32, device=dev), pos + 1)
            for pos in timed_pos * reps]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # one call per set: the mean over the timed positions
    ms, plain_ms, lib_ms = (graph_ms(fn, sets, iters=len(sets)) for fn in (
        lambda a, c, d, pt, n: decode_self_attention(a, c, d, pt),
        lambda a, c, d, pt, n: attend_plain(a, c, d, n),
        lambda a, c, d, pt, n: sdpa(a, c[:, :, :n], d[:, :, :n])))
    bounds = [_decode_bound(b, h, dh, s[4]) for s in sets]
    return dict(
        shape=(f"B={b} H={h} T_max={t_max} pos={timed_pos[0]}.."
               f"{timed_pos[-1]} ({len(timed_pos)} pos) dh={dh} bf16"),
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound=(sum(x[0] for x in bounds) / len(bounds), bounds[0][1]))


def self_attention_rows(randn, dev, main: dict):
    """K3's row of the kernels line (batch rows of the main path, its
    self cache, every pos the decode loop visits) and its extra: batch 16,
    T_max 448.  The checks take pos 6, 7 and 8 (n = 7, 8, 9: the key axis
    is split over the blocks of a cluster, so short lengths leave blocks
    without keys) besides the first, middle and last slots."""
    b, h, dh = main["batch"], main["heads"], main["dh"]
    t_max, p = main["t_max"], main["prefix"]
    steps = np.unique(np.linspace(p, t_max - 2, 20).round().astype(int))
    row = self_attention_row(randn, dev, b, h, dh, t_max,
                             [int(x) for x in steps],
                             checks=(0, 1, 6, 7, 8, p, (p + t_max) // 2,
                                     t_max - 1))
    return row, [self_attention_row(randn, dev, 16, h, dh, 448, [447],
                                    checks=(0, 1, 6, 7, 8, 100, 255, 447))]


def cross_attention_row(randn, dev, b, h, dh, ta):
    """K4 vs its plain version at kv_len Ta, Ta - 1, 1000, 8, 7 and 1 (the
    key axis is split over 8 blocks: a ragged last slice, slices that are
    empty for some or all but one block), then timed at kv_len = Ta (the
    main path's) over K/V copies that exceed L2."""
    q = randn((b, h, 1, dh))
    k = randn((b, h, ta, dh))
    v = randn((b, h, ta, dh))
    err = 0.0
    for kv_len in (ta, ta - 1, 1000, 8, 7, 1):
        len_t = torch.full((1,), kv_len, dtype=torch.int32, device=dev)
        err = max(err, compare("decode_cross_attention",
                               decode_cross_attention(q, k, v, len_t),
                               attend_plain(q, k, v, kv_len)))
    len_t = torch.full((1,), ta, dtype=torch.int32, device=dev)
    sets = [(randn((b, h, 1, dh)), randn((b, h, ta, dh)),
             randn((b, h, ta, dh)))
            for _ in range(copies_for(2 * k.numel() * 2))]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return dict(
        shape=f"B={b} H={h} Ta={ta} kv_len={ta} dh={dh} bf16",
        max_abs_err=err,
        ms=graph_ms(lambda a, c, d: decode_cross_attention(a, c, d, len_t),
                    sets),
        plain_ms=graph_ms(lambda a, c, d: attend_plain(a, c, d, ta), sets),
        library_ms=graph_ms(sdpa, sets),
        bound=_decode_bound(b, h, dh, ta))


def _int8_cross_bound(b, h, dh, n, scale_bytes):
    """Bound of K5 over n positions: int8 K and V and their per-position
    scales read once, q read and the output written once (bf16)."""
    return bound(4.0 * b * h * n * dh,
                 2.0 * b * h * n * dh + 2.0 * b * h * n * scale_bytes
                 + 2.0 * 2 * b * h * dh, F32_FLOPS)


def cross_int8_row(randn, dev, b, h, dh, ta, scale_dtype):
    """K5 vs its plain version at kv_len Ta, Ta - 1, 1000, 8, 7 and 1 (the
    key axis is split over 8 blocks: a ragged last slice, slices that are
    empty for some or all but one block), then timed at kv_len = Ta over
    K/V copies that exceed L2; the yardstick is SDPA over a bf16 copy of
    K/V dequantized before timing."""
    from manual_whisper_tpu_torch.models.whisper import quantize_cross_kv

    def kv4():
        return quantize_cross_kv(randn((b, h, ta, dh)), randn((b, h, ta, dh)),
                                 scale_dtype)
    q, kv = randn((b, h, 1, dh)), kv4()
    err = 0.0
    for kv_len in (ta, ta - 1, 1000, 8, 7, 1):
        len_t = torch.full((1,), kv_len, dtype=torch.int32, device=dev)
        err = max(err, compare("decode_cross_attention_int8",
                               decode_cross_attention_int8(q, *kv, len_t),
                               attend_int8_plain(q, *kv, kv_len)))
    len_t = torch.full((1,), ta, dtype=torch.int32, device=dev)
    sets = [(randn((b, h, 1, dh)), *kv4())
            for _ in range(copies_for(2 * b * h * ta * dh))]
    deq = [(a, (kq.float() * ks.float()[..., None]).bfloat16(),
            (vq.float() * vs.float()[..., None]).bfloat16())
           for a, kq, ks, vq, vs in sets]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    scale_bytes = torch.empty((), dtype=scale_dtype).element_size()
    return dict(
        shape=(f"B={b} H={h} Ta={ta} kv_len={ta} dh={dh} int8 K/V, "
               f"{str(scale_dtype).split('.')[-1]} scales"),
        max_abs_err=err,
        ms=graph_ms(lambda *a: decode_cross_attention_int8(*a, len_t), sets),
        plain_ms=graph_ms(lambda *a: attend_int8_plain(*a, ta), sets),
        library_ms=graph_ms(sdpa, deq),
        bound=_int8_cross_bound(b, h, dh, ta, scale_bytes))


def cross_int8_rows(randn, dev, main: dict):
    """K5's row of the kernels line (batch rows of the main path, f32
    scales, the default) and its extras: bf16 scales, and batch 16."""
    b, h, dh, ta = main["batch"], main["heads"], main["dh"], main["ta"]
    row = cross_int8_row(randn, dev, b, h, dh, ta, torch.float32)
    return row, [cross_int8_row(randn, dev, b, h, dh, ta, torch.bfloat16),
                 cross_int8_row(randn, dev, 16, h, dh, ta, torch.float32)]


def mel_hard_rows(n_samples: int, dev, randn) -> torch.Tensor:
    """Rows that test K1's floor and range: exact zeros (a batch's padding
    row), quiet noise (amplitude 1e-4), DC 0.5 plus a 1e-3 tone at 7 kHz."""
    t = torch.arange(n_samples, device=dev) / 16000.0
    return torch.stack([
        torch.zeros(n_samples, device=dev),
        1e-4 * randn((n_samples,), torch.float32),
        0.5 + 1e-3 * torch.sin(2 * math.pi * 7000.0 * t)]).contiguous()


def mel_tilt_rows(n_samples: int, dev, randn) -> torch.Tensor:
    """Rows with a steep spectral tilt, where K1's bins 101..200 are small
    differences of two large sums: a 0.5 tone at 200 Hz (bin 5) with a 1e-4
    tone at 7.8 kHz (bin 195, its mirror), a 0.5 tone at 100 Hz over 1e-5
    high-passed noise, a 0.8 tone at 150 Hz over 1e-5 noise."""
    t = torch.arange(n_samples, device=dev) / 16000.0
    noise = randn((n_samples + 1,), torch.float32)

    def tone(amp, hz):
        return amp * torch.sin(2 * math.pi * hz * t)
    return torch.stack([
        tone(0.5, 200.0) + tone(1e-4, 7800.0),
        tone(0.5, 100.0) + 1e-5 * (noise[1:] - noise[:-1]),
        tone(0.8, 150.0) + 1e-5 * noise[1:]]).float().contiguous()


def mel_f64_errors(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """Max abs error of a float32 raw log-mel against the float64
    reference, row by row: everywhere, and where the normalisation keeps
    the reference (within 8 decades of its row's max)."""
    err = (out.double() - ref).abs()
    kept = ref >= ref.amax(dim=(-2, -1), keepdim=True) - 8.0
    return {"raw": [float(e.max()) for e in err],
            "kept": [float(e[k].max()) for e, k in zip(err, kept)]}


def mel_fft_ops(n_mels: int, nnz: int) -> float:
    """Operations a frame of log-mel needs by the cheapest known route:
    the window (400 multiplies), the 400-point real DFT as a 200-point
    complex FFT (5 N log2 N, the conventional count) and its real
    post-pass (10 a bin), the power (3 a bin), the filterbank's nonzeros
    (2 each) and the log (1 a band)."""
    return (400 + 5 * 200 * math.log2(200) + 10 * 201 + 3 * 201 + 2 * nnz
            + n_mels)


def mel_stft_chain(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """The route a PyTorch user would take to raw log10-mel, four calls:
    ``torch.stft`` (Hann 400, hop 160, reflect) -> ``abs() ** 2`` -> ``@``
    the filterbank -> ``log10(clamp)``.  A yardstick; the port never calls
    it."""
    window, filters = _stft_constants(n_mels, audio.device)
    spec = torch.stft(audio, 400, 160, window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    power = spec[..., :audio.shape[-1] // 160].abs() ** 2   # [B, 201, F]
    return torch.log10(torch.clamp(power.transpose(-1, -2) @ filters,
                                   min=1e-10))


@functools.lru_cache(maxsize=4)
def _stft_constants(n_mels: int, dev):
    return (torch.hann_window(400, periodic=True, device=dev),
            torch.from_numpy(mel_filter_bank(n_mels).astype(np.float32)
                             ).to(dev))


def mel_row(randn, dev) -> dict:
    """K1 vs its plain version on B=4 windows of 30 s at 128 mels (noise
    over a gated 220 Hz tone), compared after the normalisation, then on
    ``mel_hard_rows`` (logged as a ``kernel_check`` line); timed over audio
    copies that exceed L2.  No single PyTorch call computes log-mel, so
    ``library_ms`` is null; a ``library_route`` line times
    ``mel_stft_chain``.  A second ``kernel_check`` line holds kernel and
    plain version against the float64 reference on ``mel_tilt_rows``.
    Bound: the function's own work, ``mel_fft_ops`` a frame at the f32
    rate, or audio, constants and output moved once (the bytes bind).  On
    the row's line, labelled, the bounds of the work the kernel's DFT does
    (folded twice: 200 x 101 + 199 x 100 multiply-adds a frame, taps folded
    by the window's symmetry, bins 101..200 from the sums of bins 0..100),
    of the DFT folded once (200 x 201 + 199 x 199) and of the dense product
    (400 x 402 + 201 x n_mels), each with the filterbank's nonzeros."""
    b, n_samples, n_mels = 4, 480000, 128
    t = torch.arange(n_samples, device=dev) / 16000.0
    audio = (0.1 * randn((b, n_samples), torch.float32)
             + 0.3 * torch.sin(2 * math.pi * 220.0 * t)
             * (torch.sin(2 * math.pi * 0.7 * t) > 0)).float().contiguous()

    def normalized(fn, x):
        return normalize_log_mel(fn(x, n_mels))
    err = compare("mel", normalized(unnormalized_log_mel, audio),
                  normalized(unnormalized_log_mel_plain, audio))
    hard = mel_hard_rows(n_samples, dev, randn)
    log(json.dumps({
        "phase": "kernel_check", "name": "mel",
        "shape": f"3 rows x T={n_samples} n_mels={n_mels}: zeros, noise "
                 "1e-4, DC 0.5 + 1e-3 tone at 7 kHz; after normalisation",
        "max_abs_err": compare("mel", normalized(unnormalized_log_mel, hard),
                               normalized(unnormalized_log_mel_plain, hard)),
        "tol": TOL["mel"]}))
    tilt = mel_tilt_rows(n_samples, dev, randn)
    ref = unnormalized_log_mel_f64(tilt, n_mels)
    log(json.dumps({
        "phase": "kernel_check", "name": "mel",
        "shape": f"3 rows x T={n_samples} n_mels={n_mels}: tones of 0.5 at "
                 "200 Hz + 1e-4 at 7.8 kHz, 0.5 at 100 Hz + 1e-5 high-passed "
                 "noise, 0.8 at 150 Hz + 1e-5 noise; raw, against float64",
        "kernel_vs_f64": mel_f64_errors(unnormalized_log_mel(tilt, n_mels),
                                        ref),
        "plain_vs_f64": mel_f64_errors(
            unnormalized_log_mel_plain(tilt, n_mels), ref)}))
    n_frames = n_samples // 160
    nnz = int(np.count_nonzero(mel_filter_bank(n_mels).astype(np.float32)))
    sets = [(randn((b, n_samples), torch.float32),)
            for _ in range(copies_for(audio.numel() * 4))]
    io_bytes = 4.0 * (b * n_samples + b * n_frames * n_mels)
    least = bound(b * n_frames * mel_fft_ops(n_mels, nnz),
                  io_bytes + 4.0 * (400 + 2 * 200 + nnz + 4 * n_mels),
                  F32_FLOPS)
    twice = bound(2.0 * b * n_frames * (200 * 101 + 199 * 100 + nnz),
                  io_bytes + 4.0 * (2 * 200 * 101 + nnz + 4 * n_mels),
                  F32_FLOPS)
    once = bound(2.0 * b * n_frames * (200 * 201 + 199 * 199 + nnz),
                 io_bytes + 4.0 * ((200 + 199) * 201 + nnz + 4 * n_mels),
                 F32_FLOPS)
    dense = bound(2.0 * b * n_frames * (400 * 402 + 201 * n_mels),
                  io_bytes + 4.0 * (400 * 402 + 201 * n_mels), F32_FLOPS)
    route_err = compare("mel", normalized(mel_stft_chain, audio),
                        normalized(unnormalized_log_mel_plain, audio))
    log(json.dumps({
        "phase": "library_route", "name": "mel",
        "route": "torch.stft -> abs()**2 -> @ filters -> log10(clamp)",
        "calls": 4, "shape": f"B={b} T={n_samples} n_mels={n_mels}",
        "ms": graph_ms(lambda x: mel_stft_chain(x, n_mels), sets),
        "max_abs_err_vs_plain": route_err}))
    return dict(
        shape=f"B={b} T={n_samples} n_mels={n_mels}", max_abs_err=err,
        ms=graph_ms(lambda x: unnormalized_log_mel(x, n_mels), sets),
        plain_ms=graph_ms(lambda x: unnormalized_log_mel_plain(x, n_mels),
                          sets),
        library_ms=None, bound=least, other_bounds={
            "folded_twice_bound_ms": twice[0], "folded_once_bound_ms":
            once[0], "dense_product_bound_ms": dense[0]})


def flash_row(randn, b, h, tt, dh):
    """K2 vs its plain version at [b, h, tt, dh], then timed over copies
    that exceed L2; the yardstick is SDPA.  Bound: q, k, v read and the
    output written once, or 4 b h tt^2 dh operations at the bf16
    tensor-core rate.  ``exp2`` counts the b h tt^2 exponentials of the
    softmax, which the special-function units run at 16 a cycle and SM."""
    q, k, v = (randn((b, h, tt, dh)) for _ in range(3))
    err = compare("flash_attention", flash_attention(q, k, v),
                  attention_plain(q, k, v))
    per = 3 * q.numel() * 2
    sets = [tuple(randn((b, h, tt, dh)) for _ in range(3))
            for _ in range(copies_for(per))]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return dict(
        shape=f"B={b} H={h} T={tt} dh={dh} bf16", max_abs_err=err,
        ms=graph_ms(flash_attention, sets),
        plain_ms=graph_ms(attention_plain, sets[:1]),
        library_ms=graph_ms(sdpa, sets),
        bound=bound(4.0 * b * h * tt * tt * dh, 4.0 * b * h * tt * dh * 2,
                    BF16_FLOPS),
        exp2=float(b * h * tt * tt))


# (t_q, t_k, dh) of K2's ragged check: a query tile of one row, a last key
# tile of one key (129 = 128 + 1), the test config's dh=32 at T=150 and the
# encoder's T=1500 at both head widths
FLASH_CHECKS = ((1, 70, 64), (150, 150, 32), (127, 129, 64), (1499, 1499, 64),
                (1500, 1500, 32))


def flash_check(randn) -> dict:
    """K2 vs its plain version at FLASH_CHECKS, B=2, H=3.  Checked, not
    timed."""
    errs = {}
    for t_q, t_k, dh in FLASH_CHECKS:
        q = randn((2, 3, t_q, dh))
        k, v = randn((2, 3, t_k, dh)), randn((2, 3, t_k, dh))
        errs[f"t_q={t_q} t_k={t_k} dh={dh}"] = compare(
            "flash_attention", flash_attention(q, k, v),
            attention_plain(q, k, v))
    return {"phase": "kernel_check", "name": "flash_attention",
            "shape": "B=2 H=3 bf16, ragged tiles", "max_abs_err": errs,
            "tol": TOL["flash_attention"]}


def int8_matmul_row(randn, m, k, n):
    """K6 vs its plain version at x [m, k], weight [k, n], then timed over
    copies that exceed L2; the yardstick is cuBLAS x @ w on a bf16 copy of
    the weight dequantized before timing (twice K6's weight bytes).
    Bound: x, codes, scales read once and the output written once, or
    2*m*k*n operations at the bf16 tensor-core rate."""
    def weight():
        w = quantize_weight(randn((k, n), torch.float32) / math.sqrt(k))
        return w["q"], w["s"]
    x, (q, s) = randn((m, k)), weight()
    err = compare("int8_matmul", int8_matmul(x, q, s),
                  int8_matmul_plain(x, q, s))
    nbytes = 2.0 * m * k + k * n + 4.0 * n + 2.0 * m * n
    sets = [(randn((m, k)), *weight()) for _ in range(copies_for(nbytes))]
    deq = [(a, (wq.float() * ws).bfloat16()) for a, wq, ws in sets]
    return dict(shape=f"M={m} K={k} N={n} bf16 x int8", max_abs_err=err,
                ms=graph_ms(int8_matmul, sets),
                plain_ms=graph_ms(int8_matmul_plain, sets),
                library_ms=graph_ms(torch.matmul, deq),
                bound=bound(2.0 * m * k * n, nbytes, BF16_FLOPS))


def int8_matmul_ragged(randn) -> dict:
    """K6's tile product vs its plain version where no tile divides the
    shape: M in {9, 129, 771}, K = 1288 (a last K step of 8), N = 1296 (a
    last column tile of 16).  Checked, not timed."""
    k, n = 1288, 1296
    w = quantize_weight(randn((k, n), torch.float32) / math.sqrt(k))
    errs = {}
    for m in (9, 129, 771):
        x = randn((m, k))
        errs[f"M={m}"] = compare("int8_matmul", int8_matmul(x, w["q"], w["s"]),
                                 int8_matmul_plain(x, w["q"], w["s"]))
    return {"phase": "kernel_check", "name": "int8_matmul",
            "shape": f"K={k} N={n} bf16 x int8, ragged tiles",
            "max_abs_err": errs, "tol": TOL["int8_matmul"]}


# (K, N) of the matvec's check: one of each launch shape (wide: N >= 4K,
# deep: K >= 4N, square), the square one with a last column stripe and a
# last K step that are cut short
MATVEC_CHECKS = ((64, 256), (1288, 1296), (5120, 1280))


def int8_matvec_check(randn) -> dict:
    """K6's matvec (M <= 8) vs its plain version at every M in {1, 2, 3,
    5, 8} and (K, N) in MATVEC_CHECKS.  Checked, not timed."""
    errs = {}
    for k, n in MATVEC_CHECKS:
        w = quantize_weight(randn((k, n), torch.float32) / math.sqrt(k))
        for m in (1, 2, 3, 5, 8):
            x = randn((m, k))
            errs[f"M={m} K={k} N={n}"] = compare(
                "int8_matmul", int8_matmul(x, w["q"], w["s"]),
                int8_matmul_plain(x, w["q"], w["s"]))
    return {"phase": "kernel_check", "name": "int8_matmul",
            "shape": "M <= 8 (matvec) bf16 x int8", "max_abs_err": errs,
            "tol": TOL["int8_matmul"]}


def int8_matmul_rows(randn, main: dict):
    """K6 at every shape the int8 main path gives it: the row of the
    kernels line at a decode step's fc1 (M = batch rows), and as extras the
    other decode shapes and every M > 8 shape: the encoder's and the
    cross-K/V's M = batch x Ta and the prefill's M = batch x prompt length,
    each with the attention projections' and both MLP weights' (K, N).
    Logs the ragged-tile and matvec checks on its way."""
    b, d, p, ta = main["batch"], main["d"], main["prefix"], main["ta"]
    log(json.dumps(int8_matmul_ragged(randn)))
    log(json.dumps(int8_matvec_check(randn)))
    row = int8_matmul_row(randn, b, d, 4 * d)
    shapes = [(b, d, d), (b, 4 * d, d)]
    shapes += [(m, k, n) for m in (b * ta, b * p)
               for k, n in ((d, d), (d, 4 * d), (4 * d, d))]
    return row, [int8_matmul_row(randn, *shape) for shape in shapes]


def _row_line(phase: str, name: str, row: dict) -> str:
    line = {"phase": phase, "name": name, "shape": row["shape"],
            "max_abs_err": row["max_abs_err"], "tol": TOL[name],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "library_ms": row["library_ms"], "bound_ms": row["bound"][0],
            "bound_by": row["bound"][1]}
    if "exp2" in row:
        line["exp2"] = row["exp2"]
    line.update(row.get("other_bounds", {}))
    return json.dumps(line)


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version at large-v3 shapes
# ---------------------------------------------------------------------------

def seeded_randn(dev, seed: int):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def randn(shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)
    return randn


def phase_rows(dev, main: dict, names) -> None:
    """``--rows``: only the named kernels' checks and timed rows, at the
    main paths' shapes (for work on one kernel; prints no result line)."""
    randn = seeded_randn(dev, 1234)
    b, h, dh, ta = main["batch"], main["heads"], main["dh"], main["ta"]
    for name in names:
        if name == "mel":
            rows = [mel_row(randn, dev)]
        elif name == "int8_matmul":
            row, extra = int8_matmul_rows(randn, main)
            rows = [row] + extra
        elif name == "decode_self_attention":
            row, extra = self_attention_rows(randn, dev, main)
            rows = [row] + extra
        elif name == "decode_cross_attention":
            rows = [cross_attention_row(randn, dev, bb, h, dh, ta)
                    for bb in (b, 16)]
        elif name == "decode_cross_attention_int8":
            row, extra = cross_int8_rows(randn, dev, main)
            rows = [row] + extra
        elif name == "flash_attention":
            log(json.dumps(flash_check(randn)))
            rows = [flash_row(randn, 4, 20, 1500, 64)]
        else:
            raise SystemExit(f"--rows: no rows for {name!r}")
        for row in rows:
            log(_row_line("kernel_rows", name, row))


def phase_kernels(dev, main: dict) -> dict:
    randn = seeded_randn(dev, 1234)
    rows = {}

    rows["mel"] = mel_row(randn, dev)

    # K2 flash: B=4, H=20, T=1500, dh=64 (the encoder's); ragged check
    log(json.dumps(flash_check(randn)))
    rows["flash_attention"] = flash_row(randn, 4, 20, 1500, 64)

    # K3/K4 at the main path's shapes (phase 4: batch rows, self cache of
    # prefix + max_new slots, every pos the decode loop visits, Ta cross
    # positions); then at batch 16, T_max 448 as an extra, labelled check
    b, h, dh, ta = main["batch"], main["heads"], main["dh"], main["ta"]
    rows["decode_self_attention"], k3_extra = self_attention_rows(randn, dev,
                                                                  main)
    rows["decode_cross_attention"] = cross_attention_row(
        randn, dev, b, h, dh, ta)
    # K5 at the int8 path's shapes (f32 scales, the default; bf16 scales
    # and batch 16 extra)
    rows["decode_cross_attention_int8"], k5_extra = cross_int8_rows(
        randn, dev, main)
    rows["int8_matmul"], k6_extra = int8_matmul_rows(randn, main)
    extra = [("decode_self_attention", row) for row in k3_extra]
    extra += [("decode_cross_attention", cross_attention_row(
        randn, dev, 16, h, dh, ta))]
    extra += [("decode_cross_attention_int8", row) for row in k5_extra]
    extra += [("int8_matmul", row) for row in k6_extra]
    for name, row in extra:
        log(_row_line("kernel_extra", name, row))
    for name, row in rows.items():
        log(_row_line("kernel", name, row))
    return rows


# ---------------------------------------------------------------------------
# Phase 3: tiny test config, card vs CPU
# ---------------------------------------------------------------------------

def _tiny_forward(params, cfg, audio, prefix, d, cross_len_scale=1.0,
                  int8_cross_kv=False, cross_fault=None):
    """Encoder output and the logits of a prefill plus three decode steps
    (both [..] on the CPU, f32).  ``cross_len_scale`` < 1 makes the decode
    steps read too few cross positions, ``cross_fault`` rewrites the cross
    K/V list (negative controls)."""
    from manual_whisper_tpu_torch.models.whisper import (
        StepLengths, decode_step, decoder_forward, encode, init_kv_cache,
        precompute_cross_kv)
    mel = log_mel_spectrogram(torch.from_numpy(audio).to(d), cfg.n_mels)
    xa = encode(params, mel, cfg)
    cross = precompute_cross_kv(params, xa, cfg, quantize=int8_cross_kv)
    if cross_fault is not None:
        cross = cross_fault(cross)
    cache = init_kv_cache(cfg, 2, len(prefix) + 3, d)
    toks = torch.tensor(prefix, device=d).expand(2, -1)
    logits, cache = decoder_forward(params, toks, None, cfg, 0, cache, cross)
    steps = [logits[:, -1]]
    positions = torch.arange(len(prefix) + 3, dtype=torch.int32, device=d)
    cross_len = torch.full((1,), int(xa.shape[1] * cross_len_scale),
                           dtype=torch.int32, device=d)
    emb32 = params["decoder"]["tok_emb"].float()
    for i, tok in enumerate((65, 70, 75)):
        pos = len(prefix) + i
        token = torch.full((2,), tok, dtype=torch.long, device=d)
        steps.append(decode_step(params, token,
                                 StepLengths(positions[pos:pos + 1],
                                             cross_len),
                                 cache, cross, cfg, emb32))
    return xa.float().cpu(), torch.stack(steps).cpu()


def _drop_last_block(params, part):
    return {**params, part: {**params[part],
                             "blocks": params[part]["blocks"][:-1]}}


def _reverse_last_block_scales(params, part):
    """The last block's int8 weights with each ``s`` reversed: scales on
    the wrong output channels."""
    def flip(node):
        if isinstance(node, dict) and "q" in node:
            return {"q": node["q"], "s": node["s"].flip(0)}
        if isinstance(node, dict):
            return {k: flip(v) for k, v in node.items()}
        return node
    blocks = params[part]["blocks"]
    return {**params, part: {**params[part],
                             "blocks": blocks[:-1] + [flip(blocks[-1])]}}


def _last_cross_scales(fault: str):
    """A cross-K/V rewrite: the last layer's int8 scales ``dropped`` (all
    ones) or ``swapped`` (K's for V's, an argument-order slip)."""
    def rewrite(cross):
        k_q, k_s, v_q, v_s = cross[-1]
        if fault == "swapped":
            k_s, v_s = v_s, k_s
        else:
            k_s, v_s = torch.ones_like(k_s), torch.ones_like(v_s)
        return cross[:-1] + [(k_q, k_s, v_q, v_s)]
    return rewrite


def _to(tree, d):
    if isinstance(tree, dict):
        return {k: _to(v, d) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, d) for v in tree]
    return tree.to(d)


def phase_tiny(dev, int8: bool) -> None:
    """The test config in bf16 (``int8``: int8 weights and int8 cross K/V
    on bf16 activations) on the card vs the CPU, then faults run on the
    card: each must exceed its tolerance, so the tolerances are shown to
    catch them.  bf16: a dropped encoder layer, a dropped decoder layer,
    half the cross length in the decode steps; int8: the last encoder
    block's weight scales reversed, the last decoder layer's cross-K/V
    scales dropped, or swapped between K and V."""
    from manual_whisper_tpu_torch.models.whisper import (MODEL_CONFIGS,
                                                         init_params)
    from manual_whisper_tpu_torch.ops.quant import quantize_params
    cfg = MODEL_CONFIGS["test"].with_dtype(torch.bfloat16)
    cpu = torch.device("cpu")
    params_cpu = init_params(cfg, cpu, seed=7)
    if int8:
        params_cpu = quantize_params(params_cpu)
    params_gpu = _to(params_cpu, dev)
    rng = np.random.default_rng(7)
    n = cfg.n_audio_ctx * 2 * 160
    audio = (0.1 * rng.standard_normal((2, n))).astype(np.float32)
    prefix = [257, 258, 359, 362, 65, 66]

    def run(params, d, **kw):
        return _tiny_forward(params, cfg, audio, prefix, d,
                             int8_cross_kv=int8, **kw)

    enc_ref, logits_ref = run(params_cpu, cpu)
    enc, logits = run(params_gpu, dev)
    for t in (enc, logits):
        if not torch.isfinite(t).all():
            raise AssertionError("tiny config: non-finite output on the card")
    if int8:
        faults = {
            "weight_scales_reversed": run(
                _reverse_last_block_scales(params_gpu, "encoder"), dev),
            "cross_scales_dropped": run(
                params_gpu, dev, cross_fault=_last_cross_scales("dropped")),
            "cross_scales_swapped": run(
                params_gpu, dev, cross_fault=_last_cross_scales("swapped"))}
        caught = {"weight_scales_reversed": "encoder",
                  "cross_scales_dropped": "logits",
                  "cross_scales_swapped": "logits"}
    else:
        faults = {
            "encoder_layer_dropped": run(
                _drop_last_block(params_gpu, "encoder"), dev),
            "decoder_layer_dropped": run(
                _drop_last_block(params_gpu, "decoder"), dev),
            "cross_len_halved": run(params_gpu, dev, cross_len_scale=0.5)}
        caught = {"encoder_layer_dropped": "encoder",
                  "decoder_layer_dropped": "logits",
                  "cross_len_halved": "logits"}
    suffix = "_int8" if int8 else ""
    fault_errs = {name: {"encoder_max_abs_err": max_err(out[0], enc_ref),
                         "logits_max_abs_err": max_err(out[1], logits_ref)}
                  for name, out in faults.items()}
    log(json.dumps({"phase": "tiny_test_config" + suffix,
                    "encoder_max_abs_err": max_err(enc, enc_ref),
                    "encoder_tol": TOL["encoder" + suffix],
                    "encoder_std": float(enc_ref.std()),
                    "logits_max_abs_err": max_err(logits, logits_ref),
                    "logits_tol": TOL["logits" + suffix],
                    "logits_std": float(logits_ref.std()),
                    "faults": fault_errs}))
    compare("encoder" + suffix, enc, enc_ref)
    compare("logits" + suffix, logits, logits_ref)
    for name, what in caught.items():
        if fault_errs[name][f"{what}_max_abs_err"] <= TOL[what + suffix][0]:
            raise AssertionError(f"tiny config: the {what} tolerance does "
                                 f"not catch the fault {name}: "
                                 f"{fault_errs[name]}")


# ---------------------------------------------------------------------------
# Phase 4: the main path at large-v3
# ---------------------------------------------------------------------------

def synthetic_speech(seconds: float, seed: int) -> np.ndarray:
    """Seeded amplitude-modulated audio: harmonic bursts of 0.3-2 s with
    pauses, over a low noise floor, so the energy VAD finds many regions."""
    rng = np.random.default_rng(seed)
    sr = 16000
    out = 0.003 * rng.standard_normal(int(seconds * sr)).astype(np.float32)
    cursor = 0.5
    while cursor < seconds - 1.0:
        dur = float(rng.uniform(0.3, 2.0))
        n = int(min(dur, seconds - cursor) * sr)
        tt = np.arange(n) / sr
        f0 = float(rng.uniform(110, 260))
        burst = sum(np.sin(2 * np.pi * f0 * k * tt) / k for k in (1, 2, 3))
        env = np.sin(np.pi * tt / (n / sr)) * (0.5 + 0.5 * np.sin(
            2 * np.pi * 4.0 * tt))
        s = int(cursor * sr)
        out[s:s + n] += (0.25 * burst * env).astype(np.float32)
        cursor += dur + float(rng.uniform(0.2, 1.2))
    return out


BATCH = 4


def load_main_model(compute_type: str, int8_cross_kv: bool):
    """large-v3 at full width and depth, seeded random weights, the CLI's
    asr_options; returns (model, load seconds)."""
    from manual_whisper_tpu_torch.pipeline import load_model
    from manual_whisper_tpu_torch.text import INITIAL_PROMPT
    os.environ["MWX_ALLOW_RANDOM_WEIGHTS"] = "1"
    t0 = time.perf_counter()
    model = load_model("large-v3", device="cuda", compute_type=compute_type,
                       language="zh",
                       asr_options={"initial_prompt": INITIAL_PROMPT,
                                    "beam_size": 1,
                                    "int8_cross_kv": int8_cross_kv})
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def main_path_shapes(model) -> dict:
    """The decode attentions' shapes on the main path: batch rows, heads,
    width, head dim, prompt length, self-cache slots (prompt + max_new) and
    cross positions, from the decoder ``transcribe`` uses."""
    cfg = model.cfg
    decoder = model._decoder("zh", 0.0)
    prefix, _ = decoder._prefix()
    max_new = min(decoder.opts.max_new_tokens,
                  cfg.n_text_ctx - len(prefix) - 1)
    return {"batch": BATCH, "heads": cfg.n_text_head, "d": cfg.n_text_state,
            "dh": cfg.n_text_state // cfg.n_text_head,
            "prefix": len(prefix), "t_max": len(prefix) + max_new,
            "ta": cfg.n_audio_ctx}


def expected_launches(cfg, stats: dict, int8: bool) -> dict:
    """Launches the main path implies for the batches, decode loops and
    steps in ``last_stats``: K1 once and K2 once per encoder layer per
    batch; per decode step K3 and the cross kernel (K4, or K5 for int8)
    once per decoder layer; K6 for every block matmul: 6 per encoder layer
    per batch, per decoder layer 2 (cross K/V) + 8 (prefill) per decode
    loop and 8 per step."""
    le, ld = cfg.n_audio_layer, cfg.n_text_layer
    batches, calls = stats["batches"], stats["decode_calls"]
    steps = stats["decode_steps"]
    exp = {"mel": batches, "flash_attention": le * batches,
           "decode_self_attention": ld * steps}
    if int8:
        exp["decode_cross_attention_int8"] = ld * steps
        exp["int8_matmul"] = 6 * le * batches + 10 * ld * calls \
            + 8 * ld * steps
    else:
        exp["decode_cross_attention"] = ld * steps
    return exp


def graph_replays(decoder) -> dict:
    """Replays so far of each captured chunk of ``decoder``, by (rows,
    steps of the chunk)."""
    return {(key[0], n): loop.graphs.replays[n]
            for key, loop in decoder._loops.items()
            for n in loop.graphs.graphs}


def phase_main(model, load_s: float, compute_type: str) -> dict:
    """``warmup`` (timed alone; it captures the decode chunks of batch
    buckets 1, 2 and 4), then the launch counters are zeroed and
    ``transcribe`` runs.  Every decode step must have run inside a replayed
    chunk, and the launches must be the ones ``last_stats`` implies."""
    audio = synthetic_speech(75.0, seed=0)
    duration = len(audio) / 16000.0
    int8 = compute_type == "int8"

    torch.cuda.reset_peak_memory_stats()
    decoder = model._decoder("zh", 0.0)
    if not decoder.captured:
        raise AssertionError("the pipeline's decoder does not capture")
    t0 = time.perf_counter()
    model.warmup(batch_size=BATCH, language="zh")
    warmup_s = time.perf_counter() - t0
    capture_s = decoder.stats["capture_s"]
    replays_before = graph_replays(decoder)
    _build.launches.clear()
    t0 = time.perf_counter()
    result = model.transcribe(audio, batch_size=BATCH, language="zh")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    replays = {k: n - replays_before.get(k, 0)
               for k, n in graph_replays(decoder).items()}

    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    stats = model.last_stats
    segs = result["segments"]
    if result["language"] != "zh" or not isinstance(segs, list):
        raise AssertionError(f"bad result shape: {result!r:.200}")
    if stats["windows"] < 2:
        raise AssertionError(f"expected several windows, got {stats}")
    for s in segs:
        if not (0.0 <= s["start"] < s["end"] <= duration + 1e-6) \
                or not isinstance(s["text"], str) \
                or not math.isfinite(s["avg_logprob"]):
            raise AssertionError(f"bad segment {s}")
    expected = expected_launches(model.cfg, stats, int8)
    if launches != expected or 0 in expected.values():
        raise AssertionError(f"{compute_type} main path: launches {launches}"
                             f", expected {expected} (every kernel of the "
                             f"path, and no other)")
    replayed_steps = sum(n * count for (_, n), count in replays.items())
    if replayed_steps != stats["decode_steps"]:
        raise AssertionError(f"{compute_type} main path: {replayed_steps} "
                             f"steps replayed, {stats['decode_steps']} run")
    log(json.dumps({
        "phase": "main_path", "model": "large-v3",
        "compute_type": compute_type,
        "int8_cross_kv": model.asr_options.get("int8_cross_kv", False),
        "load_s": load_s, "warmup_s": warmup_s, "capture_s": capture_s,
        "audio_s": duration, "wall_s": wall, "rtf": wall / duration,
        "vad_s": stats["vad_s"], "mel_encode_s": stats["encode_s"],
        "decode_s": stats["decode_s"], "batches": stats["batches"],
        "windows": stats["windows"], "rows": stats["rows"],
        "decode_calls": stats["decode_calls"],
        "decode_steps": stats["decode_steps"],
        "token_rows": stats["token_rows"],
        "ms_per_token_row": 1e3 * stats["decode_s"]
        / max(stats["token_rows"], 1),
        "rung_rows": stats["rung_rows"], "segments": len(segs),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "clocks_power_temp_after": clocks,
        "replays": {f"rows={r} steps={n}": c
                    for (r, n), c in sorted(replays.items()) if c},
        "launches": launches}))
    return launches


# graph vs eager: sum_logprob of one loop (same kernels in the same order,
# so equal is expected; the limit only names the gap that fails)
SUM_LP_TOL = 1e-3


def phase_graph_vs_eager(model, compute_type: str) -> None:
    """One batch-4 loop at T = 0 and one at T = 0.2, replayed (the
    pipeline's decoder, captured by ``warmup``) against the same chunk run
    eagerly (``BatchDecoder(eager=True)``), on the encoder states of four
    30 s windows of synthetic speech: tokens and lengths must be equal,
    sum_logprob within SUM_LP_TOL."""
    from manual_whisper_tpu_torch.models.decode import BatchDecoder
    decoder = model._decoder("zh", 0.0)
    eager = BatchDecoder(model.params, model.cfg, model.tokenizer,
                         decoder.opts, model.device, eager=True)
    windows = synthetic_speech(BATCH * model.window_sec, seed=1).reshape(
        BATCH, -1)
    xa = model._encode_windows(windows)
    line = {"phase": "graph_vs_eager", "compute_type": compute_type,
            "int8_cross_kv": decoder.opts.int8_cross_kv, "batch": BATCH,
            "sum_logprob_tol": SUM_LP_TOL}
    for temp in (0.0, 0.2):
        outs, ms = {}, {}
        for name, dec in (("graph", decoder), ("eager", eager)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[name] = dec.decode_submit(xa, temp, rng_tag=11)
            torch.cuda.synchronize()
            ms[name] = 1e3 * (time.perf_counter() - t0) / (
                BATCH * outs[name].steps)
        g, e = outs["graph"], outs["eager"]
        row = {"tokens_equal": torch.equal(g.tokens, e.tokens),
               "lengths_equal": torch.equal(g.lengths, e.lengths),
               "steps": [g.steps, e.steps],
               "sum_logprob_max_abs_diff": max_err(g.sum_logprob,
                                                   e.sum_logprob),
               "ms_per_token_row_graph": ms["graph"],
               "ms_per_token_row_eager": ms["eager"]}
        line[f"T={temp}"] = row
        if not (row["tokens_equal"] and row["lengths_equal"]
                and g.steps == e.steps
                and row["sum_logprob_max_abs_diff"] <= SUM_LP_TOL):
            log(json.dumps(line))
            raise AssertionError(f"{compute_type}: the replayed loop differs "
                                 f"from the eager one at T={temp}")
    log(json.dumps(line))


# ---------------------------------------------------------------------------
# Phase 5: where the time goes (torch.profiler over short windows)
# ---------------------------------------------------------------------------

def _profiled(fn, reps: int) -> dict:
    """Time ``reps`` calls of fn() on the host clock (ending in a
    synchronise), then run them again under torch.profiler and sum the
    device time of the CUDA kernels.  Busy share = kernel time / wall time
    of the unprofiled run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    rows = sorted(((us, name, n) for name, (us, n) in by_name.items()),
                  reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3
    return {"wall_ms_per_rep": wall_ms / reps,
            "device_ms_per_rep": device_ms / reps,
            "device_busy_share": device_ms / wall_ms,
            "kernel_launches_per_rep": sum(r[2] for r in rows) / reps,
            "top": [{"kernel": name[:70], "ms_per_rep": us / 1e3 / reps,
                     "calls_per_rep": n / reps}
                    for us, name, n in rows[:8]]}


def phase_profile(model, main: dict, compute_type: str) -> None:
    from manual_whisper_tpu_torch.models.whisper import (
        StepLengths, decode_step, encode, init_kv_cache, precompute_cross_kv)
    cfg, params, dev = model.cfg, model.params, model.device
    b = main["batch"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    mel = torch.randn((b, cfg.n_mels, 2 * cfg.n_audio_ctx), generator=gen,
                      device=dev)
    enc = _profiled(lambda: encode(params, mel, cfg), reps=2)
    xa = encode(params, mel, cfg)
    cross = precompute_cross_kv(
        params, xa, cfg,
        quantize=model.asr_options.get("int8_cross_kv", False))
    cache = init_kv_cache(cfg, b, main["t_max"], dev)
    positions = torch.arange(main["t_max"], dtype=torch.int32, device=dev)
    cross_len = torch.full((1,), xa.shape[1], dtype=torch.int32, device=dev)
    emb32 = params["decoder"]["tok_emb"].float()
    state = {"pos": (main["prefix"] + main["t_max"]) // 2 - 8,
             "tok": torch.zeros(b, dtype=torch.long, device=dev)}

    def step():
        pos = state["pos"]
        logits = decode_step(params, state["tok"],
                             StepLengths(positions[pos:pos + 1], cross_len),
                             cache, cross, cfg, emb32)
        state["tok"] = logits.argmax(-1)
        state["pos"] = pos + 1

    dec = _profiled(step, reps=16)
    log(json.dumps({"phase": "profile", "compute_type": compute_type,
                    "batch": b,
                    "first_pos": (main["prefix"] + main["t_max"]) // 2 - 8,
                    "encode": enc,
                    "decode_step": dec}))
    phase_profile_chunks(model, xa, compute_type)


def _event_ms(fn, reps: int) -> float:
    """Device time of ``reps`` calls of fn() between two CUDA events (gaps
    between kernels included), per call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_profile_chunks(model, xa, compute_type: str) -> None:
    """The pipeline's batch-4 decode loop (captured by ``warmup``): one
    replay of its 16-step chunk beside the same chunk run eagerly, both
    from step 97 (pos 289 of 417), and the cross K/V and the prefill that
    run eagerly once a loop."""
    from manual_whisper_tpu_torch.models.whisper import (decoder_forward,
                                                         precompute_cross_kv)
    decoder = model._decoder("zh", 0.0)
    loop = next(lp for key, lp in decoder._loops.items() if key[0] == BATCH)
    params, cfg, first = model.params, model.cfg, 97
    prefix, _ = decoder._prefix()
    prefix_b = torch.tensor(prefix, device=xa.device).expand(BATCH, -1)

    def cross_kv():
        precompute_cross_kv(params, xa, cfg, quantize=loop.quantize,
                            scale_dtype=loop.scale_dtype, out=loop.cross)

    def prefill():
        decoder_forward(params, prefix_b, None, cfg, 0, loop.cache,
                        loop.cross)

    def rewind():
        loop.state.i.fill_(first)
        loop.state.pos.fill_(loop.p + first - 1)
    n = 16
    rewind()
    replay = _profiled(lambda: loop.run_chunk(n), reps=2)
    rewind()
    replay["event_ms_per_rep"] = _event_ms(lambda: loop.run_chunk(n), 4)
    rewind()
    eager = _profiled(lambda: loop._chunk(n), reps=2)
    out = {"phase": "profile_chunk", "compute_type": compute_type,
           "batch": BATCH, "steps": n, "first_pos": loop.p + first - 1,
           "launch_delta": dict(loop.graphs.launch_delta[n]),
           "cross_kv": _profiled(cross_kv, reps=2),
           "prefill": _profiled(prefill, reps=2),
           "chunk_replay": replay, "chunk_eager": eager}
    for name in ("chunk_replay", "chunk_eager"):
        out[name]["wall_ms_per_step"] = out[name]["wall_ms_per_rep"] / n
        out[name]["device_ms_per_step"] = out[name]["device_ms_per_rep"] / n
    log(json.dumps(out))


def _host_us(fn, n: int = 200) -> float:
    """Host time to issue one call, mean over n calls after a warm-up; the
    timed loop ends before the synchronise, so it measures the enqueue."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def phase_host_costs(dev, main: dict) -> None:
    """Host time per call of the int8 decode step's wrappers against the
    bf16 step's calls they replace, at the decode step's shapes: K6
    through ``mm`` vs ``x @ w`` on a bf16 weight (cuBLAS), K5 vs K4."""
    from manual_whisper_tpu_torch.models.whisper import quantize_cross_kv
    from manual_whisper_tpu_torch.ops.quant import mm
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()
    b, h, d, dh, ta = (main[k] for k in ("batch", "heads", "d", "dh", "ta"))
    x = randn((b, 1, d))
    w = quantize_weight(randn((d, 4 * d)).float() / math.sqrt(d))
    w_bf16 = (w["q"].float() * w["s"]).bfloat16()
    q, k, v = randn((b, h, 1, dh)), randn((b, h, ta, dh)), randn((b, h, ta, dh))
    kv4 = quantize_cross_kv(k, v)
    len_t = torch.full((1,), ta, dtype=torch.int32, device=dev)
    log(json.dumps({
        "phase": "host_us_per_call", "batch": b,
        "int8_matmul_via_mm": _host_us(lambda: mm(x, w)),
        "bf16_matmul": _host_us(lambda: x @ w_bf16),
        "decode_cross_attention_int8": _host_us(
            lambda: decode_cross_attention_int8(q, *kv4, len_t)),
        "decode_cross_attention": _host_us(
            lambda: decode_cross_attention(q, k, v, len_t))}))


def timed(label: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"phase {label}: {time.perf_counter() - t0:.1f}s")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", default="", metavar="KERNEL[,KERNEL]",
                    help="only build, check and time these kernels' rows "
                         "(mel, flash_attention, decode_self_attention, "
                         "decode_cross_attention, "
                         "decode_cross_attention_int8, int8_matmul), then "
                         "stop without a result line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f}s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "wgmma",
                                       "setmaxnreg")):
                log(f"  ptxas {name}: {line.strip()}")

    model, load_s = load_main_model("bfloat16", False)
    main_shapes = main_path_shapes(model)
    log(json.dumps({"phase": "main_path_shapes", **main_shapes}))
    if args.rows:
        timed("rows", phase_rows, dev, main_shapes, args.rows.split(","))
        return 0
    rows = timed("kernels", phase_kernels, dev, main_shapes)
    timed("host costs", phase_host_costs, dev, main_shapes)
    timed("tiny bf16", phase_tiny, dev, False)
    timed("tiny int8", phase_tiny, dev, True)
    launches = {}
    for compute_type, kernels in (("bfloat16", BF16_KERNELS),
                                  ("int8", INT8_KERNELS)):
        if compute_type == "int8":     # one model on the card at a time
            del model
            torch.cuda.empty_cache()
            model, load_s = load_main_model("int8", True)
        found = timed(f"main {compute_type}", phase_main, model, load_s,
                      compute_type)
        launches.update({k: found[k] for k in kernels if k not in launches})
        timed(f"graph vs eager {compute_type}", phase_graph_vs_eager, model,
              compute_type)
        timed(f"profile {compute_type}", phase_profile, model, main_shapes,
              compute_type)

    kernels = []
    for name, row in rows.items():
        src, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "tol": TOL[name],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound"][0], "bound_by": row["bound"][1],
            "library_ms": row["library_ms"], "shape": row["shape"]})
    log(f"card: {card_line()}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
