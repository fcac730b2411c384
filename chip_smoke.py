#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --rows decode_self_attention,int8_matmul
    python3 chip_smoke.py --phases align,diarize,cli
    python3 chip_smoke.py --phases train,mesh
    python3 chip_smoke.py --phases fetch,launch
    python3 chip_smoke.py --phases float32

With ``--rows`` only phase 1 and the named kernels' checks and timed rows
run (for work on one kernel; the names are ``mel``, ``flash_attention``,
``decode_self_attention``, ``decode_cross_attention``,
``decode_cross_attention_int8``, ``int8_matmul``, ``add_layer_norm`` and
the float32 builds ``flash_attention_f32``, ``decode_self_attention_f32``,
``decode_cross_attention_f32`` and ``add_layer_norm_f32``); with
``--phases``
only the kernels' build and the named phases of stage 6, or ``float32``
(phases 3-5's float32 parts: the tiny config, ``.synth_ckpt`` and
large-v3's main path); neither prints a result line.

Phases (any failure exits non-zero; no phase's exception is swallowed):

1. Print the card (``nvidia-smi``), torch and CUDA versions; build the
   CUDA kernels K1-K6 from ``manual_whisper_tpu_torch/csrc`` with nvcc;
   load large-v3 at full width and depth with seeded random weights in
   bf16 and read the decode attentions' shapes from it.  The int8 model
   (``compute_type="int8"``, ``int8_cross_kv=True``) and then the float32
   model are each loaded in their turn in phase 4, after the one before is
   freed.
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
   shapes and every M > 8 shape of the int8 path: M = 4 x 1500,
   M = 4 x 193 and the beam step's M = 10, 20 and 80, each with 1280x1280,
   1280x5120 and 5120x1280; two
   ``kernel_check`` lines hold ragged tiles and the matvec at M in {1, 2,
   3, 5, 8} against the plain version);
   K3 and K4 also at batch 16 (extra).  The decode step's fused bias +
   residual add + LayerNorm (``add_layer_norm``, bf16 and float32; no
   Pallas counterpart) is checked at R in {1, 5, 16, 80} and d in {64,
   384, 1280} (h_new the plain version's bits, y within one bf16 ulp or
   1e-6) and timed at R = 16, d = 1280 (the main path's batch extra), its
   plain version (five to seven ATen launches) beside it and no library
   call.  The float32 builds of K2-K4
   (``compute_type="float32"``) have rows of their own at the bf16 rows'
   shapes with the same ragged and empty-slice checks, within (1e-4,
   1e-4); their yardstick is SDPA on float32 inputs with TF32 off, whose
   device kernels (the backend PyTorch picked) are on the row's line.
   K2 f32's bound is its 3xTF32 products at the TF32 rate, with the FMA
   pipes', the exponentials' and the bytes' times beside it; its row also
   holds it at a sharp softmax (keys scaled 3x), its ragged check at key
   lengths around its 64-key step.  K3 f32's row names the launch shape
   the library picked and the empty-launch floor of its split
   (kernel_variants' ``probe_empty_split{s}``), checks the edges of its
   slices and passes, and has a batch-16 line (its wide shape).
   K1 is also checked and timed at
   diarization's shapes on raw log-mel of zero-padded rows (extra lines,
   TOL["mel_raw"]): 32 rows of each embedding length bucket (0.5, 1, 2, 4
   and 10 s) at 80 mels (the ResNet34) and at 40 (the statistics
   embedding; K1's 32-wide band table), and 256 rows of 3 s at 40 mels.
3. Run the tiny ``test`` config through the port on the card and on the
   CPU (plain versions), in bf16 and in int8 (int8 weights and int8 cross
   K/V on bf16 activations): encoder output and the logits of a prefill
   plus three decode steps must agree within tolerance, and faults run on
   the card (bf16: a dropped encoder layer, a dropped decoder layer, half
   the cross length; int8: one layer's weight scales on the wrong output
   channels, one layer's cross-K/V scales dropped or swapped between K
   and V) must each exceed it.  Then ``.synth_ckpt`` (the test config
   trained on synthetic speech, the JAX package's orbax tree) through
   ``from_hf.load_params``, ``convert.from_jax_tree`` and the pipeline on
   the card and on the CPU, bf16: logits within TOL["logits_synth"], two
   dropped-layer faults caught, each row's tokens and the segments
   compared (rows that differ printed), the rows ended on EOT printed (at
   least one), K1-K4 launched.  Then both again in float32 (the float32
   builds of K2-K4 on the card, the port's float32 path on the CPU):
   encoder and logits within 1e-3, the same faults caught, and for
   ``.synth_ckpt`` each row's tokens and the segments equal, the float32
   builds launched and no bf16 one.  Then the ``vad``
   phase: PyanNet from the registry's ``pyannote-segmentation-3.0/jax``
   tree on the card against the same weights on the CPU, over phase 4's
   audio: speech
   probabilities within TOL["vad"] and regions equal; two faults (the
   LSTM's directions swapped, the norm after the first conv dropped) must
   each exceed the tolerance; a 16-row and a 4-row block timed with CUDA
   events.
4. The main paths: ``warmup(batch_size=4, language="zh")`` (timed alone
   as ``warmup_s``; it captures the decode chunks of batch buckets 1, 2
   and 4 as CUDA graphs, ``capture_s``), then ``transcribe`` of about 75 s
   of seeded amplitude-modulated audio at batch 4, language zh, with the
   CLI's options and the full temperature ladder, with the bf16 model,
   then with the int8 model, then with the float32 model.  Launch counters are zeroed just before each
   ``transcribe`` and read just after; the pipeline's VAD must be PyanNet
   on the card (the ``main_path`` line says ``"vad": "pyannet"``); bf16
   must launch K1-K4 and not
   K5/K6; float32 K1 and the float32 builds of K2-K4 and no other; int8
   must launch K1, K2, K3, K5 and K6 and not K4, each exactly
   as often as the batches, decode loops and steps in ``last_stats`` imply
   (a replay adds the launches its capture recorded), and every decode
   step must have run inside a replayed chunk.  Then a ``graph_vs_eager``
   line: one batch-4 loop at T = 0 and one at T = 0.2, replayed against
   the same chunks run eagerly, tokens and lengths equal, sum_logprob
   within SUM_LP_TOL, ms per token row of each.
   Then, with the bf16 and int8 models after their phases 4 and 5 (not
   float32), ``beam`` and ``timestamps``: pipelines over the same weights
   with ``beam_size=5``, and with ``without_timestamps=False``; ``warmup`` and ``transcribe`` of
   the same audio at batch 4 (beam: one beam loop and five greedy rungs a
   batch; timestamps: one loop a batch, no ladder), launches exact (a beam
   step launches no K3/K4/K5, and for int8 8 K6 a layer, at M = rows x
   beams in the eager loop's calls), every beam, greedy and timestamp step inside a replay, every
   timestamp row decoded held to the four rules by a host checker
   (``timestamp_rule_violations``), peak memory, one loop of each replayed
   against the same loop eager; the beam phase then runs one batch-16
   beam loop with the server's 4-token prompt for its peak memory.
5. Where the time goes: ``torch.profiler`` over one batch-4 encoder pass
   and 16 eager decode steps of each model (device-busy share, top
   kernels, and each of csrc/'s kernels with its share of the device
   time, ``ours``), and over one replay of the 16-step chunk beside the same
   chunk run eagerly and the cross K/V and the prefill of a loop, run right
   after that model's phase 4; before phase 3, the host time to issue one
   call of K6 (through ``mm``) and K5 against the bf16 step's cuBLAS
   matmul and K4.

6. The speech stages after transcription, with the phase-4 model freed.
   ``checkpoint``: the four orbax trees (``.synth_ckpt`` and the
   registry's ``jax/`` trees) read by the port's reader on the card's
   host, each tree's leaves, bytes and read ms printed; the PyanNet and
   aligner trees bit-equal to their committed ``pytorch_model.bin``
   exports through the port's converters; a flipped byte in a chunk of a
   copy fails the read.
   ``align``: the repository's synthetic aligner from its orbax tree on
   the card against the CPU over 6 seeded synthetic files (log-probs
   within TOL["align_logprobs"], words equal, word-timing scores equal, a
   dropped ``n_valid`` mask caught), then wav2vec2 at full width and depth
   (XLSR-53 large, seeded random weights) aligning segments of phase 4's
   audio in every length bucket, with device ms of an 8-row forward per
   bucket, and full-width logits (2 layers) card vs CPU.  ``diarize``:
   ``DiarizationPipeline`` on a 3-speaker conversation of about 2 minutes,
   the registry's PyanNet and its ResNet34 trained on synthetic speakers
   (both from their orbax trees), card vs CPU (embeddings within
   TOL["diarize_emb"], segments and DER equal, the speakers printed, K1
   launched once a 32-row forward at 80 mels, a swapped BatchNorm
   caught), then the statistics-embedding and windows
   fallbacks card vs CPU, with device and host times.  ``cli``:
   ``cli.main`` on a WAV of that conversation with ``HF_TOKEN`` set,
   random large-v3 and the trained ResNet34: every stage runs (no alignment or diarization failure
   line), the Markdown has speaker headings, every segment a speaker.
   ``train``: the test config's AdamW steps at f32 card vs CPU (TRAIN_TOL;
   the loss mask ignored must exceed it), then three bf16 steps of
   large-v3 at full width and depth on a batch of two 30 s windows (K1
   once a step, no K2; losses finite and falling; ms per step and peak
   memory).  ``mesh``: a one-rank NCCL world, whose mesh runs every
   collective of the mesh path: ``load_model(mesh=make_mesh(1, 1))`` at
   large-v3 transcribes phase 4's audio to the meshless pipeline's
   segments, launches exact, the all-reduces captured in the decode
   chunks, and a test-config train step with the mesh equals the step
   without, with every all-reduce of the sharded step made; K2-K6 held to their plain
   versions at the local shapes of a tp=2 shard of large-v3; with two or
   more GPUs a dp=2 ``parallel.dryrun`` under torchrun (else a
   ``mesh_multi`` line with ``"ran": false``).  ``fetch``: the
   pipeline's fetch worker at large-v3 (bf16, batch 4) on about 400 s of
   seeded speech (at least four batches), with the log-prob gate set so
   that one or two rows of the first batch climb the ladder in a bucket
   that ``warmup`` captured but the phase dropped, so the worker thread
   captures it: worker and ``MWX_FETCH_WORKER=0`` give equal segments and
   counts, launches exact, every step replayed; both walls printed.
   ``launch``: the CLI alone and under ``torchrun --nproc-per-node 1``
   (a one-rank NCCL world through ``parallel/launch.py``'s leader path),
   Markdown equal; one server job through ``launch.Leader`` in a one-rank
   world; with two or more GPUs the CLI on every GPU (else a
   ``launch_multi`` line with ``"ran": false``).
7. The job server (``serve``): the port's
   native audio libraries are built (libmwx_audio must build, libmwx_ffdec
   must where g++ finds the FFmpeg headers) and each suffix's route
   printed, with the host ms to decode and resample a minute of 44.1 kHz
   stereo audio through each route the machine has (``serve_native``);
   then ``PipelineBackend`` (large-v3, bf16, batch 16) is warmed up
   (buckets 2, 4, 8 and 16 captured) and served by ``create_server`` on
   127.0.0.1: a 16 kHz WAV, about 9 min of audio (at least 16 windows), a
   44.1 kHz stereo FLAC and an m4a (refused with the zh-CN message where
   the FFmpeg shim is missing) go through upload, create and polls, with
   a second pass (``transcribe_clip`` on the server's thread) decoding
   beside the long job; the WAV job also asks for word alignment and
   diarization, and its segments must carry speakers (the diarizer's K1
   launches are counted apart); every job must succeed on
   ``load_audio``'s audio,
   a 16-row loop must replay, and the launches of both threads must be
   the ones their calls' stats imply.  One ``serve_request`` line a job,
   then a ``serve`` line (warmup, capture, peak memory with both decoders
   resident, ms per token row and replayed step time per bucket).

The kernels line gives each kernel's launches on the main path that
runs it (K1-K4 bf16, K5 and K6 int8, the float32 builds of K2-K4 float32;
the int8 and float32 paths' K1 counts are on their ``main_path`` lines).  The line before the last is
``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA it exits 2 and prints no
result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import dataclasses
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
from manual_whisper_tpu_torch.ops.norm import (add_layer_norm,
                                               add_layer_norm_plain)
from manual_whisper_tpu_torch.ops.quant import (int8_matmul,
                                                int8_matmul_plain,
                                                quantize_weight)

# published H100 SXM peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12        # non-tensor-core float32
TF32_FLOPS = 495e12      # TF32 tensor cores
BF16_FLOPS = 989e12      # bf16 tensor cores
SMS = 132
SPEC_CLOCK_HZ = 1.83e9   # the SM clock those peaks assume (989e12 / 132 /
                         # 4096 bf16 operations a cycle and SM)
L2_BYTES = 50 * 2 ** 20

# (atol, rtol): |kernel - plain| <= atol + rtol * |plain| elementwise
TOL = {"mel": (1e-3, 0.0),                   # normalised log-mel, both f32
       # bf16 outputs: the kernels keep P and the sums in f32, the plain
       # versions round P to bf16 (one bf16 ulp is 2^-8 relative)
       "flash_attention": (1e-2, 1e-2),
       "decode_self_attention": (1e-2, 1e-2),
       "decode_cross_attention": (1e-2, 1e-2),
       "decode_cross_attention_int8": (1e-2, 1e-2),
       # the float32 builds of K2-K4 against their plain versions, both
       # float32 throughout (TF32 off), summing in other orders
       "flash_attention_f32": (1e-4, 1e-4),
       "decode_self_attention_f32": (1e-4, 1e-4),
       "decode_cross_attention_f32": (1e-4, 1e-4),
       # bf16 output of an f32 sum of exact products: one bf16 rounding
       "int8_matmul": (1e-2, 1e-2),
       # the decode step's LayerNorm against the plain version's (ATen's
       # LayerNorm in float32): the statistics summed in another order, so
       # y within one bf16 ulp (at most 2^-7 relative), or 1e-6 in
       # float32; h_new must be the same bits (checked apart)
       "add_layer_norm": (1e-6, 2.0 ** -7),
       "add_layer_norm_f32": (1e-6, 1e-6),
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
       "logits_int8": (0.015, 0.0),
       # the test config in float32 (TF32 off), card vs CPU: float32
       # rounding in other summation orders only; the faults phase 3 runs
       # move the encoder or the logits by far more (in bf16 the smallest,
       # half the cross length, moved the logits by 0.099)
       "encoder_f32": (1e-3, 0.0),
       "logits_f32": (1e-3, 0.0),
       # .synth_ckpt in float32, card vs CPU: its trained logits (std 0.79)
       # amplify rounding more than random weights do, but in float32 it is
       # float32 rounding; its faults move the logits by 5.0 and 6.2 (CPU)
       "logits_synth_f32": (1e-3, 0.0),
       # .synth_ckpt (the test config trained on synthetic speech) in bf16,
       # card vs CPU: its logits' std is 0.79, five times the random
       # weights', and bf16 rounding moves them further: on the CPU its bf16
       # and float32 forwards differ by 0.088 (random weights: 0.0045, where
       # card vs CPU measured 0.0047), so TOL["logits"] cannot hold.  The
       # limit sits about 3x above that; the faults planted with these
       # weights (a dropped encoder or decoder layer) move the logits by
       # 5.0 and 6.2 on the CPU.  The encoder keeps TOL["encoder"] (0.043)
       "logits_synth": (0.25, 0.0),
       # PyanNet's speech probabilities, card vs CPU, both float32 with TF32
       # off: cuDNN sums in another order than the CPU, and the trained
       # network amplifies float32 rounding (the JAX package's CPU forward
       # is up to 1.6e-4 from a float64 evaluation).  On an H100 the error
       # was 1.2e-4 over 75 s; the faults the vad phase plants move
       # probabilities by 0.88 and more
       "vad": (1e-3, 0.0),
       # raw log10-mel (not normalised) at diarization's shapes, rows
       # zero-padded past ragged lengths: both f32, the kernel's folded sums
       # against the plain version's dense products (tests/test_torch_cuda.py
       # holds the same limit)
       "mel_raw": (2e-3, 0.0),
       # wav2vec2 CTC log-probs, card vs CPU, both f32 with TF32 off: the
       # repository's tiny aligner, and full width (2 layers, 4 s); the
       # planted fault (a padded row's n_valid mask dropped) must exceed it
       "align_logprobs": (1e-3, 0.0),
       # speaker embeddings (unit vectors) card vs CPU, both f32 with TF32
       # off: the ResNet34's and the 40-mel statistics embedding's; the
       # planted fault (one BatchNorm's running mean and variance swapped)
       # must exceed it
       "diarize_emb": (1e-3, 0.0)}

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
    "flash_attention_f32": (
        "manual_whisper_tpu_torch/csrc/flash_attention.cu",
        "manual_whisper_tpu/ops/attention.py:32"),
    "decode_self_attention_f32": (
        "manual_whisper_tpu_torch/csrc/decode_attention.cu",
        "manual_whisper_tpu/ops/decode_attention.py:204"),
    "decode_cross_attention_f32": (
        "manual_whisper_tpu_torch/csrc/decode_attention.cu",
        "manual_whisper_tpu/ops/decode_attention.py:150"),
    "int8_matmul": ("manual_whisper_tpu_torch/csrc/int8_matmul.cu",
                    "manual_whisper_tpu/ops/quant.py:102"),
    # no Pallas counterpart: XLA fuses the sequence in the JAX package
    "add_layer_norm": ("manual_whisper_tpu_torch/csrc/add_layer_norm.cu",
                       None),
    "add_layer_norm_f32": ("manual_whisper_tpu_torch/csrc/add_layer_norm.cu",
                           None),
}
BF16_KERNELS = ("mel", "flash_attention", "decode_self_attention",
                "decode_cross_attention", "add_layer_norm")
INT8_KERNELS = ("mel", "flash_attention", "decode_self_attention",
                "decode_cross_attention_int8", "int8_matmul",
                "add_layer_norm")
F32_KERNELS = ("mel", "flash_attention_f32", "decode_self_attention_f32",
               "decode_cross_attention_f32", "add_layer_norm_f32")


def log(msg: str) -> None:
    print(msg, flush=True)


def span_s(stats: dict, name: str) -> float:
    """Seconds of the program span ``name`` in a ``last_stats``, summed
    over the threads that closed it (``manual_whisper_tpu_torch/spans.py``:
    each thread's clock is its own, so loops of the dispatch thread and the
    fetch worker's retries add up to the time spent in loops)."""
    return sum(role.get(name, (0.0,))[0] for role in stats["spans"].values())


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


def _dtype_name(dtype: torch.dtype) -> str:
    return {torch.bfloat16: "bf16", torch.float32: "f32"}[dtype]


def sdpa_kernels(fn, args) -> list:
    """The device kernels of one call ``fn(*args)`` (torch.profiler), by
    name: which SDPA backend PyTorch picked for these inputs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    return sorted({e.name[:90] for e in prof.events()
                   if e.device_type == DeviceType.CUDA})


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


def _decode_bound(b, h, dh, n, elem=2):
    """Bound of one q_len = 1 attention over n positions: K and V read
    once, q read and the output written once (``elem`` bytes a value: 2
    bf16, 4 float32); 4 FLOP per (key, dim)."""
    return bound(4.0 * b * h * n * dh, elem * (2 * b * h * n * dh
                                             + 2 * b * h * dh), F32_FLOPS)


def self_attention_row(randn, dev, b, h, dh, t_max, timed_pos, checks,
                       dtype=torch.bfloat16):
    """K3 (the build of ``dtype``) vs its plain version at every pos in
    ``checks`` (a sharp softmax: keys scaled 3x), then timed over one call
    per pos in ``timed_pos``, each on its own K/V copy."""
    suffix, elem = _build.ATTENTION_DTYPES[dtype], dtype.itemsize
    q = randn((b, h, 1, dh), dtype)
    k = randn((b, h, t_max, dh), dtype, scale=3.0)
    v = randn((b, h, t_max, dh), dtype)
    err = 0.0
    for pos in checks:
        pos_t = torch.full((1,), pos, dtype=torch.int32, device=dev)
        err = max(err, compare("decode_self_attention" + suffix,
                               decode_self_attention(q, k, v, pos_t),
                               attend_plain(q, k, v, pos + 1)))
    reps = max(1, math.ceil(copies_for(2 * k.numel() * elem)
                            / len(timed_pos)))
    sets = [(randn((b, h, 1, dh), dtype), randn((b, h, t_max, dh), dtype),
             randn((b, h, t_max, dh), dtype),
             torch.full((1,), pos, dtype=torch.int32, device=dev), pos + 1)
            for pos in timed_pos * reps]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # one call per set: the mean over the timed positions
    ms, plain_ms, lib_ms = (graph_ms(fn, sets, iters=len(sets)) for fn in (
        lambda a, c, d, pt, n: decode_self_attention(a, c, d, pt),
        lambda a, c, d, pt, n: attend_plain(a, c, d, n),
        lambda a, c, d, pt, n: sdpa(a, c[:, :, :n], d[:, :, :n])))
    bounds = [_decode_bound(b, h, dh, s[4], elem) for s in sets]
    extra = {}
    if dtype == torch.float32:
        a, c, d, _, n = sets[-1]
        extra["library_kernels"] = sdpa_kernels(
            sdpa, (a, c[:, :, :n], d[:, :, :n]))
        shape = self_launch_shape(dtype, b * h)
        extra["launch_shape"] = shape
        extra["empty_launch_ms"] = empty_launch_ms(shape["split"], b * h, dev)
    return dict(**extra,
        shape=(f"B={b} H={h} T_max={t_max} pos={timed_pos[0]}.."
               f"{timed_pos[-1]} ({len(timed_pos)} pos) dh={dh} "
               f"{_dtype_name(dtype)}"),
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound=(sum(x[0] for x in bounds) / len(bounds), bounds[0][1]))


def self_launch_shape(dtype, bh: int) -> dict:
    """K3's launch shape in the build of ``dtype`` at batch x heads ``bh``,
    as the library reports it (``mwx_decode_self_shape``)."""
    import ctypes
    shape = (ctypes.c_int * 3)()
    _build.check(_build.library("decode_attention").mwx_decode_self_shape(
        int(dtype == torch.float32), bh, shape), "mwx_decode_self_shape")
    return dict(zip(("split", "keys", "threads"), shape))


@functools.lru_cache(maxsize=None)
def _empty_probes() -> dict:
    """``kernel_variants``'s empty-launch probes of K3's splits, built once
    (their nvcc processes side by side)."""
    from manual_whisper_tpu_torch.kernel_variants import build_variants
    return build_variants("decode_self_attention", "float32",
                          only=[f"probe_empty_split{s}" for s in (1, 2, 4, 8)])


def empty_launch_ms(split: int, bh: int, dev) -> float:
    """The floor of a launch of K3's grid: ``probe_empty_split{split}`` (bh
    x split blocks that meet their cluster and write one row each), timed
    as the kernels are."""
    var = f"probe_empty_split{split}"
    fn = _empty_probes()[var]
    out = torch.empty((bh, 64), dtype=torch.float32, device=dev)
    return graph_ms(lambda o: _build.check(
        fn(0, 0, 0, o.data_ptr(), 0, 0, bh, 0, 64, _build.stream_of(o)),
        var), [(out,)])


def self_attention_rows(randn, dev, main: dict, dtype=torch.bfloat16):
    """K3's row of the kernels line (batch rows of the main path, its
    self cache, every pos the decode loop visits) and its extra: batch 16,
    T_max 448 (the server's), where the launch shape is the wide one.  The
    checks take pos 6, 7 and 8 (n = 7, 8, 9: the key axis is split over
    the blocks of a cluster, so short lengths leave blocks without keys)
    besides the first, middle and last slots; in float32 also the slice
    edges of its shapes (n = 53, 54: a slice of the narrow split at 417
    slots; 63 to 65, 104, 105, 256 and 257)."""
    b, h, dh = main["batch"], main["heads"], main["dh"]
    t_max, p = main["t_max"], main["prefix"]
    steps = np.unique(np.linspace(p, t_max - 2, 20).round().astype(int))
    edges = ((52, 53, 62, 63, 64, 103, 104, 255, 256)
             if dtype == torch.float32 else ())
    row = self_attention_row(randn, dev, b, h, dh, t_max,
                             [int(x) for x in steps],
                             checks=(0, 1, 6, 7, 8, p, (p + t_max) // 2,
                                     t_max - 1) + edges, dtype=dtype)
    return row, [self_attention_row(randn, dev, 16, h, dh, 448, [447],
                                    checks=(0, 1, 6, 7, 8, 100, 255, 447)
                                    + edges, dtype=dtype)]


def cross_attention_row(randn, dev, b, h, dh, ta, dtype=torch.bfloat16):
    """K4 (the build of ``dtype``) vs its plain version at kv_len Ta, Ta -
    1, 1000, 8, 7 and 1 (the key axis is split over 8 blocks: a ragged last
    slice, slices that are empty for some or all but one block), then timed
    at kv_len = Ta (the main path's) over K/V copies that exceed L2."""
    suffix, elem = _build.ATTENTION_DTYPES[dtype], dtype.itemsize
    q = randn((b, h, 1, dh), dtype)
    k = randn((b, h, ta, dh), dtype)
    v = randn((b, h, ta, dh), dtype)
    err = 0.0
    for kv_len in (ta, ta - 1, 1000, 8, 7, 1):
        len_t = torch.full((1,), kv_len, dtype=torch.int32, device=dev)
        err = max(err, compare("decode_cross_attention" + suffix,
                               decode_cross_attention(q, k, v, len_t),
                               attend_plain(q, k, v, kv_len)))
    len_t = torch.full((1,), ta, dtype=torch.int32, device=dev)
    sets = [(randn((b, h, 1, dh), dtype), randn((b, h, ta, dh), dtype),
             randn((b, h, ta, dh), dtype))
            for _ in range(copies_for(2 * k.numel() * elem))]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row = dict(
        shape=f"B={b} H={h} Ta={ta} kv_len={ta} dh={dh} {_dtype_name(dtype)}",
        max_abs_err=err,
        ms=graph_ms(lambda a, c, d: decode_cross_attention(a, c, d, len_t),
                    sets),
        plain_ms=graph_ms(lambda a, c, d: attend_plain(a, c, d, ta), sets),
        library_ms=graph_ms(sdpa, sets),
        bound=_decode_bound(b, h, dh, ta, elem))
    if dtype == torch.float32:
        row["library_kernels"] = sdpa_kernels(sdpa, sets[0])
    return row


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


# diarization's K1 shapes: clips in the embedding's length buckets (0.5
# to 10 s, 32 rows a forward) at 80 mels (the ResNet34) and 40 (the
# statistics embedding), and the windows flow's 3 s windows (256 rows, 40
# mels, K1's 32-wide band table)
DIARIZE_MEL_SHAPES = tuple(
    [(32, int(sec * 16000), m) for m in (80, 40)
     for sec in (0.5, 1.0, 2.0, 4.0, 10.0)] + [(256, 48000, 40)])


def mel_diarize_rows(randn, dev) -> list:
    """K1 against its plain version at ``DIARIZE_MEL_SHAPES`` on raw
    log-mel (TOL["mel_raw"]) of noise rows zero-padded past lengths from a
    quarter of the row to all of it, as the buckets hold clips; each timed
    as ``mel_row`` is, with the function's bound (the bytes bind)."""
    rows = []
    for b, n, n_mels in DIARIZE_MEL_SHAPES:
        def make():
            x = 0.1 * randn((b, n), torch.float32)
            lengths = torch.linspace(n // 4, n, b, device=dev).long()
            keep = torch.arange(n, device=dev)[None] < lengths[:, None]
            return (x * keep).contiguous()
        audio = make()
        err = compare("mel_raw", unnormalized_log_mel(audio, n_mels),
                      unnormalized_log_mel_plain(audio, n_mels))
        n_frames = n // 160
        nnz = int(np.count_nonzero(
            mel_filter_bank(n_mels).astype(np.float32)))
        sets = [(make(),) for _ in range(copies_for(audio.numel() * 4))]
        least = bound(b * n_frames * mel_fft_ops(n_mels, nnz),
                      4.0 * (b * n + b * n_frames * n_mels)
                      + 4.0 * (400 + 2 * 200 + nnz + 4 * n_mels), F32_FLOPS)
        rows.append(dict(
            shape=f"B={b} T={n} n_mels={n_mels} raw, zero-padded tails",
            max_abs_err=err, tol="mel_raw",
            ms=graph_ms(lambda x: unnormalized_log_mel(x, n_mels), sets),
            plain_ms=graph_ms(
                lambda x: unnormalized_log_mel_plain(x, n_mels), sets),
            library_ms=None, bound=least))
    return rows


def flash_row(randn, b, h, tt, dh, dtype=torch.bfloat16):
    """K2 (the build of ``dtype``) vs its plain version at [b, h, tt, dh],
    then timed over copies that exceed L2; the yardstick is SDPA on the
    same inputs (float32 with TF32 off; its kernels are on the row).
    Bound: q, k, v read and the output written once, or 4 b h tt^2 dh
    operations at the bf16 tensor-core rate (bf16) or, in float32, three
    times as many at the TF32 rate (the kernel's 3xTF32: float32-class
    products); beside it the same operations at the FMA pipes' float32
    rate, the bytes' time and the b h tt^2 exponentials of the softmax
    (``exp2``), which the special-function units run at 16 a cycle and
    SM.  In float32 also the error at a sharp softmax (keys scaled 3x)."""
    suffix, elem = _build.ATTENTION_DTYPES[dtype], dtype.itemsize
    q, k, v = (randn((b, h, tt, dh), dtype) for _ in range(3))
    err = compare("flash_attention" + suffix, flash_attention(q, k, v),
                  attention_plain(q, k, v))
    per = 3 * q.numel() * elem
    sets = [tuple(randn((b, h, tt, dh), dtype) for _ in range(3))
            for _ in range(copies_for(per))]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ops, nbytes = 4.0 * b * h * tt * tt * dh, 4.0 * b * h * tt * dh * elem
    f32 = dtype == torch.float32
    row = dict(
        shape=f"B={b} H={h} T={tt} dh={dh} {_dtype_name(dtype)}",
        max_abs_err=err,
        ms=graph_ms(flash_attention, sets),
        plain_ms=graph_ms(attention_plain, sets[:1]),
        library_ms=graph_ms(sdpa, sets),
        bound=(bound(3 * ops, nbytes, TF32_FLOPS) if f32
               else bound(ops, nbytes, BF16_FLOPS)),
        exp2=float(b * h * tt * tt))
    if f32:
        sharp = 3.0 * k
        row["sharp_max_abs_err"] = compare(
            "flash_attention" + suffix, flash_attention(q, sharp, v),
            attention_plain(q, sharp, v))
        row["max_abs_err"] = max(err, row["sharp_max_abs_err"])
        row["other_bounds"] = {
            "fma_bound_ms": ops / F32_FLOPS * 1e3,
            "exp2_ms": b * h * tt * tt / (16 * SMS * SPEC_CLOCK_HZ) * 1e3,
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        row["library_kernels"] = sdpa_kernels(sdpa, sets[0])
        row["library_max_abs_err"] = max_err(sdpa(q, k, v),
                                             attention_plain(q, k, v))
    return row


# (t_q, t_k, dh) of K2's ragged check: a query tile of one row, a last key
# tile of one key (129 = 128 + 1 in bf16, 2 x 64 + 1 in float32), the test
# config's dh=32 at T=150 and the encoder's T=1500 at both head widths;
# float32 (64 keys a step) adds key lengths one short of, at and one past
# a step at both widths (its row checks a sharp softmax)
FLASH_CHECKS = ((1, 70, 64), (150, 150, 32), (127, 129, 64), (1499, 1499, 64),
                (1500, 1500, 32))
FLASH_F32_CHECKS = tuple((t_q, t_k, dh) for dh in (32, 64)
                         for t_q, t_k in ((63, 63), (64, 64), (65, 65),
                                          (130, 63), (1, 65)))


def flash_check(randn, dtype=torch.bfloat16) -> dict:
    """K2 (the build of ``dtype``) vs its plain version at FLASH_CHECKS
    (float32: and FLASH_F32_CHECKS), B=2, H=3.  Checked, not timed."""
    name = "flash_attention" + _build.ATTENTION_DTYPES[dtype]
    errs = {}
    checks = FLASH_CHECKS
    if dtype == torch.float32:
        checks += FLASH_F32_CHECKS
    for t_q, t_k, dh in checks:
        q = randn((2, 3, t_q, dh), dtype)
        k, v = randn((2, 3, t_k, dh), dtype), randn((2, 3, t_k, dh), dtype)
        errs[f"t_q={t_q} t_k={t_k} dh={dh}"] = compare(
            name, flash_attention(q, k, v), attention_plain(q, k, v))
    return {"phase": "kernel_check", "name": name,
            "shape": f"B=2 H=3 {_dtype_name(dtype)}, ragged tiles",
            "max_abs_err": errs, "tol": TOL[name]}


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
    cross-K/V's M = batch x Ta, the prefill's M = batch x prompt length,
    and the beam step's M = rows x beams (10, 20, 80), each with the
    attention projections' and both MLP weights' (K, N).
    Logs the ragged-tile and matvec checks on its way."""
    b, d, p, ta = main["batch"], main["d"], main["prefix"], main["ta"]
    log(json.dumps(int8_matmul_ragged(randn)))
    log(json.dumps(int8_matvec_check(randn)))
    row = int8_matmul_row(randn, b, d, 4 * d)
    shapes = [(b, d, d), (b, 4 * d, d)]
    # the beam step's M = rows x beams: buckets 2 and 4 of batch 4, and
    # the server's batch 16 (the tile product; bucket 1's M = 5 is a matvec)
    shapes += [(m, k, n) for m in (b * ta, b * p, 2 * BEAM, b * BEAM,
                                   SERVE_BATCH * BEAM)
               for k, n in ((d, d), (d, 4 * d), (4 * d, d))]
    return row, [int8_matmul_row(randn, *shape) for shape in shapes]


def bf16_ulps(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |out - ref| in units of one bf16 ulp of ref (2^(e - 7) for
    |ref| in [2^e, 2^(e + 1)))."""
    ref = ref.float()
    e = torch.floor(torch.log2(ref.abs().clamp_min(2.0 ** -126)))
    return float(((out.float() - ref).abs() / torch.exp2(e - 7)).max())


def add_layer_norm_row(randn, dev, rows: int, d: int,
                       dtype=torch.bfloat16) -> dict:
    """The decode step's fused bias + residual add + LayerNorm (the build of
    ``dtype``) against its plain version (the unfused sequence: two adds,
    ATen's LayerNorm in float32, the cast) at R in {1, 5, 16, 80} and d in
    {64, 384, 1280}, with a delta and a bias, a delta alone and neither:
    h_new the same bits, y within TOL (in bf16 also in ulps); then timed
    at (rows, d) with a delta and a bias over copies that exceed L2.  Bound:
    the bytes of h, delta, h_new and y [R, d] and bias, gamma and beta [d].
    No single PyTorch call computes it: no library time."""
    name = "add_layer_norm" + _build.ATTENTION_DTYPES[dtype]
    err, ulps, equal = 0.0, 0.0, True
    for r in (1, 5, 16, 80):
        for dd in (64, 384, 1280):
            for inputs in ("ln_only", "delta", "delta_bias"):
                args = (randn((r, 1, dd), dtype, 4.0),
                        randn((r, 1, dd), dtype, 3.0)
                        if inputs != "ln_only" else None,
                        randn((dd,), dtype) if inputs == "delta_bias"
                        else None,
                        randn((dd,), dtype) + 1, randn((dd,), dtype))
                h_new, y = add_layer_norm(*args)
                ref_h, ref_y = add_layer_norm_plain(*args)
                equal = equal and torch.equal(h_new, ref_h)
                err = max(err, compare(name, y, ref_y))
                if dtype == torch.bfloat16:
                    ulps = max(ulps, bf16_ulps(y, ref_y))
    if not equal:
        raise AssertionError(f"{name}: h_new differs from the plain "
                             f"version's bits")
    nbytes = dtype.itemsize * (4 * rows * d + 3 * d)
    sets = [(randn((rows, 1, d), dtype), randn((rows, 1, d), dtype),
             randn((d,), dtype), randn((d,), dtype) + 1, randn((d,), dtype))
            for _ in range(copies_for(nbytes))]
    row = dict(shape=f"R={rows} d={d} delta+bias {_dtype_name(dtype)}",
               max_abs_err=err, h_new_equal=equal,
               ms=graph_ms(add_layer_norm, sets),
               plain_ms=graph_ms(add_layer_norm_plain, sets),
               library_ms=None,
               # about 10 operations an element: two adds, the two sums,
               # the centred square, the scale and shift
               bound=bound(10.0 * rows * d, nbytes, F32_FLOPS))
    if dtype == torch.bfloat16:
        row["y_max_bf16_ulps"] = ulps
    return row


def add_layer_norm_rows(randn, dev, main: dict, dtype=torch.bfloat16):
    """The row at the benchmark's and the server's 16 rows of large-v3's
    width, and an extra at the main path's batch."""
    d = main["d"]
    return (add_layer_norm_row(randn, dev, 16, d, dtype),
            [add_layer_norm_row(randn, dev, main["batch"], d, dtype)])


def _row_line(phase: str, name: str, row: dict) -> str:
    line = {"phase": phase, "name": name, "shape": row["shape"],
            "max_abs_err": row["max_abs_err"],
            "tol": TOL[row.get("tol", name)],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "library_ms": row["library_ms"], "bound_ms": row["bound"][0],
            "bound_by": row["bound"][1]}
    for key in ("exp2", "sharp_max_abs_err", "launch_shape", "empty_launch_ms",
                "library_kernels", "library_max_abs_err", "h_new_equal",
                "y_max_bf16_ulps"):
        if key in row:
            line[key] = row[key]
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
        # K2-K4's float32 builds are the names with "_f32"
        dtype = torch.float32 if name.endswith("_f32") else torch.bfloat16
        base = name.removesuffix("_f32")
        if name == "mel":
            rows = [mel_row(randn, dev)] + mel_diarize_rows(randn, dev)
        elif name == "int8_matmul":
            row, extra = int8_matmul_rows(randn, main)
            rows = [row] + extra
        elif name == "decode_cross_attention_int8":
            row, extra = cross_int8_rows(randn, dev, main)
            rows = [row] + extra
        elif base == "decode_self_attention":
            row, extra = self_attention_rows(randn, dev, main, dtype)
            rows = [row] + extra
        elif base == "decode_cross_attention":
            rows = [cross_attention_row(randn, dev, bb, h, dh, ta, dtype)
                    for bb in ((b, 16) if base == name else (b,))]
        elif base == "flash_attention":
            log(json.dumps(flash_check(randn, dtype)))
            rows = [flash_row(randn, 4, 20, 1500, 64, dtype)]
        elif base == "add_layer_norm":
            row, extra = add_layer_norm_rows(randn, dev, main, dtype)
            rows = [row] + extra
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
    # the float32 builds of K2-K4 (compute_type float32) at the same shapes
    # and checks
    f32 = torch.float32
    log(json.dumps(flash_check(randn, f32)))
    rows["flash_attention_f32"] = flash_row(randn, 4, 20, 1500, 64, f32)
    rows["decode_self_attention_f32"], k3_f32_extra = self_attention_rows(
        randn, dev, main, f32)
    rows["decode_cross_attention_f32"] = cross_attention_row(
        randn, dev, b, h, dh, ta, f32)
    # the decode step's bias + residual add + LayerNorm, bf16 and float32
    rows["add_layer_norm"], aln_extra = add_layer_norm_rows(randn, dev, main)
    rows["add_layer_norm_f32"], aln_f32_extra = add_layer_norm_rows(
        randn, dev, main, f32)
    extra = [("add_layer_norm", row) for row in aln_extra]
    extra += [("add_layer_norm_f32", row) for row in aln_f32_extra]
    extra += [("decode_self_attention", row) for row in k3_extra]
    extra += [("decode_self_attention_f32", row) for row in k3_f32_extra]
    extra += [("decode_cross_attention", cross_attention_row(
        randn, dev, 16, h, dh, ta))]
    extra += [("decode_cross_attention_int8", row) for row in k5_extra]
    extra += [("int8_matmul", row) for row in k6_extra]
    extra += [("mel", row) for row in mel_diarize_rows(randn, dev)]
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


def phase_tiny(dev, int8: bool, dtype=torch.bfloat16) -> None:
    """The test config in ``dtype`` (bf16 or float32; ``int8``: int8
    weights and int8 cross K/V on bf16 activations) on the card vs the CPU,
    then faults run on the card: each must exceed its tolerance, so the
    tolerances are shown to catch them.  bf16 and float32: a dropped
    encoder layer, a dropped decoder layer, half the cross length in the
    decode steps; int8: the last encoder block's weight scales reversed,
    the last decoder layer's cross-K/V scales dropped, or swapped between K
    and V.  float32 also counts the card's launches: the float32 builds of
    K2-K4 only."""
    from manual_whisper_tpu_torch.models.whisper import (MODEL_CONFIGS,
                                                         init_params)
    from manual_whisper_tpu_torch.ops.quant import quantize_params
    cfg = MODEL_CONFIGS["test"].with_dtype(dtype)
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
    _build.launches.clear()
    enc, logits = run(params_gpu, dev)
    launches = dict(_build.launches)
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
    suffix = "_int8" if int8 else _build.ATTENTION_DTYPES[dtype]
    fault_errs = {name: {"encoder_max_abs_err": max_err(out[0], enc_ref),
                         "logits_max_abs_err": max_err(out[1], logits_ref)}
                  for name, out in faults.items()}
    log(json.dumps({"phase": "tiny_test_config" + suffix,
                    "launches": launches,
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
    if dtype == torch.float32:
        # one encoder pass (2 layers), three decode steps (2 layers each)
        expected = {"mel": 1, "flash_attention_f32": cfg.n_audio_layer,
                    "decode_self_attention_f32": 3 * cfg.n_text_layer,
                    "decode_cross_attention_f32": 3 * cfg.n_text_layer,
                    "add_layer_norm_f32": 3 * (3 * cfg.n_text_layer + 1)}
        if launches != expected:
            raise AssertionError(f"tiny config float32: launches "
                                 f"{launches}, expected {expected}")


SYNTH_CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          ".synth_ckpt")
# greedy, gates off: no row climbs to a sampled rung, whose random numbers
# differ between the card and the CPU
SYNTH_OPTS = {"max_new_tokens": 40, "suppress_blank": False,
              "log_prob_threshold": None, "compression_ratio_threshold": None}


def synthetic_test_file(seed: int = 123, n_utts: int = 3):
    """The synthetic-speech file the CPU tests transcribe with
    ``.synth_ckpt`` (``tests/test_torch_pipeline.py``): audio and its
    words."""
    from manual_whisper_tpu_torch.eval.synth import (render_file_with_times,
                                                     sample_text)
    rng = np.random.default_rng(seed)
    utts = [sample_text(rng, 4, 8) for _ in range(n_utts)]
    audio, words_t = render_file_with_times(utts, seed=seed)
    return audio, " ".join(w for w, _, _ in words_t)


@contextlib.contextmanager
def _decoded_rows():
    """Every row ``BatchDecoder.decode_finalize`` builds in the block, as
    (tokens without EOT, ended on EOT before max_new_tokens)."""
    from manual_whisper_tpu_torch.models import decode as dec_mod
    rows = []
    real = dec_mod.BatchDecoder.decode_finalize

    def spy(self, out, b, temperature=0.0):
        res = real(self, out, b, temperature)
        max_new = out.tokens.shape[1]
        rows.extend((r.tokens, len(r.tokens) < max_new) for r in res)
        return res
    dec_mod.BatchDecoder.decode_finalize = spy
    try:
        yield rows
    finally:
        dec_mod.BatchDecoder.decode_finalize = real


def phase_tiny_synth(dev, dtype=torch.bfloat16) -> None:
    """``.synth_ckpt``, the test config trained on synthetic speech (the
    JAX package's orbax tree), read by ``from_hf.load_params``, crossed by
    ``convert.from_jax_tree`` (inside ``load_model``) and run on the card
    and on the CPU, both in ``dtype`` (bf16 or float32; the CPU side is the
    port's own path), on the synthetic test file (3 utterances, seed 123,
    language en): the prefill-plus-three-steps forward over its first two
    windows (bf16: encoder within TOL["encoder"], logits within
    TOL["logits_synth"]; float32: TOL["encoder_f32"] and
    TOL["logits_synth_f32"]; a dropped encoder layer and a dropped decoder
    layer must exceed them), then ``transcribe`` at batch 4 with the gates
    off: segments and each decoded row's tokens compared (rows that differ
    printed; in float32 they must be equal, and so must the segments), the
    rows that ended on EOT before ``max_new_tokens`` printed (at least one
    on the card: the trained model emits EOT), word error against the
    file's words, and the card's launches counted over the call: K1-K4 of
    the dtype's builds, and none of the other's."""
    from manual_whisper_tpu_torch.convert import from_jax_tree
    from manual_whisper_tpu_torch.eval.metrics import wer
    from manual_whisper_tpu_torch.from_hf import load_params
    from manual_whisper_tpu_torch.models.whisper import MODEL_CONFIGS
    from manual_whisper_tpu_torch.pipeline import load_model
    from manual_whisper_tpu_torch.text import clean_result_segments
    os.environ["MWX_ALLOW_SYNTH_WEIGHTS"] = "1"
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    tree = load_params(SYNTH_CKPT)
    read_ms = 1e3 * (time.perf_counter() - t0)
    if tree is None:
        raise AssertionError(f"tiny synth: no checkpoint at {SYNTH_CKPT}")
    cfg = MODEL_CONFIGS["test"].with_dtype(dtype)
    f32 = dtype == torch.float32
    tol_enc, tol_logits = (("encoder_f32", "logits_synth_f32") if f32
                           else ("encoder", "logits_synth"))
    kernels = F32_KERNELS if f32 else BF16_KERNELS
    audio, truth = synthetic_test_file()
    n = cfg.n_audio_ctx * 2 * 160
    windows = np.zeros((2, n), np.float32)
    for i in range(2):
        part = audio[i * n:(i + 1) * n]
        windows[i, :len(part)] = part
    prefix = [257, 258, 359, 362, 65, 66]
    params = from_jax_tree(tree, cfg, dev)
    enc_ref, logits_ref = _tiny_forward(from_jax_tree(tree, cfg, cpu), cfg,
                                        windows, prefix, cpu)
    enc, logits = _tiny_forward(params, cfg, windows, prefix, dev)
    fault_errs = {
        f"{part}_layer_dropped": max_err(_tiny_forward(
            _drop_last_block(params, part), cfg, windows, prefix, dev)[1],
            logits_ref) for part in ("encoder", "decoder")}

    runs = {}
    for name, d in (("cpu", cpu), ("card", dev)):
        model = load_model(tree, device=d,
                           compute_type="float32" if f32 else "bfloat16",
                           cfg=MODEL_CONFIGS["test"], asr_options=SYNTH_OPTS,
                           language="en")
        if d.type == "cuda":
            model.warmup(batch_size=4, language="en")
            torch.cuda.synchronize()
        _build.launches.clear()
        t0 = time.perf_counter()
        with _decoded_rows() as rows:
            out = model.transcribe(audio, batch_size=4, language="en")
        if d.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cleaned, _, _ = clean_result_segments(out["segments"])
        runs[name] = {
            "segments": [(g["text"], g["start"], g["end"])
                         for g in out["segments"]],
            "rows": rows, "wall_s": wall, "launches": dict(_build.launches),
            "wer": wer(truth, " ".join(g["text"].strip() for g in cleaned)),
            "stats": {k: model.last_stats[k] for k in (
                "windows", "batches", "decode_calls", "decode_steps")}}
        del model
    card, host = runs["card"], runs["cpu"]
    differ = [{"row": i, "card": a[0], "cpu": b[0]}
              for i, (a, b) in enumerate(zip(card["rows"], host["rows"]))
              if a[0] != b[0]]
    eot = {k: [i for i, r in enumerate(v["rows"]) if r[1]]
           for k, v in runs.items()}
    log(json.dumps({
        "phase": "tiny_synth_ckpt" + ("_f32" if f32 else ""),
        "read_ms": read_ms, "audio_s": len(audio) / 16000.0,
        "encoder_max_abs_err": max_err(enc, enc_ref),
        "encoder_tol": TOL[tol_enc],
        "logits_max_abs_err": max_err(logits, logits_ref),
        "logits_tol": TOL[tol_logits],
        "logits_std": float(logits_ref.std()), "faults": fault_errs,
        "rows": len(card["rows"]), "rows_cpu": len(host["rows"]),
        "rows_differ": differ,
        "segments_equal": card["segments"] == host["segments"],
        "segments": card["segments"], "segments_cpu": host["segments"],
        "rows_ended_on_eot": eot["card"], "rows_ended_on_eot_cpu": eot["cpu"],
        "max_new_tokens": SYNTH_OPTS["max_new_tokens"],
        "wer_card": card["wer"], "wer_cpu": host["wer"],
        "launches": card["launches"], "stats": card["stats"],
        "transcribe_s": {k: v["wall_s"] for k, v in runs.items()}}))
    compare(tol_enc, enc, enc_ref)
    compare(tol_logits, logits, logits_ref)
    for name, err in fault_errs.items():
        if err <= TOL[tol_logits][0]:
            raise AssertionError(f"tiny synth: the logits tolerance does not "
                                 f"catch the fault {name}: {err}")
    if not eot["card"]:
        raise AssertionError("tiny synth: no row ended on EOT on the card")
    missing = [k for k in kernels if not card["launches"].get(k)]
    if missing or set(card["launches"]) != set(kernels):
        raise AssertionError(f"tiny synth: launches {card['launches']}, "
                             f"expected each of {kernels} and no other")
    if f32 and (differ or card["segments"] != host["segments"]
                or len(card["rows"]) != len(host["rows"])):
        raise AssertionError("tiny synth float32: the card's rows or "
                             "segments differ from the CPU's")


# ---------------------------------------------------------------------------
# The vad phase: PyanNet on the card against the CPU
# ---------------------------------------------------------------------------

def _lstm_directions_swapped(model):
    """A copy of ``model`` whose every LSTM layer runs each direction with
    the other direction's weights."""
    bad = copy.deepcopy(model)
    with torch.no_grad():
        for name, fwd in bad.lstm.named_parameters():
            if name.endswith("_reverse"):
                continue
            rev = getattr(bad.lstm, name + "_reverse")
            tmp = fwd.clone()
            fwd.copy_(rev)
            rev.copy_(tmp)
    return bad


def _speech_probs_without_norm(det, audio, which: int):
    """Speech probabilities with the ``which``-th instance norm of the
    forward (0: the waveform's, 1-3: after the sinc conv and each conv)
    left out."""
    from manual_whisper_tpu_torch.models import vad as vad_mod
    norm = vad_mod._instance_norm
    calls = []

    def dropped(x, g, b, eps=1e-5):
        calls.append(1)
        return x if (len(calls) - 1) % 4 == which else norm(x, g, b, eps)

    vad_mod._instance_norm = dropped
    try:
        return det.speech_probs(audio)[0]
    finally:
        vad_mod._instance_norm = norm


def phase_vad(dev) -> None:
    """PyanNet from the registry (its orbax ``jax/`` tree, read by the
    port's reader) on the card and on the CPU, same weights, phase 4's 75 s
    of audio: speech probabilities
    within TOL["vad"] and regions equal; two planted faults on the card (the
    LSTM's directions swapped; the norm after the first conv dropped) must
    each exceed the tolerance; then a 16-row and a 4-row block timed with
    CUDA events (device time of the forward, no host copies)."""
    from manual_whisper_tpu_torch.convert import (from_jax_pyannet,
                                                  load_segmentation_params)
    from manual_whisper_tpu_torch.models.vad import (
        PYANNET_CHUNK, PYANNET_CHUNK_SMALL, VoiceActivityDetector)
    tree = load_segmentation_params()
    if tree is None:
        raise AssertionError("the registry holds no checkpoint of "
                             "pyannote-segmentation-3.0")
    cpu_det = VoiceActivityDetector(from_jax_pyannet(tree,
                                                     torch.device("cpu")))
    gpu_det = VoiceActivityDetector(from_jax_pyannet(tree, dev))
    audio = synthetic_speech(75.0, seed=0)
    t0 = time.perf_counter()
    ref, frame_dur = cpu_det.speech_probs(audio)
    cpu_s = time.perf_counter() - t0
    gpu_det.warmup()
    t0 = time.perf_counter()
    probs, _ = gpu_det.speech_probs(audio)
    gpu_s = time.perf_counter() - t0
    ref_t, probs_t = torch.from_numpy(ref), torch.from_numpy(probs)
    regions, ref_regions = gpu_det(audio), cpu_det(audio)
    faults = {
        "lstm_directions_swapped": VoiceActivityDetector(
            _lstm_directions_swapped(gpu_det.model)).speech_probs(audio)[0],
        "conv1_norm_dropped": _speech_probs_without_norm(gpu_det, audio, 2)}
    fault_errs = {k: max_err(torch.from_numpy(v), ref_t)
                  for k, v in faults.items()}
    window = int(gpu_det.cfg.window_sec * 16000)
    block_ms = {}
    gen = torch.Generator(device=dev).manual_seed(0)
    for rows in (PYANNET_CHUNK, PYANNET_CHUNK_SMALL):
        x = 0.1 * torch.randn(rows, window, device=dev, generator=gen)
        with torch.inference_mode():
            for _ in range(3):
                gpu_det.model(x)
            block_ms[rows] = _event_ms(lambda: gpu_det.model(x), 10)
    log(json.dumps({
        "phase": "vad", "audio_s": len(audio) / 16000.0,
        "windows": -(-len(audio) // window), "frames": len(probs),
        "frame_s": frame_dur, "max_abs_err": max_err(probs_t, ref_t),
        "tol": TOL["vad"], "regions": len(regions),
        "regions_equal": regions == ref_regions,
        "faults": fault_errs, "cpu_s": cpu_s, "card_s": gpu_s,
        "block_ms": {f"rows={r}": ms for r, ms in block_ms.items()}}))
    if probs.shape != ref.shape:
        raise AssertionError(f"vad: {probs.shape} frames on the card, "
                             f"{ref.shape} on the CPU")
    compare("vad", probs_t, ref_t)
    if regions != ref_regions or not regions:
        raise AssertionError(f"vad: regions differ or are empty: "
                             f"{regions[:5]} vs {ref_regions[:5]}")
    for name, err in fault_errs.items():
        if err <= TOL["vad"][0]:
            raise AssertionError(f"vad: the tolerance does not catch the "
                                 f"fault {name}: {err}")


# ---------------------------------------------------------------------------
# Phase 4: the main path at large-v3
# ---------------------------------------------------------------------------

def synthetic_speech(seconds: float, seed: int) -> np.ndarray:
    """Seeded amplitude-modulated audio: harmonic bursts of 0.3-2 s with
    pauses, over a low noise floor, so the VAD finds many regions (PyanNet
    with the repository's weights: 39 regions, 3 windows)."""
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


def load_main_model(compute_type: str, int8_cross_kv: bool, mesh=None):
    """large-v3 at full width and depth, seeded random weights, the CLI's
    asr_options, on ``mesh`` (none by default); returns (model, load
    seconds)."""
    from manual_whisper_tpu_torch.pipeline import load_model
    from manual_whisper_tpu_torch.text import INITIAL_PROMPT
    os.environ["MWX_ALLOW_RANDOM_WEIGHTS"] = "1"
    t0 = time.perf_counter()
    model = load_model("large-v3", device="cuda", compute_type=compute_type,
                       language="zh",
                       asr_options={"initial_prompt": INITIAL_PROMPT,
                                    "beam_size": 1,
                                    "int8_cross_kv": int8_cross_kv},
                       mesh=mesh)
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
    """Launches a path implies for the batches, decode loops and steps in
    ``last_stats``: K1 once and K2 once per encoder layer per batch; per
    greedy or timestamp step K3 and the cross kernel (K4, or K5 for int8)
    once per decoder layer and ``add_layer_norm`` 3 times a layer and once
    more, per beam step none of them; K6 for every block
    matmul: 6 per encoder layer per batch, per decoder layer 2 (cross K/V)
    + 8 (prefill) per decode loop of any kind and 8 per step of any kind
    (a beam step's at M = rows x beams).  K2-K4 and ``add_layer_norm`` are
    the builds of ``cfg.dtype`` (bf16, or float32: the names with
    ``_f32``)."""
    le, ld = cfg.n_audio_layer, cfg.n_text_layer
    batches, calls = stats["batches"], stats["decode_calls"]
    steps = stats["decode_steps"]
    suffix = _build.ATTENTION_DTYPES[cfg.dtype]
    exp = {"mel": batches, "flash_attention" + suffix: le * batches,
           "decode_self_attention" + suffix: ld * steps,
           "add_layer_norm" + suffix: (3 * ld + 1) * steps}
    if int8:
        exp["decode_cross_attention_int8"] = ld * steps
        exp["int8_matmul"] = 6 * le * batches + 10 * ld * calls \
            + 8 * ld * (steps + stats.get("beam_steps", 0))
    else:
        exp["decode_cross_attention" + suffix] = ld * steps
    return exp


def graph_replays(decoder, kind: str = "_loops") -> dict:
    """Replays so far of each captured chunk of ``decoder``'s loops of one
    kind (``_loops``, ``_beam_loops``, ``_ts_loops``), by (rows, steps of
    the chunk)."""
    return {(key[0], n): loop.graphs.replays[n]
            for key, loop in getattr(decoder, kind).items()
            for n in loop.graphs.graphs}


def phase_main(model, load_s: float, compute_type: str) -> dict:
    """``warmup`` (timed alone; it captures the decode chunks of batch
    buckets 1, 2 and 4), then the launch counters are zeroed and
    ``transcribe`` runs.  Every decode step must have run inside a replayed
    chunk, and the launches must be the ones ``last_stats`` implies."""
    torch.cuda.reset_peak_memory_stats()
    result, stats, launches, line = _mode_transcribe(
        model, compute_type, ("_loops",), "main_path")
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    vad = model.vad.model
    if vad is None or vad.sinc.device.type != "cuda":
        raise AssertionError("the main path did not run PyanNet on the card")
    if stats["windows"] < 2:
        raise AssertionError(f"expected several windows, got {stats}")
    for s in result["segments"]:
        if not s["start"] < s["end"] or not math.isfinite(s["avg_logprob"]):
            raise AssertionError(f"bad segment {s}")
    line.update({
        "vad": "pyannet", "load_s": load_s, "vad_s": stats["vad_s"],
        "mel_encode_s": stats["encode_s"], "windows": stats["windows"],
        "ms_per_token_row": 1e3 * span_s(stats, "decode.loop")
        / max(stats["token_rows"], 1),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "clocks_power_temp_after": clocks})
    log(json.dumps(line))
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
# Phase 4b: beam search and timestamp-token decoding at large-v3
# ---------------------------------------------------------------------------

BEAM = 5
# BatchDecoder's loops by kind
LOOP_KINDS = {"_loops": "greedy", "_beam_loops": "beam",
              "_ts_loops": "timestamps"}


def _mode_pipeline(model, **asr):
    """A pipeline over ``model``'s weights, tokenizer and VAD with
    ``asr_options`` changed (no second copy of the weights)."""
    from manual_whisper_tpu_torch.pipeline.transcribe import \
        TranscribePipeline
    return TranscribePipeline(model.params, model.cfg, model.tokenizer,
                              vad=model.vad,
                              asr_options={**model.asr_options, **asr},
                              language="zh", device=model.device)


def _mode_transcribe(pipe, compute_type: str, kinds: tuple, label: str):
    """``warmup`` then ``transcribe`` of phase 4's audio at batch 4 through
    ``pipe``, with the launch counters zeroed just before and read just
    after; the launches must be the ones ``last_stats`` implies, and every
    step of each loop kind in ``kinds`` must have run inside a replay.
    Returns (result, stats, launches, line)."""
    audio = synthetic_speech(75.0, seed=0)
    decoder = pipe._decoder("zh", 0.0)
    if not decoder.captured:
        raise AssertionError(f"{label}: the decoder does not capture")
    t0 = time.perf_counter()
    pipe.warmup(batch_size=BATCH, language="zh")
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    before = {kind: graph_replays(decoder, kind) for kind in kinds}
    _build.launches.clear()
    t0 = time.perf_counter()
    result = pipe.transcribe(audio, batch_size=BATCH, language="zh")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    stats = pipe.last_stats
    int8 = compute_type == "int8"
    expected = expected_launches(pipe.cfg, stats, int8)
    if launches != expected or 0 in expected.values():
        raise AssertionError(f"{label} {compute_type}: launches {launches}, "
                             f"expected {expected}")
    steps_of = {"_loops": stats["decode_steps"], "_ts_loops":
                stats["decode_steps"], "_beam_loops": stats["beam_steps"]}
    replays = {(kind, rows, n): count - before[kind].get((rows, n), 0)
               for kind in kinds
               for (rows, n), count in graph_replays(decoder, kind).items()}
    replayed = {kind: sum(n * c for (k, _, n), c in replays.items()
                          if k == kind) for kind in kinds}
    for kind in kinds:
        if replayed[kind] != steps_of[kind]:
            raise AssertionError(f"{label} {compute_type}: {replayed[kind]} "
                                 f"{kind} steps replayed, {steps_of[kind]} "
                                 "run")
    duration = len(audio) / 16000.0
    if result["language"] != "zh" or not isinstance(result["segments"],
                                                    list):
        raise AssertionError(f"{label}: bad result shape: {result!r:.200}")
    for seg in result["segments"]:
        if not (0.0 <= seg["start"] <= seg["end"] <= duration + 1e-6) \
                or not isinstance(seg["text"], str):
            raise AssertionError(f"{label}: bad segment {seg}")
    line = {"phase": label, "model": "large-v3",
            "compute_type": compute_type,
            "int8_cross_kv": decoder.opts.int8_cross_kv,
            "warmup_s": warmup_s, "capture_s": decoder.stats["capture_s"],
            "audio_s": duration, "wall_s": wall, "rtf": wall / duration,
            "decode_loop_s": span_s(stats, "decode.loop"),
            "finalize_s": span_s(stats, "finalize.batch"),
            "batches": stats["batches"],
            "rows": stats["rows"], "decode_calls": stats["decode_calls"],
            "decode_steps": stats["decode_steps"],
            "beam_calls": stats["beam_calls"],
            "beam_steps": stats["beam_steps"],
            "token_rows": stats["token_rows"],
            "rung_rows": stats["rung_rows"],
            "segments": len(result["segments"]),
            "replays": {f"{LOOP_KINDS[kind]} rows={r} steps={n}": c
                        for (kind, r, n), c in sorted(replays.items()) if c},
            "launches": launches}
    return result, stats, launches, line


def _loop_vs_eager(decoder, eager, run, rows_per_out) -> dict:
    """One loop of ``decoder`` (captured) and of ``eager`` through
    ``run(dec)``: tokens and lengths equal, sum_logprob within SUM_LP_TOL;
    host ms per token row of each (``rows_per_out`` token rows a
    position)."""
    outs, ms = {}, {}
    for name, dec in (("graph", decoder), ("eager", eager)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[name] = run(dec)
        torch.cuda.synchronize()
        ms[name] = 1e3 * (time.perf_counter() - t0) / (
            rows_per_out * outs[name].steps)
    g, e = outs["graph"], outs["eager"]
    row = {"tokens_equal": torch.equal(g.tokens, e.tokens),
           "lengths_equal": torch.equal(g.lengths, e.lengths),
           "steps": [g.steps, e.steps],
           "sum_logprob_max_abs_diff": max_err(g.sum_logprob, e.sum_logprob),
           "ms_per_token_row_graph": ms["graph"],
           "ms_per_token_row_eager": ms["eager"]}
    if not (row["tokens_equal"] and row["lengths_equal"]
            and g.steps == e.steps
            and row["sum_logprob_max_abs_diff"] <= SUM_LP_TOL):
        raise AssertionError(f"the replayed loop differs from the eager one: "
                             f"{row}")
    return row


def phase_beam(model, compute_type: str) -> None:
    """Beam 5 at large-v3: ``warmup`` (each bucket's beam loop and greedy
    loop captured) and ``transcribe`` of phase 4's audio at batch 4 with
    the CLI's prompt; random weights fail every gate, so each batch runs
    one beam loop and five greedy rungs.  Exact launches (a beam step
    launches no K3/K4/K5; K6 at M = 4 x 5 for int8), every beam step
    replayed, peak memory; one batch-4 beam loop replayed against the same
    loop eager (whose K6 calls are counted by M: with int8, 8 a layer and
    step at M = 4 x 5), and a profile of one replayed 16-step chunk of it;
    then one
    batch-16 beam loop with the server's 4-token prompt, for its peak
    memory."""
    from manual_whisper_tpu_torch.models.decode import BatchDecoder
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pipe = _mode_pipeline(model, beam_size=BEAM)
    result, stats, launches, line = _mode_transcribe(
        pipe, compute_type, ("_loops", "_beam_loops"), "beam")
    if stats["beam_calls"] != stats["batches"]:
        raise AssertionError(f"beam: {stats['beam_calls']} beam loops for "
                             f"{stats['batches']} batches")
    line["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    line["resident_before_gib"] = base / 2 ** 30
    decoder = pipe._decoder("zh", 0.0)
    eager = BatchDecoder(model.params, model.cfg, model.tokenizer,
                         decoder.opts, model.device, eager=True)
    windows = synthetic_speech(BATCH * model.window_sec, seed=1).reshape(
        BATCH, -1)
    xa = model._encode_windows(windows)
    # K6's rows in the eager loop: every beam step's 8 matmuls a layer at
    # M = rows x beams
    from manual_whisper_tpu_torch.ops import quant
    kernel, rows_m = quant.int8_matmul, collections.Counter()

    def counting(x, q, s):
        rows_m[x.shape[0]] += 1
        return kernel(x, q, s)

    def run(dec):
        if dec is not eager:
            return dec.decode_submit(xa, 0.0)
        quant.int8_matmul = counting
        try:
            return dec.decode_submit(xa, 0.0)
        finally:
            quant.int8_matmul = kernel
    line["beam_vs_eager"] = _loop_vs_eager(decoder, eager, run, BATCH * BEAM)
    steps = line["beam_vs_eager"]["steps"][1] - 1
    ld = model.cfg.n_text_layer
    line["k6_calls_by_m_eager"] = dict(rows_m)
    if compute_type == "int8" and rows_m[BATCH * BEAM] != 8 * ld * steps:
        raise AssertionError(f"beam int8: K6 calls by M {dict(rows_m)}, "
                             f"expected {8 * ld * steps} at M = "
                             f"{BATCH * BEAM}")
    # where a replayed 16-step beam chunk's device time goes
    loop = next(lp for key, lp in decoder._beam_loops.items()
                if key[0] == BATCH)

    def chunk16():
        loop._rewind()
        loop.run_chunk(16)
    chunk = _profiled(chunk16, reps=2)
    line["profile_chunk"] = {
        "device_ms_per_step": chunk["device_ms_per_rep"] / 16,
        "wall_ms_per_step": chunk["wall_ms_per_rep"] / 16,
        "device_busy_share": chunk["device_busy_share"],
        "kernels_per_step": chunk["kernel_launches_per_rep"] / 16,
        "top": chunk["top"]}
    del eager, pipe, decoder, loop
    torch.cuda.empty_cache()

    # batch 16, the server's batch and prompt (SOT sequence only)
    windows = synthetic_speech(SERVE_BATCH * model.window_sec, seed=2
                               ).reshape(SERVE_BATCH, -1)
    xa = model._encode_windows(windows)
    torch.cuda.synchronize()
    base16 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    opts = dataclasses.replace(model._decoder("zh", 0.0).opts,
                               initial_prompt=None, beam_size=BEAM)
    server = BatchDecoder(model.params, model.cfg, model.tokenizer, opts,
                          model.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = server.decode_submit(xa, 0.0)
    torch.cuda.synchronize()
    line["batch16"] = {
        "prompt_tokens": len(server._prefix()[0]), "steps": out.steps,
        "loop_s_with_capture": time.perf_counter() - t0,
        "capture_s": server.stats["capture_s"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "peak_above_resident_gib":
            (torch.cuda.max_memory_allocated() - base16) / 2 ** 30}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = server.decode_submit(xa, 0.0)
    torch.cuda.synchronize()
    line["batch16"]["ms_per_token_row"] = 1e3 * (
        time.perf_counter() - t0) / (SERVE_BATCH * BEAM * out.steps)
    del server, xa
    torch.cuda.empty_cache()
    log(json.dumps(line))


def phase_timestamps(model, compute_type: str) -> None:
    """Timestamp-token mode at large-v3: ``warmup`` (each bucket's
    timestamp loop captured) and ``transcribe`` of phase 4's audio at
    batch 4 (no ladder; the SOT sequence with timestamps, no prompt).
    Exact launches, every step replayed, each row decoded in the phase
    (the warm-up's zero windows included) held to the four rules by the
    host checker, peak memory; one batch-4 timestamp loop replayed against
    the same loop eager."""
    from manual_whisper_tpu_torch.models.decode import BatchDecoder
    torch.cuda.reset_peak_memory_stats()
    pipe = _mode_pipeline(model, without_timestamps=False)
    decoder = pipe._decoder("zh", 0.0)
    rows_seen = []
    finalize = decoder.timestamps_finalize

    def recording(out, starts, durations):
        rows_seen.extend(out.tokens.cpu().tolist())
        return finalize(out, starts, durations)
    # an instance attribute while the phase runs; deleted after, so no
    # cycle through the bound method keeps the decoder's buffers alive
    decoder.timestamps_finalize = recording
    try:
        result, stats, launches, line = _mode_transcribe(
            pipe, compute_type, ("_ts_loops",), "timestamps")
    finally:
        del decoder.timestamps_finalize
    sp = model.tokenizer.special
    broken = {i: v for i, row in enumerate(rows_seen)
              if (v := timestamp_rule_violations(row, sp.timestamp_begin,
                                                 sp.eot))}
    n_rows = len(rows_seen)
    line.update({"rows_checked": n_rows, "rule_violations": broken,
                 "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                 "ms_per_token_row": 1e3 * span_s(stats, "decode.loop")
                 / max(stats["token_rows"], 1)})
    if broken or n_rows < stats["rows"]:
        log(json.dumps(line))
        raise AssertionError(f"timestamps: {len(broken)} of {n_rows} rows "
                             "break the rules")
    eager = BatchDecoder(model.params, model.cfg, model.tokenizer,
                         decoder.opts, model.device, eager=True)
    windows = synthetic_speech(BATCH * model.window_sec, seed=1).reshape(
        BATCH, -1)
    xa = model._encode_windows(windows)
    line["ts_vs_eager"] = _loop_vs_eager(
        decoder, eager, lambda d: d.timestamps_submit(xa), BATCH)
    del eager, pipe, decoder, xa
    torch.cuda.empty_cache()
    log(json.dumps(line))


# ---------------------------------------------------------------------------
# Phase 5: where the time goes (torch.profiler over short windows)
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# The align and diarize phases, and the full CLI
# ---------------------------------------------------------------------------

def _utterance_segments(utts, words_t):
    """One segment an utterance of ``render_file_with_times``: its words'
    text, from 0.15 s before the first word to 0.15 s after the last."""
    segments, i = [], 0
    for utt in utts:
        times = words_t[i: i + len(utt)]
        i += len(utt)
        segments.append({"text": " " + " ".join(utt),
                         "start": round(max(0.0, times[0][1] - 0.15), 3),
                         "end": round(times[-1][2] + 0.15, 3)})
    return segments


# the full-width aligner's own vocabulary: blank, word separator, 30 chars
W2V_VOCAB = {ch: i for i, ch in enumerate(
    ["<pad>", "|"] + list("abcdefghijklmnopqrstuvwxyz'-.,"))}


def phase_align(dev) -> None:
    """(a) The repository's synthetic aligner, from its orbax tree (the
    port's reader), on the card and on the CPU over 6 seeded ``render_file_with_times`` files:
    the log-probs of every padded batch within TOL["align_logprobs"] on
    the valid frames, ``align``'s words equal (text, start, end, score),
    ``word_timing_scores`` against the rendered times equal; a planted
    fault (a padded row's ``n_valid`` mask dropped) must exceed the
    tolerance.  (b) ``Wav2Vec2Config()`` at full width and depth with
    seeded random weights: ``align`` over segments cut from phase 4's 75 s
    audio so that every length bucket (2, 4, 8, 15, 30 s) runs, text seeded
    over the model's vocabulary at a feasible length; ``align_s``, the
    device ms of one 8-row forward per bucket (CUDA events), peak memory.
    (c) Full-width log-probs with 2 layers, 1 row of 4 s, card vs CPU."""
    from manual_whisper_tpu_torch.convert import from_jax_wav2vec2
    from manual_whisper_tpu_torch.eval.metrics import word_timing_scores
    from manual_whisper_tpu_torch.eval.synth import (render_file_with_times,
                                                     sample_text)
    from manual_whisper_tpu_torch.models import align as align_mod
    from manual_whisper_tpu_torch.models.wav2vec2 import (
        Wav2Vec2Config, init_wav2vec2_params)
    os.environ["MWX_ALLOW_SYNTH_WEIGHTS"] = "1"
    cpu = torch.device("cpu")
    # (a)
    gpu_m = align_mod.load_align_model("en", device=dev)
    cpu_m = align_mod.load_align_model("en", device=cpu)
    rng = np.random.default_rng(0)
    lp_err, words_equal, timing, n_words = 0.0, True, [], 0
    fault_err = None
    for seed in range(6):
        utts = [sample_text(rng, 3, 6) for _ in range(3)]
        audio, words_t = render_file_with_times(utts, seed=seed)
        segments = _utterance_segments(utts, words_t)
        prep, _, groups = align_mod._prepare(segments, gpu_m, audio)
        for idxs in groups.values():
            batch = np.stack([prep[i]["row"] for i in idxs])
            n_valid = np.array([prep[i]["n_samples"] for i in idxs],
                               np.int32)
            card = align_mod.forward_batch(gpu_m, batch, n_valid).cpu()
            ref = align_mod.forward_batch(cpu_m, batch, n_valid)
            for r, i in enumerate(idxs):
                nf = prep[i]["n_frames"]
                lp_err = max(lp_err, max_err(card[r, :nf], ref[r, :nf]))
            if fault_err is None:     # the mask dropped on a padded row
                with torch.inference_mode():
                    bad = gpu_m.model(torch.from_numpy(batch).to(dev)).cpu()
                nf = prep[idxs[0]]["n_frames"]
                fault_err = max_err(bad[0, :nf], ref[0, :nf])
        got = align_mod.align(segments, gpu_m, audio)
        ref_out = align_mod.align(segments, cpu_m, audio)
        words_equal &= got == ref_out
        n_words += len(got["word_segments"])
        timing.append((word_timing_scores(words_t, got["word_segments"]),
                       word_timing_scores(words_t,
                                          ref_out["word_segments"])))
    del gpu_m, cpu_m

    # (b) full width and depth, seeded random weights
    cfg = Wav2Vec2Config(vocab_size=len(W2V_VOCAB))
    t0 = time.perf_counter()
    tree = init_wav2vec2_params(torch.Generator().manual_seed(0), cfg)
    model = align_mod.AlignModel(tree, cfg=cfg, vocab=W2V_VOCAB, blank_id=0,
                                 language="en", device=dev)
    del tree
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    speech = synthetic_speech(75.0, seed=0)
    letters = list("abcdefghijklmnopqrstuvwxyz")
    segments, cursor = [], 0.0
    for sec in (1.5, 1.9, 3.5, 3.9, 7.0, 7.8, 12.0, 14.5, 25.0, 29.0, 40.0):
        start = cursor if cursor + sec <= 75.0 else 0.0
        n_chars = int(4 * sec)
        words = "".join(rng.choice(letters, n_chars))
        text = " ".join(words[i: i + 5] for i in range(0, n_chars, 5))
        segments.append({"text": text, "start": round(start, 3),
                         "end": round(start + sec, 3)})
        cursor = start + sec
    buckets = collections.Counter()
    real_forward = align_mod.forward_batch

    def counted(m, batch, n_valid):
        buckets[batch.shape[1] // 16000] += 1
        return real_forward(m, batch, n_valid)
    align_mod.forward_batch = counted
    try:
        out = align_mod.align(segments, model, speech)    # cuDNN set-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        buckets.clear()
        t0 = time.perf_counter()
        out = align_mod.align(segments, model, speech)
        torch.cuda.synchronize()
        align_s = time.perf_counter() - t0
    finally:
        align_mod.forward_batch = real_forward
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if sorted(buckets) != [2, 4, 8, 15, 30]:
        raise AssertionError(f"align: length buckets run {dict(buckets)}")
    for seg, src in zip(out["segments"], segments):
        if not seg["words"]:
            raise AssertionError(f"align: no words in {src}")
        for w in seg["words"]:
            if not (src["start"] - 1e-6 <= w["start"] <= w["end"]
                    <= src["end"] + 0.03) or not math.isfinite(w["score"]):
                raise AssertionError(f"align: word {w} outside {src}")
    gen = torch.Generator(device=dev).manual_seed(2)
    forward_ms = {}
    with torch.inference_mode():
        for sec in (2, 4, 8, 15, 30):
            x = torch.randn(8, sec * 16000, generator=gen, device=dev)
            nv = torch.full((8,), sec * 16000, device=dev)
            model.model(x, nv)
            forward_ms[f"{sec}s"] = _event_ms(lambda: model.model(x, nv), 3)
    del model, x
    torch.cuda.empty_cache()

    # (c) full width, 2 layers, one 4 s row: card vs CPU
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    tree2 = init_wav2vec2_params(torch.Generator().manual_seed(1), cfg2)
    clip = speech[16000: 5 * 16000]
    row = torch.from_numpy(((clip - clip.mean()) / clip.std())[None])
    with torch.inference_mode():
        full_card = from_jax_wav2vec2(tree2, cfg2, dev)(row.to(dev)).cpu()
        full_cpu = from_jax_wav2vec2(tree2, cfg2, cpu)(row)
    full_err = max_err(full_card, full_cpu)

    log(json.dumps({
        "phase": "align",
        "synthetic_aligner": {
            "files": 6, "words": n_words, "logprobs_max_abs_err": lp_err,
            "tol": TOL["align_logprobs"], "words_equal": words_equal,
            "word_timing_card": [t[0] for t in timing],
            "word_timing_cpu": [t[1] for t in timing],
            "fault_mask_dropped_err": fault_err},
        "full_width": {
            "config": dataclasses.asdict(cfg), "load_s": load_s,
            "segments": len(segments), "words": len(out["word_segments"]),
            "forwards_by_bucket_s": {str(k): v
                                     for k, v in sorted(buckets.items())},
            "align_s": align_s, "peak_mem_gib": peak_gib,
            "forward_8_rows_device_ms": forward_ms,
            "logits_2_layers_4s_max_abs_err": full_err,
            "logits_std": float(full_cpu.std())}}))
    if not lp_err <= TOL["align_logprobs"][0]:
        raise AssertionError(f"align: log-probs card vs CPU {lp_err}")
    compare("align_logprobs", full_card, full_cpu)
    if not words_equal or n_words == 0:
        raise AssertionError("align: the card's words differ from the CPU's")
    if any(a != b for a, b in timing):
        raise AssertionError("align: word timing scores differ")
    if not fault_err > TOL["align_logprobs"][0]:
        raise AssertionError(f"align: the tolerance does not catch the "
                             f"dropped mask ({fault_err})")


CONVERSATION = dict(n_turns=48, seed=5, n_speakers=3, overlap_prob=0.1)


def make_registry(path: str, resnet: bool) -> str:
    """A checkpoint registry at ``path``: the repository's ``.weights/``
    entries linked in, with the speaker embedder's only with ``resnet``:
    then its orbax ``jax/`` tree (the ResNet34 trained on synthetic
    speakers, which the port reads as the JAX package does) and its
    synthetic-data marker, and not a torch export that a working tree may
    hold beside them (git ignores it), so the run reads what a checkout
    has.  Without ``resnet`` the pipelines embed 40-mel statistics."""
    from manual_whisper_tpu_torch.models import diarize as dmod
    weights = os.path.join(ROOT, ".weights")
    os.makedirs(path, exist_ok=True)
    for name in os.listdir(weights):
        if name != dmod.EMBEDDING_NAME:
            os.symlink(os.path.join(weights, name), os.path.join(path, name))
    if resnet:
        emb_dir = os.path.join(path, dmod.EMBEDDING_NAME)
        os.makedirs(emb_dir)
        for name in ("jax", "SYNTH_TRAINED"):
            os.symlink(os.path.join(weights, dmod.EMBEDDING_NAME, name),
                       os.path.join(emb_dir, name))
    return path


def _tree_leaves(tree, path=""):
    """(path, leaf) of a param tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _tree_leaves(v, f"{path}/{i}")
    else:
        yield path, np.asarray(tree)


def _bit_equal(got, ref) -> bool:
    """The same leaf paths (in any order), dtypes, shapes and bits."""
    a, b = dict(_tree_leaves(got)), dict(_tree_leaves(ref))
    return sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and a[k].tobytes() == b[k].tobytes() for k in a)


CHECKPOINT_TREES = (".synth_ckpt", ".weights/pyannote-segmentation-3.0/jax",
                    ".weights/jonatasgrosman--wav2vec2-large-xlsr-53-english"
                    "/jax",
                    ".weights/wespeaker-voxceleb-resnet34-LM/jax")


def phase_checkpoint(workdir: str) -> None:
    """The JAX package's orbax trees read on the card's host by the port's
    reader (``from_hf.load_params``: OCDBT, zarr, ``native/mwx_zstd.cpp``;
    no orbax, tensorstore or zstd package there): each tree's leaves,
    bytes, and host ms of three reads (the decoder's g++ build timed
    apart).  The PyanNet and aligner trees must equal their committed
    ``pytorch_model.bin`` exports passed through the port's converters
    (``convert_pyannote_segmentation``, ``convert_wav2vec2_state_dict``)
    bit for bit; ``tests/test_torch_export.py`` holds those exports equal
    to orbax's trees.  A copy of the PyanNet tree with the first byte of a
    chunk's zstd frame flipped must fail to read."""
    import shutil
    from manual_whisper_tpu_torch import ocdbt
    from manual_whisper_tpu_torch.convert import (
        convert_pyannote_segmentation, convert_wav2vec2_state_dict)
    from manual_whisper_tpu_torch.from_hf import load_params
    from manual_whisper_tpu_torch.models.wav2vec2 import Wav2Vec2Config
    t0 = time.perf_counter()
    ocdbt.crc32c(b"")                            # builds libmwx_zstd
    build_ms = 1e3 * (time.perf_counter() - t0)
    trees, read = {}, {}
    for rel in CHECKPOINT_TREES:
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            tree = load_params(os.path.join(ROOT, rel))
            times.append(1e3 * (time.perf_counter() - t0))
        if tree is None:
            raise AssertionError(f"checkpoint: no tree at {rel}")
        leaves = [x for _, x in _tree_leaves(tree)]
        trees[rel] = tree
        read[rel] = {"leaves": len(leaves),
                     "bytes": int(sum(x.nbytes for x in leaves)),
                     "read_ms": times}
    seg_dir = os.path.join(ROOT, ".weights", "pyannote-segmentation-3.0")
    sd = torch.load(os.path.join(seg_dir, "pytorch_model.bin"),
                    map_location="cpu", weights_only=True)
    sd = sd.get("state_dict", sd)
    align_dir = os.path.join(
        ROOT, ".weights", "jonatasgrosman--wav2vec2-large-xlsr-53-english")
    with open(os.path.join(align_dir, "align_meta.json"),
              encoding="utf-8") as f:
        w2v_cfg = Wav2Vec2Config(**json.load(f)["config"])
    exports = {
        "pyannote-segmentation-3.0": _bit_equal(
            trees[CHECKPOINT_TREES[1]], convert_pyannote_segmentation(sd)),
        "wav2vec2-large-xlsr-53-english": _bit_equal(
            trees[CHECKPOINT_TREES[2]], convert_wav2vec2_state_dict(
                torch.load(os.path.join(align_dir, "pytorch_model.bin"),
                           map_location="cpu", weights_only=True),
                w2v_cfg))}
    copy_dir = os.path.join(workdir, "flipped")
    shutil.copytree(os.path.join(seg_dir, "jax"), copy_dir)
    store = ocdbt.KvStore(copy_dir)
    key, (file, offset, _) = next(
        (k, v) for k, v in store.refs.items()
        if not k.endswith(b"/.zarray") and not isinstance(v, bytes))
    with open(os.path.join(copy_dir, file[0] + file[1]), "r+b") as f:
        f.seek(offset)
        byte = f.read(1)
        f.seek(offset)
        f.write(bytes([byte[0] ^ 0x10]))
    try:
        load_params(copy_dir)
        flipped = "read without an error"
    except ValueError as exc:
        flipped = f"{type(exc).__name__}: {exc}"
    log(json.dumps({"phase": "checkpoint", "zstd_build_ms": build_ms,
                    "trees": read, "exports_bit_equal": exports,
                    "flipped_chunk": key.decode(), "flipped_read": flipped}))
    if not all(exports.values()):
        raise AssertionError(f"checkpoint: a tree differs from its export: "
                             f"{exports}")
    if flipped == "read without an error":
        raise AssertionError("checkpoint: a flipped byte in a chunk was read "
                             "without an error")


@contextlib.contextmanager
def _registry(path):
    """``MWX_WEIGHTS_DIR`` set to ``path`` for the block."""
    from manual_whisper_tpu_torch import config as port_config
    saved = os.environ.pop("MWX_WEIGHTS_DIR", None)
    os.environ["MWX_WEIGHTS_DIR"] = path
    port_config.clear_env_cache()
    try:
        yield
    finally:
        os.environ.pop("MWX_WEIGHTS_DIR", None)
        if saved is not None:
            os.environ["MWX_WEIGHTS_DIR"] = saved
        port_config.clear_env_cache()


@contextlib.contextmanager
def _embed_forwards():
    """The list of every ``DiarizationPipeline.embed_rows`` call in the
    block, each as (rows, samples, ResNet or not): one K1 launch each."""
    from manual_whisper_tpu_torch.models import diarize as dmod
    forwards = []
    real = dmod.DiarizationPipeline.embed_rows

    def counted(self, rows, frames):
        forwards.append((*rows.shape, self.embedding is not None))
        return real(self, rows, frames)
    dmod.DiarizationPipeline.embed_rows = counted
    try:
        yield forwards
    finally:
        dmod.DiarizationPipeline.embed_rows = real


def _swap_bn_stats(model):
    """A copy of the ResNet34 with one BatchNorm's running mean and
    running variance swapped."""
    bad = copy.deepcopy(model)
    bn = bad.stages[1][0].bn1
    with torch.no_grad():
        mean = bn.running_mean.clone()
        bn.running_mean.copy_(bn.running_var)
        bn.running_var.copy_(mean.abs())
    return bad


def _diarize_pair(dev, **kw):
    from manual_whisper_tpu_torch.models.diarize import DiarizationPipeline
    return (DiarizationPipeline(device=dev, **kw),
            DiarizationPipeline(device="cpu", **kw))


def _entry_embeddings(state):
    return torch.from_numpy(np.stack([e[2] for e in state["entries"]]))


def phase_diarize(dev, registry: str) -> None:
    """``DiarizationPipeline`` on the card and on the CPU over a seeded
    ``render_conversation`` (3 speakers, about 2 minutes), both loading
    their weights from ``registry`` (``make_registry`` with the ResNet): the
    segmentation PyanNet and the ResNet34 trained on synthetic speakers,
    both from their orbax ``jax/`` trees: the entries' embeddings within
    TOL["diarize_emb"], segments equal, DER against the reference turns
    printed for both and equal.  The ResNet path must have run: its
    weights loaded and K1 launched once a 32-row forward, at 80 mels.  A
    planted fault (one BatchNorm's running mean and variance swapped) must
    exceed the tolerance.  The speakers found are printed.  Then the two
    fallbacks, each card vs CPU with K1 counted: no embedding weights (a
    registry without the speaker embedder; 40-mel statistics of the
    32-row clip buckets), and no segmentation
    weights (an empty registry; the windows flow: 256-row forwards of 3 s
    windows).  Times: ``diarize_s``, device ms of a
    16-window segmentation batch and of one 32-row ResNet forward (K1 and
    the network) per bucket, host ms of the clustering."""
    import tempfile
    from manual_whisper_tpu_torch.eval.metrics import der
    from manual_whisper_tpu_torch.eval.synth import (render_conversation,
                                                     turns_to_rttm)
    from manual_whisper_tpu_torch.models.vad import PYANNET_CHUNK
    os.environ["MWX_ALLOW_SYNTH_WEIGHTS"] = "1"
    audio, turns = render_conversation(**CONVERSATION)
    ref_turns = turns_to_rttm(turns)
    with _registry(registry):
        gpu, cpu = _diarize_pair(dev)
    if gpu.vad.model is None or gpu.vad.model.sinc.device != gpu.device \
            or gpu.embedding is None or gpu.embedding_cfg.n_mels != 80 \
            or next(gpu.embedding.parameters()).device != gpu.device:
        raise AssertionError("diarize: PyanNet and the ResNet34 are not "
                             "both on the card")
    gpu(audio)                                   # cuDNN set-up
    torch.cuda.synchronize()
    _build.launches.clear()
    t0 = time.perf_counter()
    with _embed_forwards() as calls:
        segs = gpu(audio)
        torch.cuda.synchronize()
    diarize_s = time.perf_counter() - t0
    launches = dict(_build.launches)
    if not calls or launches != {"mel": len(calls)} \
            or any(c[0] != 32 or not c[2] for c in calls):
        raise AssertionError(f"diarize: K1 launches {launches} for the "
                             f"ResNet's forwards {calls}")
    st_gpu = gpu._segment_and_embed(audio)
    st_cpu = cpu._segment_and_embed(audio)
    if [e[:2] for e in st_gpu["entries"]] != \
            [e[:2] for e in st_cpu["entries"]]:
        raise AssertionError("diarize: the card's active local speakers "
                             "differ from the CPU's")
    emb_err = max_err(_entry_embeddings(st_gpu), _entry_embeddings(st_cpu))
    cpu_segs = cpu._cluster_and_stitch(st_cpu, len(audio), None, None)
    host_ms = _best_ms(lambda: gpu._cluster_and_stitch(st_gpu, len(audio),
                                                       None, None))
    good = gpu.embedding
    gpu.embedding = _swap_bn_stats(good)
    fault_err = max_err(_entry_embeddings(gpu._segment_and_embed(audio)),
                        _entry_embeddings(st_cpu))
    gpu.embedding = good

    # device times: one segmentation batch, one ResNet forward per bucket
    gen = torch.Generator(device=dev).manual_seed(4)
    window = int(gpu.vad.cfg.window_sec * 16000)
    with torch.inference_mode():
        x = 0.1 * torch.randn(PYANNET_CHUNK, window, generator=gen,
                              device=dev)
        seg_ms = _event_ms(lambda: gpu.vad.model(x), 5)
        resnet_ms = {}
        for sec in gpu._EMBED_LEN_BUCKETS_SEC:
            x = 0.1 * torch.randn(32, int(sec * 16000), generator=gen,
                                  device=dev)
            gpu.embedding(unnormalized_log_mel(x, 80))
            resnet_ms[f"{sec}s"] = _event_ms(
                lambda: gpu.embedding(unnormalized_log_mel(x, 80)), 3)
    del cpu

    # the fallbacks: no embedding weights (no speaker embedder in the
    # registry), then no segmentation weights either (an empty registry)
    fallbacks = {}
    with tempfile.TemporaryDirectory() as tmp:
        no_embedder = tmp + "/no_embedder"
        empty = tmp + "/empty"
        os.makedirs(no_embedder)
        os.makedirs(empty)
        make_registry(no_embedder, resnet=False)
        for flow in ("stats_embeddings", "windows"):
            with _registry(no_embedder if flow == "stats_embeddings"
                           else empty):
                f_gpu, f_cpu = _diarize_pair(dev)
            if f_gpu.embedding is not None or \
                    (f_gpu.vad.model is None) != (flow == "windows"):
                raise AssertionError(f"diarize {flow}: the pipeline loaded "
                                     "other weights than expected")
            _build.launches.clear()
            t0 = time.perf_counter()
            with _embed_forwards() as f_calls:
                f_segs = f_gpu(audio)
                torch.cuda.synchronize()
            f_s = time.perf_counter() - t0
            f_launches = dict(_build.launches)
            rows = 256 if flow == "windows" else 32
            if not f_calls or f_launches != {"mel": len(f_calls)} \
                    or any(c[0] != rows or c[2] for c in f_calls):
                raise AssertionError(f"diarize {flow}: K1 launches "
                                     f"{f_launches} for {f_calls}")
            f_ref = f_cpu(audio)
            f_err = None if flow == "windows" else max_err(
                _entry_embeddings(f_gpu._segment_and_embed(audio)),
                _entry_embeddings(f_cpu._segment_and_embed(audio)))
            fallbacks[flow] = {
                "segments": len(f_segs), "equal": f_segs == f_ref,
                "speakers": len({s["speaker"] for s in f_segs}),
                "der_card": der(ref_turns, f_segs),
                "der_cpu": der(ref_turns, f_ref), "diarize_s": f_s,
                "k1_launches": f_launches.get("mel", 0),
                "forward_shapes": sorted({tuple(c[:2]) for c in f_calls}),
                "embedding_max_abs_err": f_err}

    line = {
        "phase": "diarize", "audio_s": len(audio) / 16000.0,
        "speakers_ref": len({t["speaker"] for t in ref_turns}),
        "resnet34": "trained on synthetic speakers, the registry's orbax "
                    "jax/ tree",
        "entries": len(st_gpu["entries"]), "segments": len(segs),
        "segments_equal": segs == cpu_segs,
        "speakers": sorted({s["speaker"] for s in segs}),
        "speakers_cpu": sorted({s["speaker"] for s in cpu_segs}),
        "der_card": der(ref_turns, segs), "der_cpu": der(ref_turns, cpu_segs),
        "embedding_max_abs_err": emb_err, "tol": TOL["diarize_emb"],
        "fault_bn_stats_swapped_err": fault_err,
        "k1_launches": launches.get("mel", 0),
        "forward_shapes": sorted({tuple(c[:2]) for c in calls}),
        "diarize_s": diarize_s,
        "segmentation_16_windows_device_ms": seg_ms,
        "resnet_32_rows_device_ms": resnet_ms,
        "cluster_host_ms": host_ms, "fallbacks": fallbacks}
    log(json.dumps(line))
    compare("diarize_emb", _entry_embeddings(st_gpu),
            _entry_embeddings(st_cpu))
    if segs != cpu_segs or not segs:
        raise AssertionError(f"diarize: segments differ or are empty: "
                             f"{segs[:4]} vs {cpu_segs[:4]}")
    if not fault_err > TOL["diarize_emb"][0]:
        raise AssertionError(f"diarize: the tolerance does not catch the "
                             f"swapped BatchNorm statistics ({fault_err})")
    for flow, f in fallbacks.items():
        if not f["equal"] or not f["segments"] or f["der_card"] != \
                f["der_cpu"]:
            raise AssertionError(f"diarize {flow}: card and CPU differ: {f}")
        if f["embedding_max_abs_err"] is not None:
            if not f["embedding_max_abs_err"] <= TOL["diarize_emb"][0]:
                raise AssertionError(f"diarize {flow}: embeddings {f}")


def phase_cli(workdir: str, registry: str) -> None:
    """``cli.main`` on a WAV of the diarize phase's conversation, on the
    card, with ``HF_TOKEN`` set and ``MWX_ALLOW_RANDOM_WEIGHTS=1`` (random
    large-v3 in bf16; the zh default aligner is not in the repository, so
    the tiny random aligner) and the diarize phase's ``registry`` (its
    PyanNet and its trained ResNet34, both from their orbax trees, which
    every embedding forward must run):
    every stage must run (no "对齐失败" or
    "说话人分离失败" line), the Markdown must have ``### SPEAKER_``
    headings, and every segment of the JSON must carry ``speaker``
    (``words`` are counted: the random aligner's vocabulary may hold none of
    the random model's characters)."""
    import contextlib
    import io
    from manual_whisper_tpu_torch import cli
    from manual_whisper_tpu_torch import config as port_config
    from manual_whisper_tpu_torch.eval.synth import render_conversation
    audio, _ = render_conversation(**CONVERSATION)
    path = os.path.join(workdir, "meeting.wav")
    with open(path, "wb") as f:
        f.write(_wav_bytes(audio, 16000))
    os.environ.update({"HF_TOKEN": "hf_smoke", "MWX_ALLOW_RANDOM_WEIGHTS": "1",
                       "WHISPER_MODEL": "large-v3"})
    port_config.clear_env_cache()
    cwd = os.getcwd()
    printed = io.StringIO()
    t0 = time.perf_counter()
    try:
        os.chdir(workdir)
        with contextlib.redirect_stdout(printed), _registry(registry), \
                _embed_forwards() as forwards:
            rc = cli.main([path])
    finally:
        os.chdir(cwd)
        os.environ.pop("HF_TOKEN", None)
    cli_s = time.perf_counter() - t0
    out = printed.getvalue()
    for ln in out.splitlines():
        log(f"  cli: {ln}")
    md = open(os.path.join(workdir, "meeting_transcript.md"),
              encoding="utf-8").read()
    with open(os.path.join(workdir, "meeting_transcript.json"),
              encoding="utf-8") as f:
        result = json.load(f)
    segs = result["segments"]
    line = {"phase": "cli", "audio_s": len(audio) / 16000.0, "rc": rc,
            "cli_s": cli_s, "segments": len(segs),
            "speakers": sorted({s.get("speaker") for s in segs
                                if s.get("speaker")}),
            "words": sum(len(s.get("words", [])) for s in segs),
            "speaker_headings": md.count("### SPEAKER_"),
            "embed_forwards": len(forwards),
            "resnet_forwards": sum(f[2] for f in forwards)}
    log(json.dumps(line))
    if rc != 0 or "对齐失败" in out or "说话人分离失败" in out \
            or "👥 识别说话人..." not in out or "   对齐耗时" not in out:
        raise AssertionError("cli: a stage did not run")
    if not forwards or not all(f[2] for f in forwards):
        raise AssertionError(f"cli: the diarizer did not embed with the "
                             f"registry's ResNet34: {forwards}")
    if not segs or not all("speaker" in s for s in segs) \
            or "### SPEAKER_" not in md:
        raise AssertionError("cli: segments without speakers, or no "
                             "speaker headings")


# ---------------------------------------------------------------------------
# Phase 8: the fine-tuning step (training/) and the mesh path (parallel/)
# ---------------------------------------------------------------------------

# the test config's train step, card vs CPU, both float32 with TF32 off:
# the loss's relative error at each of TRAIN_STEPS steps; the first step's
# gradients (its first moment, 0.1 g) over each leaf's largest magnitude;
# and the params after TRAIN_STEPS AdamW updates on the card from the
# CPU's gradients (abs).  The card's own gradients are not fed to the
# params comparison: Adam's update lr * g / (|g| + eps) turns the last bits
# of a gradient near eps into a good part of lr, and the trajectories part
# there.  The planted fault (the loss mask ignored) must exceed the loss's
# limit.
TRAIN_TOL = {"loss": 1e-5, "grads": 1e-5, "params": 1e-6}
TRAIN_STEPS = 3


def _train_steps(cfg, params, batch, steps: int, lr: float, mesh=None,
                 grads=None):
    """``steps`` AdamW steps on one batch; returns (state, losses).  With
    ``grads`` (a list) each step's gradients are appended to it."""
    from manual_whisper_tpu_torch.training import (adamw, init_train_state,
                                                   make_train_step)
    optimizer = adamw(lr)
    if grads is not None:
        update = optimizer.update

        def recorded(g, state, leaves):
            grads.append([x.clone() for x in g])
            update(g, state, leaves)
        optimizer.update = recorded
    state = init_train_state(params, optimizer)
    step = make_train_step(cfg, optimizer, mesh=mesh)
    losses = []
    for _ in range(steps):
        state, loss = step(state, *batch)
        losses.append(float(loss))
    return state, losses


def phase_train(dev) -> None:
    """The test config at f32, card vs CPU: TRAIN_STEPS AdamW steps (lr
    1e-3) on one seeded batch whose rows carry different label counts,
    held to TRAIN_TOL (the losses, the first step's gradients, and the
    params the card's AdamW makes of the CPU's gradients), and the loss
    mask ignored on the card must exceed it.  Then large-v3 at full width and depth in bf16 (seeded random
    weights): batch 2 of 30 s windows of seeded synthetic speech, each
    step's log-mel through K1 (``training.features``), tokens at
    n_text_ctx with the loss over the first 200, TRAIN_STEPS steps at lr
    1e-5 on the same batch; the launch counters are zeroed before the
    steps and read after (K1 once a step, K2 never: the encoder trains
    through its einsum attention), the losses must be finite and the last
    below the first; ms per step of steps 2 on, and peak memory; then
    ``torch.profiler`` over one more step (device busy share, top
    kernels)."""
    from manual_whisper_tpu_torch.models.whisper import (MODEL_CONFIGS,
                                                         init_params)
    from manual_whisper_tpu_torch.parallel.dryrun import train_batch
    from manual_whisper_tpu_torch.training import features
    from manual_whisper_tpu_torch.parallel.dryrun import max_leaf_err
    from manual_whisper_tpu_torch.training import adamw, init_train_state
    from manual_whisper_tpu_torch.training.optim import tree_leaves
    cpu = torch.device("cpu")
    cfg = MODEL_CONFIGS["test"]
    batch = train_batch(4, cfg, seed=5)
    on_card = tuple(x.to(dev) for x in batch)

    def fresh(d):
        return _to(init_params(cfg, cpu, seed=3), d)

    grads = []
    ref_state, ref_losses = _train_steps(cfg, fresh(cpu), batch,
                                         TRAIN_STEPS, 1e-3, grads=grads)
    state, losses = _train_steps(cfg, fresh(dev), on_card, TRAIN_STEPS, 1e-3)
    one_ref, _ = _train_steps(cfg, fresh(cpu), batch, 1, 1e-3)
    one, _ = _train_steps(cfg, fresh(dev), on_card, 1, 1e-3)
    optimizer = adamw(1e-3)
    fed = init_train_state(fresh(dev), optimizer)
    for g in grads:
        optimizer.update([x.to(dev) for x in g], fed.opt_state,
                         tree_leaves(fed.params))
    to_cpu = functools.partial(_to, d=cpu)
    errs = {"loss": max(abs(a - b) / abs(b)
                        for a, b in zip(losses, ref_losses)),
            "grads": max_leaf_err(to_cpu(one.opt_state.mu),
                                  one_ref.opt_state.mu, relative=True),
            "params": max_leaf_err(to_cpu(fed.params), ref_state.params)}
    unmasked = (batch[0], batch[1], torch.ones_like(batch[2]))
    _, fault_losses = _train_steps(cfg, fresh(dev),
                                   tuple(x.to(dev) for x in unmasked),
                                   TRAIN_STEPS, 1e-3)
    fault = max(abs(a - b) / abs(b) for a, b in zip(fault_losses,
                                                      ref_losses))
    log(json.dumps({"phase": "train_test_config", "steps": TRAIN_STEPS,
                    "losses": losses, "losses_cpu": ref_losses,
                    "errors": errs, "tol": TRAIN_TOL,
                    "params_own_gradients_max_abs_err": max_leaf_err(
                        to_cpu(state.params), ref_state.params),
                    "fault_mask_ignored_loss_err": fault}))
    for k, tol in TRAIN_TOL.items():
        if not errs[k] <= tol:
            raise AssertionError(f"train: {k} error {errs[k]} exceeds {tol}")
    if not fault > TRAIN_TOL["loss"]:
        raise AssertionError(f"train: the loss tolerance does not catch the "
                             f"ignored loss mask ({fault})")

    cfg = MODEL_CONFIGS["large-v3"]
    torch.cuda.empty_cache()
    params = init_params(cfg, dev, seed=0)
    audio = torch.from_numpy(np.stack([synthetic_speech(30.0, seed=s)
                                       for s in (11, 12)])).to(dev)
    rng = np.random.default_rng(11)
    tokens = torch.from_numpy(rng.integers(
        0, 50000, (2, cfg.n_text_ctx))).to(dev)
    mask = torch.zeros((2, cfg.n_text_ctx), device=dev)
    mask[:, :200] = 1.0
    from manual_whisper_tpu_torch.training import (adamw, init_train_state,
                                                   make_train_step)
    optimizer = adamw(1e-5)
    state = init_train_state(params, optimizer)
    step = make_train_step(cfg, optimizer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    losses, ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, loss = step(state, features(audio, cfg), tokens, mask)
        losses.append(float(loss))          # waits for the step
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    launches = dict(_build.launches)
    line = {"phase": "train_large_v3", "batch": 2, "tokens": cfg.n_text_ctx,
            "labels_per_row": 200, "dtype": "bfloat16",
            "moments_dtype": str(state.opt_state.mu["decoder"]["tok_emb"]
                                 .dtype), "losses": losses,
            "ms_per_step": ms[1:], "ms_first_step": ms[0],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": launches, "card": card_line()}
    log(json.dumps(line))
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train large-v3: losses {losses}")
    if launches.get("mel") != TRAIN_STEPS or launches.get("flash_attention"):
        raise AssertionError(f"train large-v3: launches {launches}, expected "
                             f"mel {TRAIN_STEPS} and no flash_attention")
    if line["moments_dtype"] != "torch.bfloat16":
        raise AssertionError(f"train large-v3: moments in "
                             f"{line['moments_dtype']}")
    prof = _profiled(lambda: step(state, features(audio, cfg), tokens, mask),
                     1)
    log(json.dumps({"phase": "profile_train_step", "model": "large-v3",
                    **prof}))


def tp_kernel_checks(dev, main: dict) -> None:
    """K2-K6 against their plain versions at the local shapes a tp=2 shard
    of large-v3 gives them (``kernel_check`` lines): 10 heads for K2-K5,
    K6 at the column shards (K, N) = (1280, 640) and (1280, 2560) and the
    row shards (640, 1280) and (2560, 1280), at a decode step's M = 4 and
    the encoder's M = 4 x 1500."""
    from manual_whisper_tpu_torch.models.whisper import quantize_cross_kv
    randn = seeded_randn(dev, 4321)
    b, dh, ta, t_max = main["batch"], main["dh"], main["ta"], main["t_max"]
    h = main["heads"] // 2
    errs = {}
    q, k, v = (randn((b, h, 1500, dh)) for _ in range(3))
    errs["flash_attention"] = compare(
        "flash_attention", flash_attention(q, k, v), attention_plain(q, k, v))
    q1 = randn((b, h, 1, dh))
    ks, vs = randn((b, h, t_max, dh), scale=3.0), randn((b, h, t_max, dh))
    for pos in (0, t_max // 2, t_max - 1):
        p = torch.full((1,), pos, dtype=torch.int32, device=dev)
        errs[f"decode_self_attention pos={pos}"] = compare(
            "decode_self_attention", decode_self_attention(q1, ks, vs, p),
            attend_plain(q1, ks, vs, pos + 1))
    kc, vc = randn((b, h, ta, dh)), randn((b, h, ta, dh))
    n = torch.full((1,), ta, dtype=torch.int32, device=dev)
    errs["decode_cross_attention"] = compare(
        "decode_cross_attention", decode_cross_attention(q1, kc, vc, n),
        attend_plain(q1, kc, vc, ta))
    k_q, k_s, v_q, v_s = quantize_cross_kv(kc, vc)
    errs["decode_cross_attention_int8"] = compare(
        "decode_cross_attention_int8",
        decode_cross_attention_int8(q1, k_q, k_s, v_q, v_s, n),
        attend_int8_plain(q1, k_q, k_s, v_q, v_s, ta))
    for kk, nn in ((1280, 640), (1280, 2560), (640, 1280), (2560, 1280)):
        w = quantize_weight(randn((kk, nn), torch.float32,
                                  scale=kk ** -0.5))
        for m in (b, b * 1500):
            x = randn((m, kk))
            errs[f"int8_matmul M={m} K={kk} N={nn}"] = compare(
                "int8_matmul", int8_matmul(x, w["q"], w["s"]),
                int8_matmul_plain(x, w["q"], w["s"]))
    log(json.dumps({"phase": "kernel_check", "what": "tp=2 local shapes",
                    "heads": h, "max_abs_err": errs,
                    "tol": {name: TOL[name] for name in SOURCES
                            if name != "mel"}}))


@contextlib.contextmanager
def _counted_collectives():
    """Counts of the ``torch.distributed`` all-reduce and all-gather calls
    made inside the block (the mesh code calls them through the module;
    a replayed capture makes none)."""
    import torch.distributed as dist
    calls = collections.Counter()
    saved = {name: getattr(dist, name) for name in ("all_reduce",
                                                     "all_gather")}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call
    for name, fn in saved.items():
        setattr(dist, name, counted(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def _train_all_reduces(cfg, n_leaves: int) -> int:
    """All-reduces of one train step on a mesh whose groups both exist:
    forward, the row-parallel outputs (o and fc2 of an encoder block; o,
    cross o and fc2 of a decoder block); backward, the column-parallel
    inputs (ln1 and ln2 of an encoder block; a decoder block's ln1 twice,
    once for its K/V and once for its q, lnx and ln2; the encoder output
    once for every cross K/V); then the label count, every gradient leaf
    and the loss over the data group."""
    return (4 * cfg.n_audio_layer + 7 * cfg.n_text_layer + 1
            + 2 + n_leaves)


def phase_mesh(dev, workdir: str) -> None:
    """A one-rank NCCL world (a file store in ``workdir``), whose mesh
    keeps its data and model groups (``parallel.axis_group``), so every
    collective of the mesh path runs: large-v3 from
    ``load_model(mesh=make_mesh(1, 1))`` transcribes phase 4's audio to
    the segments of the meshless pipeline on the same weights (both
    warmed up, launches exact, every step replayed; each row-parallel
    output's NCCL all-reduce is captured inside the decode chunks, the
    results are gathered over the data group); a test-config train step
    with the mesh equals the step without and makes every all-reduce of
    the sharded step (``_train_all_reduces``: the Megatron operators
    forward and backward, the label count, the gradients); then K2-K6 at
    the tp=2 local shapes (``tp_kernel_checks``).  Where the machine has
    two or more GPUs, ``parallel.dryrun`` under torchrun on two of them
    (dp=2) must match one process; else a ``mesh_multi`` line says it did
    not run."""
    import torch.distributed as dist
    from manual_whisper_tpu_torch.models.whisper import (MODEL_CONFIGS,
                                                         init_params)
    from manual_whisper_tpu_torch.parallel import make_mesh
    from manual_whisper_tpu_torch.parallel.dryrun import (max_leaf_err,
                                                          train_batch)
    from manual_whisper_tpu_torch.training.optim import tree_leaves
    torch.cuda.set_device(dev)          # the device the NCCL ranks use
    dist.init_process_group(
        "nccl", init_method=f"file://{os.path.join(workdir, 'nccl_store')}",
        rank=0, world_size=1)
    try:
        mesh = make_mesh(1, model_parallel=1)
        model, _ = load_main_model("bfloat16", False)
        main = main_path_shapes(model)
        expected, _, _, ref_line = _mode_transcribe(
            model, "bfloat16", ("_loops",), "mesh_reference")
        del model
        torch.cuda.empty_cache()
        sharded, load_s = load_main_model("bfloat16", False, mesh=mesh)
        with _counted_collectives() as infer_calls:
            got, _, launches, line = _mode_transcribe(
                sharded, "bfloat16", ("_loops",), "mesh_one_rank")
        same = _segment_keys(got) == _segment_keys(expected)
        del sharded
        torch.cuda.empty_cache()
        cfg = MODEL_CONFIGS["test"]
        batch = tuple(x.to(dev) for x in train_batch(2, cfg, seed=6))
        plain, plain_losses = _train_steps(
            cfg, init_params(cfg, dev, seed=4), batch, 1, 1e-3)
        with _counted_collectives() as train_calls:
            meshed, mesh_losses = _train_steps(
                cfg, init_params(cfg, dev, seed=4), batch, 1, 1e-3,
                mesh=mesh)
        train_err = max_leaf_err(meshed.params, plain.params)
        want_reduces = _train_all_reduces(cfg,
                                          len(tree_leaves(meshed.params)))
        log(json.dumps({**line, "load_s": load_s, "world": 1,
                        "backend": dist.get_backend(),
                        "mesh": {"data": 1, "model": 1},
                        "segments_equal_meshless": same,
                        "meshless_wall_s": ref_line["wall_s"],
                        "collective_calls": dict(infer_calls),
                        "train_loss": mesh_losses[0],
                        "train_loss_meshless": plain_losses[0],
                        "train_params_max_abs_err": train_err,
                        "train_collective_calls": dict(train_calls),
                        "train_all_reduces_expected": want_reduces}))
        if not same:
            raise AssertionError("mesh: a one-rank mesh's segments differ "
                                 "from the meshless pipeline's")
        if not (infer_calls["all_reduce"] and infer_calls["all_gather"]):
            raise AssertionError("mesh: the one-rank mesh's transcription "
                                 f"ran no collective ({dict(infer_calls)})")
        if mesh_losses != plain_losses or train_err != 0.0:
            raise AssertionError("mesh: the one-rank mesh's train step "
                                 "differs from the step without a mesh")
        if train_calls["all_reduce"] != want_reduces:
            raise AssertionError(
                f"mesh: the train step made {train_calls['all_reduce']} "
                f"all-reduces, not {want_reduces}")
    finally:
        dist.destroy_process_group()
    tp_kernel_checks(dev, main)
    n = torch.cuda.device_count()
    if n < 2:
        log(json.dumps({"phase": "mesh_multi", "ran": False, "devices": n}))
        return
    report = os.path.join(workdir, "mesh_multi.json")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "-m", "manual_whisper_tpu_torch.parallel.dryrun", "--meshes",
         "2x1", "--modes", "greedy,timestamps", "--report", report],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    log(json.dumps({"phase": "mesh_multi", "ran": True, "devices": n,
                    "returncode": proc.returncode,
                    "lines": (json.load(open(report)) if proc.returncode == 0
                              else proc.stderr[-2000:])}))
    if proc.returncode != 0:
        raise AssertionError("mesh_multi: the dp=2 world failed")


# ---------------------------------------------------------------------------
# The fetch worker (pipeline/transcribe.py) and the launcher
# (parallel/launch.py)
# ---------------------------------------------------------------------------

FETCH_SECONDS = 400.0


def _first_batch_logprobs(model, audio) -> tuple:
    """(avg logprobs of the first batch's real rows, windows) of a
    transcription at batch 4 with the gates off (one loop a batch)."""
    from manual_whisper_tpu_torch.models import decode as dec_mod
    probe = _mode_pipeline(model, log_prob_threshold=None,
                           compression_ratio_threshold=None)
    found = []
    real = dec_mod.BatchDecoder.decode_with_fallback

    def spy(dec, xa, first=None, n_valid=None, rng_tag=0):
        out = real(dec, xa, first=first, n_valid=n_valid, rng_tag=rng_tag)
        if rng_tag == 0:
            found.extend(r.avg_logprob for r in out[:n_valid])
        return out
    dec_mod.BatchDecoder.decode_with_fallback = spy
    try:
        probe.transcribe(audio, batch_size=BATCH, language="zh")
    finally:
        dec_mod.BatchDecoder.decode_with_fallback = real
    return found, probe.last_stats["windows"]


def phase_fetch(dev) -> None:
    """The fetch worker at large-v3 (bf16, batch 4, seeded random weights,
    the CLI's options) on about 400 s of seeded speech (at least four
    batches).  A first transcription with the gates off reads the first
    batch's rows' average logprobs; the log-prob gate is then set between
    two of them, so that one or two of its rows fail (random weights then
    fail every sampled rung: those rows climb the whole ladder) and its
    retries take a smaller bucket than the dispatch thread ever uses.
    After ``warmup`` that bucket's loop is dropped, so the worker thread
    captures it while the dispatch thread encodes and decodes the next
    batches.  ``transcribe`` runs with the worker and then with
    ``MWX_FETCH_WORKER=0``, then with the worker again (every bucket
    captured, so its wall is the one to set beside the serial path's):
    segments and ``last_stats`` counts equal, launches exact (the
    capture's eager warm-up steps added), every decode step replayed, the
    capture made on the worker in the first run; each run's wall,
    capture, decode-loop and finalize seconds (``span_s``) and
    ``encode_s``, beside the card."""
    import threading
    from manual_whisper_tpu_torch import config as port_config
    from manual_whisper_tpu_torch.models import graphs as graphs_mod
    from manual_whisper_tpu_torch.pipeline.chunking import _bucket_for
    model, load_s = load_main_model("bfloat16", False)
    audio = synthetic_speech(FETCH_SECONDS, seed=3)
    lps, windows = _first_batch_logprobs(model, audio)
    tail = windows % BATCH
    dispatch_buckets = {BATCH} | ({_bucket_for(tail, BATCH)} if tail else set())
    order = sorted(lps)
    choice = [(order[k] - order[k - 1], k) for k in (1, 2)
              if k < len(order) and _bucket_for(k, BATCH)
              not in dispatch_buckets]
    if windows < 4 * BATCH - 3 or not choice or max(choice)[0] < 1e-3:
        raise AssertionError(f"fetch: no gate fits: {windows} windows, first "
                             f"batch logprobs {lps}")
    failing = max(choice)[1]
    threshold = 0.5 * (order[failing - 1] + order[failing])
    retry_rows = _bucket_for(failing, BATCH)
    pipe = _mode_pipeline(model, log_prob_threshold=threshold,
                          compression_ratio_threshold=None)
    decoder = pipe._decoder("zh", 0.0)
    pipe.warmup(batch_size=BATCH, language="zh")
    torch.cuda.synchronize()
    dropped = [k for k in decoder._loops if k[0] == retry_rows]
    for key in dropped:
        del decoder._loops[key]
    captures = []
    real_capture = graphs_mod.ChunkGraphs.capture

    def capture(graphs, n, fn, reset):
        captures.append(threading.current_thread().name)
        return real_capture(graphs, n, fn, reset)
    graphs_mod.ChunkGraphs.capture = capture
    runs = {}
    try:
        for name, worker in (("worker", "1"), ("serial", "0"),
                             ("worker_again", "1")):
            os.environ["MWX_FETCH_WORKER"] = worker
            port_config.clear_env_cache()
            replays_before = graph_replays(decoder)
            _build.launches.clear()
            n_captures = len(captures)
            capture_s = decoder.stats["capture_s"]
            t0 = time.perf_counter()
            result = pipe.transcribe(audio, batch_size=BATCH, language="zh")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(_build.launches)
            stats = dict(pipe.last_stats)
            replayed = sum(n * (c - replays_before.get((rows, n), 0))
                           for (rows, n), c in graph_replays(decoder).items())
            new = captures[n_captures:]
            expected = expected_launches(pipe.cfg, stats, False)
            if new:
                # each captured chunk first runs its steps eagerly
                warm = sum(decoder._loops[dropped[0]].chunk_lengths())
                ld = pipe.cfg.n_text_layer
                for k in ("decode_self_attention", "decode_cross_attention"):
                    expected[k] += ld * warm
                expected["add_layer_norm"] += (3 * ld + 1) * warm
            runs[name] = {"result": result, "stats": stats, "wall": wall,
                          "launches": launches, "expected": expected,
                          "replayed_steps": replayed, "captures": new,
                          "capture_s": decoder.stats["capture_s"] - capture_s}
    finally:
        graphs_mod.ChunkGraphs.capture = real_capture
        os.environ.pop("MWX_FETCH_WORKER", None)
        port_config.clear_env_cache()
    counts = ("batches", "windows", "rows", "token_rows", "decode_calls",
              "decode_steps", "beam_calls", "beam_steps", "rung_rows")
    w, s, w2 = runs["worker"], runs["serial"], runs["worker_again"]
    line = {"phase": "fetch", "model": "large-v3", "compute_type": "bfloat16",
            "audio_s": FETCH_SECONDS, "load_s": load_s,
            "log_prob_threshold": threshold, "first_batch_logprobs": lps,
            "uncaptured_rows": retry_rows,
            "counts": {k: w["stats"][k] for k in counts},
            "counts_equal": all(w["stats"][k] == s["stats"][k]
                                == w2["stats"][k] for k in counts),
            "segments": len(w["result"]["segments"]),
            "segments_equal": w["result"] == s["result"] == w2["result"],
            "captures": {k: r["captures"] for k, r in runs.items()},
            "card": card_line()}
    for name, run in runs.items():
        line[name] = {"wall_s": run["wall"], "capture_s": run["capture_s"],
                      "decode_loop_s": span_s(run["stats"],
                                              "decode.loop"),
                      "finalize_s": span_s(run["stats"], "finalize.batch"),
                      "encode_s": run["stats"]["encode_s"],
                      "vad_s": run["stats"]["vad_s"],
                      "replayed_steps": run["replayed_steps"],
                      "launches_exact": run["launches"] == run["expected"],
                      "launches": run["launches"]}
    log(json.dumps(line))
    if w["stats"]["batches"] < 4:
        raise AssertionError(f"fetch: {w['stats']['batches']} batches")
    if not line["segments_equal"] or not line["counts_equal"]:
        raise AssertionError("fetch: the worker and the serial path differ")
    rungs = w["stats"]["rung_rows"]
    if sorted(rungs) != list(range(6)):
        raise AssertionError(f"fetch: retries did not climb the ladder: "
                             f"{rungs}")
    for name, run in runs.items():
        if run["launches"] != run["expected"]:
            raise AssertionError(f"fetch {name}: launches {run['launches']}, "
                                 f"expected {run['expected']}")
        if run["replayed_steps"] != run["stats"]["decode_steps"]:
            raise AssertionError(f"fetch {name}: {run['replayed_steps']} "
                                 "steps replayed, "
                                 f"{run['stats']['decode_steps']} run")
    if not w["captures"] or set(w["captures"]) != {"mwx-fetch"} \
            or s["captures"] or w2["captures"]:
        raise AssertionError(f"fetch: captures {line['captures']}: the "
                             "dropped bucket was not captured on the worker")
    del pipe, decoder, model
    torch.cuda.empty_cache()


def _markdown_body(path: str) -> list:
    """The Markdown's lines without the model and timing lines."""
    with open(path, encoding="utf-8") as f:
        return [ln for ln in f.read().splitlines()
                if not ln.startswith(("**模型**", "**转写总耗时**"))]


def _cli_run(workdir: str, name: str, wav: str, prefix: list,
             env: dict) -> dict:
    """``prefix + [wav]`` in a directory of its own; its lines, code,
    seconds and Markdown."""
    d = os.path.join(workdir, name)
    os.makedirs(d, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(prefix + [wav], cwd=d, env=env, capture_output=True,
                          text=True, timeout=600)
    out = {"rc": proc.returncode, "s": time.perf_counter() - t0,
           "stdout": proc.stdout, "stderr": proc.stderr[-3000:]}
    md = os.path.join(d, "launch_transcript.md")
    out["markdown"] = _markdown_body(md) if os.path.exists(md) else None
    return out


def phase_launch(dev, workdir: str) -> None:
    """The CLI and the job server through ``parallel/launch.py`` on the
    card's one GPU.  ``python -m manual_whisper_tpu_torch.cli`` (no world:
    one GPU) and the same CLI under ``torchrun --standalone
    --nproc-per-node 1`` (a one-rank NCCL world; rank 0 leads) on a WAV of
    40 s of seeded speech with random large-v3: both succeed, the torchrun
    run reports its world, and its Markdown equals the plain run's apart
    from the model and timing lines.  Then, in this process, a one-rank
    world joined as under torchrun: ``PipelineBackend`` wrapped in
    ``Leader`` serves one job through ``create_server`` (upload, create,
    polls); the job must succeed with the pipeline call sent through the
    leader.  With two or more GPUs the CLI also runs on every GPU (rank 0
    starts the others) at batch 16 and must give the plain run's Markdown
    at batch 16; else a ``launch_multi`` line says it did not run."""
    import threading
    import urllib.request
    from manual_whisper_tpu_torch import config as port_config
    from manual_whisper_tpu_torch.parallel import launch
    from manual_whisper_tpu_torch.serving import server as server_mod
    from manual_whisper_tpu_torch.serving.jobs import PipelineBackend
    wav = os.path.join(workdir, "launch.wav")
    with open(wav, "wb") as f:
        f.write(_wav_bytes(synthetic_speech(40.0, seed=11), 16000))
    env = {k: v for k, v in os.environ.items()
           if k not in ("HF_TOKEN", "RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update({"WHISPER_MODEL": "large-v3", "MWX_ALLOW_RANDOM_WEIGHTS": "1",
                "PYTHONPATH": ROOT})
    cli = [sys.executable, "-m", "manual_whisper_tpu_torch.cli"]
    runs = {"plain": _cli_run(workdir, "plain", wav, cli,
                              {**env, "MWX_AUTO_MESH": "false"}),
            "torchrun": _cli_run(
                workdir, "torchrun", wav,
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc-per-node", "1", "-m",
                 "manual_whisper_tpu_torch.cli"], env)}
    line = {"phase": "launch", "card": card_line()}
    for name, run in runs.items():
        line[name] = {"rc": run["rc"], "s": run["s"],
                      "lines": len(run["markdown"] or [])}
        for ln in run["stdout"].splitlines():
            log(f"  launch {name}: {ln}")
        if run["rc"] != 0:
            log(run["stderr"])
            raise AssertionError(f"launch: the {name} CLI failed")
    line["torchrun_world"] = "进程组: 1 个进程" in runs["torchrun"]["stdout"]
    line["markdown_equal"] = (runs["plain"]["markdown"]
                              == runs["torchrun"]["markdown"])

    # one server job through the leader, in a one-rank world of this process
    world_env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 launch.STORE_ENV: os.path.join(workdir, "launch_store")}
    os.environ.update(world_env)
    os.environ.update({"MWX_ALLOW_RANDOM_WEIGHTS": "1",
                       "GET_RATE_LIMIT_PER_MIN": "1000000"})
    port_config.clear_env_cache()
    try:
        world = launch.start_world(["-c", "pass"], device="cuda")
    finally:
        for k in world_env:
            os.environ.pop(k)
    with world:
        backend = PipelineBackend(model_name="large-v3", device=world.device)
        backend.model = launch.Leader(backend.model, world)
        srv = server_mod.create_server(backend, host="127.0.0.1", port=0,
                                       upload_dir=os.path.join(workdir,
                                                               "launch_up"))
        threading.Thread(target=srv.serve_forever, args=(0.05,),
                         daemon=True, name="http").start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"

        def req(method, path, body=None, headers=None):
            r = urllib.request.Request(base + path, data=body, method=method,
                                       headers=headers or {})
            with urllib.request.urlopen(r, timeout=120) as resp:
                return json.loads(resp.read().decode())
        _build.launches.clear()
        t0 = time.perf_counter()
        with open(wav, "rb") as f:
            up = req("POST", "/api/upload", f.read(),
                     {"x-file-name": "launch.wav"})
        job = req("POST", "/api/transcribe", json.dumps(
            {"fileUrl": up["fileUrl"], "language": "zh"}).encode())
        deadline = time.time() + 300
        while True:
            out = req("GET", f"/api/transcribe?id={job['id']}")
            if out["status"] in ("succeeded", "failed") \
                    or time.time() > deadline:
                break
            time.sleep(0.25)
        srv.shutdown()
        srv.server_close()
        line["server_job"] = {"status": out["status"],
                              "s": time.perf_counter() - t0,
                              "leader_calls": backend.model.calls,
                              "launches": dict(_build.launches),
                              "world": world.size,
                              "backend": torch.distributed.get_backend()}
    del backend
    torch.cuda.empty_cache()
    log(json.dumps(line))
    if not (line["torchrun_world"] and line["markdown_equal"]):
        raise AssertionError("launch: the torchrun CLI ran no world, or its "
                             "Markdown differs from the plain CLI's")
    if out["status"] != "succeeded" or line["server_job"]["leader_calls"] < 1:
        raise AssertionError(f"launch: the server job through the leader: "
                             f"{line['server_job']}")
    n = torch.cuda.device_count()
    if n < 2:
        log(json.dumps({"phase": "launch_multi", "ran": False, "devices": n}))
        return
    multi = {**env, "BATCH_SIZE": "16"}
    runs = {"plain16": _cli_run(workdir, "plain16", wav, cli,
                                {**multi, "MWX_AUTO_MESH": "false"}),
            "every_gpu": _cli_run(workdir, "every_gpu", wav, cli, multi)}
    multi_line = {"phase": "launch_multi", "ran": True, "devices": n,
                  **{k: {"rc": r["rc"], "s": r["s"]} for k, r in runs.items()},
                  "markdown_equal": runs["plain16"]["markdown"]
                  == runs["every_gpu"]["markdown"]}
    log(json.dumps(multi_line))
    if any(r["rc"] for r in runs.values()) or not multi_line["markdown_equal"]:
        raise AssertionError(f"launch_multi: {multi_line}")


def _profiled(fn, reps: int) -> dict:
    """Time ``reps`` calls of fn() on the host clock (ending in a
    synchronise), then run them again under torch.profiler and sum the
    device time of the CUDA kernels (user annotations left out).  Busy
    share = kernel time / wall time of the unprofiled run."""
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
        # the program's ``mwx.`` spans have device-side copies on the
        # trace: spans, not kernels
        if e.device_type == DeviceType.CUDA and not (
                getattr(e, "is_user_annotation", False)
                or e.name.startswith("mwx.")):
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    rows = sorted(((us, name, n) for name, (us, n) in by_name.items()),
                  reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3
    return {"wall_ms_per_rep": wall_ms / reps,
            "device_ms_per_rep": device_ms / reps,
            "device_busy_share": device_ms / wall_ms,
            "kernel_launches_per_rep": sum(r[2] for r in rows) / reps,
            # ATen's LayerNorm kernels (the decode step's run in ours)
            "aten_layer_norm_calls_per_rep": sum(
                n for _, name, n in rows
                if "layer_norm" in name and not _short_kernel(name)) / reps,
            "top": [{"kernel": name[:70], "ms_per_rep": us / 1e3 / reps,
                     "calls_per_rep": n / reps}
                    for us, name, n in rows[:8]],
            "ours": {_short_kernel(name): {
                "ms_per_rep": us / 1e3 / reps, "calls_per_rep": n / reps,
                "share": us / 1e3 / device_ms}
                for us, name, n in rows if _short_kernel(name)}}


# the kernels of csrc/ by function name (K4's split_kernel shape pulls its
# partial results, K3's pushes them: ", false>" and ", true>")
OUR_KERNELS = ("flash_kernel", "flash_f32_kernel", "split_kernel",
               "cross_int8_kernel", "matvec_kernel", "tile_kernel",
               "log_mel_kernel", "add_layer_norm_kernel")


def _short_kernel(name: str) -> str:
    """A device kernel's name without namespaces and arguments when it is
    one of csrc/'s (its template arguments kept), else ""."""
    head = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    head = head.removeprefix("void ").strip()
    return head if head.split("<", 1)[0] in OUR_KERNELS else ""


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
    before = collections.Counter(_build.launches)
    step()
    dec["launches_per_step"] = dict(_build.launches - before)
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
           "add_layer_norm_per_step": sum(
               v for k, v in loop.graphs.launch_delta[n].items()
               if k.startswith("add_layer_norm")) / n,
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


# ---------------------------------------------------------------------------
# Phase 6: the job server at batch 16 (serve)
# ---------------------------------------------------------------------------

SERVE_BATCH = 16
ROOT = os.path.dirname(os.path.abspath(__file__))


def _ffmpeg_headers() -> bool:
    """Whether g++ finds the FFmpeg headers libmwx_ffdec includes."""
    probe = ("#include <libavformat/avformat.h>\n"
             "#include <libswresample/swresample.h>\n")
    try:
        out = subprocess.run(["g++", "-E", "-x", "c++", "-", "-o",
                              os.devnull], input=probe, text=True,
                             capture_output=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return False
    return out.returncode == 0


def _wav_bytes(x: np.ndarray, sr: int) -> bytes:
    """16-bit PCM WAV of x [n] or [n, channels]."""
    import struct
    x = x.reshape(len(x), -1)
    pcm = np.round(np.clip(x, -1, 1) * 32767).astype("<i2").tobytes()
    ch = x.shape[1]
    return struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(pcm),
                       b"WAVE", b"fmt ", 16, 1, ch, sr, sr * 2 * ch, 2 * ch,
                       16, b"data", len(pcm)) + pcm


def _best_ms(fn, reps: int = 3) -> float:
    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def phase_serve_native(workdir: str) -> dict:
    """Build the port's native audio libraries (libmwx_audio must build;
    libmwx_ffdec must where g++ finds the FFmpeg headers), then the host ms
    to decode and resample one minute of 44.1 kHz stereo audio through
    each route this machine has (best of 3); each route's own output must
    equal ``load_audio``'s.  Prints the route ``load_audio`` took for each
    suffix: the minute's file where one was made, else 64 zero bytes
    (``unsupported`` when no decoder takes the suffix, ``refused`` when
    one does and rejects them)."""
    import shutil
    from manual_whisper_tpu_torch.audio import encode_flac
    from manual_whisper_tpu_torch.audio import io as aio
    from manual_whisper_tpu_torch.audio import native
    from manual_whisper_tpu_torch.audio.resample import (resample_poly,
                                                         to_mono)
    t0 = time.perf_counter()
    native.warm_native_libs()
    build_s = time.perf_counter() - t0
    lib, ffdec = native.get_lib(), native.get_ffdec()
    line = {"phase": "serve_native", "build_s": build_s,
            "libmwx_audio": lib is not None,
            "libmwx_ffdec": ffdec is not None,
            "ffmpeg_headers": _ffmpeg_headers(),
            "ffmpeg_cli": shutil.which("ffmpeg") is not None,
            "decodable_suffixes": list(aio.decodable_suffixes()),
            "build_errors": {k: v[-400:]
                             for k, v in native.build_errors.items()}}
    if lib is None or (line["ffmpeg_headers"] and ffdec is None):
        log(json.dumps(line))
        raise AssertionError("a native audio library did not build")
    x44 = resample_poly(synthetic_speech(60.0, seed=3), 16000, 44100)
    stereo = np.stack([x44, 0.8 * x44], axis=1)
    files = {"wav": _wav_bytes(stereo, 44100),
             "flac": encode_flac(stereo, 44100)}
    if ffdec is not None:
        files["m4a"] = native.native_encode_fixture(x44, 44100, "ipod",
                                                    "aac")
    route_fns = {
        "wav": lambda b: aio._resample(*native.native_decode_wav(b), 16000),
        "flac": lambda b: aio._resample(*native.native_decode_flac(b),
                                        16000),
        "m4a": lambda b: aio._resample(*native.native_decode_any(b), 16000)}
    host_ms, routes = {}, {}
    for ext, data in files.items():
        path = os.path.join(workdir, f"minute.{ext}")
        with open(path, "wb") as f:
            f.write(data)
        out, routes["." + ext] = aio._load(path)
        if not np.array_equal(out, route_fns[ext](data)):
            raise AssertionError(f"load_audio of .{ext} is not its route's")
        host_ms[routes["." + ext]] = _best_ms(lambda: aio.load_audio(path))
    for suffix in aio.FFMPEG_SUFFIXES:
        if suffix in routes:
            continue
        path = os.path.join(workdir, "probe" + suffix)
        with open(path, "wb") as f:
            f.write(b"\x00" * 64)
        try:
            routes[suffix] = aio._load(path)[1]
        except aio.UnsupportedFormatError:
            routes[suffix] = "unsupported"
        except (ValueError, RuntimeError):
            routes[suffix] = "refused"
    line["routes"] = routes
    host_ms["numpy-wav"] = _best_ms(
        lambda: resample_poly(to_mono(aio.decode_wav_bytes(files["wav"])[0]),
                              44100, 16000))
    host_ms["resample_only_native"] = _best_ms(
        lambda: native.native_resample(x44, 44100, 16000))
    host_ms["resample_only_numpy"] = _best_ms(
        lambda: resample_poly(x44, 44100, 16000))
    line["host_ms_per_minute_44k1_stereo"] = host_ms
    log(json.dumps(line))
    return line


def _replay_ms_per_step(loop, reps: int = 4) -> float:
    """Device ms per step of one replayed 16-step chunk of ``loop``, from
    step 97, between CUDA events."""
    def rewind():
        loop.state.i.fill_(97)
        loop.state.pos.fill_(loop.p + 96)
    rewind()
    return _event_ms(lambda: loop.graphs.replay(16), reps) / 16


def phase_serve(workdir: str, native_line: dict, registry: str) -> None:
    """The job server over the port's bf16 ``PipelineBackend`` at batch 16:
    ``warmup()`` called directly (buckets 2, 4, 8, 16 captured), then
    ``create_server`` on 127.0.0.1 at a free port and four requests through
    ``/api/upload``, ``POST /api/transcribe`` and polls of ``GET
    /api/transcribe``, queued at once: a 16 kHz WAV, about 9 min of phase
    4's seeded audio (at least 16 windows: a batch of 16 rows), a 44.1 kHz
    stereo FLAC (the port's ``encode_flac``) and an m4a (the FFmpeg shim's
    encoder; without the shim its upload must be refused with the zh-CN
    message).  The WAV job's result carries a planted prompt-leak segment
    over 2-14 s, so the server's first success poll starts a second pass
    (``transcribe_clip`` on a thread of its own) while the long job
    decodes (a prompt leak of 12 s is what the quality report flags as a
    suspicious range; random weights write none).  Checks: every job
    succeeds; the audio each ``transcribe``
    got equals ``load_audio`` of the upload; a loop of 16 rows replayed;
    the second pass ran inside the long job's decode; the launches equal
    those the calls' ``last_stats`` imply (plus the eager warm-up steps of
    the second-pass decoder's new loop, and one K1 launch for each
    embedding forward of the WAV job's diarizer, which loads the
    ResNet34 from ``registry`` and must run it), and every decode step ran
    in a replayed chunk."""
    import threading
    import urllib.error
    import urllib.request
    import manual_whisper_tpu_torch.audio as audio_pkg
    from manual_whisper_tpu_torch.audio import io as aio
    from manual_whisper_tpu_torch.audio import encode_flac, native
    from manual_whisper_tpu_torch.audio.resample import resample_poly
    from manual_whisper_tpu_torch.serving import server as server_mod
    from manual_whisper_tpu_torch.serving.jobs import PipelineBackend
    os.environ.update({"MWX_ALLOW_RANDOM_WEIGHTS": "1",
                       "MWX_WEIGHTS_DIR": registry,
                       "GET_RATE_LIMIT_PER_MIN": "1000000",
                       "POST_RATE_LIMIT_PER_MIN": "1000",
                       "MAX_ACTIVE_JOBS_PER_IP": "16",
                       "ENABLE_SECOND_PASS": "true"})
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    backend = PipelineBackend(model_name="large-v3", batch_size=SERVE_BATCH,
                              device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    model = backend.model
    if model.vad.model is None or model.vad.model.sinc.device.type != "cuda":
        raise AssertionError("the server's pipeline does not run PyanNet on "
                             "the card")
    t0 = time.perf_counter()
    backend.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    main_dec = model._decoder("zh", 0.0)
    if not main_dec.captured or sorted(k[0] for k in main_dec._loops) != \
            [2, 4, 8, 16]:
        raise AssertionError(f"warmup built loops {list(main_dec._loops)}")
    capture_s = main_dec.stats["capture_s"]

    calls, calls_lock = [], threading.Lock()
    real_transcribe = model.transcribe

    def traced(audio, **kw):
        t_start = time.perf_counter()
        out = real_transcribe(audio, **kw)
        torch.cuda.synchronize()
        with calls_lock:
            calls.append({"kind": "clip" if "vad_options" in kw else "job",
                          "thread": threading.current_thread().name,
                          "t0": t_start, "t1": time.perf_counter(),
                          "stats": dict(model.last_stats),
                          "audio": np.asarray(audio), "kw": kw,
                          "segments": _segment_keys(out)})
        return out
    model.transcribe = traced
    post_ms = []
    real_post = server_mod.post_process_segments

    def timed_post(*a, **k):
        t_start = time.perf_counter()
        out = real_post(*a, **k)
        post_ms.append(1e3 * (time.perf_counter() - t_start))
        return out
    server_mod.post_process_segments = timed_post
    clip_s = []
    real_clip = backend.transcribe_clip

    def timed_clip(*a, **k):
        t_start = time.perf_counter()
        out = real_clip(*a, **k)
        clip_s.append(time.perf_counter() - t_start)
        return out
    backend.transcribe_clip = timed_clip
    planted, diarized = set(), []
    real_job = backend.transcribe

    def job_transcribe(audio_path, language, progress, options=None):
        if os.path.basename(audio_path) in planted:
            # the WAV job asks for word alignment and diarization too
            out = real_job(audio_path, language, progress,
                           dict(options or {}, align=True, diarization=True))
            diarized.append([dict(g) for g in out["segments"]])
            out["segments"].append({"text": "请使用简体中文。", "start": 2.0,
                                    "end": 14.0})
            return out
        return real_job(audio_path, language, progress, options)
    backend.transcribe = job_transcribe
    # the diarizer's embedding forwards: one K1 launch each, beside the
    # decodes' launches that the calls' stats imply
    embed_count = contextlib.ExitStack()
    embed_forwards = embed_count.enter_context(_embed_forwards())
    # the route of each decode the server makes, as load_audio took it
    routes = {}
    real_load = audio_pkg.load_audio

    def routed_load(path, sample_rate=aio.SAMPLE_RATE):
        audio, routes[os.path.basename(path)] = aio._load(path, sample_rate)
        return audio
    audio_pkg.load_audio = routed_load

    srv = server_mod.create_server(backend, host="127.0.0.1", port=0,
                                   upload_dir=os.path.join(workdir, "up"))
    http_thread = threading.Thread(target=srv.serve_forever, args=(0.05,),
                                   daemon=True, name="http")
    http_thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def req(method, path, body=None, headers=None):
        r = urllib.request.Request(base + path, data=body, method=method,
                                   headers=headers or {})
        try:
            with urllib.request.urlopen(r, timeout=120) as resp:
                return resp.status, json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read().decode())

    x441 = resample_poly(synthetic_speech(30.0, seed=12), 16000, 44100)
    uploads = {"wav16": ("meeting.wav",
                         _wav_bytes(synthetic_speech(40.0, seed=11), 16000)),
               "long": ("long.wav",
                        _wav_bytes(synthetic_speech(540.0, seed=0), 16000)),
               "flac44": ("stereo.flac", encode_flac(
                   np.stack([x441, 0.8 * x441], axis=1), 44100))}
    m4a = native.native_encode_fixture(synthetic_speech(30.0, seed=13),
                                       16000, "ipod", "aac") \
        if native_line["libmwx_ffdec"] else None
    line = {"phase": "serve", "model": "large-v3", "compute_type": "bfloat16",
            "batch_size": SERVE_BATCH, "load_s": load_s,
            "warmup_s": warmup_s, "capture_s": capture_s,
            "buckets": sorted(k[0] for k in main_dec._loops)}
    if m4a is not None:
        uploads["m4a"] = ("meeting.m4a", m4a)
    elif not native_line["ffmpeg_cli"]:
        status, out = req("POST", "/api/upload", b"\x00" * 64,
                          {"x-file-name": "meeting.m4a"})
        if status != 415 or out.get("error") != \
                aio.UnsupportedFormatError(".m4a").zh:
            raise AssertionError(f"m4a upload without decoders: {status} "
                                 f"{out}")
        line["m4a"] = "refused with the zh-CN message (no FFmpeg shim)"
    else:
        line["m4a"] = "not made: no FFmpeg shim to encode it"

    _build.launches.clear()
    loops_before = {id(main_dec): set(main_dec._loops)}
    replays_before = graph_replays(main_dec)
    jobs = {}
    for name, (fname, data) in uploads.items():
        t_up = time.perf_counter()
        status, out = req("POST", "/api/upload", data, {"x-file-name": fname})
        if status != 200:
            raise AssertionError(f"upload {fname}: {status} {out}")
        file_url = out["fileUrl"]
        stored = file_url.rsplit("/", 1)[1]
        if name == "wav16":
            planted.add(stored)
        status, created = req("POST", "/api/transcribe", json.dumps(
            {"fileUrl": file_url, "language": "zh"}).encode())
        if status != 201:
            raise AssertionError(f"create {fname}: {status} {created}")
        jobs[name] = {"id": created["id"], "t_upload": t_up,
                      "path": os.path.join(workdir, "up", stored),
                      "file": fname}

    # every unfinished job polled in each round, so a job's success is
    # seen within one round of the server's
    results, pending = {}, None
    deadline = time.time() + 300
    while len(results) < len(jobs):
        if time.time() > deadline:
            raise AssertionError(f"jobs {set(jobs) - set(results)} did not "
                                 "finish")
        for name, job in jobs.items():
            if name in results:
                continue
            n_post = len(post_ms)
            status, out = req("GET", f"/api/transcribe?id={job['id']}")
            if status != 200:
                raise AssertionError(f"poll {name}: {status} {out}")
            if len(post_ms) > n_post:
                job["postprocess_ms"] = post_ms[n_post]
            if out["status"] == "failed":
                raise AssertionError(f"job {name} failed: {out['error']}")
            if out["status"] == "succeeded":
                results[name] = out
                job["t_done"] = time.perf_counter()
            elif name == "wav16" and out["status"] == "processing" \
                    and out["progress"].get("secondPass"):
                pending = pending or out
        time.sleep(0.05)
    if pending is None:
        raise AssertionError("the WAV job's first success poll started no "
                             "second pass")
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    srv.shutdown()
    srv.server_close()
    http_thread.join(10)
    model.transcribe = real_transcribe
    server_mod.post_process_segments = real_post
    audio_pkg.load_audio = real_load
    embed_count.close()
    if len(diarized) != 1 or not diarized[0] \
            or not all("speaker" in g for g in diarized[0]) \
            or not embed_forwards or not all(f[2] for f in embed_forwards):
        raise AssertionError(f"serve: the WAV job's diarization: "
                             f"{diarized!r:.300} {embed_forwards}")

    clip_calls = [c for c in calls if c["kind"] == "clip"]
    job_calls = [c for c in calls if c["kind"] == "job"]
    if len(clip_calls) != 1 or len(job_calls) != len(jobs):
        raise AssertionError(f"calls: {[(c['kind'], c['thread']) for c in calls]}")
    sp = results["wav16"]["output"]["json"].get("second_pass") or {}
    if sp.get("attempted_ranges") != 1 or "error" in sp:
        raise AssertionError(f"second pass: {sp} (pending: {pending})")
    for name, job in jobs.items():
        want = aio.load_audio(job["path"])
        match = [c for c in job_calls if np.array_equal(c["audio"], want)]
        if len(match) != 1:
            raise AssertionError(f"{name}: the transcribed audio is not "
                                 "load_audio of the upload")
        job["call"] = match[0]
        body = results[name]["output"]
        if not isinstance(body["json"]["segments"], list) \
                or not body["markdown"].startswith("# 录音转写"):
            raise AssertionError(f"{name}: bad output {body!r:.300}")
    long_call, clip_call = jobs["long"]["call"], clip_calls[0]
    overlap = min(long_call["t1"], clip_call["t1"]) - max(long_call["t0"],
                                                          clip_call["t0"])
    if overlap <= 0:
        raise AssertionError("the second pass did not run during the long "
                             "job's decode")
    decoders = list(model._decoders.values())
    clip_dec = [d for d in decoders if d.opts.temperatures == (0.0,)]
    if len(decoders) != 2 or len(clip_dec) != 1:
        raise AssertionError(f"decoders: {list(model._decoders)}")
    clip_dec = clip_dec[0]
    ld = model.cfg.n_text_layer
    expected = collections.Counter()
    for c in calls:
        expected.update(expected_launches(model.cfg, c["stats"], False))
    expected["mel"] += len(embed_forwards)
    new_loops = [lp for dec in decoders for key, lp in dec._loops.items()
                 if key not in loops_before.get(id(dec), ())]
    warm_steps = sum(sum(lp.chunk_lengths()) for lp in new_loops)
    for k in ("decode_self_attention", "decode_cross_attention"):
        expected[k] += ld * warm_steps
    expected["add_layer_norm"] += (3 * ld + 1) * warm_steps
    if launches != dict(expected):
        raise AssertionError(f"serve: launches {launches}, expected "
                             f"{dict(expected)} (two threads)")
    replays = {("main",) + k: n - replays_before.get(k, 0)
               for k, n in graph_replays(main_dec).items()}
    replays.update({("clip",) + k: n for k, n in
                    graph_replays(clip_dec).items()})
    replayed_steps = sum(k[2] * n for k, n in replays.items())
    steps = sum(c["stats"]["decode_steps"] for c in calls)
    if replayed_steps != steps:
        raise AssertionError(f"serve: {replayed_steps} steps replayed, "
                             f"{steps} run")
    long_stats = long_call["stats"]
    if not any(k[1] == 16 and n for k, n in replays.items()) \
            or long_stats["rung_rows"].get(0, 0) < 16 \
            or long_stats["windows"] < 16:
        raise AssertionError(f"no batch of 16 rows: {long_stats}")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    # the long job once more, alone: no second pass beside it, every
    # bucket it takes already captured; its result must be the same
    t0 = time.perf_counter()
    alone = model.transcribe(long_call["audio"], **dict(
        long_call["kw"], progress_callback=None))
    torch.cuda.synchronize()
    long_alone_s = time.perf_counter() - t0
    if _segment_keys(alone) != long_call["segments"]:
        raise AssertionError("the long job alone gives other segments than "
                             "beside the second pass")

    for name, job in jobs.items():
        st = job["call"]["stats"]
        log(json.dumps({
            "phase": "serve_request", "name": name, "file": job["file"],
            "route": routes[os.path.basename(job["path"])],
            "audio_s": len(job["call"]["audio"]) / 16000.0,
            "upload_to_succeeded_s": job["t_done"] - job["t_upload"],
            "queue_wait_s": _queue_wait(srv, job["id"]),
            "transcribe_s": job["call"]["t1"] - job["call"]["t0"],
            "postprocess_ms": job.get("postprocess_ms"),
            "second_pass_s": clip_s[0] if name == "wav16" else None,
            "windows": st["windows"], "batches": st["batches"],
            "rows": st["rows"], "decode_calls": st["decode_calls"],
            "decode_steps": st["decode_steps"],
            "rung_rows": st["rung_rows"], "vad_s": st["vad_s"],
            "encode_s": st["encode_s"],
            "decode_loop_s": span_s(st, "decode.loop"),
            "finalize_s": span_s(st, "finalize.batch"),
            "ms_per_token_row": 1e3 * span_s(st, "decode.loop")
            / max(st["token_rows"], 1),
            "segments": len(results[name]["output"]["json"]["segments"])}))

    # batch 16 against the smaller buckets, same prompt and loop: one
    # decode loop per bucket at T = 0 (host clock, ms per token row) and
    # one replayed 16-step chunk (CUDA events, device ms a step)
    per_bucket = {}
    speech = synthetic_speech(SERVE_BATCH * model.window_sec, seed=21)
    for rows in (2, 4, 8, 16):
        xa = model._encode_windows(speech.reshape(SERVE_BATCH, -1)[:rows])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = main_dec.decode_submit(xa, 0.0, rng_tag=5)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        loop = next(lp for key, lp in main_dec._loops.items()
                    if key[0] == rows)
        per_bucket[rows] = {
            "ms_per_token_row": 1e3 * wall / (rows * out.steps),
            "replay_device_ms_per_step": _replay_ms_per_step(loop)}
    line.update({
        "long_transcribe_alone_s": long_alone_s,
        "second_pass": {"clip_s": clip_s, "overlap_with_long_job_s": overlap,
                        "thread": clip_call["thread"],
                        "job_thread": long_call["thread"],
                        "recovered_segments": sp.get("recovered_segments")},
        "wav16_align_diarize": {
            "segments": len(diarized[0]),
            "speakers": sorted({g["speaker"] for g in diarized[0]}),
            "words": sum(len(g.get("words", [])) for g in diarized[0]),
            "resnet_forwards": embed_forwards},
        "launches": launches, "new_loops_during_phase": [
            (lp.state.tokens.shape[0], sum(lp.chunk_lengths()))
            for lp in new_loops],
        "replays": {f"{k[0]} rows={k[1]} steps={k[2]}": n
                    for k, n in sorted(replays.items()) if n},
        "peak_mem_gib_two_decoders": peak_gib,
        "per_bucket": per_bucket})
    log(json.dumps(line))


def _segment_keys(result: dict) -> list:
    return [(g["start"], g["end"], g["text"]) for g in result["segments"]]


def _queue_wait(srv, job_id: str) -> float:
    job = srv.app_state.store.get(job_id)
    return job.started_at - job.created_at


def timestamp_rule_violations(tokens, ts_begin: int, eot: int,
                              max_initial_index: int = 50) -> list:
    """The timestamp rules a decoded token row breaks, checked on the host
    from the tokens alone (empty when it keeps them all): ``first``, the
    first token is a timestamp no later than ``max_initial_index`` steps
    (1.0 s); ``pairs``, the first timestamp stands alone and every later
    run of timestamps is a pair (a single one may end the row);
    ``monotonic``, timestamps never decrease; ``closing``, a timestamp after
    text is strictly greater than the last timestamp (a segment has a
    duration)."""
    seq = []
    for t in tokens:
        if int(t) == eot:
            break
        seq.append(int(t))
    is_ts = [t >= ts_begin for t in seq]
    out = []
    if not seq or not is_ts[0] or seq[0] > ts_begin + max_initial_index:
        out.append(f"first: {seq[:1]}")
    i = 0
    while i < len(seq):
        j = i
        while j < len(seq) and is_ts[j]:
            j += 1
        if j > i:
            allowed = {1} if i == 0 else {1, 2} if j == len(seq) else {2}
            if j - i not in allowed:
                out.append(f"pairs: {j - i} timestamps at {i}")
        i = max(j, i + 1)
    last = None
    for i, t in enumerate(seq):
        if not is_ts[i]:
            continue
        if last is not None and t < last:
            out.append(f"monotonic: {t} after {last} at {i}")
        elif last is not None and not is_ts[i - 1] and t == last:
            out.append(f"closing: {t} repeats {last} at {i}")
        last = t
    return out


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
                         "decode_cross_attention_int8, int8_matmul, "
                         "flash_attention_f32, decode_self_attention_f32, "
                         "decode_cross_attention_f32), then stop without a "
                         "result line")
    ap.add_argument("--phases", default="", metavar="PHASE[,PHASE]",
                    help="only build the kernels and run these phases of "
                         "stage 6 (checkpoint, align, diarize, cli, train, "
                         "mesh, fetch, launch) or float32 (phases 3-5's "
                         "float32 parts), then stop without a result line")
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

    stages = {"checkpoint": lambda: phase_checkpoint(work),
              "align": lambda: phase_align(dev),
              "diarize": lambda: phase_diarize(dev, registry),
              "cli": lambda: phase_cli(work, registry),
              "train": lambda: phase_train(dev),
              "mesh": lambda: phase_mesh(dev, work),
              "fetch": lambda: phase_fetch(dev),
              "launch": lambda: phase_launch(dev, work)}
    # run alone only: the whole script runs these parts in phases 3 and 4
    alone = {"float32": lambda: phase_float32(dev)}
    import tempfile
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".serve-") as work:
        registry = make_registry(os.path.join(work, "registry"), resnet=True)
        if args.phases:
            for name in args.phases.split(","):
                if name not in stages and name not in alone:
                    raise SystemExit(f"--phases: no phase {name!r}")
                timed(name, {**stages, **alone}[name])
            return 0
        return run_all(args, dev, card, stages, work, registry)


def phase_model(model, load_s: float, compute_type: str,
                main_shapes: dict) -> dict:
    """Phases 4 and 5 of one large-v3 model: the main path, graph vs
    eager and the profile, then (not in float32) beam and timestamps.
    Returns the main path's launches."""
    found = timed(f"main {compute_type}", phase_main, model, load_s,
                  compute_type)
    timed(f"graph vs eager {compute_type}", phase_graph_vs_eager, model,
          compute_type)
    timed(f"profile {compute_type}", phase_profile, model, main_shapes,
          compute_type)
    if compute_type != "float32":
        timed(f"beam {compute_type}", phase_beam, model, compute_type)
        timed(f"timestamps {compute_type}", phase_timestamps, model,
              compute_type)
    return found


def phase_float32(dev) -> None:
    """``--phases float32``: the float32 parts of phases 3-5 alone (the
    tiny config and ``.synth_ckpt`` card vs CPU, then large-v3's main
    path, graph vs eager and profile)."""
    timed("tiny f32", phase_tiny, dev, False, torch.float32)
    timed("tiny synth f32", phase_tiny_synth, dev, torch.float32)
    model, load_s = load_main_model("float32", False)
    phase_model(model, load_s, "float32", main_path_shapes(model))


def run_all(args, dev, card, stages, work, registry) -> int:
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
    timed("tiny synth", phase_tiny_synth, dev)
    timed("tiny f32", phase_tiny, dev, False, torch.float32)
    timed("tiny synth f32", phase_tiny_synth, dev, torch.float32)
    timed("vad", phase_vad, dev)
    launches = {}
    for compute_type, kernels in (("bfloat16", BF16_KERNELS),
                                  ("int8", INT8_KERNELS),
                                  ("float32", F32_KERNELS)):
        if compute_type != "bfloat16":  # one model on the card at a time
            del model
            torch.cuda.empty_cache()
            model, load_s = load_main_model(compute_type,
                                            compute_type == "int8")
        found = phase_model(model, load_s, compute_type, main_shapes)
        launches.update({k: found[k] for k in kernels if k not in launches})
    del model                          # the stages load their own
    torch.cuda.empty_cache()
    for name, run in stages.items():
        timed(name, run)
        torch.cuda.empty_cache()
    native_line = timed("serve native", phase_serve_native, work)
    timed("serve", phase_serve, work, native_line, registry)

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
