"""Time launch shapes of one CUDA kernel against each other on one card.

    python3 -m manual_whisper_tpu_torch.kernel_variants decode_self_attention
    python3 -m manual_whisper_tpu_torch.kernel_variants decode_self_attention \
        --dtype float32
    python3 -m manual_whisper_tpu_torch.kernel_variants int8_matmul
    python3 -m manual_whisper_tpu_torch.kernel_variants mel
    python3 -m manual_whisper_tpu_torch.kernel_variants \
        decode_cross_attention_int8 --baseline _checkout/parent

Run from the repository root (it times with ``chip_smoke.py``'s CUDA-graph
timer).  Each variant is a small source under ``_kernels/variants/`` that
includes the kernel's own file from ``csrc/`` and instantiates it with other
template arguments behind ``mwx_variant``, which takes the shipped entry
point's arguments.  A probe is a variant built from a copy of the source in
which one part of the kernel is replaced by a stand-in that keeps the rest
alive: its result is wrong, so it is timed and not checked, and its time
beside the variant it was cut from says what that part costs.  All variants
build with nvcc in parallel; each non-probe is held against the plain
version, then all are timed in three rounds, in an order that turns each
round, beside the shipped kernel and the PyTorch yardstick, at the main
path's shapes.  Prints one JSON line per (shape, variant) with the median
of the rounds.  ``--dtype float32`` builds and times the variants whose
names start with ``f32_`` (K3's float32 instance) instead of the others;
the empty-launch probes time with either.  ``--baseline DIR`` also builds
the kernel's source as it stands in another checkout at DIR (say an older
commit unpacked with ``git archive``) and checks and times its shipped
entry point beside the variants, as ``baseline`` (K5, whose variants take
its entry point's arguments).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import statistics
import subprocess
import sys

import torch

from .ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int

# A launch that does nothing but meet its cluster: the floor of a launch
# of the split kernel's grid.
_EMPTY_SELF = """
template <int SPLIT>
__global__ void empty_kernel(bf16* out) {
  if constexpr (SPLIT > 1) cg::this_cluster().sync();
  if (threadIdx.x < 64) out[(blockIdx.x / SPLIT) * 64 + threadIdx.x] = bf16();
}

template <int SPLIT>
int launch_empty(void* out, int bh, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bh * SPLIT);
  cfg.blockDim = dim3(128);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SPLIT;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = SPLIT > 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, empty_kernel<SPLIT>, (bf16*)out);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
"""


def _self(s, u, t, push="true", patches=(), elem=""):
    return ("", f"return launch_split<64, SplitCfg<{s}, {u}, {t}, {push}>"
                f"{', ' + elem if elem else ''}>("
                "q, k, v, out, len_ptr, len_offset, bh, t_max, "
                "(cudaStream_t)stream);", patches)


def _int8(split, stages, keys, threads, patches=()):
    """K5 at dh 64 with ``Int8Cfg<split, stages, keys, threads>``, f32 or
    bf16 scales as the entry point's ``scale_bf16`` says."""
    return (f"using VariantInt8 = Int8Cfg<{split}, {stages}, {keys}, "
            f"{threads}>;",
            "return scale_bf16 ? launch_int8<64, bf16, VariantInt8>(q, kq, "
            "ks, vq, vs, out, len_ptr, bh, t_max, (cudaStream_t)stream)\n"
            "                  : launch_int8<64, float, VariantInt8>(q, kq, "
            "ks, vq, vs, out, len_ptr, bh, t_max, (cudaStream_t)stream);",
            patches)


def _int8_name(split, stages, keys, threads):
    return f"split{split}_stages{stages}_keys{keys}_threads{threads}"


# K5's shapes: the shipped ones (Int8Shape<split>, split 1, 2, 4 and 8 by
# B x H), shallower and deeper rings, shorter and longer stages, smaller
# and wider blocks
_INT8_SHAPES = ((1, 4, 64, 128), (2, 4, 64, 128), (4, 4, 64, 128),
                (8, 4, 64, 128), (8, 2, 64, 128), (4, 6, 64, 128),
                (2, 6, 64, 128), (4, 3, 64, 64), (8, 3, 64, 64),
                (1, 3, 64, 128), (1, 6, 64, 128), (1, 3, 128, 128),
                (1, 8, 32, 128), (1, 4, 64, 256), (4, 4, 64, 256))

# probes: no copies (the slots' stale bytes are summed: the ring's
# arithmetic and barriers alone), and no arithmetic (the stages are
# waited for and released: the ring's streaming alone)
_INT8_PROBES = {
    "no_copies": [("    mbar_expect_tx(bar, 2 * (t1 - t0) * DH + k_bytes + "
                   "v_bytes);",
                   "    mbar_arrive(bar);\n    if (bar) return;\n"
                   "    mbar_expect_tx(bar, 2 * (t1 - t0) * DH + k_bytes + "
                   "v_bytes);")],
    "no_math": [("    constexpr bool kWhole = decltype(whole)::value;",
                 "    constexpr bool kWhole = decltype(whole)::value;\n"
                 "    if (klo >= 0) return;")],
}


def _matvec(cols, u, warps, cs, patches=(), groups=1):
    return ("", f"const int stripes = (n + {cols - 1}) / {cols};\n"
                f"  const int cs = {cs};\n"
                f"  return launch_matvec<{cols}, {u}, {warps}, {groups}>(x, q, "
                "s, out, m, k, n, cs, (cudaStream_t)stream);", patches)


# the matvec's variants for M = 9..16 (two groups of 8 rows of x) are
# named rows16_...; the others take M <= 8
_ROWS16 = "rows16_"


# cluster sizes: as many blocks along K as fill the SMs once, or fixed; at
# least one 16-row step per warp either way
def _fill(warps):
    return (f"max(1, min(min(8, sm_count() / stripes), "
            f"(k + {16 * warps - 1}) / {16 * warps}))")


def _fixed(c, warps):
    return f"max(1, min({c}, (k + {16 * warps - 1}) / {16 * warps}))"


# Probes, as (old, new) text of the kernel's source.
_SELF_PROBES = {
    "no_kv_loads": [
        ("kr[u] = __ldg(reinterpret_cast<const uint4*>(kb + (size_t)t * DH\n"
         "                                                     + sub * kVec));",
         "kr[u] = make_uint4(t, t + 1, t + 2, t + 3);"),
        ("vr[u] = __ldg(reinterpret_cast<const uint4*>(vb + (size_t)t * DH\n"
         "                                                     + sub * kVec));",
         "vr[u] = make_uint4(t, t, t, t);")],
    "len_from_t_max": [("int n = *len_ptr + len_offset;",
                        "int n = t_max * 3 / 4 + len_offset;")],
}
_MATVEC_PROBES = {
    "no_mma": [("mma_16816(acc[j], a, b[u][0], b[u][1]);",
                "acc[j][0] += __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3] ^ "
                "b[u][0] ^ b[u][1]);"),
               ("mma_16816(acc1[j], a, b1[u][0], b1[u][1]);",
                "acc1[j][0] += __uint_as_float(a[0] ^ b1[u][0] ^ b1[u][1]);")],
    "no_widen": [
        ("widen4(__byte_perm(w[u][0][j / 2], w[u][1][j / 2], sel), a[0], "
         "a[1]);", "a[0] = w[u][0][j / 2]; a[1] = w[u][1][j / 2];"),
        ("widen4(__byte_perm(w[u][2][j / 2], w[u][3][j / 2], sel), a[2], "
         "a[3]);", "a[2] = w[u][2][j / 2]; a[3] = w[u][3][j / 2];")],
    "no_weight_loads": [
        ("ld_stream<WORDS>(w[u][i], qc + (size_t)r * n);",
         "for (int e = 0; e < WORDS; ++e) w[u][i][e] = r * 0x01010101u + e;")],
    "no_epilogue": [
        ("  // the warps meet in shared memory: acc[j]",
         "  float sum_ = 0.f;\n"
         "  for (int j = 0; j < J; ++j) sum_ += acc[j][0] + acc[j][1] + "
         "acc[j][2] + acc[j][3];\n"
         "  if constexpr (R == 2)\n"
         "    for (int j = 0; j < J; ++j) sum_ += acc1[j][0] + acc1[j][1] + "
         "acc1[j][2] + acc1[j][3];\n"
         "  if (sum_ == 1.2345f) out[threadIdx.x] = bf16();\n  return;\n"
         "  // the warps meet in shared memory: acc[j]")],
}

# Timeline: thread 0 of each block (numbered along x, then y) writes
# %globaltimer (ns, one clock for the whole card) at marks 0..5 and its SM
# at slot 7; mwx_read_stamps copies them out.
_STAMPS = (
    "\n__device__ unsigned long long mwx_stamps[8192 * 8];\n"
    "#define MWX_STAMP(i) do { const unsigned b_ = blockIdx.y * gridDim.x"
    " + blockIdx.x; if (threadIdx.x == 0 && b_ < 8192) {"
    " unsigned long long t_; unsigned s_;"
    " asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_));"
    " asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(s_));"
    " mwx_stamps[b_ * 8 + (i)] = t_;"
    " mwx_stamps[b_ * 8 + 7] = s_; } } while (0)\n"
    'extern "C" int mwx_read_stamps(void* dst) {\n'
    "  return (int)cudaMemcpyFromSymbol(dst, mwx_stamps, "
    "sizeof(mwx_stamps));\n}\n")


def _marks(header, marks):
    """Patches that put the timeline's header after ``header`` and
    MWX_STAMP(i) after the first line of the i-th text of ``marks`` (before
    it when the text starts with "<")."""
    out = [(header, header + _STAMPS)]
    for i, mark in enumerate(marks):
        if mark.startswith("<"):
            out.append((mark[1:], f"MWX_STAMP({i});\n" + mark[1:]))
        else:
            first, _, rest = mark.partition("\n")
            out.append((mark, f"{first}\nMWX_STAMP({i});\n{rest}"))
    return out


# marks: start; K3: lengths known, loop done, block combined, cluster met,
# outputs written; K6: loop done, warps met, all blocks run, sums sent (or
# with no cluster, written), outputs written
_SELF_MARKS = _marks('#include "hopper.cuh"\n', [
    "  const int bh = blockIdx.x / kSplit;",
    "<  const int per = (n + kSplit - 1) / kSplit;",
    "<  // the block's lane groups meet in shared memory\n  if (sub == 0) {\n"
    "    part_m[g] = m;\n    part_l[g] = l;\n  }\n#pragma unroll\n"
    "  for (int i = 0; i < kVec; ++i) part_o[g][sub * kVec + i] = o[i];",
    "    cluster_wait();   // every rank runs and has set up its barrier",
    "      mbar_wait(smem_u32(&inbox_full), 0);",
    "<    return;\n  }\n  if (tid < DH) {\n    block_o[tid] = bo;"])
_MATVEC_MARKS = _marks('#include "int8.cuh"\n', [
    "  const int cs = (int)cluster.num_blocks();",
    "<  // the warps meet in shared memory: acc[j]",
    "  __syncthreads();\n  if (cs > 1) cluster_wait();",
    "  if (cs > 1) cluster_wait();   // every block of the cluster runs by now",
    "<  if (cs == 1) return;",
    "<}\n\n// One cluster of `cs` blocks per COLS columns"])

# K1: MelCfg<TM, TN, GX, GY, LX, KC, STAGES> (frames and frequencies a
# thread, a half's threads along frequencies and frames, a warp's threads
# along the frequencies, constant rows a chunk, chunks in the ring); each
# variant reports its tile through mwx_variant_tile, and its constants are
# packed for it
_MEL_SHIPPED = "6, 13, 8, 16, 4, 20, 3"


def _mel(cfg, patches=()):
    return (f"using VariantMel = MelCfg<{cfg}>;",
            "return launch_mel<VariantMel>(audio, cos_p, sin_p, bands, "
            "weights, out, batch, n_samples, n_frames, n_mels, "
            "(cudaStream_t)stream);", patches)


def _mel_name(cfg):
    return "tile" + cfg.replace(", ", "_")


# every thread reads its constants from L2 instead of a ring copy: no
# copies, __ldg loads from the packed arrays
_MEL_FROM_L2 = [
    ("  if (q < 2 * C::kChunks) {", "  if (false) {"),
    ("      const float4 v = *src;", "      const float4 v = __ldg(src);"),
    ("    const float* w = ring + (q % C::kStages) * C::KC * C::kRow\n"
     "                     + half * C::kRow + tx * 4;",
     "    const float* w = (q < C::kChunks ? cos_p : sin_p) + r0 * C::kRow\n"
     "                     + tx * 4;")]

_MEL_PROBES = {
    "no_filterbank": [("  for (int m = tid / 32; m < n_mels; m += C::kWarps) {",
                       "  if (power[tid] == 1.2345f) tile[tid] = 0.f;\n"
                       "  for (int m = tid / 32; m < 0; m += C::kWarps) {")],
    "no_constant_copies": [("      cp_async16(dst + i, src + i);",
                            "      ;")],
    "no_constant_loads": [
        ("      const float4 v = *src;",
         "      const float4 v = make_float4(r + 0.5f, p + 0.25f, "
         "__int_as_float(threadIdx.x), 0.75f);")],
    "no_folds": [("  fold_span<C>(fold, span, 1.f);", "  ;"),
                 ("      fold_span<C>(fold, span, -1.f);", "      ;")],
    "no_audio_loads": [("__ldg(row + reflect(p0 + i, n_samples))",
                        "(float)(p0 + i)")],
}

# marks: start, cosine fold written (this block's thread 0), cosine
# product done and sine fold written, sine product done, filterbank
# starts, outputs written
_MEL_MARKS = _marks("#include <cuda_runtime.h>\n", [
    "  const int tid = threadIdx.x;",
    "<  // the two folded products as one walk over 2 * kChunks chunks",
    "      fold_span<C>(fold, span, -1.f);",
    "  __syncthreads();                     // the exchange's region is free",
    "<  // filterbank: a warp takes a mel band at a time, its lanes the",
    "<}\n\ntemplate <class C>\nint launch_mel("])

# name -> (source, the entry point's C parameters, their argtypes,
# {variant: (code before mwx_variant, body of mwx_variant, probe patches)});
# the body sees the entry point's parameters by name.  _EXPORTS: C code
# after mwx_variant in every variant of a kernel.
VARIANTS = {
    "decode_self_attention": (
        "decode_attention.cu",
        "const void* q, const void* k, const void* v, void* out, "
        "const void* len_ptr, int len_offset, int bh, int t_max, "
        "int head_dim, void* stream",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        {**{f"split{s}_keys{u}_threads{t}" + ("_push" if p else "_pull"):
            _self(s, u, t, "true" if p else "false")
            for s, u, t, p in (
                (4, 4, 256, 1), (2, 4, 256, 1), (8, 8, 128, 0), (4, 4, 256, 0),
                (4, 2, 256, 1), (2, 4, 128, 1), (8, 4, 128, 1))},
         **{f"stamps_split{s}_keys4_threads{t}_push": _self(
             s, 4, t, "true", _SELF_MARKS)
            for s, t in ((4, 256), (2, 256))},
         **{f"probe_split4_keys4_threads256_push_{name}":
            _self(4, 4, 256, "true", patches)
            for name, patches in _SELF_PROBES.items()},
         # the float32 instance (--dtype float32): bf16's shapes, whose
         # blocks cover half the keys a pass in float32, shapes that cover
         # a slice of the 417 slots in one pass again, and a timeline and
         # the probes at the narrow shape it ships
         **{f"f32_split{s}_keys{u}_threads{t}_push": _self(
             s, u, t, "true", elem="float")
            for s, u, t in ((4, 4, 256), (2, 4, 256), (8, 4, 256),
                            (4, 8, 256), (8, 8, 128), (2, 8, 256),
                            (8, 2, 256), (4, 4, 128))},
         "f32_stamps_split8_keys4_threads256_push": _self(
             8, 4, 256, "true", _SELF_MARKS, elem="float"),
         **{f"f32_probe_split8_keys4_threads256_push_{name}":
            _self(8, 4, 256, "true", patches, elem="float")
            for name, patches in _SELF_PROBES.items()},
         **{f"probe_empty_split{s}": (
             _EMPTY_SELF, f"return launch_empty<{s}>(out, bh, "
                          "(cudaStream_t)stream);", ())
            for s in (1, 2, 4, 8)}}),
    "int8_matmul": (
        "int8_matmul.cu",
        "const void* x, const void* q, const void* s, void* out, int m, "
        "int k, int n, void* stream",
        [_P, _P, _P, _P, _I, _I, _I, _P],
        {**{f"cols{c}_u{u}_warps{w}_" + (f"cs{cs}" if cs else "fill"):
            _matvec(c, u, w, _fixed(cs, w) if cs else _fill(w))
            for c, u, w, cs in (
                (64, 5, 16, 1), (64, 3, 16, 1), (32, 5, 16, 1),
                (64, 2, 8, 8), (64, 5, 8, 8), (64, 3, 8, 8), (32, 3, 16, 8),
                (32, 3, 8, 4), (32, 2, 8, 4), (32, 5, 8, 2), (32, 4, 16, 2),
                (64, 2, 8, 0))},
         "stamps_cols64_u2_warps8_cs8": _matvec(64, 2, 8, _fixed(8, 8),
                                                _MATVEC_MARKS),
         "stamps_cols32_u3_warps8_cs4": _matvec(32, 3, 8, _fixed(4, 8),
                                                _MATVEC_MARKS),
         **{f"probe_cols64_u2_warps8_cs8_{name}": _matvec(
             64, 2, 8, _fixed(8, 8), patches)
            for name, patches in _MATVEC_PROBES.items()},
         # M = 9..16 (two row groups): the shipped shapes (square
         # cols32_u5_warps8_cs2, wide cols32_u3_warps8_cs2, deep
         # cols32_u3_warps8_cs8), the M <= 8 square and deep shapes (the
         # wide one's sums of two groups pass the static 48 KB), and shapes
         # with fewer warps, other clusters or fewer loads in flight
         **{f"{_ROWS16}cols{c}_u{u}_warps{w}_cs{cs}": _matvec(
             c, u, w, _fixed(cs, w), groups=2)
            for c, u, w, cs in (
                (32, 5, 8, 2), (32, 3, 8, 2), (32, 3, 8, 8), (32, 3, 8, 4),
                (64, 2, 8, 8), (32, 2, 8, 8), (32, 2, 8, 4), (32, 5, 4, 4),
                (32, 3, 4, 4))},
         f"stamps_{_ROWS16}cols32_u3_warps8_cs2": _matvec(
             32, 3, 8, _fixed(2, 8), _MATVEC_MARKS, groups=2),
         **{f"probe_{_ROWS16}cols{c}_u{u}_warps{w}_cs{cs}_{name}": _matvec(
             c, u, w, _fixed(cs, w), patches, groups=2)
            for c, u, w, cs in ((32, 5, 8, 2), (32, 3, 8, 2))
            for name, patches in _MATVEC_PROBES.items()}}),
    "decode_cross_attention_int8": (
        "decode_attention.cu",
        "const void* q, const void* kq, const void* ks, const void* vq, "
        "const void* vs, void* out, const void* len_ptr, int bh, int t_max, "
        "int head_dim, int scale_bf16, void* stream",
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        {**{_int8_name(*shape): _int8(*shape) for shape in _INT8_SHAPES},
         **{f"probe_{_int8_name(*shape)}_{name}": _int8(*shape, patches)
            for shape in ((1, 4, 64, 128), (4, 4, 64, 128))
            for name, patches in _INT8_PROBES.items()}}),
    "mel": (
        "mel.cu",
        "const void* audio, const void* cos_p, const void* sin_p, "
        "const void* bands, const void* weights, void* out, int batch, "
        "int n_samples, int n_frames, int n_mels, void* stream",
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        {**{_mel_name(cfg): _mel(cfg)
            for cfg in (
                _MEL_SHIPPED, "6, 13, 8, 16, 8, 20, 3",
                "6, 13, 8, 16, 4, 8, 4", "6, 13, 8, 16, 4, 40, 2",
                "6, 13, 8, 16, 4, 50, 2", "4, 13, 8, 16, 4, 20, 3",
                "2, 13, 8, 16, 4, 20, 3", "4, 13, 8, 24, 4, 20, 3",
                "2, 13, 8, 48, 4, 20, 3", "6, 7, 16, 16, 4, 20, 3")},
         f"{_mel_name(_MEL_SHIPPED)}_from_l2": _mel(_MEL_SHIPPED,
                                                    _MEL_FROM_L2),
         f"stamps_{_mel_name(_MEL_SHIPPED)}": _mel(
             _MEL_SHIPPED, patches=_MEL_MARKS),
         **{f"probe_{_mel_name(_MEL_SHIPPED)}_{name}": _mel(
             _MEL_SHIPPED, patches=patches)
            for name, patches in _MEL_PROBES.items()}}),
}


_EXPORTS = {"mel": 'extern "C" int mwx_variant_tile(void* tile) {\n'
                   "  return report_tile<VariantMel>(tile);\n}\n",
            # K5: the variant's launch shape, ring bytes and blocks resident
            # per SM (put_int8_shape), with f32 scales
            "decode_cross_attention_int8":
                'extern "C" int mwx_variant_shape(void* shape) {\n'
                "  return put_int8_shape<VariantInt8, float>((int*)shape);"
                "\n}\n"}

# the shipped entry point of each kernel whose variants take its arguments
# (``--baseline``)
SHIPPED_ENTRY = {"decode_cross_attention_int8": "mwx_decode_attention_int8"}


def variant_source(name: str, var: str) -> str:
    """The source of variant ``var`` of kernel ``name``, as it is built."""
    src, params, _, variants = VARIANTS[name]
    prelude, body, patches = variants[var]
    text = (_build.CSRC_DIR / src).read_text()
    for old, new in patches:
        if old not in text:
            raise ValueError(f"variant {var}: {old!r} not in {src}")
        text = text.replace(old, new)
    return ((text if patches else f'#include "{src}"\n')
            + f"\nnamespace {{\n{prelude}\n}}\n\n"
            f'extern "C" int mwx_variant({params}) {{\n  {body}\n}}\n'
            + _EXPORTS.get(name, ""))


def selected(name: str, dtype: str = "bfloat16", only=None) -> list:
    """The variants of kernel ``name`` that a run in ``dtype`` builds:
    with float32 those named ``f32_...``, else the others, and the
    empty-launch probes with either; ``only`` narrows them to a list."""
    f32 = dtype == "float32"
    return [var for var in VARIANTS[name][3]
            if (only is None or var in only)
            and (var.startswith("probe_empty")
                 or var.startswith("f32_") == f32)]


def build_variants(name: str, dtype: str = "bfloat16", only=None) -> dict:
    """Build the variants of kernel ``name`` that ``selected`` names;
    {variant: typed function}."""
    _, _, argtypes, _ = VARIANTS[name]
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for var in selected(name, dtype, only):
        cu = out_dir / f"{name}-{var}.cu"
        cu.write_text(variant_source(name, var))
        so = cu.with_suffix(".so")
        procs[var] = (so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    fns = {}
    for var, (so, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"variant {var} failed to build:\n{log}")
        print(json.dumps({"variant": var, "ptxas": _ptxas(log)}), flush=True)
        lib = ctypes.CDLL(str(so))
        fn = lib.mwx_variant
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fn.lib = lib
        fns[var] = fn
    return fns


def build_baseline(name: str, root) -> object:
    """Kernel ``name``'s source as it stands in the checkout at ``root``,
    built as a library; its shipped entry point (``SHIPPED_ENTRY``) typed
    as the variants are."""
    from pathlib import Path
    src, _, argtypes, _ = VARIANTS[name]
    csrc = Path(root) / _build.CSRC_DIR.relative_to(_build.PACKAGE_DIR.parent)
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"{name}-baseline.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc),
                           "-o", str(so), str(csrc / src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    log = proc.stdout.decode(errors="replace")
    if proc.returncode != 0:
        raise RuntimeError(f"baseline of {name} failed to build:\n{log}")
    print(json.dumps({"variant": "baseline", "source": str(csrc / src),
                      "ptxas": _ptxas(log)}), flush=True)
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, SHIPPED_ENTRY[name])
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    fn.lib = lib
    return fn


def _ptxas(log: str) -> list:
    """ptxas's register and spill lines of the variant's kernels
    (``split_kernel``, ``empty_kernel``, ``matvec_kernel``,
    ``log_mel_kernel``, ``cross_int8_kernel``), each after its
    template arguments as they stand in the mangled name."""
    out, entry = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            found = re.search(r"(split_kernel|empty_kernel|matvec_kernel|"
                              r"log_mel_kernel|cross_int8_kernel)I(\w*?)EE",
                              line)
            entry = f"{found.group(1)}<{found.group(2)}>" if found else ""
        elif entry and ("registers" in line or "spill" in line):
            out.append(f"{entry}: {line.strip()}")
    return out


def _launcher(fn, *consts):
    """fn(tensor pointers..., *consts, stream) as a callable of tensors."""
    def call(*tensors):
        ptrs = [t.data_ptr() for t in tensors]
        _build.check(fn(*ptrs, *consts, _build.stream_of(tensors[0])),
                     "variant")
    return call


def timeline(var, fn, call, args) -> None:
    """One cold call of a stamped variant (L2 flushed first): per mark, the
    spread over blocks of its time after the first block's start, in ns."""
    import numpy as np
    torch.empty(64 * 2 ** 20, dtype=torch.int32, device=args[0].device).zero_()
    torch.cuda.synchronize()
    call(*args)
    torch.cuda.synchronize()
    stamps = np.zeros(8192 * 8, dtype=np.uint64)
    read = fn.lib.mwx_read_stamps
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    _build.check(read(stamps.ctypes.data), "mwx_read_stamps")
    st = stamps.reshape(8192, 8).astype(np.int64)
    st = st[st[:, 0] > 0]
    t0 = st[:, 0].min()
    marks = {}
    for i in range(6):
        col = st[:, i][st[:, i] > 0] - t0
        if len(col):
            marks[i] = [int(np.percentile(col, p)) for p in (0, 50, 90, 100)]
    print(json.dumps({"timeline": var, "blocks": int(len(st)),
                      "sms": int(len(set(st[:, 7].tolist()))),
                      "ns_after_first_start_p0_p50_p90_max": marks}),
          flush=True)


def _check(var, out, ref, what):
    """bf16 outputs within 1e-2 + 1e-2 max |ref|; float32 elementwise
    within chip_smoke's TOL of the float32 build."""
    if out.dtype == torch.float32:
        from chip_smoke import compare
        compare("decode_self_attention_f32", out, ref)
        return
    err = float((out.float() - ref.float()).abs().max())
    if not err <= 1e-2 + 1e-2 * float(ref.float().abs().max()):
        raise AssertionError(f"{var} at {what}: max abs error {err}")


def run_self(fns, randn, dev, dtype=torch.bfloat16):
    """K3 in ``dtype`` at the main path's shape (B=4, H=20, T_max=417, the
    decode loop's positions) and at batch 16, T_max 448, pos 447, over K/V
    copies that exceed L2; the yardstick is SDPA."""
    from chip_smoke import copies_for
    from .ops.decode_attention import attend_plain, decode_self_attention
    sdpa = torch.nn.functional.scaled_dot_product_attention
    h, dh = 20, 64
    for b, t_max, positions in ((4, 417, [193 + round(i * 222 / 19)
                                          for i in range(20)]),
                                (16, 448, [447])):
        reps = max(1, math.ceil(copies_for(2 * dtype.itemsize * b * h
                                           * t_max * dh) / len(positions)))
        sets = [(randn((b, h, 1, dh), dtype),
                 randn((b, h, t_max, dh), dtype, scale=3.0),
                 randn((b, h, t_max, dh), dtype),
                 torch.full((1,), pos, dtype=torch.int32, device=dev), pos + 1)
                for pos in positions * reps]
        shape = (f"B={b} H={h} T_max={t_max} pos={positions[0]}.."
                 f"{positions[-1]} dh={dh} {dtype}".replace("torch.", ""))
        calls = {var: _launcher(fn, 1, b * h, t_max, dh)
                 for var, fn in fns.items()}
        outs = {st[0]: torch.empty_like(st[0]) for st in sets}
        for var, call in calls.items():
            q, k, v, pos, n = sets[0]
            if "stamps_" in var:
                timeline(var, fns[var], call, (q, k, v, outs[q], pos))
            if "probe_" not in var:
                call(q, k, v, outs[q], pos)
                _check(var, outs[q], attend_plain(q, k, v, n), shape)
        timed = {var: (lambda c: lambda q, k, v, p, n: c(q, k, v, outs[q], p)
                       )(c) for var, c in calls.items()}
        timed["shipped"] = lambda q, k, v, p, n: decode_self_attention(q, k,
                                                                       v, p)
        timed["sdpa"] = lambda q, k, v, p, n: sdpa(q, k[:, :, :n], v[:, :, :n])
        report(shape, timed, sets)


def run_int8(fns, randn, dev):
    """K5 at the int8 decode loops' shapes: 1, 2, 4, 8 and 16 rows of 20
    heads (B x H = 20 to 320), 1500 cross positions, dh 64, f32 scales,
    and the 16 rows again with bf16 scales, over K/V copies that exceed
    L2; each non-probe checked against the plain version at kv_len 1500
    and 1499.  First each variant's launch shape as its library reports
    it (blocks resident per SM)."""
    from chip_smoke import INT8_SHAPE_KEYS, copies_for, graph_ms
    from .models.whisper import quantize_cross_kv
    from .ops.decode_attention import (attend_int8_plain,
                                       decode_cross_attention_int8)
    import numpy as np
    for var, fn in fns.items():
        report_shape = getattr(fn.lib, "mwx_variant_shape", None)
        if report_shape is not None:
            report_shape.argtypes = [ctypes.c_void_p]
            report_shape.restype = ctypes.c_int
            shape = np.zeros(len(INT8_SHAPE_KEYS), dtype=np.int32)
            _build.check(report_shape(shape.ctypes.data),
                         "mwx_variant_shape")
            print(json.dumps({"variant": var, "launch_shape": dict(zip(
                INT8_SHAPE_KEYS, shape.tolist()))}), flush=True)
    h, dh, ta = 20, 64, 1500
    for b, scale_dtype in ((1, torch.float32), (2, torch.float32),
                           (4, torch.float32), (8, torch.float32),
                           (16, torch.float32), (16, torch.bfloat16)):
        def kv4():
            return quantize_cross_kv(randn((b, h, ta, dh)),
                                     randn((b, h, ta, dh)), scale_dtype)
        sets = [(randn((b, h, 1, dh)), *kv4())
                for _ in range(copies_for(2 * b * h * ta * dh))]
        lens = {n: torch.full((1,), n, dtype=torch.int32, device=dev)
                for n in (ta, ta - 1)}
        bf16_scales = int(scale_dtype == torch.bfloat16)
        shape = (f"B={b} H={h} Ta={ta} kv_len={ta} dh={dh} int8 K/V, "
                 f"{str(scale_dtype).split('.')[-1]} scales")
        calls = {var: _launcher(fn, b * h, ta, dh, bf16_scales)
                 for var, fn in fns.items()}
        outs = {st[0]: torch.empty_like(st[0]) for st in sets}
        q, *kv = sets[0]
        for var, call in calls.items():
            if "probe_" not in var:
                for n, len_t in lens.items():
                    call(q, *kv, outs[q], len_t)
                    _check(var, outs[q], attend_int8_plain(q, *kv, n), shape)
        full = lens[ta]
        timed = {var: (lambda c: lambda a, kq, ks, vq, vs: c(
            a, kq, ks, vq, vs, outs[a], full))(c) for var, c in calls.items()}
        timed["shipped"] = lambda *a: decode_cross_attention_int8(*a, full)
        report(shape, timed, sets)
        # the read floor: one PyTorch reduction over as many bytes
        nbytes = sum(t.numel() * t.element_size() for t in sets[0][1:])
        flat = [(torch.empty(nbytes // 4, dtype=torch.int32, device=dev),)
                for _ in range(copies_for(nbytes))]
        print(json.dumps({"shape": shape, "variant": "torch_read_floor",
                          "bytes": nbytes,
                          "ms": graph_ms(torch.amax, flat,
                                         iters=len(flat))}), flush=True)


def run_matvec(fns, randn, dev):
    """K6's matvec at the int8 decode step's shapes, M = 4, 8 and 16 (the
    rows16_ variants at M = 16, the others at M <= 8), over weight copies
    that exceed L2; the yardstick is cuBLAS on a bf16 copy of the
    weight."""
    from chip_smoke import copies_for
    from .ops.quant import int8_matmul, int8_matmul_plain, quantize_weight
    for m, k, n in [(m, k, n) for m in (4, 8, 16)
                    for k, n in ((1280, 1280), (1280, 5120), (5120, 1280))]:
        def weight():
            w = quantize_weight(randn((k, n), torch.float32) / math.sqrt(k))
            return w["q"], w["s"]
        sets = [(randn((m, k)), *weight())
                for _ in range(copies_for(k * n + 2 * m * k))]
        shape = f"M={m} K={k} N={n}"
        calls = {var: _launcher(fn, m, k, n) for var, fn in fns.items()
                 if (_ROWS16 in var) == (m > 8)}
        outs = {st[0]: torch.empty((m, n), dtype=torch.bfloat16, device=dev)
                for st in sets}
        for var, call in calls.items():
            x, q, s = sets[0]
            if var.startswith("stamps"):
                timeline(var, fns[var], call, (x, q, s, outs[x]))
            if not var.startswith("probe"):
                call(x, q, s, outs[x])
                _check(var, outs[x], int8_matmul_plain(x, q, s), shape)
        timed = {var: (lambda c: lambda x, q, s: c(x, q, s, outs[x]))(c)
                 for var, c in calls.items()}
        timed["shipped"] = int8_matmul
        deq = {st[0]: (st[1].float() * st[2]).bfloat16() for st in sets}
        timed["cublas_bf16"] = lambda x, q, s: x @ deq[x]
        report(shape, timed, sets)


def run_mel(fns, randn, dev):
    """K1 at the main path's shape (B=4 windows of 30 s, 128 mels) over
    audio copies that exceed L2, each variant held against the plain
    version after the normalisation (chip_smoke's TOL["mel"]); beside
    them the shipped wrapper, the plain version and the four-call
    ``torch.stft`` route."""
    from chip_smoke import TOL, copies_for, mel_stft_chain
    from .ops.mel import (_constants, kernel_tile, normalize_log_mel,
                          packed_folds, unnormalized_log_mel,
                          unnormalized_log_mel_plain)
    b, n, n_mels = 4, 480000, 128
    n_frames = n // 160
    c = _constants(n_mels, dev)
    consts = {}
    for var, fn in fns.items():
        tile = kernel_tile(fn.lib.mwx_variant_tile)
        consts[var] = (*(torch.from_numpy(p).to(dev)
                         for p in packed_folds(*tile)), c.bands, c.weights)
    sets = [(0.1 * randn((b, n), torch.float32),)
            for _ in range(copies_for(4 * b * n))]
    outs = {a: torch.empty((b, n_frames, n_mels), device=dev)
            for (a,) in sets}
    calls = {var: _launcher(fn, b, n, n_frames, n_mels)
             for var, fn in fns.items()}
    shape = f"B={b} T={n} n_mels={n_mels}"
    a = sets[0][0]
    ref = normalize_log_mel(unnormalized_log_mel_plain(a, n_mels))
    for var, call in calls.items():
        if var.startswith("stamps"):
            timeline(var, fns[var], call, (a, *consts[var], outs[a]))
        if not var.startswith("probe"):
            call(a, *consts[var], outs[a])
            err = float((normalize_log_mel(outs[a]) - ref).abs().max())
            if not err <= TOL["mel"][0]:
                raise AssertionError(f"{var} at {shape}: max abs error {err}")
    timed = {var: (lambda c_, k_: lambda x: c_(x, *k_, outs[x]))(
        call, consts[var]) for var, call in calls.items()}
    timed["shipped"] = lambda x: unnormalized_log_mel(x, n_mels)
    timed["plain"] = lambda x: unnormalized_log_mel_plain(x, n_mels)
    timed["stft_chain"] = lambda x: mel_stft_chain(x, n_mels)
    report(shape, timed, sets)


def report(shape, timed, sets):
    from chip_smoke import graph_ms
    names = list(timed)
    times = {n: [] for n in names}
    for r in range(3):
        order = names[r % len(names):] + names[:r % len(names)]
        for n in order:
            times[n].append(graph_ms(timed[n], sets, iters=len(sets)))
    for n in names:
        print(json.dumps({"shape": shape, "variant": n,
                          "ms": statistics.median(times[n]),
                          "ms_rounds": times[n]}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=sorted(VARIANTS))
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16",
                    help="the element type of the variants (float32: "
                         "decode_self_attention's f32_ variants)")
    ap.add_argument("--baseline", metavar="DIR",
                    help="a checkout whose build of the kernel's shipped "
                         "entry point is checked and timed beside the "
                         "variants")
    args = ap.parse_args()
    if args.dtype == "float32" and args.kernel != "decode_self_attention":
        ap.error("--dtype float32: only decode_self_attention has float32 "
                 "variants")
    if args.baseline and args.kernel not in SHIPPED_ENTRY:
        ap.error(f"--baseline: only {', '.join(SHIPPED_ENTRY)}")
    if not torch.cuda.is_available():
        print("kernel_variants: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ".")
    from chip_smoke import card_line, seeded_randn
    dev = torch.device("cuda", 0)
    print(f"card: {card_line()}", flush=True)
    fns = build_variants(args.kernel, args.dtype)
    if args.baseline:
        fns["baseline"] = build_baseline(args.kernel, args.baseline)
    randn = seeded_randn(dev, 4321)
    if args.kernel == "decode_self_attention":
        run_self(fns, randn, dev, getattr(torch, args.dtype))
    else:
        {"int8_matmul": run_matvec, "mel": run_mel,
         "decode_cross_attention_int8": run_int8}[args.kernel](fns, randn,
                                                               dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
