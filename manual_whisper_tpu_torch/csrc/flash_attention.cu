// K2: non-causal flash attention for the Whisper encoder, Hopper (sm_90a).
//
// Replaces `_flash_kernel` / `flash_attention` of
// manual_whisper_tpu/ops/attention.py: out = softmax(q k^T / sqrt(dh)) v on
// [B*H, T, dh] tensors, bf16 here (`mwx_flash_attention`) and float32 in
// `flash_f32_kernel` further down (`mwx_flash_attention_f32`: 3xTF32
// products on the tensor cores; its own design notes), with the
// online-softmax recurrence so the [T, T] score matrix never reaches device
// memory.  Running max, running sum and the output accumulator are
// float32; in bf16 P enters the second product as bf16.
//
// Bound on the H100: 4*B*H*T^2*dh operations against 4*B*H*T*dh*2 bytes,
// so at T=1500 it is bound by the bf16 tensor-core rate.  Beside the
// products the softmax takes B*H*T^2 exponentials, which the SMs'
// special-function units (16 a cycle and SM) run in about the time the
// tensor cores take for the products at dh=64.  What the design does:
//
// - A block owns 128 query rows of one (batch, head): two consumer
//   warpgroups of 64 rows each, and one producer warpgroup whose one
//   thread keeps the Tensor Memory Accelerator (TMA) busy.  `setmaxnreg`
//   gives the producer 24 registers a thread and the consumers 240 (ptxas
//   still fits the consumers' code into the launch bound's 168).
// - Q is loaded once; K and V of 128 keys a step arrive by TMA in a ring of
//   kStages stages in dynamic shared memory, each on its own mbarrier, and
//   the consumers hand each stage back on a second one (K as soon as its
//   scores are in, V after its product).  The maps are 3-D over
//   [B*H, T, dh], so a box that runs past T reads zeros from its own head.
//   Rows are 128 bytes at dh=64 (128-byte swizzle) and 64 bytes at dh=32
//   (64-byte swizzle); the products read the swizzled tiles directly.
// - S = Q K^T is one `wgmma` m64n128k16 per 16 head dims, both operands
//   K-major in shared memory, the scores in registers (64 a thread).
// - The softmax runs on those registers: a row lives in the four lanes of
//   a quad (two shuffles for its max; the sum stays per lane until the
//   end), log2(e)/sqrt(dh) is folded into one FFMA a score, and `ex2` gives
//   P.  Only the last key tile masks keys >= t_k.
// - O += P V is `wgmma` m64n{dh}k16 with A from registers: the scores'
//   accumulator fragment of keys [16 j, 16 j + 16) is, element for element,
//   the A fragment of the product's k-step j, so P is packed to bf16 pairs
//   in place.  V, N-contiguous, is read with the transposed-B flag.  O is
//   rescaled in registers and divided by the row sum once at the end.
// - The epilogue writes bf16 O into the warpgroup's Q tile (no longer
//   read) in the swizzled layout, and one TMA store writes it out; rows
//   past t_q fall outside the map and are not written.
//
// On an H100 at B=4, H=20, T=1500, dh=64 (chip_smoke.py, PERF.md) this
// runs at about SDPA's speed and 3x the tensor-core bound.  What holds it
// there: the products and the softmax do not overlap.  Builds with the
// softmax compiled out take a little over half the time, and the softmax
// adds the rest; a clock64 timeline of one block shows that while one
// warpgroup issues its products (the issuing warp waits until the tensor
// cores take them) the other warpgroup's softmax stalls too.  Overlapping
// a tile's softmax with the next tile's scores, ping-pong between the
// warpgroups, deeper rings, P through shared memory, one barrier for K
// and V, fewer softmax instructions and exponentials on the FMA pipe each
// left the time within 5 % of this kernel's, so it keeps the simple
// sequential order.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 128;              // query rows per block
constexpr int kBK = 128;              // keys per step
constexpr int kStages = 2;            // depth of the K and V rings
constexpr int kConsumers = 2;         // warpgroups of 64 query rows
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kConsumerWarps = kConsumers * 4;
// registers a thread after the rebalancing; at launch every thread has
// the launch bound's 65536 / 384 rounded down to 8, i.e. 168
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kLaunchRegs = (65536 / kThreads) / 8 * 8;
static_assert(kProducerRegs * 128 + kConsumerRegs * 128 * kConsumers <=
                  kLaunchRegs * kThreads,
              "the rebalanced registers fit what the block starts with");

// Shared memory of a block, from a 1024-byte aligned base: the Q tile, the
// K ring, the V ring, then the barriers (Q full; per stage K full, V full,
// K empty, V empty).
template <int DH>
struct Smem {
  static_assert(DH == 32 || DH == 64, "head dim 32 or 64");
  static constexpr int row = DH * 2;                  // bytes of a row
  static constexpr int layout = DH == 64 ? kSwizzle128 : kSwizzle64;
  static constexpr int atom = 8 * row;                // 8 rows: the SBO
  static constexpr int q_bytes = kBQ * row;
  static constexpr int kv_bytes = kBK * row;
  static constexpr int k_off = q_bytes;
  static constexpr int v_off = k_off + kStages * kv_bytes;
  static constexpr int bar_off = v_off + kStages * kv_bytes;
  static constexpr int full_q = 0;                    // from bar_off
  static constexpr int full_k = 8;
  static constexpr int full_v = full_k + kStages * 8;
  static constexpr int empty_k = full_v + kStages * 8;
  static constexpr int empty_v = empty_k + kStages * 8;
  static constexpr int launch_bytes = bar_off + empty_v + kStages * 8 + 1024;
  static_assert(q_bytes % 1024 == 0 && kv_bytes % 1024 == 0, "atoms");
};

// Byte offset of 16-byte chunk `c` of row `r` in a tile as the TMA writes
// it: 128-byte rows, chunk XOR (r mod 8); or 64-byte rows, chunk XOR
// (r / 2 mod 4).
template <int DH>
__device__ __forceinline__ int swz(int r, int c) {
  if (DH == 64) return r * 128 + ((c ^ (r & 7)) << 4);
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// Registers that an asynchronous product reads or writes stay where they
// are: the compiler may not move, copy or reuse them across this point.
template <int N>
__device__ __forceinline__ void keep(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    asm volatile("" : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]),
                 "+f"(d[j][3]) :: "memory");
}

template <int N>
__device__ __forceinline__ void keep(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    asm volatile("" : "+r"(a[j][0]), "+r"(a[j][1]), "+r"(a[j][2]),
                 "+r"(a[j][3]) :: "memory");
}

// s[64, 128] (+)= q[64, 16] k[128, 16]^T for one warpgroup, both operands
// K-major in shared memory.  s[j] is the fragment of keys [8 j, 8 j + 8):
// rows 16 (warp % 4) + lane / 4 and + 8, keys 2 (lane % 4) + {0, 1}.
__device__ __forceinline__ void wgmma_qk(float (&d)[16][4], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// o[64, 64] += p[64, 16] v[16, 64]: p in registers as bf16 pairs (the A
// fragment: rows lane / 4 and + 8 of the warp's 16, keys 2 (lane % 4) +
// {0, 1} and + 8), v N-contiguous in shared memory (transposed-B flag).
__device__ __forceinline__ void wgmma_pv(float (&d)[8][4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// The same at dh=32: o[64, 32] += p[64, 16] v[16, 32].
__device__ __forceinline__ void wgmma_pv(float (&d)[4][4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// One thread of the producer warpgroup: Q once, then K and V of every key
// step into the rings, each as soon as the consumers have handed its stage
// back.
template <int DH>
__device__ __forceinline__ void produce(uint32_t base, uint32_t bars,
                                        const CUtensorMap* map_q,
                                        const CUtensorMap* map_k,
                                        const CUtensorMap* map_v, int t_k,
                                        int q0, int bh) {
  using L = Smem<DH>;
  mbar_expect_tx(bars + L::full_q, L::q_bytes);
  tma_load_3d(base, map_q, bars + L::full_q, 0, q0, bh);
  const int nk = (t_k + kBK - 1) / kBK;
  for (int j = 0; j < nk; ++j) {
    const int stage = j % kStages;
    const int parity = ((j / kStages) & 1) ^ 1;  // a fresh stage is empty
    mbar_wait(bars + L::empty_k + stage * 8, parity);
    mbar_expect_tx(bars + L::full_k + stage * 8, L::kv_bytes);
    tma_load_3d(base + L::k_off + stage * L::kv_bytes, map_k,
                bars + L::full_k + stage * 8, 0, j * kBK, bh);
    mbar_wait(bars + L::empty_v + stage * 8, parity);
    mbar_expect_tx(bars + L::full_v + stage * 8, L::kv_bytes);
    tma_load_3d(base + L::v_off + stage * L::kv_bytes, map_v,
                bars + L::full_v + stage * 8, 0, j * kBK, bh);
  }
}

// Online softmax of one key tile for this thread's two rows (row 0: lane /
// 4 of the warp's 16, row 1: 8 below).  s holds raw scores q.k; keys from
// `valid` on are masked.  On return p holds exp2(c s - c m) as the bf16 A
// fragments of the P V product (p[kk]: keys [16 kk, 16 kk + 16)), m is
// the new running max, l this lane's share of the running sum, and
// alpha the factor that brings the old O to the new max.
__device__ __forceinline__ void softmax_tile(float (&s)[16][4],
                                             uint32_t (&p)[8][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float c,
                                             int valid, int quad) {
  if (valid < kBK) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j * 8 + quad * 2 + (e & 1) >= valid) s[j][e] = -INFINITY;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
  float mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = ex2((m[r] - mx[r]) * c);     // 0 on the first tile
    m[r] = mx[r];
    mc[r] = mx[r] * c;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float p0 = ex2(fmaf(s[j][0], c, -mc[0]));
    const float p1 = ex2(fmaf(s[j][1], c, -mc[0]));
    const float p2 = ex2(fmaf(s[j][2], c, -mc[1]));
    const float p3 = ex2(fmaf(s[j][3], c, -mc[1]));
    sum[0] += p0 + p1;
    sum[1] += p2 + p3;
    p[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
    p[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
}

// A consumer warpgroup: 64 query rows against every key step, then the
// epilogue.
template <int DH>
__device__ __forceinline__ void consume(unsigned char* smem, uint32_t bars,
                                        const CUtensorMap* map_o, int t_q,
                                        int t_k, int q0, int bh, float c,
                                        int wg, int tid) {
  using L = Smem<DH>;
  constexpr int kOut = DH / 8;                  // O fragments per thread
  const int warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const uint32_t base = smem_u32(smem);
  const uint32_t sq = base + wg * 64 * L::row;  // this warpgroup's Q rows
  const int nk = (t_k + kBK - 1) / kBK;

  float o[kOut][4];
#pragma unroll
  for (int j = 0; j < kOut; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  float s[16][4];
  uint32_t p[8][4];

  mbar_wait(bars + L::full_q, 0);
  for (int j = 0; j < nk; ++j) {
    const int stage = j % kStages;
    const int parity = (j / kStages) & 1;
    const uint32_t sk = base + L::k_off + stage * L::kv_bytes;
    const uint32_t sv = base + L::v_off + stage * L::kv_bytes;

    mbar_wait(bars + L::full_k + stage * 8, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_qk(s, gmma_desc(sq + kk * 32, 16, L::atom, L::layout),
               gmma_desc(sk + kk * 32, 16, L::atom, L::layout), kk);
    wgmma_commit();
    keep(s);
    wgmma_wait<0>();
    keep(s);
    if (lane == 0) mbar_arrive(bars + L::empty_k + stage * 8);

    softmax_tile(s, p, m, l, alpha, c, t_k - j * kBK, quad);
#pragma unroll
    for (int jj = 0; jj < kOut; ++jj) {
      o[jj][0] *= alpha[0];
      o[jj][1] *= alpha[0];
      o[jj][2] *= alpha[1];
      o[jj][3] *= alpha[1];
    }

    mbar_wait(bars + L::full_v + stage * 8, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_pv(o, p[kk], gmma_desc(sv + kk * 16 * L::row, L::kv_bytes,
                                   L::atom, L::layout));
    wgmma_commit();
    keep(o);
    keep(p);
    wgmma_wait<0>();
    keep(o);
    keep(p);
    if (lane == 0) mbar_arrive(bars + L::empty_v + stage * 8);
  }

  // epilogue: the row sums meet across the quad; bf16 O goes into this
  // warpgroup's Q rows in the TMA box's swizzled layout, and one thread
  // stores the box
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
  unsigned char* tile = smem + wg * 64 * L::row;
  const int r0 = warp * 16 + lane / 4;
#pragma unroll
  for (int jj = 0; jj < kOut; ++jj) {
    *reinterpret_cast<uint32_t*>(tile + swz<DH>(r0, jj) + quad * 4) =
        pack_bf16(o[jj][0] * inv[0], o[jj][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(tile + swz<DH>(r0 + 8, jj) + quad * 4) =
        pack_bf16(o[jj][2] * inv[1], o[jj][3] * inv[1]);
  }
  fence_async_proxy();
  named_sync(1 + wg, 128);
  if (tid == 0 && q0 + wg * 64 < t_q)
    tma_store_3d(map_o, sq, 0, q0 + wg * 64, bh);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const __grid_constant__ CUtensorMap map_q,
             const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v,
             const __grid_constant__ CUtensorMap map_o, int t_q, int t_k,
             float c) {
  using L = Smem<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - smem_u32(smem_raw)) & 1023u);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + L::bar_off;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bars + L::full_q, 1);
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(bars + L::full_k + i * 8, 1);
      mbar_init(bars + L::full_v + i * 8, 1);
      mbar_init(bars + L::empty_k + i * 8, kConsumerWarps);
      mbar_init(bars + L::empty_v + i * 8, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128)
      produce<DH>(base, bars, &map_q, &map_k, &map_v, t_k, q0, bh);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    consume<DH>(smem, bars, &map_o, t_q, t_k, q0, bh, c, wg,
                threadIdx.x % 128);
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int t_q, int t_k, cudaStream_t stream) {
  using L = Smem<DH>;
  static bool configured = false;
  if (!configured) {
    // setmaxnreg only moves registers within the block: if the compiler
    // started the kernel with fewer than the launch bound's, the consumers'
    // request could never be met.  Refuse rather than hang.
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, flash_kernel<DH>);
    if (err != cudaSuccess) return (int)err;
    if (attr.numRegs < kLaunchRegs) return (int)cudaErrorInvalidConfiguration;
    err = cudaFuncSetAttribute(flash_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::launch_bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const CUtensorMapSwizzle swizzle =
      DH == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap map_q, map_k, map_v, map_o;
  if (!make_map_3d(&map_q, type, 2, q, bh, t_q, DH, kBQ, DH, swizzle) ||
      !make_map_3d(&map_k, type, 2, k, bh, t_k, DH, kBK, DH, swizzle) ||
      !make_map_3d(&map_v, type, 2, v, bh, t_k, DH, kBK, DH, swizzle) ||
      !make_map_3d(&map_o, type, 2, out, bh, t_q, DH, 64, DH, swizzle))
    return (int)cudaErrorInvalidValue;
  dim3 grid((t_q + kBQ - 1) / kBQ, bh);
  flash_kernel<DH><<<grid, kThreads, L::launch_bytes, stream>>>(
      map_q, map_k, map_v, map_o, t_q, t_k,
      1.4426950408889634f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

// ---- K2 in float32: 3xTF32 on the tensor cores ---------------------------
//
// compute_type="float32" runs the encoder in float32, and the JAX kernel then
// computes in float32 throughout (it casts to f32 inside and writes the
// output's dtype).  TF32 products keep 11 significant bits, which is not
// what the float32 reference computes (one TF32 product a score puts the
// output about 1e-3 off; tests/test_torch_tf32_split.py shows it).  So each
// operand x is split into two TF32 values, hi = rna(x) and lo = rna(x - hi)
// (`split_tf32`, explicit: the tensor cores are never left to truncate an
// unsplit float32), and every product is three TF32 products summed in
// float32, lo hi + hi lo + hi hi; the dropped lo lo and the split's own
// rounding are below 2^-22 of a product, float32-class.
//
// Bound on the H100: 3 x 4*B*H*T^2*dh TF32 operations at 495 TFLOP/s (0.279
// ms at B=4, H=20, T=1500, dh=64), against 0.688 ms for the float32
// operations on the FMA pipes, 0.047 for the softmax's B*H*T^2 exponentials
// and 0.037 for the bytes: bound by the tensor cores.  What the design does:
//
// - A block owns 128 query rows of one (batch, head): two consumer
//   warpgroups of 64 rows and one producer warpgroup, 384 threads with the
//   launch bound's 168 registers each (no rebalancing).
// - Every operand sits in shared memory K-major, which is the only layout a
//   TF32 product reads: 128-byte rows of 32 floats in the 128-byte swizzle
//   (a 16-byte unit u of row r at u ^ (r mod 8)), so a row of dh=64 is two
//   such boxes and dh=32 one; a k-step of 8 floats is 32 bytes into a box.
// - Each consumer warpgroup loads its 64 Q rows once, splits them and
//   stores Q hi and Q lo (rows past t_q are zeros).  The producer
//   warpgroup loads K and V of 64 keys a step with 16-byte loads (keys past
//   t_k are zeros), splits them in registers and stores K hi, K lo and the
//   transposed V^T hi, V^T lo (dh rows of 64 keys: the product over the
//   keys needs them contiguous) into a ring of kF32Stages stages, each
//   announced on a full barrier (128 arrivals, each after the thread's
//   fence.proxy.async) and handed back on an empty one (K as soon as its
//   scores are in, V after its product).  Shared memory at dh=64: Q 64 KB,
//   two stages of 64 KB; 197,696 bytes with the barriers and alignment.
// - S = Q K^T is `wgmma` m64n64k8 three times a k-step, A and B from
//   shared memory; S (32 registers a thread) takes the bf16 kernel's
//   online softmax: log2(e)/sqrt(dh) folded into one FFMA a score, `ex2`,
//   a row's max across its quad; only the last key tile masks keys >= t_k.
// - P V is `wgmma` m64n{dh}k8 three times a k-step with P in registers.
//   The accumulator fragment of S holds keys 2 (lane % 4) and + 1 of each
//   group of 8, while the TF32 A fragment wants columns lane % 4 and + 4,
//   so the keys are permuted within each group of 8, in P's fragment and
//   in V^T's columns alike (`key_slot`: key 2i to column i, 2i + 1 to
//   i + 4); the sum over the keys is unchanged.  That keeps P in
//   registers, where a pass through shared memory would cost a store, a
//   fence and a barrier a tile.  P is split into hi and lo in place.
// - The tensor cores' float32 sums lose more than float32 rounding along
//   a long chain of products into one accumulator.  With every tile's
//   products chained into O (576 at T=1500) the sharp-softmax check (keys
//   scaled 3x) read 4.3e-5 against the plain version; so each tile's P V
//   goes into a fresh accumulator and O = alpha O + P V is one FFMA a value
//   in registers (1.4e-5), and S keeps its hi hi products apart from the
//   lo hi and hi lo ones, added in registers (1.1e-5; 0.9e-6 at unscaled
//   keys).  Each cost under 1.5 % of the time.
// - O is divided by the row sum once at the end and written from
//   registers as float32; rows past t_q are not written.
//
// ptxas: 116 registers at dh=32 and 155 at dh=64, no spills.  On an H100
// at B=4, H=20, T=1500, dh=64 (chip_smoke.py, PERF.md) this takes 0.63 ms,
// 2.25x its bound and 2.3x faster than SDPA's float32 kernel.  A build
// with one TF32 product in place of each three takes 0.46 ms: two products
// cost 0.17 ms, so the products take about 0.26 ms (near the bound) and
// the softmax, the splits and the hand-offs, which do not overlap with
// them (as in the bf16 kernel), the rest.  Rounding with integer
// operations instead of `cvt.rna.tf32.f32` (bit-identical on finite
// values) would save 5 %.
constexpr int kF32Rows = 128;         // query rows per block
constexpr int kF32Keys = 64;          // keys per step
constexpr int kF32Stages = 2;         // depth of the K and V rings
constexpr int kF32Box = 128;          // bytes of a swizzled row (32 floats)

template <int DH>
struct F32Smem {
  static_assert(DH == 32 || DH == 64, "head dim 32 or 64");
  static constexpr int tile = 64 * DH * 4;            // Q, K or V^T, hi or lo
  static constexpr int q_off = 0;                     // [wg][hi, lo]
  static constexpr int stage_off = kConsumers * 2 * tile;
  static constexpr int stage_bytes = 4 * tile;        // K hi, lo, V^T hi, lo
  static constexpr int bar_off = stage_off + kF32Stages * stage_bytes;
  static constexpr int full_k = 0;                    // from bar_off
  static constexpr int full_v = full_k + kF32Stages * 8;
  static constexpr int empty_k = full_v + kF32Stages * 8;
  static constexpr int empty_v = empty_k + kF32Stages * 8;
  static constexpr int launch_bytes = bar_off + empty_v + kF32Stages * 8
                                      + 1024;
  static_assert(tile % 1024 == 0, "swizzle atoms");
};

// Byte offset of 16-byte unit u (floats 4u .. 4u + 3 along K) of row r in a
// K-major tile of `rows` rows: box u / 8, then the 128-byte swizzle.
__device__ __forceinline__ int swz_f32(int rows, int r, int u) {
  return (u >> 3) * rows * kF32Box + r * kF32Box + (((u & 7) ^ (r & 7)) << 4);
}

// Descriptor of k-step kk (8 floats along K) of a K-major tile of `rows`
// rows at `addr`: its box, 32 bytes a step into it; 8-row atoms 1024 bytes
// apart.
__device__ __forceinline__ uint64_t desc_f32(uint32_t addr, int rows,
                                             int kk) {
  return gmma_desc(addr + (kk >> 2) * rows * kF32Box + (kk & 3) * 32, 16,
                   8 * kF32Box, kSwizzle128);
}

// The column of key r (of a 64-key tile) in V^T: keys 2i and 2i + 1 of each
// group of 8 go to columns i and i + 4, where P's fragment has them.
__device__ __forceinline__ int key_slot(int r) {
  return (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);
}

// Rows [r0, r0 + 64) of a row-major [n, DH] float32 matrix into registers,
// rows at or past n as zeros.  128 threads: thread t takes row t % 64 and
// the half t / 64 of its 16-byte units.
template <int DH>
__device__ __forceinline__ void load_rows(float4 (&x)[DH / 8],
                                          const float* __restrict__ src,
                                          int r0, int n, int t) {
  const int r = t % 64, u0 = (t / 64) * (DH / 8);
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
    x[i] = r0 + r < n
               ? __ldg(reinterpret_cast<const float4*>(src + (size_t)(r0 + r)
                                                       * DH) + u0 + i)
               : make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void split4(const float4& x, uint4& hi, uint4& lo) {
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
}

// The rows of load_rows, split, into K-major hi and lo tiles of 64 rows.
template <int DH>
__device__ __forceinline__ void store_rows(unsigned char* hi,
                                           unsigned char* lo,
                                           const float4 (&x)[DH / 8], int t) {
  const int r = t % 64, u0 = (t / 64) * (DH / 8);
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) {
    uint4 h, l;
    split4(x[i], h, l);
    const int off = swz_f32(64, r, u0 + i);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// The rows of load_rows (64 keys), split, into K-major V^T hi and lo tiles:
// DH rows, key r in column key_slot(r).  A warp's lanes hold 32 keys of one
// box and store one row of it at a time: 32 banks.
template <int DH>
__device__ __forceinline__ void store_cols(unsigned char* hi,
                                           unsigned char* lo,
                                           const float4 (&x)[DH / 8], int t) {
  const int p = key_slot(t % 64), u0 = (t / 64) * (DH / 8);
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) {
    uint4 h, l;
    split4(x[i], h, l);
    const uint32_t hv[4] = {h.x, h.y, h.z, h.w}, lv[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int off = swz_f32(DH, 4 * (u0 + i) + e, p >> 2) + (p & 3) * 4;
      *reinterpret_cast<uint32_t*>(hi + off) = hv[e];
      *reinterpret_cast<uint32_t*>(lo + off) = lv[e];
    }
  }
}

// The producer warpgroup: K and V of every key step, split, into the ring,
// each half as soon as the consumers have handed its stage back.
template <int DH>
__device__ __forceinline__ void produce_f32(unsigned char* smem, uint32_t bars,
                                            const float* __restrict__ k,
                                            const float* __restrict__ v,
                                            int t_k, int t) {
  using L = F32Smem<DH>;
  const int nk = (t_k + kF32Keys - 1) / kF32Keys;
  for (int j = 0; j < nk; ++j) {
    const int stage = j % kF32Stages;
    const int parity = ((j / kF32Stages) & 1) ^ 1;  // a fresh stage is empty
    unsigned char* st = smem + L::stage_off + stage * L::stage_bytes;
    float4 xk[DH / 8], xv[DH / 8];
    load_rows<DH>(xk, k, j * kF32Keys, t_k, t);
    load_rows<DH>(xv, v, j * kF32Keys, t_k, t);
    mbar_wait(bars + L::empty_k + stage * 8, parity);
    store_rows<DH>(st, st + L::tile, xk, t);
    fence_async_proxy();
    mbar_arrive(bars + L::full_k + stage * 8);
    mbar_wait(bars + L::empty_v + stage * 8, parity);
    store_cols<DH>(st + 2 * L::tile, st + 3 * L::tile, xv, t);
    fence_async_proxy();
    mbar_arrive(bars + L::full_v + stage * 8);
  }
}

// Online softmax of one 64-key tile for this thread's two rows (row 0: lane
// / 4 of the warp's 16, row 1: 8 below); keys from `valid` on are masked.
// On return ph and pl hold exp2(c s - c m) split into TF32 hi and lo as the
// A fragments of the P V product's k-steps (keys in key_slot order), m is
// the new running max, l this lane's share of the running sum, and alpha
// the factor that brings the old O to the new max.
__device__ __forceinline__ void softmax_tile_f32(float (&s)[8][4],
                                                 uint32_t (&ph)[8][4],
                                                 uint32_t (&pl)[8][4],
                                                 float (&m)[2], float (&l)[2],
                                                 float (&alpha)[2], float c,
                                                 int valid, int quad) {
  if (valid < kF32Keys) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j * 8 + quad * 2 + (e & 1) >= valid) s[j][e] = -INFINITY;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
  float mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = ex2((m[r] - mx[r]) * c);     // 0 on the first tile
    m[r] = mx[r];
    mc[r] = mx[r] * c;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    // s[j]: (row 0, key 2 quad), (row 0, + 1), (row 1, key 2 quad), (row
    // 1, + 1); the A fragment: (row 0, column quad), (row 1, quad), (row
    // 0, quad + 4), (row 1, quad + 4)
    const float p0 = ex2(fmaf(s[j][0], c, -mc[0]));
    const float p1 = ex2(fmaf(s[j][1], c, -mc[0]));
    const float p2 = ex2(fmaf(s[j][2], c, -mc[1]));
    const float p3 = ex2(fmaf(s[j][3], c, -mc[1]));
    sum[0] += p0 + p1;
    sum[1] += p2 + p3;
    split_tf32(p0, ph[j][0], pl[j][0]);
    split_tf32(p2, ph[j][1], pl[j][1]);
    split_tf32(p1, ph[j][2], pl[j][2]);
    split_tf32(p3, ph[j][3], pl[j][3]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
}

// A consumer warpgroup: its 64 query rows into Q hi and lo, against every
// key step, then the output.
template <int DH>
__device__ __forceinline__ void consume_f32(unsigned char* smem, uint32_t bars,
                                            const float* __restrict__ q,
                                            float* __restrict__ out, int t_q,
                                            int t_k, int q0, float c, int wg,
                                            int tid) {
  using L = F32Smem<DH>;
  constexpr int kOut = DH / 8;                  // O fragments per thread
  const int warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const int nk = (t_k + kF32Keys - 1) / kF32Keys;
  unsigned char* sq = smem + L::q_off + wg * 2 * L::tile;
  const uint32_t q_hi = smem_u32(sq), q_lo = q_hi + L::tile;
  {
    float4 xq[DH / 8];
    load_rows<DH>(xq, q, q0 + wg * 64, t_q, tid);
    store_rows<DH>(sq, sq + L::tile, xq, tid);
    fence_async_proxy();
    named_sync(1 + wg, 128);
  }

  float o[kOut][4];
#pragma unroll
  for (int j = 0; j < kOut; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  float s[8][4], s_lo[8][4], pv[kOut][4];
  uint32_t ph[8][4], pl[8][4];

  for (int j = 0; j < nk; ++j) {
    const int stage = j % kF32Stages;
    const int parity = (j / kF32Stages) & 1;
    const uint32_t k_hi = smem_u32(smem + L::stage_off
                                   + stage * L::stage_bytes);
    const uint32_t k_lo = k_hi + L::tile;
    const uint32_t v_hi = k_hi + 2 * L::tile, v_lo = k_hi + 3 * L::tile;

    // S: the hi hi products chained in s, the lo hi and hi lo ones in
    // s_lo, added in registers
    mbar_wait(bars + L::full_k + stage * 8, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 8; ++kk) {
      wgmma_tf32(s_lo, desc_f32(q_lo, 64, kk), desc_f32(k_hi, 64, kk), kk);
      wgmma_tf32(s_lo, desc_f32(q_hi, 64, kk), desc_f32(k_lo, 64, kk), 1);
      wgmma_tf32(s, desc_f32(q_hi, 64, kk), desc_f32(k_hi, 64, kk), kk);
    }
    wgmma_commit();
    keep(s);
    keep(s_lo);
    wgmma_wait<0>();
    keep(s);
    keep(s_lo);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += s_lo[j][e];
    if (lane == 0) mbar_arrive(bars + L::empty_k + stage * 8);

    softmax_tile_f32(s, ph, pl, m, l, alpha, c, t_k - j * kF32Keys, quad);

    // this tile's P V into a fresh accumulator, then O = alpha O + P V in
    // registers
    mbar_wait(bars + L::full_v + stage * 8, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kF32Keys / 8; ++kk) {
      wgmma_tf32(pv, pl[kk], desc_f32(v_hi, DH, kk), kk);
      wgmma_tf32(pv, ph[kk], desc_f32(v_lo, DH, kk), 1);
      wgmma_tf32(pv, ph[kk], desc_f32(v_hi, DH, kk), 1);
    }
    wgmma_commit();
    keep(pv);
    keep(ph);
    keep(pl);
    wgmma_wait<0>();
    keep(pv);
    keep(ph);
    keep(pl);
    if (lane == 0) mbar_arrive(bars + L::empty_v + stage * 8);
#pragma unroll
    for (int jj = 0; jj < kOut; ++jj) {
      o[jj][0] = fmaf(o[jj][0], alpha[0], pv[jj][0]);
      o[jj][1] = fmaf(o[jj][1], alpha[0], pv[jj][1]);
      o[jj][2] = fmaf(o[jj][2], alpha[1], pv[jj][2]);
      o[jj][3] = fmaf(o[jj][3], alpha[1], pv[jj][3]);
    }
  }

  // the row sums meet across the quad; float32 O straight from registers
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
  const int r0 = q0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (r0 + 8 * r >= t_q) continue;
    float* dst = out + (size_t)(r0 + 8 * r) * DH + quad * 2;
#pragma unroll
    for (int jj = 0; jj < kOut; ++jj)
      *reinterpret_cast<float2*>(dst + jj * 8) =
          make_float2(o[jj][2 * r] * inv[r], o[jj][2 * r + 1] * inv[r]);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 int t_q, int t_k, float c) {
  using L = F32Smem<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - smem_u32(smem_raw)) & 1023u);
  const uint32_t bars = smem_u32(smem) + L::bar_off;
  const size_t bh = blockIdx.y;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kF32Stages; ++i) {
      mbar_init(bars + L::full_k + i * 8, 128);
      mbar_init(bars + L::full_v + i * 8, 128);
      mbar_init(bars + L::empty_k + i * 8, kConsumerWarps);
      mbar_init(bars + L::empty_v + i * 8, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers)
    produce_f32<DH>(smem, bars, k + bh * t_k * DH, v + bh * t_k * DH, t_k,
                    threadIdx.x % 128);
  else
    consume_f32<DH>(smem, bars, q + bh * t_q * DH, out + bh * t_q * DH, t_q,
                    t_k, blockIdx.x * kF32Rows, c, wg, threadIdx.x % 128);
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, void* out, int bh,
               int t_q, int t_k, cudaStream_t stream) {
  using L = F32Smem<DH>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_f32_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::launch_bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((t_q + kF32Rows - 1) / kF32Rows, bh);
  flash_f32_kernel<DH><<<grid, kThreads, L::launch_bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, t_q, t_k,
      1.4426950408889634f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

}  // namespace

// K2 in bf16: q [bh, t_q, dh], k/v [bh, t_k, dh], out [bh, t_q, dh], all
// bf16, contiguous and 16-byte aligned; dh is 32 or 64.
extern "C" int mwx_flash_attention(const void* q, const void* k, const void* v,
                                   void* out, int bh, int t_q, int t_k,
                                   int head_dim, void* stream) {
  if (bh <= 0 || t_q <= 0) return 0;
  if (t_k <= 0 || bh > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (head_dim) {
    case 64: return launch<64>(q, k, v, out, bh, t_q, t_k, s);
    case 32: return launch<32>(q, k, v, out, bh, t_q, t_k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K2 in float32: the same arguments, q, k, v and out float32, contiguous
// and 16-byte aligned; dh is 32 or 64.
extern "C" int mwx_flash_attention_f32(const void* q, const void* k,
                                       const void* v, void* out, int bh,
                                       int t_q, int t_k, int head_dim,
                                       void* stream) {
  if (bh <= 0 || t_q <= 0) return 0;
  if (t_k <= 0 || bh > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (head_dim) {
    case 64: return launch_f32<64>(q, k, v, out, bh, t_q, t_k, s);
    case 32: return launch_f32<32>(q, k, v, out, bh, t_q, t_k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
