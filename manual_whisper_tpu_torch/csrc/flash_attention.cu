// K2: non-causal flash attention for the Whisper encoder, Hopper (sm_90a).
//
// Replaces `_flash_kernel` / `flash_attention` of
// manual_whisper_tpu/ops/attention.py: out = softmax(q k^T / sqrt(dh)) v on
// [B*H, T, dh] tensors, bf16 here (`mwx_flash_attention`) and float32 in
// `flash_f32_kernel` further down (`mwx_flash_attention_f32`; its own
// design notes), with the online-softmax recurrence so the
// [T, T] score matrix never reaches device memory.  Running max, running
// sum and the output accumulator are float32; P enters the second product
// as bf16.
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

// ---- K2 in float32: FFMA on register tiles -------------------------------
//
// compute_type="float32" runs the encoder in float32, and the JAX kernel then
// computes in float32 throughout (it casts to f32 inside and writes the
// output's dtype).  The bf16 kernel above cannot take it: its TMA maps,
// `wgmma` products and register layouts are bf16.  TF32 `wgmma` would keep
// about three decimal digits, which is not what the float32 reference
// computes, so this kernel multiplies in full float32 on the FMA pipes.
//
// Bound on the H100: the same 4*B*H*T^2*dh operations at the 67 TFLOP/s of
// the FMA pipes (0.69 ms at B=4, H=20, T=1500, dh=64), about 20x the bytes'
// time, so it is bound by operations.  Every product has to come from
// registers at a few operations per shared-memory load:
//
// - A block owns 64 query rows of one (batch, head); 256 threads as 16 x 16,
//   thread (ty, tx) owns rows 4 ty .. 4 ty + 3, of S the keys tx + 16 j
//   (j < 4) and of O the dims [tx * DH/16, (tx + 1) * DH/16).
// - Q (scaled by log2(e)/sqrt(dh) as it is stored, so the softmax is base
//   2), K and V of 64 keys a step sit in shared memory with rows padded to
//   DH + 4 floats: a quarter warp's 16-byte loads along a row then fall in 8
//   different bank groups.  S is 4 x 4 scores a thread, built from 16-byte
//   loads of 4 Q rows and 4 K rows: 64 FMAs for 8 loads.
// - The online softmax runs on those registers: a row's max is 4 shuffles
//   across the 16 lanes of its tx, the row sum stays per thread until the
//   end.  P goes to shared memory (rows padded to 68) and O += P V takes 4 P
//   rows and 4 V rows a step of 4 keys, again 64 FMAs for 8 loads.
// - Keys past t_k are zeros in K and V and -3e38 in S (each tile holds at
//   least one valid key), rows past t_q are zeros and are not written.
constexpr int kF32Rows = 64;          // query rows per block
constexpr int kF32Keys = 64;          // keys per step
constexpr int kF32Threads = 256;      // 16 x 16

template <int DH>
struct F32Smem {
  static_assert(DH == 32 || DH == 64, "head dim 32 or 64");
  static constexpr int ld = DH + 4;           // Q, K, V row stride (floats)
  static constexpr int ldp = kF32Keys + 4;    // P row stride
  static constexpr int k_off = kF32Rows * ld;
  static constexpr int v_off = k_off + kF32Keys * ld;
  static constexpr int p_off = v_off + kF32Keys * ld;
  static constexpr int bytes = (p_off + kF32Rows * ldp) * 4;
};

// Rows [r0, r0 + 64) of a [rows, DH] float32 matrix into a tile of row
// stride ld, times `scale`; rows at or past `rows` are zeros.
template <int DH, int LD>
__device__ __forceinline__ void load_tile_f32(float* tile,
                                              const float* __restrict__ src,
                                              int r0, int rows, float scale) {
  constexpr int chunks = DH / 4;               // 16-byte chunks of a row
  static_assert(64 * chunks % kF32Threads == 0, "whole passes");
#pragma unroll
  for (int it = 0; it < 64 * chunks / kF32Threads; ++it) {
    const int i = threadIdx.x + it * kF32Threads;
    const int r = i / chunks, c = i % chunks;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < rows) {
      x = __ldg(reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * DH)
                + c);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    *reinterpret_cast<float4*>(tile + r * LD + c * 4) = x;
  }
}

template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&x)[N]) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  }
}

template <int DH>
__global__ void __launch_bounds__(kF32Threads, 2)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 int t_q, int t_k, float c) {
  using L = F32Smem<DH>;
  constexpr int kOD = DH / 16;                 // O dims a thread
  extern __shared__ float4 smem_f32[];
  float* sq = reinterpret_cast<float*>(smem_f32);
  float* sk = sq + L::k_off;
  float* sv = sq + L::v_off;
  float* sp = sq + L::p_off;
  const int q0 = blockIdx.x * kF32Rows;
  const size_t bh = blockIdx.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* kb = k + bh * t_k * DH;
  const float* vb = v + bh * t_k * DH;

  load_tile_f32<DH, L::ld>(sq, q + bh * t_q * DH, q0, t_q, c);

  float m[4], l[4], o[4][kOD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -3.0e38f;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < kOD; ++d) o[i][d] = 0.f;
  }

  for (int k0 = 0; k0 < t_k; k0 += kF32Keys) {
    __syncthreads();   // the last step's K, V and P are read
    load_tile_f32<DH, L::ld>(sk, kb, k0, t_k, 1.f);
    load_tile_f32<DH, L::ld>(sv, vb, k0, t_k, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(sq + (4 * ty + i) * L::ld + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(sk + (tx + 16 * j) * L::ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

    // online softmax over this step's keys (base 2; the scale is in Q)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k0 + tx + 16 * j >= t_k) s[i][j] = -3.0e38f;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float corr = exp2f(m[i] - mx);
      m[i] = mx;
      l[i] *= corr;
#pragma unroll
      for (int d = 0; d < kOD; ++d) o[i][d] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - mx);
        l[i] += p;
        sp[(4 * ty + i) * L::ldp + tx + 16 * j] = p;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kF32Keys; j += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(sp + (4 * ty + i) * L::ldp + j);
      float vr[4][kOD];
#pragma unroll
      for (int u = 0; u < 4; ++u) load_f32(sv + (j + u) * L::ld + tx * kOD, vr[u]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int d = 0; d < kOD; ++d) {
          o[i][d] = fmaf(p[i].x, vr[0][d], o[i][d]);
          o[i][d] = fmaf(p[i].y, vr[1][d], o[i][d]);
          o[i][d] = fmaf(p[i].z, vr[2][d], o[i][d]);
          o[i][d] = fmaf(p[i].w, vr[3][d], o[i][d]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int w = 8; w > 0; w >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], w);
    const int r = q0 + 4 * ty + i;
    if (r >= t_q) continue;
    const float inv = 1.f / l[i];
    float* dst = out + (bh * t_q + r) * DH + tx * kOD;
    if constexpr (kOD == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(
          o[i][0] * inv, o[i][1] * inv, o[i][2] * inv, o[i][3] * inv);
    } else {
      *reinterpret_cast<float2*>(dst) = make_float2(o[i][0] * inv,
                                                    o[i][1] * inv);
    }
  }
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, void* out, int bh,
               int t_q, int t_k, cudaStream_t stream) {
  using L = F32Smem<DH>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_f32_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((t_q + kF32Rows - 1) / kF32Rows, bh);
  flash_f32_kernel<DH><<<grid, kF32Threads, L::bytes, stream>>>(
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
