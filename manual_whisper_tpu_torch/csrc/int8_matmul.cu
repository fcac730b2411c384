// K6: W8A16 matrix product for Hopper (sm_90a).
//
// Replaces `_int8_mm_kernel` / `int8_matmul_pallas` of
// manual_whisper_tpu/ops/quant.py:
//   out[M, N] = x[M, K] @ (q[K, N] * s[N])
// with x bf16, q int8 (symmetric per-output-channel codes), s float32 and
// a bf16 output.  int8 -> bf16 is exact and bf16 x bf16 products are exact
// in float32, so the result differs from the plain version only in the
// order of the float32 sums.  The scale is applied once per output, after
// the sum.
//
// Two launch shapes, chosen by M:
//
// - M <= 8 (decode steps): a weight-streaming matvec, bound by the int8
//   weight bytes (K*N bytes for 2*M*K*N operations).  A block owns 64
//   output columns and one eighth of K; the eight blocks of a column tile
//   form a thread-block cluster and sum their partial results through
//   distributed shared memory, so N=1280 still runs 160 blocks on the 132
//   SMs and no second pass or atomics are needed.  Each thread streams
//   16 columns of a weight row with one 16-byte load, four rows in flight.
// - M > 8 (prefill, encoder, cross-K/V): a tiled tensor-core product,
//   bound by the bf16 tensor-core rate at M >= 772.  Tiles of 128 x 128
//   outputs, 32-deep K steps; x tiles are staged in shared memory as they
//   are, weight tiles are converted int8 -> bf16 while they are staged;
//   8 warps each own 32 x 64 outputs as 2 x 4 WMMA 16x16x16 fragments with
//   float32 accumulators; the epilogue multiplies by s[n] and rounds to
//   bf16.  No double buffering yet.
//
// Ragged M, N and K edges are masked inside the kernels (zero-filled
// tiles, guarded stores), never padded by the wrapper.  K must be a
// multiple of 8 and N of 16 (16-byte vector loads and stores).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "int8.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using namespace nvcuda;

// ---- small M: cluster split-K matvec --------------------------------------

constexpr int kVecThreads = 256;
constexpr int kVecCols = 64;                         // columns per block
constexpr int kVecGroups = kVecCols / 16;            // 16-byte column groups
constexpr int kVecSlots = kVecThreads / kVecGroups;  // rows per pass
constexpr int kVecWarps = kVecThreads / 32;
constexpr int kSplit = 8;                            // blocks per cluster
constexpr int kVecMaxM = 8;
constexpr int kUnroll = 4;                           // rows in flight
static_assert(kVecCols % kSplit == 0, "ranks split the tile's columns");

template <int MT>
__device__ inline void fma_row(float (&acc)[MT][16], const uint4& w,
                               const bf16* __restrict__ x, int m, int k,
                               int row) {
  float wf[16];
  unpack16_i8(w, wf);
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    const float xv = r < m ? __bfloat162float(x[(size_t)r * k + row]) : 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[r][j] = fmaf(xv, wf[j], acc[r][j]);
  }
}

template <int MT>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kVecThreads)
matvec_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
              const float* __restrict__ s, bf16* __restrict__ out, int m,
              int k, int n) {
  __shared__ float warp_sum[kVecWarps][MT][kVecCols];
  __shared__ float block_sum[MT][kVecCols];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n0 = (blockIdx.x / kSplit) * kVecCols;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int col = n0 + (tid % kVecGroups) * 16;
  const int slot = tid / kVecGroups;
  const int k_per = (k + kSplit - 1) / kSplit;
  const int k0 = min(k, rank * k_per);
  const int k1 = min(k, k0 + k_per);

  float acc[MT][16];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[r][j] = 0.f;

  if (col < n) {
    const int8_t* qc = q + col;
    // all kUnroll loads of a pass are issued before any is used; rows past
    // the slice are masked (a rank's slice is often shorter than a pass)
    for (int row = k0 + slot; row < k1; row += kUnroll * kVecSlots) {
      uint4 w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = row + u * kVecSlots;
        w[u] = r < k1 ? __ldg(reinterpret_cast<const uint4*>(
                            qc + (size_t)r * n))
                      : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (row + u * kVecSlots < k1)
          fma_row<MT>(acc, w[u], x, m, k, row + u * kVecSlots);
    }
  }

  // sum the 8 lanes of a warp that share a column group (lane % 4)
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float v = acc[r][j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[r][j] = v;
    }
  if (lane < kVecGroups) {
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int j = 0; j < 16; ++j) warp_sum[warp][r][lane * 16 + j] = acc[r][j];
  }
  __syncthreads();
  for (int i = tid; i < MT * kVecCols; i += kVecThreads) {
    const int r = i / kVecCols;
    const int c = i % kVecCols;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kVecWarps; ++w) v += warp_sum[w][r][c];
    block_sum[r][c] = v;
  }
  cluster.sync();  // every block's partial sums are written and visible

  // rank r finishes columns [r * 8, r * 8 + 8) of the tile over all ranks
  constexpr int kRankCols = kVecCols / kSplit;
  for (int i = tid; i < MT * kRankCols; i += kVecThreads) {
    const int r = i / kRankCols;
    const int c = rank * kRankCols + i % kRankCols;
    const int nn = n0 + c;
    if (r < m && nn < n) {
      float v = 0.f;
#pragma unroll
      for (int b = 0; b < kSplit; ++b)
        v += cluster.map_shared_rank(&block_sum[0][0], b)[r * kVecCols + c];
      out[(size_t)r * n + nn] = __float2bfloat16(v * s[nn]);
    }
  }
  cluster.sync();  // keep this block's shared memory until all have read it
}

template <int MT>
int launch_matvec(const void* x, const void* q, const void* s, void* out,
                  int m, int k, int n, cudaStream_t stream) {
  const int tiles = (n + kVecCols - 1) / kVecCols;
  matvec_kernel<MT><<<tiles * kSplit, kVecThreads, 0, stream>>>(
      (const bf16*)x, (const int8_t*)q, (const float*)s, (bf16*)out, m, k, n);
  return (int)cudaGetLastError();
}

// ---- large M: WMMA tile product --------------------------------------------

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kMmaThreads = 256;   // 8 warps: 4 along M x 2 along N
constexpr int kLdA = kBK + 8;      // bf16 stride of staged x rows
constexpr int kLdB = kBN + 8;      // bf16 stride of staged weight rows

__global__ void __launch_bounds__(kMmaThreads)
mma_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
           const float* __restrict__ s, bf16* __restrict__ out, int m, int k,
           int n) {
  __shared__ __align__(128) bf16 sa[kBM * kLdA];
  __shared__ __align__(128) bf16 sb[kBK * kLdB];
  __shared__ __align__(128) float stage[kMmaThreads / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / 2;            // rows [wm * 32, +32) of the tile
  const int wn = warp % 2;            // cols [wn * 64, +64)
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < k; k0 += kBK) {
    __syncthreads();                   // all warps done with the last tiles
    for (int i = tid; i < kBM * (kBK / 8); i += kMmaThreads) {
      const int r = i / (kBK / 8);
      const int c = (i % (kBK / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < m && k0 + c < k)
        v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * k + k0 + c);
      *reinterpret_cast<uint4*>(sa + r * kLdA + c) = v;
    }
    {
      const int r = tid / (kBN / 16);
      const int c = (tid % (kBN / 16)) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < k && n0 + c < n)
        v = __ldg(reinterpret_cast<const uint4*>(q + (size_t)(k0 + r) * n
                                                 + n0 + c));
      float f[16];
      unpack16_i8(v, f);
      __align__(16) __nv_bfloat162 h[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);   // exact
      uint4* dst = reinterpret_cast<uint4*>(sb + r * kLdB + c);
      dst[0] = reinterpret_cast<const uint4*>(h)[0];
      dst[1] = reinterpret_cast<const uint4*>(h)[1];
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], sa + (wm * 32 + i * 16) * kLdA + kk * 16,
                               kLdA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(b[j], sb + kk * 16 * kLdB + wn * 64 + j * 16,
                               kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j],
                                                   acc[i][j]);
    }
  }

  // epilogue: per fragment, through this warp's 16x16 stage; two lanes per
  // row, 8 columns each, one 16-byte store
  float* st = stage[warp];
  const int r = lane / 2;
  const int c0 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wm * 32 + i * 16 + r;
      const int gc = n0 + wn * 64 + j * 16 + c0;
      if (gr < m && gc < n) {
        __align__(16) bf16 h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          h[e] = __float2bfloat16(st[r * 16 + c0 + e] * s[gc + e]);
        *reinterpret_cast<uint4*>(out + (size_t)gr * n + gc) =
            *reinterpret_cast<const uint4*>(h);
      }
      __syncwarp();
    }
}

}  // namespace

// x [m, k] bf16, q [k, n] int8, s [n] f32, out [m, n] bf16, all contiguous
// and 16-byte aligned; k a multiple of 8, n a multiple of 16.
extern "C" int mwx_int8_matmul(const void* x, const void* q, const void* s,
                               void* out, int m, int k, int n, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k <= 0 || k % 8 || n % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (m <= 1) return launch_matvec<1>(x, q, s, out, m, k, n, st);
  if (m <= 2) return launch_matvec<2>(x, q, s, out, m, k, n, st);
  if (m <= 4) return launch_matvec<4>(x, q, s, out, m, k, n, st);
  if (m <= kVecMaxM) return launch_matvec<8>(x, q, s, out, m, k, n, st);
  if ((m + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  mma_kernel<<<grid, kMmaThreads, 0, st>>>(
      (const bf16*)x, (const int8_t*)q, (const float*)s, (bf16*)out, m, k, n);
  return (int)cudaGetLastError();
}
