// K2: non-causal flash attention for the Whisper encoder, Hopper (sm_90a).
//
// Replaces `_flash_kernel` / `flash_attention` of
// manual_whisper_tpu/ops/attention.py: out = softmax(q k^T / sqrt(dh)) v on
// [B*H, T, dh] bf16 tensors, with the online-softmax recurrence so the
// [T, T] score matrix never reaches device memory.  Running max, running
// sum and the output accumulator are float32.
//
// Bound on the H100: 4*B*H*T^2*dh operations against 4*B*H*T*dh*2 bytes, so
// at T=1500 it is bound by the bf16 tensor-core rate.  Design (simple, not
// yet fast): one block of 4 warps per 64 queries; each warp owns 16 query
// rows.  Per 64-key step the block stages K and V in shared memory, each
// warp computes its 16x64 scores with bf16 WMMA (f32 accumulate), updates
// max and sum per row in registers (two lanes per row), writes P as bf16
// and multiplies P V with WMMA into a scratch tile that the lanes fold into
// their f32 output rows.  The ragged edges of T (1500 is no multiple of
// 64) are masked here, not padded in the wrapper: keys >= T score -1e30
// and query rows >= T are neither loaded nor stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = kBlockQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

template <int DH>
struct Layout {
  static constexpr int ldh = DH + 8;          // bf16 stride of Q, K, V rows
  static constexpr int lds = kBlockK + 4;     // f32 stride of scores / PV
  static constexpr int ldp = kBlockK + 8;     // bf16 stride of P rows
  static constexpr int q_elems = kBlockQ * ldh;
  static constexpr int kv_elems = kBlockK * ldh;
  static constexpr int s_elems = kWarps * 16 * lds;
  static constexpr int p_elems = kWarps * 16 * ldp;
  static constexpr size_t bytes =
      (q_elems + 2 * kv_elems) * sizeof(bf16) + s_elems * sizeof(float) +
      p_elems * sizeof(bf16);
  static_assert(DH % 16 == 0 && DH <= kBlockK, "head dim must be 16..64");
};

// rows [r0, r0 + rows) of a [t, DH] bf16 matrix into shared memory,
// zero-filled past t; 16-byte vector copies
template <int DH>
__device__ void load_tile(bf16* dst, const bf16* src, int r0, int rows,
                          int t) {
  constexpr int vecs = DH / 8;
  for (int i = threadIdx.x; i < rows * vecs; i += kThreads) {
    const int r = i / vecs;
    const int c = (i % vecs) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < t)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * DH + c);
    *reinterpret_cast<uint4*>(dst + r * Layout<DH>::ldh + c) = val;
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ out, int t_q,
             int t_k, float scale) {
  using L = Layout<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + L::q_elems;
  bf16* sv = sk + L::kv_elems;
  float* ss = reinterpret_cast<float*>(sv + L::kv_elems);
  bf16* sp = reinterpret_cast<bf16*>(ss + L::s_elems);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bf16* qg = q + (size_t)bh * t_q * DH;
  const bf16* kg = k + (size_t)bh * t_k * DH;
  const bf16* vg = v + (size_t)bh * t_k * DH;

  load_tile<DH>(sq, qg, q0, kBlockQ, t_q);
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
      qa[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wmma::load_matrix_sync(qa[kk], sq + warp * 16 * L::ldh + kk * 16, L::ldh);

  float* s_w = ss + warp * 16 * L::lds;
  bf16* p_w = sp + warp * 16 * L::ldp;
  // two lanes per query row: `half` picks the columns (scores) or head
  // dims (output) this lane owns
  const int r = lane / 2;
  const int half = lane % 2;
  float m = kNegInf, l = 0.f;
  float o[DH / 2];
#pragma unroll
  for (int d = 0; d < DH / 2; ++d) o[d] = 0.f;

  for (int k0 = 0; k0 < t_k; k0 += kBlockK) {
    __syncthreads();                    // all warps done with the last K/V
    load_tile<DH>(sk, kg, k0, kBlockK, t_k);
    load_tile<DH>(sv, vg, k0, kBlockK, t_k);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows (K row-major = K^T col-major)
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, sk + j * 16 * L::ldh + kk * 16, L::ldh);
        wmma::mma_sync(acc, qa[kk], kb, acc);
      }
      wmma::store_matrix_sync(s_w + j * 16, acc, L::lds, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax update of row r over this lane's 32 columns
    const int valid = t_k - k0;
    constexpr int cols = kBlockK / 2;
    float s[cols];
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < cols; ++c) {
      const int col = half * cols + c;
      s[c] = col < valid ? s_w[r * L::lds + col] * scale : kNegInf;
      mx = fmaxf(mx, s[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < cols; ++c) {
      const float p = expf(s[c] - m_new);
      sum += p;
      p_w[r * L::ldp + half * cols + c] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * alpha + sum;
    m = m_new;
    __syncwarp();

    // scratch = P V (into the score tile, which is consumed)
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(pa, p_w + kk * 16, L::ldp);
        wmma::load_matrix_sync(vb, sv + kk * 16 * L::ldh + j * 16, L::ldh);
        wmma::mma_sync(acc, pa, vb, acc);
      }
      wmma::store_matrix_sync(s_w + j * 16, acc, L::lds, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int d = 0; d < DH / 2; ++d)
      o[d] = o[d] * alpha + s_w[r * L::lds + half * (DH / 2) + d];
    __syncwarp();
  }

  const int row = q0 + warp * 16 + r;
  if (row < t_q) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    bf16* dst = out + ((size_t)bh * t_q + row) * DH + half * (DH / 2);
#pragma unroll
    for (int d = 0; d < DH / 2; ++d) dst[d] = __float2bfloat16(o[d] * inv);
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int t_q, int t_k, cudaStream_t stream) {
  const size_t bytes = Layout<DH>::bytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((t_q + kBlockQ - 1) / kBlockQ, bh);
  flash_kernel<DH><<<grid, kThreads, bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, t_q, t_k,
      1.0f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

}  // namespace

// q [bh, t_q, dh], k/v [bh, t_k, dh], out [bh, t_q, dh], all bf16 and
// contiguous; dh is 32 or 64.
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
