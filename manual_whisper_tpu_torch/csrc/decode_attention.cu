// K3 + K4: q_len = 1 decode-step attention for Hopper (sm_90a).
//
// Replaces, in manual_whisper_tpu/ops/decode_attention.py,
//   K3 `_self_kernel` / `decode_self_attention`   (self cache, slots <= pos)
//   K4 `_cross_bf16_kernel` / `decode_cross_attention` (cross K/V, < kv_len)
// which share `_attend_all_heads`.  Here too both are one kernel:
//   out[bh] = softmax(q[bh] . k[bh, t] / sqrt(dh), t < n) @ v[bh, t]
// with q [B*H, dh], k/v [B*H, T, dh] bf16 (the port's cache layout: the
// TPU's transposed [.., dh, T] layout existed only for its 128-lane tiles),
// float32 scores, softmax and sums, bf16 output.
//
// n, the number of valid positions, is read on the device from an int32
// (`*len_ptr + len_offset`: pos + 1 for the self cache, kv_len for cross
// K/V), so a decode step never waits on the host for it and the loop can
// later be captured in a CUDA graph.  Only positions < n are read.
//
// Bound on the H100: about one operation per byte (2*n*dh bf16 values read
// for 4*n*dh operations), so it is bound by device memory bandwidth.
// Design (simple, not yet fast): one block of 128 threads per (batch,
// head); dh/8 lanes share one key with 16-byte loads and reduce its dot
// product with shuffles; scores stay in shared memory; the weighted sum of
// V runs over 16 groups of lanes and is reduced through shared memory.
// One block per (batch, head) leaves SMs idle at small batch: splitting T
// across blocks is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ inline void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ float block_reduce(float x, float* red, bool is_max) {
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ out,
              const int* __restrict__ len_ptr, int len_offset, int t_max,
              float scale) {
  constexpr int lanes_per_key = DH / 8;            // 16-byte chunks per row
  constexpr int keys_per_warp = 32 / lanes_per_key;
  constexpr int groups = kThreads / lanes_per_key; // for the P V sum
  extern __shared__ float smem[];
  float* s = smem;                                 // [t_max] scores
  float* partial = s + t_max;                      // [groups, DH]
  float* red = partial + groups * DH;              // [kWarps]

  int n = *len_ptr + len_offset;
  if (n <= 0 || n > t_max) n = t_max;
  const int bh = blockIdx.x;
  const bf16* kb = k + (size_t)bh * t_max * DH;
  const bf16* vb = v + (size_t)bh * t_max * DH;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int sub = lane % lanes_per_key;
  const int slot = lane / lanes_per_key;

  float qf[8];
  unpack8(*reinterpret_cast<const uint4*>(q + (size_t)bh * DH + sub * 8), qf);

  // scores: all lanes of a warp run the same trip count (shuffles below)
  for (int t0 = warp * keys_per_warp; t0 < n;
       t0 += kWarps * keys_per_warp) {
    const int t = t0 + slot;
    float dot = 0.f;
    if (t < n) {
      float kf[8];
      unpack8(*reinterpret_cast<const uint4*>(kb + (size_t)t * DH + sub * 8),
              kf);
#pragma unroll
      for (int i = 0; i < 8; ++i) dot = fmaf(qf[i], kf[i], dot);
    }
#pragma unroll
    for (int o = lanes_per_key / 2; o > 0; o >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (t < n && sub == 0) s[t] = dot * scale;
  }
  __syncthreads();

  float mx = -3.0e38f;
  for (int t = tid; t < n; t += kThreads) mx = fmaxf(mx, s[t]);
  mx = block_reduce(mx, red, true);
  float sum = 0.f;
  for (int t = tid; t < n; t += kThreads) {
    const float p = expf(s[t] - mx);
    s[t] = p;
    sum += p;
  }
  sum = block_reduce(sum, red, false);   // its barrier publishes s[]

  const int g = tid / lanes_per_key;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  for (int t = g; t < n; t += groups) {
    float vf[8];
    unpack8(*reinterpret_cast<const uint4*>(vb + (size_t)t * DH + sub * 8),
            vf);
    const float p = s[t];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = fmaf(p, vf[i], acc[i]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) partial[g * DH + sub * 8 + i] = acc[i];
  __syncthreads();
  if (tid < DH) {
    float o = 0.f;
    for (int j = 0; j < groups; ++j) o += partial[j * DH + tid];
    out[(size_t)bh * DH + tid] = __float2bfloat16(o / sum);
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out,
           const void* len_ptr, int len_offset, int bh, int t_max,
           cudaStream_t stream) {
  constexpr int groups = kThreads / (DH / 8);
  const size_t bytes = (size_t)(t_max + groups * DH + kWarps) * sizeof(float);
  if (bytes > 48 * 1024) return (int)cudaErrorInvalidValue;
  decode_kernel<DH><<<bh, kThreads, bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out,
      (const int*)len_ptr, len_offset, t_max, 1.0f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

}  // namespace

// q [bh, dh], k/v [bh, t_max, dh], out [bh, dh], bf16 contiguous; len_ptr
// is one int32 on the device: n = *len_ptr + len_offset valid positions
// (n outside 1..t_max means all t_max).  dh is 32 or 64.
extern "C" int mwx_decode_attention(const void* q, const void* k,
                                    const void* v, void* out,
                                    const void* len_ptr, int len_offset,
                                    int bh, int t_max, int head_dim,
                                    void* stream) {
  if (bh <= 0) return 0;
  if (t_max <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (head_dim) {
    case 64: return launch<64>(q, k, v, out, len_ptr, len_offset, bh, t_max, s);
    case 32: return launch<32>(q, k, v, out, len_ptr, len_offset, bh, t_max, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
