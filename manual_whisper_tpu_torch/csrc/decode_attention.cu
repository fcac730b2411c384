// K3 + K4 + K5: q_len = 1 decode-step attention for Hopper (sm_90a).
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
//
// K5: the same attention over int8 cross K/V with per-position scales.
// Replaces `_cross_int8_kernel` / `decode_cross_attention_int8` of the
// same JAX file:
//   out[bh] = sum_t softmax_t(q . k_q[t] / sqrt(dh) * k_s[t]) v_s[t] v_q[t]
// with k_q/v_q int8 [B*H, T, dh] and k_s/v_s [B*H, T] float32 or bf16
// (`ckv_scale_bf16`).  The scales commute out of both dot products, so
// the codes are widened to float32 in registers and each scale multiplies
// once per position.  Half of K4's bytes (one byte per value, plus 2*T
// scales), so it too is bound by device memory; same design as K4, with
// dh/16 lanes sharing one key's 16-byte load, and the same SM under-fill
// at small batch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8.cuh"

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

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(bf16 x) { return __bfloat162float(x); }

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

template <int DH, typename S>
__global__ void __launch_bounds__(kThreads)
decode_int8_kernel(const bf16* __restrict__ q, const int8_t* __restrict__ kq,
                   const S* __restrict__ ks, const int8_t* __restrict__ vq,
                   const S* __restrict__ vs, bf16* __restrict__ out,
                   const int* __restrict__ len_ptr, int t_max, float scale) {
  constexpr int lanes_per_key = DH / 16;           // 16-byte chunks per row
  constexpr int keys_per_warp = 32 / lanes_per_key;
  constexpr int groups = kThreads / lanes_per_key; // for the P V sum
  extern __shared__ float smem[];
  float* s = smem;                                 // [t_max] scores
  float* partial = s + t_max;                      // [groups, DH]
  float* red = partial + groups * DH;              // [kWarps]

  int n = *len_ptr;
  if (n <= 0 || n > t_max) n = t_max;
  const int bh = blockIdx.x;
  const int8_t* kb = kq + (size_t)bh * t_max * DH;
  const int8_t* vb = vq + (size_t)bh * t_max * DH;
  const S* ksb = ks + (size_t)bh * t_max;
  const S* vsb = vs + (size_t)bh * t_max;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int sub = lane % lanes_per_key;
  const int slot = lane / lanes_per_key;

  float qf[16];
  const bf16* qb = q + (size_t)bh * DH + sub * 16;
  unpack8(*reinterpret_cast<const uint4*>(qb), qf);
  unpack8(*reinterpret_cast<const uint4*>(qb + 8), qf + 8);

  for (int t0 = warp * keys_per_warp; t0 < n;
       t0 += kWarps * keys_per_warp) {
    const int t = t0 + slot;
    float dot = 0.f;
    if (t < n) {
      float kf[16];
      unpack16_i8(*reinterpret_cast<const uint4*>(kb + (size_t)t * DH
                                                  + sub * 16), kf);
#pragma unroll
      for (int i = 0; i < 16; ++i) dot = fmaf(qf[i], kf[i], dot);
    }
#pragma unroll
    for (int o = lanes_per_key / 2; o > 0; o >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (t < n && sub == 0) s[t] = dot * scale * to_float(ksb[t]);
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
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int t = g; t < n; t += groups) {
    float vf[16];
    unpack16_i8(*reinterpret_cast<const uint4*>(vb + (size_t)t * DH
                                                + sub * 16), vf);
    const float p = s[t] * to_float(vsb[t]);
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = fmaf(p, vf[i], acc[i]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) partial[g * DH + sub * 16 + i] = acc[i];
  __syncthreads();
  if (tid < DH) {
    float o = 0.f;
    for (int j = 0; j < groups; ++j) o += partial[j * DH + tid];
    out[(size_t)bh * DH + tid] = __float2bfloat16(o / sum);
  }
}

template <int DH, typename S>
int launch_int8(const void* q, const void* kq, const void* ks, const void* vq,
                const void* vs, void* out, const void* len_ptr, int bh,
                int t_max, cudaStream_t stream) {
  constexpr int groups = kThreads / (DH / 16);
  const size_t bytes = (size_t)(t_max + groups * DH + kWarps) * sizeof(float);
  if (bytes > 48 * 1024) return (int)cudaErrorInvalidValue;
  decode_int8_kernel<DH, S><<<bh, kThreads, bytes, stream>>>(
      (const bf16*)q, (const int8_t*)kq, (const S*)ks, (const int8_t*)vq,
      (const S*)vs, (bf16*)out, (const int*)len_ptr, t_max,
      1.0f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

}  // namespace

// q [bh, dh] bf16, k_q/v_q [bh, t_max, dh] int8, k_s/v_s [bh, t_max]
// float32 (scale_bf16 = 0) or bf16 (scale_bf16 = 1), out [bh, dh] bf16,
// all contiguous; len_ptr is one int32 on the device: positions < *len_ptr
// are valid (outside 1..t_max means all t_max).  dh is 32 or 64.
extern "C" int mwx_decode_attention_int8(const void* q, const void* kq,
                                         const void* ks, const void* vq,
                                         const void* vs, void* out,
                                         const void* len_ptr, int bh,
                                         int t_max, int head_dim,
                                         int scale_bf16, void* stream) {
  if (bh <= 0) return 0;
  if (t_max <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (head_dim == 64 && !scale_bf16)
    return launch_int8<64, float>(q, kq, ks, vq, vs, out, len_ptr, bh, t_max,
                                  st);
  if (head_dim == 64)
    return launch_int8<64, bf16>(q, kq, ks, vq, vs, out, len_ptr, bh, t_max,
                                 st);
  if (head_dim == 32 && !scale_bf16)
    return launch_int8<32, float>(q, kq, ks, vq, vs, out, len_ptr, bh, t_max,
                                  st);
  if (head_dim == 32)
    return launch_int8<32, bf16>(q, kq, ks, vq, vs, out, len_ptr, bh, t_max,
                                 st);
  return (int)cudaErrorInvalidValue;
}

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
