// add_layer_norm: the decode step's bias + residual add + LayerNorm, in one
// launch, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves this sequence to XLA,
// which fuses it.  In the port's replayed decode step it was seven
// launches a residual point (the bias add, the residual add, three casts
// up to float32, ATen's LayerNorm and the cast back; ln1's LayerNorm ran
// twice), each moving a few tens of KB, so the step spent more device
// time in those launches and the gaps between them than in the work: 26
// launches a layer and 5 at the end, now 3 a layer and 1.  Per row r of
// [R, d]:
//
//   h_new[r] = h[r] + (delta[r] + bias)        both sums rounded to T
//   y[r]     = LayerNorm(h_new[r]; gamma, beta, eps 1e-5)
//
// with the rounding points of PyTorch's unfused sequence, so h_new is
// bit-equal to it: delta + bias is rounded to the element type, then added
// to h and rounded again (two bf16 adds); the statistics are taken in
// float32 over the rounded h_new, (x - mean) * rstd * gamma + beta in
// float32 with rstd = rsqrtf(var + 1e-5), rounded to T once.  gamma and
// beta are read in their stored dtype and widened in registers.  Without a
// delta (the first block's ln1) only the LayerNorm runs and h_new is h;
// without a bias, h_new = h + delta.  T is bf16 (`mwx_add_layer_norm`) or
// float32 (`mwx_add_layer_norm_f32`, the same arithmetic).
//
// Bound on the H100: at a decode step's R <= 16 rows of d = 1280 a launch
// moves about 170 KB (0.05 us at 3.35 TB/s), so its time is latency: the
// launch, one round trip to device memory and the block's reductions.  So
// one block a row, one 16-byte load of each input a thread (d/8 threads in
// bf16, d/4 in float32, rounded up to whole warps), the row held in
// registers, and a two-pass mean and variance, each reduced by warp
// shuffles and one exchange through shared memory: two barriers a launch
// and nothing written but the two outputs.  Any d that is a multiple of 8
// up to 8192 (4096 in float32), any R.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kEps = 1e-5f;
constexpr int kMaxThreads = 1024;

// elements of T in one 16-byte load
template <typename T> struct Vec;
template <> struct Vec<bf16> { static constexpr int N = 8; };
template <> struct Vec<float> { static constexpr int N = 4; };

__device__ __forceinline__ void load(const bf16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pair[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load(const float* p, float (&v)[4]) {
  const float4 raw = *reinterpret_cast<const float4*>(p);
  v[0] = raw.x;
  v[1] = raw.y;
  v[2] = raw.z;
  v[3] = raw.w;
}

__device__ __forceinline__ void store(bf16* p, const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* pair = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    pair[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// x rounded to the element type, as a PyTorch op returning T rounds it
__device__ __forceinline__ float rounded(float x, bf16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float rounded(float x, float) { return x; }

// The block's sum of v, the same in every thread: each warp's by shuffles,
// then every thread adds the warps' sums from `buf` in one order.
__device__ __forceinline__ float block_sum(float v, float* buf) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  const int warps = blockDim.x >> 5;
  for (int w = 0; w < warps; ++w) total += buf[w];
  return total;
}

template <typename T, bool DELTA, bool BIAS>
__global__ void add_layer_norm_kernel(const T* __restrict__ h,
                                      const T* __restrict__ delta,
                                      const T* __restrict__ bias,
                                      const T* __restrict__ gamma,
                                      const T* __restrict__ beta,
                                      T* __restrict__ h_out,
                                      T* __restrict__ y, int d) {
  constexpr int V = Vec<T>::N;
  // one buffer a reduction: a thread may still read the first while
  // another writes the second
  __shared__ float sums[2][kMaxThreads / 32];
  const int col = threadIdx.x * V;
  const bool active = col < d;
  const size_t off = (size_t)blockIdx.x * d + col;
  float x[V];
  if (active) {
    load(h + off, x);
    if (DELTA) {
      float dv[V];
      load(delta + off, dv);
      if (BIAS) {
        float bv[V];
        load(bias + col, bv);
#pragma unroll
        for (int i = 0; i < V; ++i) dv[i] = rounded(dv[i] + bv[i], T());
      }
#pragma unroll
      for (int i = 0; i < V; ++i) x[i] = rounded(x[i] + dv[i], T());
      store(h_out + off, x);
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) x[i] = 0.f;
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) s += x[i];
  const float mean = block_sum(s, sums[0]) / d;
  float q = 0.f;
  if (active) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float c = x[i] - mean;
      q += c * c;
    }
  }
  const float rstd = rsqrtf(block_sum(q, sums[1]) / d + kEps);
  if (active) {
    float g[V], b[V];
    load(gamma + col, g);
    load(beta + col, b);
#pragma unroll
    for (int i = 0; i < V; ++i) x[i] = (x[i] - mean) * rstd * g[i] + b[i];
    store(y + off, x);
  }
}

template <typename T>
int launch(const void* h, const void* delta, const void* bias,
           const void* gamma, const void* beta, void* h_out, void* y,
           int rows, int d, void* stream) {
  constexpr int V = Vec<T>::N;
  if (rows <= 0) return 0;
  if (d <= 0 || d % V || d / V > kMaxThreads || (bias && !delta) ||
      (delta && !h_out))
    return (int)cudaErrorInvalidValue;
  const int threads = (d / V + 31) / 32 * 32;
  cudaStream_t st = (cudaStream_t)stream;
  const T* hp = (const T*)h;
  const T* dp = (const T*)delta;
  const T* bp = (const T*)bias;
  const T* gp = (const T*)gamma;
  const T* ep = (const T*)beta;
  T* op = (T*)h_out;
  T* yp = (T*)y;
  if (delta && bias)
    add_layer_norm_kernel<T, true, true>
        <<<rows, threads, 0, st>>>(hp, dp, bp, gp, ep, op, yp, d);
  else if (delta)
    add_layer_norm_kernel<T, true, false>
        <<<rows, threads, 0, st>>>(hp, dp, bp, gp, ep, op, yp, d);
  else
    add_layer_norm_kernel<T, false, false>
        <<<rows, threads, 0, st>>>(hp, dp, bp, gp, ep, op, yp, d);
  return (int)cudaGetLastError();
}

}  // namespace

// h, delta, h_out, y [rows, d] and bias, gamma, beta [d], all bf16 and
// contiguous, 16-byte aligned.  delta may be null (no add: only y is
// written), bias may be null (h_out = h + delta).  d a multiple of 8, at
// most 8192.
extern "C" int mwx_add_layer_norm(const void* h, const void* delta,
                                  const void* bias, const void* gamma,
                                  const void* beta, void* h_out, void* y,
                                  int rows, int d, void* stream) {
  return launch<bf16>(h, delta, bias, gamma, beta, h_out, y, rows, d,
                      stream);
}

// The same in float32: every tensor float32, d a multiple of 4, at most
// 4096.
extern "C" int mwx_add_layer_norm_f32(const void* h, const void* delta,
                                      const void* bias, const void* gamma,
                                      const void* beta, void* h_out, void* y,
                                      int rows, int d, void* stream) {
  return launch<float>(h, delta, bias, gamma, beta, h_out, y, rows, d,
                       stream);
}
