// K3 + K4 + K5: q_len = 1 decode-step attention for Hopper (sm_90a).
//
// Replaces, in manual_whisper_tpu/ops/decode_attention.py,
//   K3 `_self_kernel` / `decode_self_attention`   (self cache, slots <= pos)
//   K4 `_cross_bf16_kernel` / `decode_cross_attention` (cross K/V, < kv_len)
// which share `_attend_all_heads`.  Both compute
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
//
// K3 (simple, not yet fast): one block of 128 threads per (batch, head);
// dh/8 lanes share one key with 16-byte loads and reduce its dot product
// with shuffles; scores stay in shared memory; the weighted sum of V runs
// over 16 groups of lanes and is reduced through shared memory.  One block
// per (batch, head) leaves SMs idle at small batch.
//
// K4 has its own kernel.  Over 1500 cross positions one block per (batch,
// head) is 80 blocks on 132 SMs, each walking its keys three times with
// one 16-byte load in flight per thread: the serial walk, not the bytes,
// set its time.  So the key axis is split over the 8 blocks of a
// thread-block cluster (640 blocks at batch 4).  A block makes one pass
// over its slice: dh/8 lanes share a key, K and V of eight keys per lane
// group are loaded before any is used, and an online softmax (running
// max, sum and weighted V in registers, base-2 exponentials with log2(e)
// folded into q) needs no score buffer.  The lane groups of a block meet
// in shared memory, the 8 blocks' (max, sum, o[dh]) in distributed shared
// memory, and each block normalises and writes dh/8 of the outputs: one
// launch, no workspace, no atomics, kv_len read on the device by every
// block.  K3 and K5 can take the same split.
//
// K5: the same attention over int8 cross K/V with per-position scales.
// Replaces `_cross_int8_kernel` / `decode_cross_attention_int8` of the
// same JAX file:
//   out[bh] = sum_t softmax_t(q . k_q[t] / sqrt(dh) * k_s[t]) v_s[t] v_q[t]
// with k_q/v_q int8 [B*H, T, dh] and k_s/v_s [B*H, T] float32 or bf16
// (`ckv_scale_bf16`).  The scales commute out of both dot products, so
// each multiplies once per position; the softmax's sum takes the
// exponentials without v_s.  Half of K4's bytes (one byte per value, plus
// 2*T scales), so it too is bound by device memory.  A block per (batch,
// head) walking its keys three times (scores, softmax, V) left it at
// K4's old speed although it reads half the bytes, so K5 takes K4's
// split: the 8 blocks of a cluster each make one pass over their slice of
// the keys (derived from kv_len on the device; the last ranks' may be
// empty), dh/16 lanes share one key's 16-byte code loads, the codes and
// both scales of eight keys per lane group are loaded before any is used,
// the codes are widened exactly on the ALU (a byte permute under 2^23 and
// one subtraction, not the slower int-to-float converter), and the lane
// groups and then the 8 ranks combine (max, sum, o[dh]) in shared and
// distributed shared memory.  One launch, no workspace, no atomics.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;
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

// ---- K4: cross attention, key axis split over a cluster -------------------

constexpr int kCrossSplit = 8;     // blocks per (batch, head): one cluster
constexpr int kCrossKeys = 8;      // keys in flight per lane group

template <int DH>
__global__ void __cluster_dims__(kCrossSplit, 1, 1) __launch_bounds__(kThreads)
cross_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ out,
             const int* __restrict__ len_ptr, int t_max, float scale_log2e) {
  constexpr int lanes_per_key = DH / 8;            // 16-byte chunks per row
  constexpr int groups = kThreads / lanes_per_key; // keys per pass and block
  constexpr int dims_per_rank = DH / kCrossSplit;
  __shared__ float part_m[groups];
  __shared__ float part_l[groups];
  __shared__ float part_o[groups][DH];
  __shared__ float block_o[DH];                    // read by the other ranks
  __shared__ float block_ml[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.x / kCrossSplit;

  int n = *len_ptr;
  if (n <= 0 || n > t_max) n = t_max;
  const int per = (n + kCrossSplit - 1) / kCrossSplit;
  const int k0 = min(n, rank * per);               // this block's slice; the
  const int k1 = min(n, k0 + per);                 // last ranks' may be empty
  const bf16* kb = k + (size_t)bh * t_max * DH;
  const bf16* vb = v + (size_t)bh * t_max * DH;
  const int tid = threadIdx.x;
  const int sub = tid % lanes_per_key;
  const int g = tid / lanes_per_key;

  float qf[8];
  unpack8(*reinterpret_cast<const uint4*>(q + (size_t)bh * DH + sub * 8), qf);
#pragma unroll
  for (int i = 0; i < 8; ++i) qf[i] *= scale_log2e;

  // running max, sum and weighted V of this lane group's keys (the lanes of
  // a group hold the same m and l and 8 dims of o each); scores in base 2
  float m = -3.0e38f, l = 0.f, o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = 0.f;

  // every thread runs the same trip count (the shuffles need whole warps);
  // keys past the slice are masked
  for (int base = k0; base < k1; base += groups * kCrossKeys) {
    uint4 kr[kCrossKeys], vr[kCrossKeys];
#pragma unroll
    for (int u = 0; u < kCrossKeys; ++u) {
      const int t = base + u * groups + g;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (t < k1) {
        kr[u] = __ldg(reinterpret_cast<const uint4*>(kb + (size_t)t * DH
                                                     + sub * 8));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(vb + (size_t)t * DH
                                                     + sub * 8));
      }
    }
    float sc[kCrossKeys];
    float mx = m;
#pragma unroll
    for (int u = 0; u < kCrossKeys; ++u) {
      float kf[8];
      unpack8(kr[u], kf);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) dot = fmaf(qf[i], kf[i], dot);
#pragma unroll
      for (int w = lanes_per_key / 2; w > 0; w >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, w);
      sc[u] = base + u * groups + g < k1 ? dot : -3.0e38f;
      mx = fmaxf(mx, sc[u]);
    }
    const float corr = exp2f(m - mx);
    l *= corr;
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] *= corr;
#pragma unroll
    for (int u = 0; u < kCrossKeys; ++u) {
      const float p =
          base + u * groups + g < k1 ? exp2f(sc[u] - mx) : 0.f;
      float vf[8];
      unpack8(vr[u], vf);
      l += p;
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = fmaf(p, vf[i], o[i]);
    }
    m = mx;
  }

  // the block's lane groups meet in shared memory
  if (sub == 0) {
    part_m[g] = m;
    part_l[g] = l;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) part_o[g][sub * 8 + i] = o[i];
  __syncthreads();
  if (tid < DH) {
    float bm = -3.0e38f;
    for (int j = 0; j < groups; ++j) bm = fmaxf(bm, part_m[j]);
    float bl = 0.f, bo = 0.f;
    for (int j = 0; j < groups; ++j) {
      const float w = exp2f(part_m[j] - bm);       // 0 for a group without keys
      bl += part_l[j] * w;
      bo += part_o[j][tid] * w;
    }
    block_o[tid] = bo;
    if (tid == 0) {
      block_ml[0] = bm;
      block_ml[1] = bl;
    }
  }
  cluster.sync();  // every block's partial result is written and visible

  // rank r normalises and writes dims [r * dh / 8, (r + 1) * dh / 8)
  if (tid < dims_per_rank) {
    const int d = rank * dims_per_rank + tid;
    float cm = -3.0e38f;
#pragma unroll
    for (int b = 0; b < kCrossSplit; ++b)
      cm = fmaxf(cm, cluster.map_shared_rank(block_ml, b)[0]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int b = 0; b < kCrossSplit; ++b) {
      const float* ml = cluster.map_shared_rank(block_ml, b);
      const float w = exp2f(ml[0] - cm);           // 0 for an empty slice
      den += ml[1] * w;
      num += cluster.map_shared_rank(block_o, b)[d] * w;
    }
    out[(size_t)bh * DH + d] = __float2bfloat16(num / den);
  }
  cluster.sync();  // keep this block's shared memory until all have read it
}

template <int DH>
int launch_cross(const void* q, const void* k, const void* v, void* out,
                 const void* len_ptr, int bh, int t_max, cudaStream_t stream) {
  cross_kernel<DH><<<bh * kCrossSplit, kThreads, 0, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out,
      (const int*)len_ptr, t_max,
      1.4426950408889634f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

// ---- K5: int8 cross attention, the same split ----------------------------

constexpr int kInt8Keys = 8;       // keys in flight per lane group

// 16 int8 codes of one 16-byte load to float32, exact and without the
// converter unit: a code c as the byte c + 128 under the float 2^23
// (0x4B000000) reads as 2^23 + 128 + c, and one subtraction leaves c.
__device__ inline void widen16(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u,
                         u.z ^ 0x80808080u, u.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[4 * i + b] =
          __int_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540u | b)) -
          8388736.f;
}

template <int DH, typename S>
__global__ void __cluster_dims__(kCrossSplit, 1, 1) __launch_bounds__(kThreads)
cross_int8_kernel(const bf16* __restrict__ q, const int8_t* __restrict__ kq,
                  const S* __restrict__ ks, const int8_t* __restrict__ vq,
                  const S* __restrict__ vs, bf16* __restrict__ out,
                  const int* __restrict__ len_ptr, int t_max,
                  float scale_log2e) {
  constexpr int lanes_per_key = DH / 16;           // 16-byte chunks per row
  constexpr int groups = kThreads / lanes_per_key; // keys per pass and block
  constexpr int dims_per_rank = DH / kCrossSplit;
  __shared__ float part_m[groups];
  __shared__ float part_l[groups];
  __shared__ float part_o[groups][DH];
  __shared__ float block_o[DH];                    // read by the other ranks
  __shared__ float block_ml[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.x / kCrossSplit;

  int n = *len_ptr;
  if (n <= 0 || n > t_max) n = t_max;
  const int per = (n + kCrossSplit - 1) / kCrossSplit;
  const int k0 = min(n, rank * per);               // this block's slice; the
  const int k1 = min(n, k0 + per);                 // last ranks' may be empty
  const int8_t* kb = kq + (size_t)bh * t_max * DH;
  const int8_t* vb = vq + (size_t)bh * t_max * DH;
  const S* ksb = ks + (size_t)bh * t_max;
  const S* vsb = vs + (size_t)bh * t_max;
  const int tid = threadIdx.x;
  const int sub = tid % lanes_per_key;
  const int g = tid / lanes_per_key;

  float qf[16];
  const bf16* qb = q + (size_t)bh * DH + sub * 16;
  unpack8(*reinterpret_cast<const uint4*>(qb), qf);
  unpack8(*reinterpret_cast<const uint4*>(qb + 8), qf + 8);
#pragma unroll
  for (int i = 0; i < 16; ++i) qf[i] *= scale_log2e;

  // running max, sum and weighted V of this lane group's keys (the lanes of
  // a group hold the same m and l and 16 dims of o each); scores in base 2
  float m = -3.0e38f, l = 0.f, o[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = 0.f;

  // every thread runs the same trip count (the shuffles need whole warps);
  // keys past the slice are masked
  for (int base = k0; base < k1; base += groups * kInt8Keys) {
    uint4 kr[kInt8Keys], vr[kInt8Keys];
    float k_s[kInt8Keys], v_s[kInt8Keys];
#pragma unroll
    for (int u = 0; u < kInt8Keys; ++u) {
      const int t = base + u * groups + g;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      k_s[u] = v_s[u] = 0.f;
      if (t < k1) {
        kr[u] = __ldg(reinterpret_cast<const uint4*>(kb + (size_t)t * DH
                                                     + sub * 16));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(vb + (size_t)t * DH
                                                     + sub * 16));
        k_s[u] = to_float(ksb[t]);
        v_s[u] = to_float(vsb[t]);
      }
    }
    float sc[kInt8Keys];
    float mx = m;
#pragma unroll
    for (int u = 0; u < kInt8Keys; ++u) {
      float kf[16];
      widen16(kr[u], kf);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) dot = fmaf(qf[i], kf[i], dot);
#pragma unroll
      for (int w = lanes_per_key / 2; w > 0; w >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, w);
      sc[u] = base + u * groups + g < k1 ? dot * k_s[u] : -3.0e38f;
      mx = fmaxf(mx, sc[u]);
    }
    const float corr = exp2f(m - mx);
    l *= corr;
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] *= corr;
#pragma unroll
    for (int u = 0; u < kInt8Keys; ++u) {
      // the softmax's sum takes p; the output takes p * v_s (K5's plain
      // version rounds p * v_s to q's dtype before it meets v_q)
      const float p =
          base + u * groups + g < k1 ? exp2f(sc[u] - mx) : 0.f;
      const float pv = p * v_s[u];
      float vf[16];
      widen16(vr[u], vf);
      l += p;
#pragma unroll
      for (int i = 0; i < 16; ++i) o[i] = fmaf(pv, vf[i], o[i]);
    }
    m = mx;
  }

  // the block's lane groups meet in shared memory
  if (sub == 0) {
    part_m[g] = m;
    part_l[g] = l;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) part_o[g][sub * 16 + i] = o[i];
  __syncthreads();
  if (tid < DH) {
    float bm = -3.0e38f;
    for (int j = 0; j < groups; ++j) bm = fmaxf(bm, part_m[j]);
    float bl = 0.f, bo = 0.f;
    for (int j = 0; j < groups; ++j) {
      const float w = exp2f(part_m[j] - bm);       // 0 for a group without keys
      bl += part_l[j] * w;
      bo += part_o[j][tid] * w;
    }
    block_o[tid] = bo;
    if (tid == 0) {
      block_ml[0] = bm;
      block_ml[1] = bl;
    }
  }
  cluster.sync();  // every block's partial result is written and visible

  // rank r normalises and writes dims [r * dh / 8, (r + 1) * dh / 8)
  if (tid < dims_per_rank) {
    const int d = rank * dims_per_rank + tid;
    float cm = -3.0e38f;
#pragma unroll
    for (int b = 0; b < kCrossSplit; ++b)
      cm = fmaxf(cm, cluster.map_shared_rank(block_ml, b)[0]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int b = 0; b < kCrossSplit; ++b) {
      const float* ml = cluster.map_shared_rank(block_ml, b);
      const float w = exp2f(ml[0] - cm);           // 0 for an empty slice
      den += ml[1] * w;
      num += cluster.map_shared_rank(block_o, b)[d] * w;
    }
    out[(size_t)bh * DH + d] = __float2bfloat16(num / den);
  }
  cluster.sync();  // keep this block's shared memory until all have read it
}

template <int DH, typename S>
int launch_int8(const void* q, const void* kq, const void* ks, const void* vq,
                const void* vs, void* out, const void* len_ptr, int bh,
                int t_max, cudaStream_t stream) {
  cross_int8_kernel<DH, S><<<bh * kCrossSplit, kThreads, 0, stream>>>(
      (const bf16*)q, (const int8_t*)kq, (const S*)ks, (const int8_t*)vq,
      (const S*)vs, (bf16*)out, (const int*)len_ptr, t_max,
      1.4426950408889634f / sqrtf((float)DH));
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

// K4.  q [bh, dh], k/v [bh, t_max, dh], out [bh, dh], bf16 contiguous;
// len_ptr is one int32 on the device: positions < *len_ptr are valid
// (outside 1..t_max means all t_max).  dh is 32 or 64.
extern "C" int mwx_decode_cross_attention(const void* q, const void* k,
                                          const void* v, void* out,
                                          const void* len_ptr, int bh,
                                          int t_max, int head_dim,
                                          void* stream) {
  if (bh <= 0) return 0;
  if (t_max <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (head_dim) {
    case 64: return launch_cross<64>(q, k, v, out, len_ptr, bh, t_max, s);
    case 32: return launch_cross<32>(q, k, v, out, len_ptr, bh, t_max, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
