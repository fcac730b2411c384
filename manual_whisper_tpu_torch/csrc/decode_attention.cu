// K3 + K4 + K5: q_len = 1 decode-step attention for Hopper (sm_90a).
//
// Replaces, in manual_whisper_tpu/ops/decode_attention.py,
//   K3 `_self_kernel` / `decode_self_attention`   (self cache, slots <= pos)
//   K4 `_cross_bf16_kernel` / `decode_cross_attention` (cross K/V, < kv_len)
// which share `_attend_all_heads`.  Both compute
//   out[bh] = softmax(q[bh] . k[bh, t] / sqrt(dh), t < n) @ v[bh, t]
// with q [B*H, dh], k/v [B*H, T, dh] and the output all bf16 or all
// float32 (the port's cache layout: the TPU's transposed [.., dh, T] layout
// existed only for its 128-lane tiles), float32 scores, softmax and sums
// either way.  The JAX kernels take any dtype and write the output's; the
// port builds `split_kernel` for the two it runs (`compute_type` bfloat16
// and float32), with their own entry points.
//
// n, the number of valid positions, is read on the device from an int32
// (`*len_ptr + len_offset`: pos + 1 for the self cache, kv_len for cross
// K/V), so a decode step never waits on the host for it and the loop can
// later be captured in a CUDA graph.  Only positions < n are read.
//
// Bound on the H100: about one operation per byte (2*n*dh bf16 values read
// for 4*n*dh operations; half that in float32), so it is bound by device
// memory bandwidth.
//
// K3 and K4 share one kernel, `split_kernel`.  One block per (batch, head)
// walking its keys three times (scores into shared memory, softmax, V),
// with one 16-byte load in flight per thread, left both far from their
// bound: the serial walk, not the bytes, set their time.  So the key axis
// is split over the blocks of a thread-block cluster.  A block makes one
// pass over its slice (derived from n on the device; the last ranks' may
// be empty): dh/8 lanes share a key (dh/4 in float32: a lane always loads
// 16 bytes of a row), K and V of KEYS keys per lane group
// are loaded before any is used, and an online softmax (running max, sum
// and weighted V in registers, base-2 exponentials with log2(e) folded
// into q) needs no score buffer.  The lane groups of a block meet in
// shared memory, the blocks' (max, sum, o[dh]) in distributed shared
// memory, and each block normalises and writes dh/SPLIT of the outputs:
// one launch, no workspace, no atomics.  The launch shape (`SplitCfg`)
// follows the
// shapes the host knows, never n, so a captured CUDA graph replays one
// launch at every step:
//   * K4, over 1500 cross positions: 8 blocks of 128 threads per (batch,
//     head), 8 keys per lane group, ranks reading each other's partial
//     results after a cluster barrier.
//   * K3, over a self cache of at most 448 slots, where a decode step's
//     call costs a few microseconds and latency, not bandwidth, decides:
//     each rank stores its partial result into the shared memory of the
//     rank that finishes those dims with asynchronous stores counted at
//     that rank's mbarrier, so each rank waits only for the bytes it
//     expects: no barrier across the cluster and no remote read stand
//     between the last key and the output.  The shape is the element
//     type's (`SelfShape`), chosen so that a block covers its slice of
//     the main paths' 417 slots in one pass: at most one (batch, head)
//     per SM gets 4 blocks of 256 threads and 4 keys per lane group in
//     bf16 (32 lane groups x 4 = 128 keys a pass); in float32 a key takes
//     twice the lanes, so it gets 8 blocks of the same (64 keys a pass).
//     With more (batch, head) pairs than SMs, where the bytes decide, 2
//     blocks of 256 threads per pair, with 8 keys a lane group in float32.
//
// K5: the same attention over int8 cross K/V with per-position scales.
// Replaces `_cross_int8_kernel` / `decode_cross_attention_int8` of the
// same JAX file:
//   out[bh] = sum_t softmax_t(q . k_q[t] / sqrt(dh) * k_s[t]) v_s[t] v_q[t]
// with k_q/v_q int8 [B*H, T, dh] and k_s/v_s [B*H, T] float32 or bf16
// (`ckv_scale_bf16`).  The scales commute out of both dot products, so
// each multiplies once per position; the softmax's sum takes the
// exponentials without v_s.
//
// Bound: the bytes.  Half of K4's (one byte a value, plus 2*T scales) for
// the same 4*n*dh operations, so device memory bounds it too; but each
// code is widened on the ALU first (a byte permute under 2^23 and one
// subtraction, exact, not the slower int-to-float converter), three times
// K4's ALU work per byte.  Loaded into registers and then used, as K4
// does, that work left no load in flight while a block summed, and K5 read
// at about 42 % of the card's bandwidth.  So each block streams its keys
// through a ring of shared memory: a producer warp, one of whose threads
// asks for a stage with four 1-D bulk copies (K codes, V codes, k_s and
// v_s, each contiguous over the positions of a (batch, head)), counted at
// the stage's full mbarrier, and refills a slot as soon as every consumer
// warp has arrived at its empty mbarrier; while the consumer warps widen
// and sum one stage, the next ones are in flight, and no barrier across
// the block stands between two stages.  Registers hold q (scaled by
// log2(e)/sqrt(dh)), the online softmax's running max and sum and o, and
// nothing of the loads.  dh/16 lanes share a key's code rows.
//
// The key axis is split over the blocks of a cluster (derived from kv_len
// on the device; the last ranks' slices may be empty).  Slices and stages
// start on 16-key boundaries.  The codes of any run of keys fill whole
// 16-byte units (dh is 32 or 64); the scales need not, so a stage's scale
// copy takes the 16-byte lines that hold its keys, clipped to the lines
// inside the row, and reads the keys of a line that would reach outside
// the row (only where a row does not start or end on a line) with plain
// loads: no copy reads outside its (batch, head)'s row.  Positions >= n
// are never copied, and masked where a lane group reads past its stage.
// The lane groups meet in shared memory (the idle ring), and the ranks
// push their (max, sum, o) to the rank that writes those dims with
// asynchronous stores counted at its mbarrier (K3's combine), so no
// cluster barrier stands between the last key and the output.  One
// launch, no workspace, no atomics.
//
// The launch shape (`Int8Shape`, `int8_split`) follows batch x heads,
// which the host knows, never n, so a captured CUDA graph replays one
// launch at every step.  It is one algorithm whose split adapts: as many
// blocks a pair, up to a cluster of 8, as keep the grid within about 2.5
// blocks an SM.  The 2-row loop's 40 pairs, where a launch's 8 MB leave
// latency to decide, get 8 blocks of 192-key slices; the 16-row loop's
// 320 pairs, where the bytes decide, one block each, which streams all
// 1500 keys and needs no combine across blocks.  Chosen by timing
// (`kernel_variants.py decode_cross_attention_int8`).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

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

// The element types of K3/K4: values in one 16-byte load, widened to float32
// (`load`), and a float32 result rounded to the element (`store`).
template <typename T> struct Elem;
template <> struct Elem<bf16> {
  static constexpr int kVec = 8;
  __device__ static void load(const uint4& u, float* f) { unpack8(u, f); }
  __device__ static bf16 store(float x) { return __float2bfloat16(x); }
};
template <> struct Elem<float> {
  static constexpr int kVec = 4;
  __device__ static void load(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static float store(float x) { return x; }
};

// ---- K3 and K4: the key axis split over a cluster ------------------------

// A launch shape of the split kernel: blocks per (batch, head) (the
// cluster), keys in flight per lane group, threads per block, and whether
// the ranks push their partial results to the rank that finishes them
// (K3) or read each other's after a cluster barrier (K4).
template <int SPLIT_, int KEYS_, int THREADS_, bool PUSH_>
struct SplitCfg {
  static constexpr int SPLIT = SPLIT_;
  static constexpr int KEYS = KEYS_;
  static constexpr int THREADS = THREADS_;
  static constexpr bool PUSH = PUSH_;
};

// K4 over the 1500 cross positions.
using CrossCfg = SplitCfg<8, 8, 128, false>;
// K3 over the self cache (at most 448 slots; 417 on the main paths, of
// which 194..416 are valid), by element type: `Narrow` for up to one
// (batch, head) per SM (the main paths' batch 4 is 80), `Wide` for more
// (batch 16 is 320).  A block covers THREADS / (dh / kVec) * KEYS keys a
// pass.  bf16: 4 blocks of 256 threads, 128 keys a pass, so a slice of
// 417 / 4 = 105 keys takes one; wide, 2 blocks.  float32 takes twice the
// lanes a key (16-byte loads of 4 values): at bf16's shape a block would
// cover 64 keys a pass and need two for a slice of 105, so it gets 8
// blocks of 256 threads (slices of 53 keys, one pass); wide, 2 blocks of
// 256 threads and 8 keys a lane group (128 keys a pass, bf16's bytes in
// flight).  Both chosen by timing (kernel_variants.py --dtype float32).
template <typename T> struct SelfShape;
template <> struct SelfShape<bf16> {
  using Narrow = SplitCfg<4, 4, 256, true>;
  using Wide = SplitCfg<2, 4, 256, true>;
};
template <> struct SelfShape<float> {
  using Narrow = SplitCfg<8, 4, 256, true>;
  using Wide = SplitCfg<2, 8, 256, true>;
};

template <int DH, typename C, typename T = bf16>
__global__ void __launch_bounds__(C::THREADS)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             const int* __restrict__ len_ptr, int len_offset, int t_max,
             float scale_log2e) {
  using E = Elem<T>;
  constexpr int kVec = E::kVec;                    // values per 16-byte load
  constexpr int kSplit = C::SPLIT;
  constexpr int kKeys = C::KEYS;
  constexpr int kBlock = C::THREADS;
  constexpr int lanes_per_key = DH / kVec;         // 16-byte chunks per row
  constexpr int groups = kBlock / lanes_per_key;   // keys per pass and block
  constexpr int dims_per_rank = DH / kSplit;
  static_assert(kBlock >= DH && dims_per_rank >= 1, "combine needs DH lanes");
  static_assert(lanes_per_key <= 32 && kBlock % lanes_per_key == 0,
                "a key's lanes lie in one warp");
  __shared__ float part_m[groups];
  __shared__ float part_l[groups];
  __shared__ float part_o[groups][DH];
  __shared__ float block_o[DH];                    // read by the other ranks
  __shared__ float block_ml[2];
  __shared__ float inbox_o[kSplit][dims_per_rank];  // sent by the other ranks
  __shared__ float inbox_ml[kSplit][2];
  __shared__ alignas(8) uint64_t inbox_full;
  if constexpr (C::PUSH) {
    if (threadIdx.x == 0) {
      mbar_init(smem_u32(&inbox_full), 1);
      fence_mbarrier_init();
    }
    cluster_arrive_relaxed();
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.x / kSplit;

  int n = *len_ptr + len_offset;
  if (n <= 0 || n > t_max) n = t_max;
  const int per = (n + kSplit - 1) / kSplit;
  const int k0 = min(n, rank * per);               // this block's slice; the
  const int k1 = min(n, k0 + per);                 // last ranks' may be empty
  const T* kb = k + (size_t)bh * t_max * DH;
  const T* vb = v + (size_t)bh * t_max * DH;
  const int tid = threadIdx.x;
  const int sub = tid % lanes_per_key;
  const int g = tid / lanes_per_key;

  float qf[kVec];
  E::load(*reinterpret_cast<const uint4*>(q + (size_t)bh * DH + sub * kVec),
          qf);
#pragma unroll
  for (int i = 0; i < kVec; ++i) qf[i] *= scale_log2e;

  // running max, sum and weighted V of this lane group's keys (the lanes of
  // a group hold the same m and l and kVec dims of o each); scores in base 2
  float m = -3.0e38f, l = 0.f, o[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) o[i] = 0.f;

  // every thread runs the same trip count (the shuffles need whole warps);
  // keys past the slice are masked
  for (int base = k0; base < k1; base += groups * kKeys) {
    uint4 kr[kKeys], vr[kKeys];
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      const int t = base + u * groups + g;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (t < k1) {
        kr[u] = __ldg(reinterpret_cast<const uint4*>(kb + (size_t)t * DH
                                                     + sub * kVec));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(vb + (size_t)t * DH
                                                     + sub * kVec));
      }
    }
    float sc[kKeys];
    float mx = m;
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      float kf[kVec];
      E::load(kr[u], kf);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) dot = fmaf(qf[i], kf[i], dot);
#pragma unroll
      for (int w = lanes_per_key / 2; w > 0; w >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, w);
      sc[u] = base + u * groups + g < k1 ? dot : -3.0e38f;
      mx = fmaxf(mx, sc[u]);
    }
    const float corr = exp2f(m - mx);
    l *= corr;
#pragma unroll
    for (int i = 0; i < kVec; ++i) o[i] *= corr;
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      const float p =
          base + u * groups + g < k1 ? exp2f(sc[u] - mx) : 0.f;
      float vf[kVec];
      E::load(vr[u], vf);
      l += p;
#pragma unroll
      for (int i = 0; i < kVec; ++i) o[i] = fmaf(p, vf[i], o[i]);
    }
    m = mx;
  }

  // the block's lane groups meet in shared memory
  if (sub == 0) {
    part_m[g] = m;
    part_l[g] = l;
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) part_o[g][sub * kVec + i] = o[i];
  __syncthreads();
  float bm = -3.0e38f, bl = 0.f, bo = 0.f;
  if (tid < DH) {
    for (int j = 0; j < groups; ++j) bm = fmaxf(bm, part_m[j]);
    for (int j = 0; j < groups; ++j) {
      const float w = exp2f(part_m[j] - bm);       // 0 for a group without keys
      bl += part_l[j] * w;
      bo += part_o[j][tid] * w;
    }
  }
  if constexpr (C::PUSH) {
    // each rank stores its (max, sum) into every rank and its dims of o
    // into the rank that writes them (asynchronous stores counted at the
    // receiver's mbarrier); each rank waits for its own bytes only, and no
    // rank reads another's shared memory
    cluster_wait();   // every rank runs and has set up its barrier
    if (tid < DH) {
      const int to = tid / dims_per_rank;
      st_async(cluster_addr(smem_u32(&inbox_o[rank][tid % dims_per_rank]),
                            to),
               bo, cluster_addr(smem_u32(&inbox_full), to));
      if (tid < kSplit) {
        const uint32_t bar = cluster_addr(smem_u32(&inbox_full), tid);
        st_async(cluster_addr(smem_u32(&inbox_ml[rank][0]), tid), bm, bar);
        st_async(cluster_addr(smem_u32(&inbox_ml[rank][1]), tid), bl, bar);
      }
    }
    if (tid == 0)
      mbar_expect_tx(smem_u32(&inbox_full), kSplit * (dims_per_rank + 2) * 4);
    if (tid < dims_per_rank) {
      mbar_wait(smem_u32(&inbox_full), 0);
      float cm = -3.0e38f;
#pragma unroll
      for (int b = 0; b < kSplit; ++b) cm = fmaxf(cm, inbox_ml[b][0]);
      float num = 0.f, den = 0.f;
#pragma unroll
      for (int b = 0; b < kSplit; ++b) {
        const float w = exp2f(inbox_ml[b][0] - cm);  // 0 for an empty slice
        den += inbox_ml[b][1] * w;
        num += inbox_o[b][tid] * w;
      }
      out[(size_t)bh * DH + rank * dims_per_rank + tid] = E::store(num / den);
    }
    return;
  }
  if (tid < DH) {
    block_o[tid] = bo;
    if (tid == 0) {
      block_ml[0] = bm;
      block_ml[1] = bl;
    }
  }
  cluster.sync();  // every block's partial result is written and visible

  // rank r normalises and writes dims [r * dh / SPLIT, (r + 1) * dh / SPLIT)
  if (tid < dims_per_rank) {
    const int d = rank * dims_per_rank + tid;
    float cm = -3.0e38f;
#pragma unroll
    for (int b = 0; b < kSplit; ++b)
      cm = fmaxf(cm, cluster.map_shared_rank(block_ml, b)[0]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int b = 0; b < kSplit; ++b) {
      const float* ml = cluster.map_shared_rank(block_ml, b);
      const float w = exp2f(ml[0] - cm);           // 0 for an empty slice
      den += ml[1] * w;
      num += cluster.map_shared_rank(block_o, b)[d] * w;
    }
    out[(size_t)bh * DH + d] = E::store(num / den);
  }
  cluster.sync();  // keep this block's shared memory until all have read it
}

// The cluster size is a launch attribute, so one kernel serves every split.
template <int DH, typename C, typename T = bf16>
int launch_split(const void* q, const void* k, const void* v, void* out,
                 const void* len_ptr, int len_offset, int bh, int t_max,
                 cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bh * C::SPLIT);
  cfg.blockDim = dim3(C::THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C::SPLIT;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, split_kernel<DH, C, T>, (const T*)q, (const T*)k, (const T*)v,
      (T*)out, (const int*)len_ptr, len_offset, t_max,
      1.4426950408889634f / sqrtf((float)DH));
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// ---- K5: int8 cross attention, keys streamed through a bulk-copy ring ----

// A launch shape of K5: blocks per (batch, head) (a cluster when more than
// one), stages of the ring, keys a stage, consumer threads per block (the
// producer warp comes on top).
template <int SPLIT_, int STAGES_, int KEYS_, int THREADS_>
struct Int8Cfg {
  static constexpr int SPLIT = SPLIT_;
  static constexpr int STAGES = STAGES_;
  static constexpr int KEYS = KEYS_;
  static constexpr int THREADS = THREADS_;
};

// K5's launch shape with SPLIT blocks a (batch, head) pair: a ring of 4
// stages of 64 keys, 128 consumer threads.
template <int SPLIT>
using Int8Shape = Int8Cfg<SPLIT, 4, 64, 128>;

// The blocks a pair at `bh` pairs: the most, up to a portable cluster of 8,
// that keep the grid within about 2.5 blocks an SM (330 on an H100).  The
// decode loops' 16 rows of 20 heads take 1, 8 rows 2, 4 rows 4, 2 and 1
// rows 8: few pairs are spread wide, for latency; many are not split, for
// the bytes, with no combine across blocks.  Timed against 2, 3 and 6
// stages, 32 and 128 keys, 64 and 256 threads and two lanes a key
// (kernel_variants.py).
inline int int8_split(int bh) {
  int split = 8;
  while (split > 1 && 2 * bh * split > 5 * sm_count()) split /= 2;
  return split;
}

// One stage of the ring: the K codes and the V codes of KEYS keys, then a
// window of k scales and one of v scales (the 16-byte lines that hold the
// stage's scales: up to 15 bytes more on each side).
template <int DH, typename S, typename C>
struct Int8Ring {
  static constexpr int kCodeBytes = C::KEYS * DH;
  static constexpr int kScaleBytes = C::KEYS * (int)sizeof(S) + 32;
  static constexpr int kStageBytes = 2 * kCodeBytes + 2 * kScaleBytes;
  static constexpr int kBytes = C::STAGES * kStageBytes;
};

// Where a row of scales lies among 16-byte lines, in keys: a bulk copy
// moves whole lines, so a stage's copy brings the lines that hold its keys
// [t0, t1), clipped to the lines that lie inside the row.  The keys of a
// line that reaches outside the row (at most 15 bytes at each end, where
// the row does not start or end on a line) are read with plain loads.
template <typename S>
struct ScaleLines {
  static constexpr int kPer = 16 / (int)sizeof(S);  // scales a line
  int mis;    // the row's first scale's place in its line
  int first;  // the first key of a line that starts inside the row
  int last;   // one past the last key of a line that ends inside it
  __device__ ScaleLines(const S* row, int t_max) {
    mis = (int)(reinterpret_cast<uintptr_t>(row) / sizeof(S) % kPer);
    first = (mis + kPer - 1) / kPer * kPer - mis;
    last = (mis + t_max) / kPer * kPer - mis;
  }
  __device__ int lo(int t0) const {
    return max(first, (mis + t0) / kPer * kPer - mis);
  }
  __device__ int hi(int t1) const {
    return min(last, (mis + t1 + kPer - 1) / kPer * kPer - mis);
  }
};

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

// The consumer warps of a block meet: named barrier 1, which the producer
// warp does not take.
template <int THREADS>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(THREADS) : "memory");
}

// The scale of key t: from the stage's window [lo, hi) in shared memory,
// else (a line outside the row) from device memory.
template <typename S>
__device__ inline float scale_at(const S* window, const S* row, int lo,
                                 int hi, int t) {
  return to_float(t >= lo && t < hi ? window[t - lo] : row[t]);
}

template <int DH, typename S, typename C>
__global__ void __launch_bounds__(C::THREADS + 32)
cross_int8_kernel(const bf16* __restrict__ q, const int8_t* __restrict__ kq,
                  const S* __restrict__ ks, const int8_t* __restrict__ vq,
                  const S* __restrict__ vs, bf16* __restrict__ out,
                  const int* __restrict__ len_ptr, int t_max,
                  float scale_log2e) {
  using R = Int8Ring<DH, S, C>;
  constexpr int kSplit = C::SPLIT;
  constexpr int kStages = C::STAGES;
  constexpr int kKeys = C::KEYS;
  constexpr int kBlock = C::THREADS;               // the consumer threads
  constexpr int lanes_per_key = DH / 16;           // 16-byte chunks per row
  constexpr int groups = kBlock / lanes_per_key;   // keys a block reads at once
  constexpr int kPer = (kKeys + groups - 1) / groups;  // a group's, a stage
  constexpr int dims_per_rank = DH / kSplit;
  static_assert(kKeys % 16 == 0, "a stage starts on 16 keys");
  static_assert(kBlock >= DH && dims_per_rank >= 1, "combine needs DH lanes");
  static_assert(R::kBytes >= (groups * DH + 2 * groups) * 4,
                "the block's combine reuses the ring");
  extern __shared__ __align__(16) unsigned char int8_ring[];  // the ring
  __shared__ alignas(8) uint64_t full[kStages];    // a slot's copies landed
  __shared__ alignas(8) uint64_t empty[kStages];   // a slot's stage was read
  __shared__ int4 windows[kStages];  // a slot's scale lines: klo, khi, vlo, vhi
  __shared__ float inbox_o[kSplit][dims_per_rank];  // sent by the other ranks
  __shared__ float inbox_ml[kSplit][2];
  __shared__ alignas(8) uint64_t inbox_full;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kBlock / 32);
    }
    if constexpr (kSplit > 1) mbar_init(smem_u32(&inbox_full), 1);
    fence_mbarrier_init();
  }
  __syncthreads();
  if constexpr (kSplit > 1) cluster_arrive_relaxed();
  const int rank = blockIdx.x % kSplit, bh = blockIdx.x / kSplit;

  // this block's slice of the keys, on 16-key boundaries (the last ranks'
  // may be empty), streamed in stages of kKeys
  int n = *len_ptr;
  if (n <= 0 || n > t_max) n = t_max;
  const int per = ((n + kSplit - 1) / kSplit + 15) / 16 * 16;
  const int k0 = min(n, rank * per);
  const int k1 = min(n, k0 + per);
  const int stages = (k1 - k0 + kKeys - 1) / kKeys;
  const int8_t* kb = kq + (size_t)bh * t_max * DH;
  const int8_t* vb = vq + (size_t)bh * t_max * DH;
  const S* ksb = ks + (size_t)bh * t_max;
  const S* vsb = vs + (size_t)bh * t_max;
  const ScaleLines<S> k_lines(ksb, t_max), v_lines(vsb, t_max);

  // the producer warp: one thread fills stage i's slot with four bulk copies
  // counted at its full barrier, once the consumers have read the slot's
  // stage i - kStages
  auto fill = [&](int i) {
    unsigned char* slot = int8_ring + (i % kStages) * R::kStageBytes;
    const uint32_t bar = smem_u32(&full[i % kStages]);
    const int t0 = k0 + i * kKeys, t1 = min(k1, t0 + kKeys);
    const int klo = k_lines.lo(t0), khi = k_lines.hi(t1);
    const int vlo = v_lines.lo(t0), vhi = v_lines.hi(t1);
    const int k_bytes = max(0, khi - klo) * (int)sizeof(S);
    const int v_bytes = max(0, vhi - vlo) * (int)sizeof(S);
    // the arrival below releases this store to the consumers' wait
    windows[i % kStages] = make_int4(klo, khi, vlo, vhi);
    mbar_expect_tx(bar, 2 * (t1 - t0) * DH + k_bytes + v_bytes);
    bulk_load_once(smem_u32(slot), kb + (size_t)t0 * DH, (t1 - t0) * DH,
                   bar);
    bulk_load_once(smem_u32(slot + R::kCodeBytes), vb + (size_t)t0 * DH,
                   (t1 - t0) * DH, bar);
    if (k_bytes)
      bulk_load_once(smem_u32(slot + 2 * R::kCodeBytes), ksb + klo, k_bytes,
                     bar);
    if (v_bytes)
      bulk_load_once(smem_u32(slot + 2 * R::kCodeBytes + R::kScaleBytes),
                     vsb + vlo, v_bytes, bar);
  };
  if (tid >= kBlock) {
    if (tid == kBlock) {
      for (int i = 0; i < stages; ++i) {
        if (i >= kStages)
          mbar_wait(smem_u32(&empty[i % kStages]), (i / kStages - 1) & 1);
        fill(i);
      }
    }
    __syncwarp();
    if constexpr (kSplit > 1) cluster_wait();
    return;
  }

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

  // One stage: key j of the slot goes to lane group j % groups.  Every
  // thread runs the same trip count (the shuffles need whole warps).  A
  // whole stage (kKeys keys, every scale in the copied windows) needs no
  // masks; the last stage of a slice, or one whose scales reach outside
  // the copied lines, masks the keys past it (they read in-bounds rows of
  // the slot) and reads those scales from device memory.
  auto consume = [&](auto whole, const unsigned char* slot, int t0, int t1,
                     int klo, int khi, int vlo, int vhi) {
    constexpr bool kWhole = decltype(whole)::value;
    const S* k_win = reinterpret_cast<const S*>(slot + 2 * R::kCodeBytes);
    const S* v_win = reinterpret_cast<const S*>(slot + 2 * R::kCodeBytes
                                                + R::kScaleBytes);
    auto valid = [&](int j) {
      return kWhole ? kPer * groups == kKeys || j < kKeys : t0 + j < t1;
    };
    auto k_scale = [&](int t) {
      return kWhole ? to_float(k_win[t - klo])
                    : scale_at(k_win, ksb, klo, khi, t);
    };
    auto v_scale = [&](int t) {
      return kWhole ? to_float(v_win[t - vlo])
                    : scale_at(v_win, vsb, vlo, vhi, t);
    };
    float sc[kPer];
    float mx = m;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int j = u * groups + g;
      const int row = kPer * groups > kKeys ? min(j, kKeys - 1) : j;
      float kf[16];
      widen16(*reinterpret_cast<const uint4*>(slot + row * DH + sub * 16),
              kf);
      float even = 0.f, odd = 0.f;   // two chains of the dot: half the wait
#pragma unroll
      for (int d = 0; d < 16; d += 2) {
        even = fmaf(qf[d], kf[d], even);
        odd = fmaf(qf[d + 1], kf[d + 1], odd);
      }
      float dot = even + odd;
#pragma unroll
      for (int w = lanes_per_key / 2; w > 0; w >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, w);
      sc[u] = valid(j) ? dot * k_scale(t0 + j) : -3.0e38f;
      mx = fmaxf(mx, sc[u]);
    }
    if (mx != m) {   // else corr = 1: the rescale would change no bit
      const float corr = exp2f(m - mx);
      l *= corr;
#pragma unroll
      for (int d = 0; d < 16; ++d) o[d] *= corr;
      m = mx;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      // the softmax's sum takes p; the output takes p * v_s (K5's plain
      // version rounds p * v_s to q's dtype before it meets v_q)
      const int j = u * groups + g;
      const int row = kPer * groups > kKeys ? min(j, kKeys - 1) : j;
      const float p = valid(j) ? exp2f(sc[u] - mx) : 0.f;
      const float pv = valid(j) ? p * v_scale(t0 + j) : 0.f;
      float vf[16];
      widen16(*reinterpret_cast<const uint4*>(slot + R::kCodeBytes + row * DH
                                              + sub * 16),
              vf);
      l += p;
#pragma unroll
      for (int d = 0; d < 16; ++d) o[d] = fmaf(pv, vf[d], o[d]);
    }
  };

  for (int i = 0; i < stages; ++i) {
    const unsigned char* slot = int8_ring + (i % kStages) * R::kStageBytes;
    const int t0 = k0 + i * kKeys, t1 = min(k1, t0 + kKeys);
    mbar_wait(smem_u32(&full[i % kStages]), (i / kStages) & 1);
    const int4 win = windows[i % kStages];
    const int klo = win.x, khi = win.y, vlo = win.z, vhi = win.w;
    if (t1 - t0 == kKeys && klo <= t0 && khi >= t1 && vlo <= t0 && vhi >= t1)
      consume(std::true_type(), slot, t0, t1, klo, khi, vlo, vhi);
    else
      consume(std::false_type(), slot, t0, t1, klo, khi, vlo, vhi);
    __syncwarp();      // this warp has read the slot
    if (tid % 32 == 0) mbar_arrive(smem_u32(&empty[i % kStages]));
  }

  // the block's lane groups meet in shared memory (the ring, idle once
  // every consumer warp is past its last stage: every copy has landed)
  consumers_sync<kBlock>();
  float* part_o = reinterpret_cast<float*>(int8_ring);     // [groups][DH]
  float* part_m = part_o + groups * DH;
  float* part_l = part_m + groups;
  if (sub == 0) {
    part_m[g] = m;
    part_l[g] = l;
  }
#pragma unroll
  for (int d = 0; d < 16; ++d) part_o[g * DH + sub * 16 + d] = o[d];
  consumers_sync<kBlock>();
  float bm = -3.0e38f, bl = 0.f, bo = 0.f;
  if (tid < DH) {
    for (int j = 0; j < groups; ++j) bm = fmaxf(bm, part_m[j]);
    for (int j = 0; j < groups; ++j) {
      const float w = exp2f(part_m[j] - bm);       // 0 for a group without keys
      bl += part_l[j] * w;
      bo += part_o[j * DH + tid] * w;
    }
  }
  if constexpr (kSplit == 1) {
    if (tid < DH) out[(size_t)bh * DH + tid] = __float2bfloat16(bo / bl);
    return;
  }
  // each rank stores its (max, sum) into every rank and its dims of o into
  // the rank that writes them (asynchronous stores counted at the
  // receiver's mbarrier); each rank waits for its own bytes only
  cluster_wait();   // every rank runs and has set up its barrier
  if (tid < DH) {
    const int to = tid / dims_per_rank;
    st_async(cluster_addr(smem_u32(&inbox_o[rank][tid % dims_per_rank]), to),
             bo, cluster_addr(smem_u32(&inbox_full), to));
    if (tid < kSplit) {
      const uint32_t bar = cluster_addr(smem_u32(&inbox_full), tid);
      st_async(cluster_addr(smem_u32(&inbox_ml[rank][0]), tid), bm, bar);
      st_async(cluster_addr(smem_u32(&inbox_ml[rank][1]), tid), bl, bar);
    }
  }
  if (tid == 0)
    mbar_expect_tx(smem_u32(&inbox_full), kSplit * (dims_per_rank + 2) * 4);
  if (tid < dims_per_rank) {
    mbar_wait(smem_u32(&inbox_full), 0);
    float cm = -3.0e38f;
#pragma unroll
    for (int b = 0; b < kSplit; ++b) cm = fmaxf(cm, inbox_ml[b][0]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int b = 0; b < kSplit; ++b) {
      const float w = exp2f(inbox_ml[b][0] - cm);  // 0 for an empty slice
      den += inbox_ml[b][1] * w;
      num += inbox_o[b][tid] * w;
    }
    out[(size_t)bh * DH + rank * dims_per_rank + tid] =
        __float2bfloat16(num / den);
  }
}

// Opts the kernel into its ring's shared memory (above 48 KB only so) and
// the largest shared-memory carve-out, once.
template <int DH, typename S, typename C>
int configure_int8() {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        cross_int8_kernel<DH, S, C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        Int8Ring<DH, S, C>::kBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(cross_int8_kernel<DH, S, C>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  return 0;
}

// The cluster size is a launch attribute (none for one block per pair).
template <int DH, typename S, typename C>
int launch_int8(const void* q, const void* kq, const void* ks, const void* vq,
                const void* vs, void* out, const void* len_ptr, int bh,
                int t_max, cudaStream_t stream) {
  const int err = configure_int8<DH, S, C>();
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bh * C::SPLIT);
  cfg.blockDim = dim3(C::THREADS + 32);   // and the producer warp
  cfg.dynamicSmemBytes = Int8Ring<DH, S, C>::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C::SPLIT;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C::SPLIT > 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, cross_int8_kernel<DH, S, C>, (const bf16*)q, (const int8_t*)kq,
      (const S*)ks, (const int8_t*)vq, (const S*)vs, (bf16*)out,
      (const int*)len_ptr, t_max, 1.4426950408889634f / sqrtf((float)DH));
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// K5 at head_dim DH with scales of type S, SPLIT blocks a pair.
template <int DH, typename S>
int launch_int8_split(int split, const void* q, const void* kq,
                      const void* ks, const void* vq, const void* vs,
                      void* out, const void* len_ptr, int bh, int t_max,
                      cudaStream_t stream) {
  switch (split) {
    case 8: return launch_int8<DH, S, Int8Shape<8>>(q, kq, ks, vq, vs, out,
                                                    len_ptr, bh, t_max, stream);
    case 4: return launch_int8<DH, S, Int8Shape<4>>(q, kq, ks, vq, vs, out,
                                                    len_ptr, bh, t_max, stream);
    case 2: return launch_int8<DH, S, Int8Shape<2>>(q, kq, ks, vq, vs, out,
                                                    len_ptr, bh, t_max, stream);
    default: return launch_int8<DH, S, Int8Shape<1>>(q, kq, ks, vq, vs, out,
                                                     len_ptr, bh, t_max,
                                                     stream);
  }
}

// K5 with scales of type S: the launch shape by head_dim and by batch x
// heads (never n).
template <typename S>
int int8_attention(const void* q, const void* kq, const void* ks,
                   const void* vq, const void* vs, void* out,
                   const void* len_ptr, int bh, int t_max, int head_dim,
                   cudaStream_t stream) {
  const int split = int8_split(bh);
  switch (head_dim) {
    case 64: return launch_int8_split<64, S>(split, q, kq, ks, vq, vs, out,
                                             len_ptr, bh, t_max, stream);
    case 32: return launch_int8_split<32, S>(split, q, kq, ks, vq, vs, out,
                                             len_ptr, bh, t_max, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K5's launch shape of config C at head_dim 64 and scales S into `shape`:
// {blocks per (batch, head), stages, keys a stage, threads (the producer
// warp's too), shared-memory bytes of the ring, blocks resident per SM}.
template <typename C, typename S>
int put_int8_shape(int* shape) {
  const int err = configure_int8<64, S, C>();
  if (err) return err;
  shape[0] = C::SPLIT;
  shape[1] = C::STAGES;
  shape[2] = C::KEYS;
  shape[3] = C::THREADS + 32;
  shape[4] = Int8Ring<64, S, C>::kBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &shape[5], cross_int8_kernel<64, S, C>, C::THREADS + 32, shape[4]);
}

// K3 and K4 of element type T: the launch shape by head_dim and, for K3,
// by element type and batch x heads (never n).
template <typename T>
int self_attention(const void* q, const void* k, const void* v, void* out,
                   const void* len_ptr, int len_offset, int bh, int t_max,
                   int head_dim, void* stream) {
  using Narrow = typename SelfShape<T>::Narrow;
  using Wide = typename SelfShape<T>::Wide;
  if (bh <= 0) return 0;
  if (t_max <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool wide = bh > sm_count();
  switch (head_dim) {
    case 64:
      return wide ? launch_split<64, Wide, T>(q, k, v, out, len_ptr,
                                              len_offset, bh, t_max, s)
                  : launch_split<64, Narrow, T>(q, k, v, out, len_ptr,
                                                len_offset, bh, t_max, s);
    case 32:
      return wide ? launch_split<32, Wide, T>(q, k, v, out, len_ptr,
                                              len_offset, bh, t_max, s)
                  : launch_split<32, Narrow, T>(q, k, v, out, len_ptr,
                                                len_offset, bh, t_max, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename C>
void put_shape(int* shape) {
  shape[0] = C::SPLIT;
  shape[1] = C::KEYS;
  shape[2] = C::THREADS;
}

template <typename T>
int cross_attention(const void* q, const void* k, const void* v, void* out,
                    const void* len_ptr, int bh, int t_max, int head_dim,
                    void* stream) {
  if (bh <= 0) return 0;
  if (t_max <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (head_dim) {
    case 64:
      return launch_split<64, CrossCfg, T>(q, k, v, out, len_ptr, 0, bh,
                                           t_max, s);
    case 32:
      return launch_split<32, CrossCfg, T>(q, k, v, out, len_ptr, 0, bh,
                                           t_max, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [bh, dh] bf16, k_q/v_q [bh, t_max, dh] int8, k_s/v_s [bh, t_max]
// float32 (scale_bf16 = 0) or bf16 (scale_bf16 = 1), out [bh, dh] bf16,
// all contiguous, q and the codes 16-byte aligned; len_ptr is one int32 on
// the device: positions < *len_ptr are valid (outside 1..t_max means all
// t_max).  dh is 32 or 64.
extern "C" int mwx_decode_attention_int8(const void* q, const void* kq,
                                         const void* ks, const void* vq,
                                         const void* vs, void* out,
                                         const void* len_ptr, int bh,
                                         int t_max, int head_dim,
                                         int scale_bf16, void* stream) {
  if (bh <= 0) return 0;
  if (t_max <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return scale_bf16 ? int8_attention<bf16>(q, kq, ks, vq, vs, out, len_ptr,
                                           bh, t_max, head_dim, st)
                    : int8_attention<float>(q, kq, ks, vq, vs, out, len_ptr,
                                            bh, t_max, head_dim, st);
}

// K5's launch shape at batch x heads `bh` with f32 (scale_bf16 = 0) or
// bf16 scales, dh 64: six ints into `shape` (see put_int8_shape).
extern "C" int mwx_decode_int8_shape(int bh, int scale_bf16, void* shape) {
  int* out = (int*)shape;
  switch (int8_split(bh)) {
    case 8: return scale_bf16 ? put_int8_shape<Int8Shape<8>, bf16>(out)
                              : put_int8_shape<Int8Shape<8>, float>(out);
    case 4: return scale_bf16 ? put_int8_shape<Int8Shape<4>, bf16>(out)
                              : put_int8_shape<Int8Shape<4>, float>(out);
    case 2: return scale_bf16 ? put_int8_shape<Int8Shape<2>, bf16>(out)
                              : put_int8_shape<Int8Shape<2>, float>(out);
    default: return scale_bf16 ? put_int8_shape<Int8Shape<1>, bf16>(out)
                               : put_int8_shape<Int8Shape<1>, float>(out);
  }
}

// K3.  q [bh, dh], k/v [bh, t_max, dh], out [bh, dh], bf16 contiguous;
// len_ptr is one int32 on the device: n = *len_ptr + len_offset valid
// positions (n outside 1..t_max means all t_max).  dh is 32 or 64.
extern "C" int mwx_decode_attention(const void* q, const void* k,
                                    const void* v, void* out,
                                    const void* len_ptr, int len_offset,
                                    int bh, int t_max, int head_dim,
                                    void* stream) {
  return self_attention<bf16>(q, k, v, out, len_ptr, len_offset, bh, t_max,
                              head_dim, stream);
}

// K3 in float32: the same arguments, q, k, v and out float32.
extern "C" int mwx_decode_attention_f32(const void* q, const void* k,
                                        const void* v, void* out,
                                        const void* len_ptr, int len_offset,
                                        int bh, int t_max, int head_dim,
                                        void* stream) {
  return self_attention<float>(q, k, v, out, len_ptr, len_offset, bh, t_max,
                               head_dim, stream);
}

// K3's launch shape at batch x heads `bh` in bf16 (f32 = 0) or float32
// (f32 = 1): {blocks per (batch, head), keys per lane group, threads}
// into the three ints at `shape`.
extern "C" int mwx_decode_self_shape(int f32, int bh, void* shape) {
  int* out = (int*)shape;
  const bool wide = bh > sm_count();
  if (f32 && wide) put_shape<SelfShape<float>::Wide>(out);
  else if (f32) put_shape<SelfShape<float>::Narrow>(out);
  else if (wide) put_shape<SelfShape<bf16>::Wide>(out);
  else put_shape<SelfShape<bf16>::Narrow>(out);
  return 0;
}

// K4.  q [bh, dh], k/v [bh, t_max, dh], out [bh, dh], bf16 contiguous;
// len_ptr is one int32 on the device: positions < *len_ptr are valid
// (outside 1..t_max means all t_max).  dh is 32 or 64.
extern "C" int mwx_decode_cross_attention(const void* q, const void* k,
                                          const void* v, void* out,
                                          const void* len_ptr, int bh,
                                          int t_max, int head_dim,
                                          void* stream) {
  return cross_attention<bf16>(q, k, v, out, len_ptr, bh, t_max, head_dim,
                               stream);
}

// K4 in float32: the same arguments, q, k, v and out float32.
extern "C" int mwx_decode_cross_attention_f32(const void* q, const void* k,
                                              const void* v, void* out,
                                              const void* len_ptr, int bh,
                                              int t_max, int head_dim,
                                              void* stream) {
  return cross_attention<float>(q, k, v, out, len_ptr, bh, t_max, head_dim,
                                stream);
}
