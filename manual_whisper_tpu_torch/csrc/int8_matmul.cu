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
// Two routes, chosen by M alone:
//
// - M <= 16 (decode steps: the greedy loops' 16, 8, 4, 2 and 1 rows, the
//   beam step's 5 and 10): a weight-streaming product, bound by the int8
//   weight bytes (K*N bytes for 2*M*K*N operations).  A code widened to
//   float32 on the converter (a quarter of the FMA rate) and multiplied
//   into M sums on the FMA pipe keeps the ALU about as busy as device
//   memory at M = 8, and M scalar loads of x for every 16 codes keep few
//   bytes in flight.  So the products go to the tensor cores: out^T =
//   q^T x^T as mma.sync m16n8k16, the codes read straight
//   from device memory into A fragments (a lane's four rows of a 16-row
//   step, interleaved by one byte permute and widened exactly to bf16
//   pairs), x's rows as the B operand in groups of 8: one group for
//   M <= 8, two for M = 9..16, where each widened A fragment feeds one
//   product per group (the widening per code stays, the tensor work
//   doubles, far below mma.sync's rate at the byte bound).  A block owns a
//   stripe of 32 to 64 columns; K is split over its warps and, where the
//   stripes alone would leave SMs idle, over a cluster of blocks, whose
//   sums meet through asynchronous stores into the finishing block's
//   shared memory.  The launch shape follows (K, N) and the number of
//   row groups so each decode shape fills the SMs about once with a few
//   steps per warp, all of a warp's loads in flight.
// - M > 16 (prefill, encoder, cross-K/V, the beam step's 20 and 80): a
//   tiled tensor-core product, bound by the bf16 tensor-core rate at
//   M >= 772.  It loses at M <= 16: its blocks are 128 rows, so at M = 16
//   seven eighths of every x tile are zeros that TMA still loads, and with
//   one block per column tile and no split along K a decode shape gets 10
//   to 40 blocks for 132 SMs, each walking all of K and sending the codes
//   through shared memory to be widened.
//   What a tile product loses on this card is time in which the tensor
//   cores wait: for device memory, for the int8 -> bf16 widening, for
//   threads that do something else.  So the block is split into roles
//   that meet only at mbarriers:
//   * A block owns 128 x BN outputs (BN = 256, or 128 where 256 would
//     leave SMs without work) and walks K in steps of 64.  One thread
//     asks the Tensor Memory Accelerator for each step's x tile and int8
//     weight tile, kStages - 1 steps ahead, into a ring in dynamic shared
//     memory: the x tile in the 128-byte-swizzled K-major layout the
//     products read, the weight tile as int8 (half the bytes a bf16 weight
//     would take through L2 and shared memory).  TMA and not cp.async:
//     with the few warps that are free to copy, 16-byte cp.async copies
//     took longer to start than the products of the step take to run.
//   * One producer warpgroup widens each step's codes to bf16 (exact: two
//     byte permutes and one packed bf16 subtraction per pair) into a
//     second ring of N-contiguous, 128-byte-swizzled tiles, a step or two
//     ahead of the products.
//   * Two consumer warpgroups of 64 rows each start the products as
//     `wgmma.mma_async` m64nBNk16 with float32 sums in registers: x as the
//     K-major A operand straight from the load ring, the widened tile as
//     B with the transposed-B flag.  One step's products are always in
//     flight while the next step's barriers are awaited.
//   * Blocks are persistent: gridDim.x = min(tiles, SMs), and the rings run
//     on from one tile into the next, so a tile's first loads and widening
//     hide behind the previous tile's epilogue.
//   * The epilogue scales the float32 sums in registers (the tile's scales
//     wait in shared memory), rounds to bf16, and each warp turns its 16
//     rows through swizzled staging rows into 16-byte row-contiguous
//     stores.
//   Measured on an H100 (chip_smoke.py): the loads alone, 16 KB of x and
//   64 BN bytes of codes per step and SM, take about as long as the
//   products (L2 bandwidth; no multicast across a cluster yet); widening
//   and epilogue do not yet hide behind them.
//
// Ragged M, N and K edges are handled inside the kernels (the matvec masks
// its loads; the TMA fills what lies outside a matrix with zeros; stores
// are guarded), never padded by the wrapper.  K must be a multiple of 8
// and N of 16 (16-byte vector loads and stores, 16-byte row pitches).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "int8.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

// ---- small M: split-K matvec on the tensor cores --------------------------

constexpr int kGroup = 8;           // rows of x in one product's B operand
constexpr int kVecMaxM = 2 * kGroup;   // the matvec's route: M <= 16
constexpr int kVecMaxCluster = 8;

// WORDS 32-bit words of weight codes, streamed: read once, so not kept in
// L1.
template <int WORDS>
__device__ __forceinline__ void ld_stream(uint32_t (&w)[WORDS],
                                          const int8_t* p) {
  static_assert(WORDS == 1 || WORDS == 2, "stripes of 32 or 64 columns");
  if constexpr (WORDS == 2)
    asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];\n"
        : "=r"(w[0]), "=r"(w[1]) : "l"(p));
  else
    asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];\n"
        : "=r"(w[0]) : "l"(p));
}

// d[16, 8] += a[16, 16] b[16, 8], bf16 operands, float32 sums (mma.sync
// fragments: lane = 4 g + c holds a's rows g and g + 8 at k = 2c, 2c + 1
// (a[0], a[1]) and at k = 2c + 8, 2c + 9 (a[2], a[3]); b's column g at the
// same k (b0, b1); d's rows g (d[0], d[1]) and g + 8 (d[2], d[3]) at
// columns 2c, 2c + 1).
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// out[M, N] for M <= 8 R as out^T = q^T x^T: the widened codes are the A
// operand of m16n8k16 products (16 weight columns as its rows), x's rows
// 8 h .. 8 h + 7 the B operand of group h < R's product (its 8 columns;
// rows of x past m read as zeros).  A block of WARPS warps owns COLS
// columns; the key to reading the codes straight from device memory into
// A fragments is the freedom in which weight column stands for which A
// row, and in the order of K within a product:
//   * lane (g, c) loads BYTES = COLS / 8 codes of its weight rows 2c,
//     2c + 1, 2c + 8 and 2c + 9 of each 16-row step (four loads of 4 or 8
//     bytes: eight lanes cover a row's COLS contiguous bytes);
//   * one byte permute interleaves rows 2c and 2c + 1 (and 2c + 8, 2c + 9)
//     column by column, and the tile product's widening turns each pair
//     into the bf16 pair (k, k + 1) of one column: an A register;
//   * product j takes columns 2j (as A row g) and 2j + 1 (row g + 8) of
//     the lane's codes, so BYTES / 2 products a row group cover a step.
// Each warp owns a contiguous run of 16-row steps (the K axis is split over
// the warps of a block and the `cs` blocks of a cluster), keeps U steps'
// loads (U * 4 * BYTES bytes a lane) in flight before it widens any, and
// keeps its sums in registers.  The warps meet in shared memory.  In a
// cluster each block then stores its sums of column c into the inbox of
// block c % cs (asynchronous stores to distributed shared memory, counted
// at the receiver's mbarrier), and each block waits only for the bytes it
// expects, then scales, rounds and writes its columns; with cs = 1 there
// is no cluster and the block writes at once.  One launch, no workspace,
// no atomics.  The second row group's work stands apart (`if constexpr`)
// and its rows' pointer is a variable of its own, so that R = 1 compiles
// to the same machine code as the single-group kernel before it: written
// as loops over per-group arrays, R = 1 reloaded n from the constant bank
// at every code load and its M <= 8 launches ran 3-4 % slower on an H100
// (R = 2 ran 2-6 % faster that way).
template <int COLS, int U, int WARPS, int R>
__global__ void __launch_bounds__(WARPS * 32)
matvec_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
              const float* __restrict__ s, bf16* __restrict__ out, int m,
              int k, int n) {
  static_assert(R == 1 || R == 2, "one or two groups of 8 rows");
  constexpr int kThreads = WARPS * 32;
  constexpr int BYTES = COLS / 8;          // codes of a row per lane
  constexpr int WORDS = BYTES / 4;
  constexpr int J = BYTES / 2;             // products per 16-row step
  constexpr int kOut = COLS * kGroup;      // a stripe's outputs of a row
                                           // group, column-major
  constexpr int kChunks = (kOut + kThreads - 1) / kThreads;
  // a warp's sums in shared memory: per lane group g its BYTES columns of
  // 8 rows of out (column by column), groups kPad floats apart: 8 more
  // than they fill, so the float2 stores of a half-warp meet no bank
  // twice; the second row group's 8 kPad floats further on
  constexpr int kPad = BYTES * 8 + 8;
  __shared__ float red[WARPS][R * 8 * kPad];
  // sums sent by the cluster's blocks: [sender][row group][this block's
  // columns][row]
  __shared__ float inbox[R * (kOut + kVecMaxCluster * kGroup)];
  __shared__ alignas(8) uint64_t inbox_full;
  static_assert(sizeof(red) + sizeof(inbox) + 8 <= 48 * 1024,
                "a launch shape's sums fit the static 48 KB");
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  if (cs > 1) {
    if (threadIdx.x == 0) {
      mbar_init(smem_u32(&inbox_full), 1);
      fence_mbarrier_init();
    }
    cluster_arrive_relaxed();
  }
  const int n0 = (blockIdx.x / cs) * COLS;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  const int col = n0 + g * BYTES;
  const int steps = (k + 15) / 16;
  const int per = (steps + cs * WARPS - 1) / (cs * WARPS);
  const int s0 = min(steps, (rank * WARPS + warp) * per);
  const int s1 = min(steps, s0 + per);
  const bool col_ok = col < n;
  const bool row_ok = g < m;
  const int8_t* qc = q + col;
  const bf16* xg = x + (size_t)(row_ok ? g : 0) * k;
  // the second row group's row 8 + g (R = 2)
  const bool row_ok1 = R == 2 && kGroup + g < m;
  const bf16* xg1 = x + (size_t)(row_ok1 ? kGroup + g : 0) * k;

  // The block finishes the stripe's columns rank, rank + cs, ...: its
  // output l of a row group (row l % 8 of its column l / 8) is the
  // stripe's output ((l / 8) * cs + rank) * 8 + l % 8, and thread tid
  // takes l = tid, tid + kThreads, ...  The scales are loaded now, off the
  // epilogue's path.
  const int own = (COLS + cs - 1) / cs * kGroup;   // outputs it finishes
  float scale[kChunks];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int l = j * kThreads + tid;
    const int cl = (l / kGroup) * cs + rank;
    scale[j] = l < own && cl < COLS && n0 + cl < n ? __ldg(s + n0 + cl)
                                                   : 0.f;
  }

  float acc[J][4], acc1[J][4];             // rows g and 8 + g of x
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  if constexpr (R == 2) {
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[j][e] = 0.f;
  }

  for (int st = s0; st < s1; st += U) {
    // U steps of codes and x: rows past the warp's steps or past k, and
    // columns past n, read as zeros
    uint32_t w[U][4][WORDS], b[U][2], b1[U][2];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool live = st + u < s1;
      const int r0 = (st + u) * 16 + 2 * c;    // k is a multiple of 8, so
#pragma unroll                                 // rows r0, r0 + 1 stand or
      for (int i = 0; i < 4; ++i) {            // fall together
        const int r = r0 + (i & 1) + (i >> 1) * 8;
        if (live && col_ok && r < k) {
          ld_stream<WORDS>(w[u][i], qc + (size_t)r * n);
        } else {
#pragma unroll
          for (int e = 0; e < WORDS; ++e) w[u][i][e] = 0u;
        }
      }
      b[u][0] = live && row_ok && r0 < k
                    ? __ldg(reinterpret_cast<const unsigned int*>(xg + r0))
                    : 0u;
      b[u][1] = live && row_ok && r0 + 8 < k
                    ? __ldg(reinterpret_cast<const unsigned int*>(xg + r0 + 8))
                    : 0u;
      if constexpr (R == 2) {
        b1[u][0] = live && row_ok1 && r0 < k
                       ? __ldg(reinterpret_cast<const unsigned int*>(xg1 + r0))
                       : 0u;
        b1[u][1] = live && row_ok1 && r0 + 8 < k
                       ? __ldg(reinterpret_cast<const unsigned int*>(
                             xg1 + r0 + 8))
                       : 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (st + u >= s1) break;                 // the same for the warp
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const uint32_t sel = j & 1 ? 0x7362u : 0x5140u;
        uint32_t a[4];
        widen4(__byte_perm(w[u][0][j / 2], w[u][1][j / 2], sel), a[0], a[1]);
        widen4(__byte_perm(w[u][2][j / 2], w[u][3][j / 2], sel), a[2], a[3]);
        mma_16816(acc[j], a, b[u][0], b[u][1]);
        if constexpr (R == 2) mma_16816(acc1[j], a, b1[u][0], b1[u][1]);
      }
    }
  }

  // the warps meet in shared memory: acc[j] holds columns g * BYTES + 2j
  // (d[0], d[1]) and + 2j + 1 (d[2], d[3]) at rows 2c, 2c + 1 of out,
  // acc1[j] the same columns at rows 8 + 2c, 8 + 2c + 1
  float* rw = red[warp] + g * kPad + 2 * c;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    *reinterpret_cast<float2*>(rw + 16 * j) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(rw + 16 * j + 8) =
        make_float2(acc[j][2], acc[j][3]);
    if constexpr (R == 2) {
      *reinterpret_cast<float2*>(rw + 8 * kPad + 16 * j) =
          make_float2(acc1[j][0], acc1[j][1]);
      *reinterpret_cast<float2*>(rw + 8 * kPad + 16 * j + 8) =
          make_float2(acc1[j][2], acc1[j][3]);
    }
  }
  __syncthreads();
  if (cs > 1) cluster_wait();   // every block of the cluster runs by now
  // each of the thread's outputs o of a row group h: the warps' sums,
  // scaled and written (cs = 1) or sent to the block that finishes its
  // column
  auto meet = [&](int h, int o, float sc) {
    const int idx = h * 8 * kPad + (o / (8 * BYTES)) * kPad + o % (8 * BYTES);
    float v = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < WARPS; ++w8) v += red[w8][idx];
    const int cl = o / kGroup;
    if (cs == 1) {
      if (n0 + cl < n)
        out[(size_t)(h * kGroup + o % kGroup) * n + n0 + cl] =
            __float2bfloat16(v * sc);
    } else {
      st_async(cluster_addr(smem_u32(inbox + (rank * R + h) * own
                                     + (cl / cs) * kGroup + o % kGroup),
                            cl % cs),
               v, cluster_addr(smem_u32(&inbox_full), cl % cs));
    }
  };
#pragma unroll
  for (int jj = 0; jj < kChunks; ++jj) {
    const int o = jj * kThreads + tid;         // column o / 8, row o % 8
    if (o < kOut && o % kGroup < m) meet(0, o, scale[jj]);
    if constexpr (R == 2)
      if (o < kOut && kGroup + o % kGroup < m) meet(1, o, scale[jj]);
  }
  if (cs == 1) return;
  // every block sends each of this block's columns its m rows
  if (threadIdx.x == 0)
    mbar_expect_tx(smem_u32(&inbox_full),
                   cs * ((COLS - rank + cs - 1) / cs) * m * 4);
  mbar_wait(smem_u32(&inbox_full), 0);

  // the block's output l of row group h: the senders' sums, scaled and
  // written
  auto finish = [&](int h, int l, int cl, float sc) {
    float v = 0.f;
#pragma unroll
    for (int b = 0; b < kVecMaxCluster; ++b)
      if (b < cs) v += inbox[(b * R + h) * own + l];
    out[(size_t)(h * kGroup + l % kGroup) * n + n0 + cl] =
        __float2bfloat16(v * sc);
  };
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int l = j * kThreads + tid;
    const int cl = (l / kGroup) * cs + rank;
    if (l < own && cl < COLS && n0 + cl < n) {
      if (l % kGroup < m) finish(0, l, cl, scale[j]);
      if constexpr (R == 2)
        if (kGroup + l % kGroup < m) finish(1, l, cl, scale[j]);
    }
  }
}

// One cluster of `cs` blocks per COLS columns (no cluster for cs = 1).
template <int COLS, int U, int WARPS, int R>
int launch_matvec(const void* x, const void* q, const void* s, void* out,
                  int m, int k, int n, int cs, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((n + COLS - 1) / COLS) * cs);
  cfg.blockDim = dim3(WARPS * 32);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, matvec_kernel<COLS, U, WARPS, R>, (const bf16*)x,
      (const int8_t*)q, (const float*)s, (bf16*)out, m, k, n);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// ---- large M: warp-specialised tensor-core tile product --------------------

constexpr int kBM = 128;            // rows per block: 64 per consumer warpgroup
constexpr int kBK = 64;             // K step: one 128-byte row of the x tile
constexpr int kConsumerThreads = 256;   // two warpgroups run the products
constexpr int kProducerThreads = 128;   // one warpgroup loads and widens
constexpr int kTileThreads = kConsumerThreads + kProducerThreads;
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kABytes = kBM * kBK * 2;  // one x tile, bf16
constexpr int kOutCols = 32;            // columns per epilogue pass

constexpr int kScaleSlots = 6;          // tiles whose scales are kept

// Shared memory of a block, from a 1024-byte aligned base: the load ring
// (per stage one x tile and one int8 weight tile in 64-column panels of
// 64-byte rows, both written by TMA),
// the ring of widened bf16 weight tiles, per consumer warp 16 staging rows
// of kOutCols outputs, the scales of the tiles in flight, and the
// barriers: full and empty per load stage, full and empty per bf16 stage.
template <int BN, int kStages, int kWideStages>
struct TileSmem {
  static constexpr int q_bytes = kBK * BN;
  static constexpr int load_bytes = kABytes + q_bytes;
  static constexpr int b_bytes = kBK * BN * 2;
  static constexpr int b_off = kStages * load_bytes;
  static constexpr int out_off = b_off + kWideStages * b_bytes;
  static constexpr int out_warp_bytes = 16 * kOutCols * 2;
  static constexpr int scale_off = out_off + kConsumerWarps * out_warp_bytes;
  static constexpr int bar_off = scale_off + kScaleSlots * BN * 4;
  static constexpr int total = bar_off + 2 * (kStages + kWideStages) * 8;
  static constexpr int launch_bytes = total + 1024;   // room to align
  static_assert(load_bytes % 1024 == 0 && b_off % 1024 == 0, "swizzle atoms");
  static_assert(launch_bytes <= 227 * 1024, "fits one SM");
};

// Byte offset of 16-byte chunk `c` (0..7) of row `r` in a tile of 128-byte
// rows under the 128-byte swizzle: chunk index XOR (row mod 8).
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// Byte offset, in a widened weight tile, of the 16-byte chunk that holds
// columns [n, n + 8) of K row `kr` (n a multiple of 8).  The tile is
// N-contiguous ("MN-major"): 64 columns make a 128-byte row, 8 K rows a
// 1024-byte swizzle atom, the 8 atoms of a 64-column panel follow each
// other, and panels are kBK * 128 bytes apart.
__device__ __forceinline__ int b_offset(int kr, int n) {
  return (n >> 6) * (kBK * 128) + swz(kr, (n & 63) >> 3);
}

// d[64, N] (+)= a[64, 16] b[16, N] for one warpgroup: a K-major, b
// N-contiguous (transposed-B flag set), both read from shared memory, d in
// registers: d[j] is the fragment of columns [8 j, 8 j + 8), rows
// 16 (warp % 4) + lane / 4 and + 8, columns 2 (lane % 4) + {0, 1}.  With
// accumulate == 0 the old d is ignored.
__device__ __forceinline__ void wgmma_m64k16(float (&d)[32][4],
                                             uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, "
      " %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103, "
      " %104, %105, %106, %107, %108, %109, %110, %111, "
      " %112, %113, %114, %115, %116, %117, %118, %119, "
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
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
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64k16(float (&d)[16][4],
                                             uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
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
      "%64, %65, p, 1, 1, 0, 1;\n"
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

// Launch shape of the tile product: BN columns per tile, the depth of the
// load ring and of the ring of widened weight tiles.
template <int BN_, int kStages_, int kWideStages_>
struct TileCfg {
  static constexpr int BN = BN_;
  static constexpr int kStages = kStages_;
  static constexpr int kWideStages = kWideStages_;
  using Smem = TileSmem<BN_, kStages_, kWideStages_>;
  // barrier addresses, from the block's first barrier
  static constexpr int full_load = 0;
  static constexpr int empty_load = kStages_ * 8;
  static constexpr int full_wide = 2 * kStages_ * 8;
  static constexpr int empty_wide = (2 * kStages_ + kWideStages_) * 8;
};

// A block's K steps in order: the tiles blockIdx.x, blockIdx.x + gridDim.x,
// ... and within each tile t = 0 .. nk - 1.
struct StepCursor {
  int tile, t;
  __device__ __forceinline__ void advance(int nk) {
    if (++t == nk) {
      t = 0;
      tile += gridDim.x;
    }
  }
};

// A position in a ring of `n` stages and the parity of the barrier phase
// that belongs to it.
struct RingPos {
  int stage, parity;
  __device__ __forceinline__ void advance(int n) {
    if (++stage == n) {
      stage = 0;
      parity ^= 1;
    }
  }
};

// The producer warpgroup widens: for every K step of this block, in the
// consumers' order, it waits for the step's load stage and for a free bf16
// weight tile, turns the stage's int8 codes into that tile (b_offset's
// layout), and one lane per warp arrives at the tile's full barrier and
// hands the load stage's weight half back.  On a tile's first step the
// warpgroup also puts the tile's scales into shared memory for the
// epilogue.  It asks for no TMA load: its fence.proxy.async, which makes the
// bf16 tile visible to the products, would wait for loads of its own that
// are still in flight.
template <typename C>
__device__ __forceinline__ void produce(unsigned char* smem, uint32_t bars,
                                        const float* __restrict__ s, int n,
                                        int tiles, int n_tiles, int nk,
                                        int ptid) {
  using L = typename C::Smem;
  constexpr int BN = C::BN;
  constexpr int PT = kProducerThreads;
  // Eight neighbouring lanes take the four 16-code chunks of one 64-column
  // panel in two neighbouring K rows: their loads cover 128 contiguous
  // bytes of the int8 tile (panels of 64-byte rows) and their stores the
  // eight 16-byte slots of two swizzled rows, so neither meets a bank
  // conflict.  A unit is such a (panel, row pair); 16 units go at a time.
  constexpr int kPanels = BN / 64;
  constexpr int kChunks = kPanels * (kBK / 2) / (PT / 8);  // per thread, step
  static_assert(kChunks * (PT / 8) == kPanels * (kBK / 2), "even split");
  const int cc = ptid & 3;                        // chunk in the panel row
  const int row_lo = (ptid >> 2) & 1;
  const int unit0 = ptid >> 3;
  const int total = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                    (int)gridDim.x * nk;

  StepCursor work_at{(int)blockIdx.x, 0};
  RingPos from{0, 0};                             // load stage being widened
  RingPos to{0, 1};                               // bf16 tile being written
  int tile_iter = 0;
  for (int i = 0; i < total; ++i) {
    mbar_wait(bars + C::full_load + from.stage * 8, from.parity);
    mbar_wait(bars + C::empty_wide + to.stage * 8, to.parity);

    if (work_at.t == 0) {
      const int col = (work_at.tile % n_tiles) * BN + ptid * 2;
      if (ptid * 2 < BN) {
        float2 v = make_float2(0.f, 0.f);
        if (col < n) v = __ldg(reinterpret_cast<const float2*>(s + col));
        *reinterpret_cast<float2*>(smem + L::scale_off +
                                   ((tile_iter % kScaleSlots) * BN + ptid * 2)
                                       * 4) = v;
      }
      ++tile_iter;
    }

    const unsigned char* sq = smem + from.stage * L::load_bytes + kABytes;
    unsigned char* sb = smem + L::b_off + to.stage * L::b_bytes;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int unit = j * (PT / 8) + unit0;
      const int panel = unit % kPanels;
      const int r = (unit / kPanels) * 2 + row_lo;
      const uint4 w = *reinterpret_cast<const uint4*>(
          sq + panel * (kBK * 64) + r * 64 + cc * 16);
      uint4 lo, hi;
      widen4(w.x, lo.x, lo.y);
      widen4(w.y, lo.z, lo.w);
      widen4(w.z, hi.x, hi.y);
      widen4(w.w, hi.z, hi.w);
      *reinterpret_cast<uint4*>(sb + b_offset(r, panel * 64 + cc * 16)) = lo;
      *reinterpret_cast<uint4*>(sb + b_offset(r, panel * 64 + cc * 16 + 8)) =
          hi;
    }
    fence_async_proxy();
    __syncwarp();
    if (ptid % 32 == 0) {
      mbar_arrive(bars + C::full_wide + to.stage * 8);
      mbar_arrive(bars + C::empty_load + from.stage * 8);
    }
    from.advance(C::kStages);
    to.advance(C::kWideStages);
    work_at.advance(nk);
  }
}

// A consumer warp's epilogue: its 16 rows of the tile, kOutCols columns a
// pass: scale the float32 sums in registers (the tile's scales are in
// shared memory), round to bf16, turn them through the warp's swizzled
// staging rows into 16-byte chunks, and store each row's chunks from
// neighbouring lanes.
template <int BN>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 8][4],
                                           unsigned char* stage,
                                           const float* scales,
                                           bf16* __restrict__ out, int m,
                                           int n, int row0, int n0,
                                           int lane) {
  const int g = lane / 4;
  const int c2 = (lane % 4) * 2;
  constexpr int jpp = kOutCols / 8;               // fragments per pass
#pragma unroll
  for (int pass = 0; pass < BN / kOutCols; ++pass) {
#pragma unroll
    for (int jj = 0; jj < jpp; ++jj) {
      const int j = pass * jpp + jj;
      const float2 sc = *reinterpret_cast<const float2*>(scales + j * 8 + c2);
      const int chunk = (jj ^ ((g >> 1) & 3)) << 4;
      *reinterpret_cast<__nv_bfloat162*>(stage + g * (kOutCols * 2) + chunk
                                         + c2 * 2) =
          __floats2bfloat162_rn(acc[j][0] * sc.x, acc[j][1] * sc.y);
      *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8) * (kOutCols * 2)
                                         + chunk + c2 * 2) =
          __floats2bfloat162_rn(acc[j][2] * sc.x, acc[j][3] * sc.y);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 16 * jpp / 32; ++i) {
      const int idx = lane + i * 32;
      const int r = idx / jpp;
      const int c = idx % jpp;
      const int gr = row0 + r;
      const int gc = n0 + pass * kOutCols + c * 8;
      if (gr < m && gc < n)
        *reinterpret_cast<uint4*>(out + (size_t)gr * n + gc) =
            *reinterpret_cast<const uint4*>(
                stage + r * (kOutCols * 2) + ((c ^ ((r >> 1) & 3)) << 4));
    }
    __syncwarp();
  }
}

// The two consumer warpgroups.  Warpgroup w owns rows [64 w, 64 w + 64) of
// the tile and all BN columns.  Per K step: wait for the x tile and for the
// widened weight tile, start four m64nBNk16 products (x tile: 8-row groups
// 1024 bytes apart, a K step of 16 is 32 bytes along the swizzled row;
// weight tile: 8-row K groups 1024 bytes apart, 64-column panels kBK * 128
// bytes apart, a K step of 16 is two K groups), then wait for the previous
// step's products and hand its two stages back.  One step's products are
// always in flight.
template <typename C>
__device__ __forceinline__ void consume(unsigned char* smem, uint32_t bars,
                                        const CUtensorMap* map_x,
                                        const CUtensorMap* map_q,
                                        bf16* __restrict__ out, int m, int n,
                                        int tiles, int n_tiles, int nk,
                                        int warp, int lane) {
  using L = typename C::Smem;
  constexpr int BN = C::BN;
  constexpr int kAhead = C::kStages - 1;
  const uint32_t base = smem_u32(smem);
  const int total = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                    (int)gridDim.x * nk;
  const bool loader = warp == 4 && lane == 0;

  // The loads run kStages - 1 steps ahead of the products.  The stage of
  // step j - 1 is handed back as step j is started, and is loaded at once
  // with step j - 1 + kStages.
  StepCursor load_at{(int)blockIdx.x, 0};
  RingPos load_to{0, 1};                          // a fresh stage is empty
  int loaded = 0;
  auto start_loads = [&]() {
    mbar_wait(bars + C::empty_load + load_to.stage * 8, load_to.parity);
    const uint32_t full = bars + C::full_load + load_to.stage * 8;
    const uint32_t dst = base + load_to.stage * L::load_bytes;
    mbar_expect_tx(full, L::load_bytes);
    tma_load_2d(dst, map_x, full, load_at.t * kBK,
                (load_at.tile / n_tiles) * kBM);
#pragma unroll
    for (int p = 0; p < BN / 64; ++p)
      tma_load_2d(dst + kABytes + p * (kBK * 64), map_q, full,
                  (load_at.tile % n_tiles) * BN + p * 64, load_at.t * kBK);
    load_at.advance(nk);
    load_to.advance(C::kStages);
    ++loaded;
  };
  if (loader)
    while (loaded < kAhead && loaded < total) start_loads();

  float acc[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  RingPos xs{0, 0}, ws{0, 0};
  int prev_x = 0, prev_w = 0, tile_iter = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    for (int t = 0; t < nk; ++t) {
      mbar_wait(bars + C::full_load + xs.stage * 8, xs.parity);
      mbar_wait(bars + C::full_wide + ws.stage * 8, ws.parity);
      const uint32_t sa = base + xs.stage * L::load_bytes + (warp / 4) * 64 * 128;
      const uint32_t sb = base + L::b_off + ws.stage * L::b_bytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_m64k16(acc, gmma_desc(sa + kk * 32, 16, 1024),
                     gmma_desc(sb + kk * 2048, kBK * 128, 1024),
                     (t | kk) != 0);
      wgmma_commit();
      if (t > 0) {
        wgmma_wait<1>();
        if (lane == 0) {
          mbar_arrive(bars + C::empty_load + prev_x * 8);
          mbar_arrive(bars + C::empty_wide + prev_w * 8);
        }
      }
      if (loader && loaded < total) start_loads();
      prev_x = xs.stage;
      prev_w = ws.stage;
      xs.advance(C::kStages);
      ws.advance(C::kWideStages);
    }
    wgmma_wait<0>();
    if (lane == 0) {
      mbar_arrive(bars + C::empty_load + prev_x * 8);
      mbar_arrive(bars + C::empty_wide + prev_w * 8);
    }
    store_tile<BN>(acc, smem + L::out_off + warp * L::out_warp_bytes,
                   reinterpret_cast<const float*>(smem + L::scale_off) +
                       (tile_iter % kScaleSlots) * BN,
                   out, m, n, (tile / n_tiles) * kBM + warp * 16,
                   (tile % n_tiles) * BN, lane);
    ++tile_iter;
  }
}

// Blocks walk the tiles in row-major order of (row tile, column tile),
// gridDim.x apart, so the blocks running together share x rows and the
// whole weight in L2; a block's rings run on from one tile into the next,
// which hides a tile's first loads behind the previous tile's epilogue.
// The two roles never meet again after the barriers are set up.
template <typename C>
__global__ void __launch_bounds__(kTileThreads, 1)
tile_kernel(const __grid_constant__ CUtensorMap map_x,
            const __grid_constant__ CUtensorMap map_q,
            const float* __restrict__ s, bf16* __restrict__ out, int m, int k,
            int n) {
  using L = typename C::Smem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - smem_u32(smem_raw)) & 1023u);
  const uint32_t bars = smem_u32(smem) + L::bar_off;

  const int tid = threadIdx.x;
  const int n_tiles = (n + C::BN - 1) / C::BN;
  const int tiles = ((m + kBM - 1) / kBM) * n_tiles;
  const int nk = (k + kBK - 1) / kBK;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < C::kStages; ++i) {
      mbar_init(bars + C::full_load + i * 8, 1);
      mbar_init(bars + C::empty_load + i * 8,
                kConsumerWarps + kProducerThreads / 32);
    }
#pragma unroll
    for (int i = 0; i < C::kWideStages; ++i) {
      mbar_init(bars + C::full_wide + i * 8, kProducerThreads / 32);
      mbar_init(bars + C::empty_wide + i * 8, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumerThreads)
    produce<C>(smem, bars, s, n, tiles, n_tiles, nk, tid - kConsumerThreads);
  else
    consume<C>(smem, bars, &map_x, &map_q, out, m, n, tiles, n_tiles, nk,
               tid / 32, tid % 32);
}

template <typename C>
int launch_tile(const void* x, const void* q, const void* s, void* out, int m,
                int k, int n, cudaStream_t stream) {
  using L = typename C::Smem;
  static bool configured = false;     // more than 48 KB: opt in once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::launch_bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  CUtensorMap map_x, map_q;
  if (!make_map(&map_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, m, k, kBM, kBK,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&map_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, k, n, kBK, 64,
                CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  const int tiles = ((m + kBM - 1) / kBM) * ((n + C::BN - 1) / C::BN);
  const int grid = min(tiles, sm_count());
  tile_kernel<C><<<grid, kTileThreads, L::launch_bytes, stream>>>(
      map_x, map_q, (const float*)s, (bf16*)out, m, k, n);
  return (int)cudaGetLastError();
}

}  // namespace

// x [m, k] bf16, q [k, n] int8, s [n] f32, out [m, n] bf16, all contiguous
// and 16-byte aligned; k a multiple of 8, n a multiple of 16.
extern "C" int mwx_int8_matmul(const void* x, const void* q, const void* s,
                               void* out, int m, int k, int n, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k <= 0 || k % 8 || n % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int steps = (k + 15) / 16;
  if (m <= kGroup) {
    // Launch shapes measured at a decode step's three shapes (K, N) on an
    // H100: each fills the SMs about once with a few 16-row steps per warp.
    // Wide (fc1, 1280 x 5120): 80 stripes of 64 columns, no cluster, 16
    // warps of 5 steps.  Deep (fc2, 5120 x 1280): 20 stripes of 64
    // columns, clusters of 8 along K.  Square (1280 x 1280): 40 stripes
    // of 32 columns, clusters of 4.  Clusters never exceed one 16-row step
    // per warp.
    if (n >= 4 * k)
      return launch_matvec<64, 5, 16, 1>(x, q, s, out, m, k, n, 1, st);
    if (k >= 4 * n)
      return launch_matvec<64, 2, 8, 1>(x, q, s, out, m, k, n,
                                        max(1, min(8, steps / 8)), st);
    return launch_matvec<32, 3, 8, 1>(x, q, s, out, m, k, n,
                                      max(1, min(4, steps / 8)), st);
  }
  if (m <= kVecMaxM) {
    // Two row groups: twice the products and x loads for every code, and
    // a second group of sums to meet over.  Measured at the same three
    // shapes: stripes of 32 columns and 8 warps, K split over clusters of
    // steps / 40 blocks (2 at K = 1280, 8 at K = 5120), so each warp has
    // about five 16-row steps.  Where the blocks fit twice on the SMs
    // (square: 80) all five steps' loads are in flight at once; where
    // they do not (wide and deep: 320), three at a time, so that three
    // blocks fit an SM and the grid runs in one wave.
    const int cs = max(1, min(kVecMaxCluster, steps / 40));
    if ((n + 31) / 32 * cs <= 2 * sm_count())
      return launch_matvec<32, 5, 8, 2>(x, q, s, out, m, k, n, cs, st);
    return launch_matvec<32, 3, 8, 2>(x, q, s, out, m, k, n, cs, st);
  }
  // 256-column tiles where they fill the SMs one and a half times over
  // (a round of tiles that leaves most SMs idle costs more than the wide
  // tile saves), else 128-column ones
  const int row_tiles = (m + kBM - 1) / kBM;
  if (2 * row_tiles * ((n + 255) / 256) >= 3 * sm_count())
    return launch_tile<TileCfg<256, 3, 3>>(x, q, s, out, m, k, n, st);
  return launch_tile<TileCfg<128, 4, 3>>(x, q, s, out, m, k, n, st);
}
