// K1: fused Whisper log-mel frontend for Hopper (sm_90a).
//
// Replaces `_mel_kernel` / `unnormalized_log_mel_pallas` of
// manual_whisper_tpu/ops/mel_pallas.py, which computes per frame
//   spec  = frame[0:400] @ dft[400, 402]        (Hann window fused in)
//   power = re^2 + im^2                         [201]
//   mel   = power @ filters[201, n_mels]
//   out   = log10(max(mel, 1e-10))
// This kernel computes the same in float32, with the DFT folded twice by
// symmetry.  First the window's: the periodic Hann window has w[k] =
// w[400-k] and w[0] = 0, so row 400-k of the DFT's cosine half equals row
// k and row 400-k of its sine half is row k negated (to 2e-13 in f32).
// With C and S rows 1..200 and 1..199 of the plain version's f32 matrix:
//   re[f] = sum_{k=1..199} C[k, f] (x[k] + x[400-k]) + C[200, f] x[200]
//   im[f] = sum_{k=1..199} S[k, f] (x[k] - x[400-k])
// (79,801 multiply-adds a frame where the dense product does 160,800).
// Then the frequencies': C[k, 200-f] = (-1)^k C[k, f] and S[k, 200-f] =
// -(-1)^k S[k, f] (to 2e-13), so with P and Q the sums of bin f <= 100
// over the even and the odd taps, bin f is P + Q and bin 200 - f is
// P - Q (the sine's up to its sign, which the power drops): 200 x 101 +
// 199 x 100 multiply-adds a frame, 40,100.  The kernel reads columns
// 0..100 of C and S, so it multiplies by the plain version's numbers for
// bins 0..100 and by their mirror (equal to 2e-13) for bins 101..200.
// The slaney filterbank has at most 2 nonzeros a bin, 391 at 80 mels and
// 394 at 128, in one run of at most 14 bins per band: each output sums
// its band's run, not 201 dense terms.  No TF32: the sums feed a log10,
// which amplifies error near the 1e-10 floor.
//
// The frames are built from the audio by index: frame f is samples
// [f*160 - 200, f*160 + 200) with reflect padding, so the [B, F, 400]
// frame tensor is never written, and any frame count is taken (the TPU's
// 600-frame blocks were a VMEM tiling constraint).
//
// Bound on the H100: the function itself needs no more than a real FFT's
// work, about 1.2e4 operations a frame, against 4 * (T + F * n_mels)
// bytes a row, so the bytes bind (0.0041 ms at B=4, 30 s, 128 mels, at
// 3.35 TB/s).  This kernel's own work, 2 * (40,100 + nnz) operations a
// frame, takes 0.0145 ms at the float32 rate outside the tensor cores
// (67 TFLOP/s): a body built as FFT stages could go below that, this one
// cannot.  What the design does about its own work:
// - one block takes TM * GY frames of one batch row (96 in the shipped
//   shape: B=4 x 3000 frames is 128 blocks, one wave on 132 SMs, one
//   block an SM); its audio span comes into shared memory with every load
//   in flight at once, and is folded from there;
// - the block's two halves of GX x GY threads take the even and the odd
//   taps: each runs a register-tiled outer product over its 100 rows, a
//   thread holding TM frames x TN bins and loading TM samples and TN
//   constants a row for TM * TN FMAs (6 x 13: 78 FMAs for 3 float2 and 4
//   float4 loads); GX * TN >= 101 pads the bins to 104, so no warp idles;
//   a warp covers LX bin groups x 32 / LX frame groups, so its vector
//   loads touch few addresses.  The halves' sums meet once, at the end;
// - the fold is k-major in shared memory, so a thread's frames are
//   adjacent; the sine fold replaces the cosine fold between the walks,
//   the cosine sums waiting in registers;
// - the constants come packed (ops/mel.py: `pack_folded`): a thread's TN
//   constants of a row are float4 planes GX * 16 bytes apart.  They stream
//   through a ring of STAGES chunks of KC rows in shared memory, a chunk
//   copied with 16-byte cp.async while an earlier one is multiplied; the
//   two products are one walk over the chunks;
// - the power spectrum replaces the audio in shared memory; a warp then
//   takes one mel band at a time and its lanes the frames, summing a
//   window of 4 * nq bins (the widest band's run, rounded up) with the
//   band's weights, zero outside its run; the results go through a
//   [mel][frame] tile and are stored along n_mels.
// MelCfg and log_mel_kernel take the tile sizes as template arguments, so
// kernel_variants.py can build other shapes from this file; the packing
// of the constants follows the tile that mwx_log_mel_tile reports.

#include <cuda_runtime.h>

namespace {

constexpr int kFft = 400;
constexpr int kHop = 160;
constexpr int kFreqs = kFft / 2 + 1;        // 201
constexpr int kFoldRows = kFft / 2;         // taps 1..200 (sine: 1..199, 0)
constexpr int kCols = kFft / 4 + 1;         // 101: bins 0..100 (and 200 - f)
constexpr int kMaxMels = 128;               // the band table's room
constexpr int kBandWidth = 16;              // the widest band it takes

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// TM frames x TN frequencies a thread; two halves of GX x GY threads, a
// warp LX of them along the frequencies; KC constant rows a chunk (KC / 2
// of each parity of k), STAGES chunks in the ring.
template <int TM_, int TN_, int GX_, int GY_, int LX_, int KC_, int STAGES_>
struct MelCfg {
  static constexpr int TM = TM_, TN = TN_, GX = GX_, GY = GY_, LX = LX_;
  static constexpr int KC = KC_, kStages = STAGES_;
  static constexpr int kHalfThreads = GX * GY;
  static constexpr int kThreads = 2 * kHalfThreads;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kFrames = TM * GY;
  static constexpr int kPlanes = (TN + 3) / 4;
  static constexpr int kRow = kPlanes * GX * 4;          // a packed row
  static constexpr int kChunks = kFoldRows / KC;         // chunks a product
  // fold rows: a multiple of 4 floats for float4 loads of TM % 4 == 0
  // frames, else of 2; not of 32, so the fold pass's stores spread
  static constexpr int kFoldStride = kFrames + (TM % 4 == 0 ? 4 : 2);
  static constexpr int kFoldFloats = kFoldRows * kFoldStride;
  static constexpr int kExchangeFloats = 2 * kFrames * kCols;
  static constexpr int kPowerFloats = kFrames * kFreqs;  // [frame][freq]
  static constexpr int kTileStride = kFrames + 1;        // [mel][frame]
  static constexpr int kTileFloats = kMaxMels * kTileStride;
  static constexpr int kSpan = (kFrames - 1) * kHop + kFft;   // samples
  // region A: the cosine fold, the sine fold, the halves' exchange, then
  // the output tile; region B: the block's audio, then the power spectrum
  static constexpr int kRegionA =
      (cmax(kFoldFloats, cmax(kExchangeFloats, kTileFloats)) + 3) / 4 * 4;
  static constexpr int kRegionB = (cmax(kSpan, kPowerFloats) + 3) / 4 * 4;
  static constexpr int kRingFloats = kStages * KC * kRow;
  static constexpr int kBandFloats = kMaxMels * (kBandWidth + 1);
  static constexpr int kBytes =
      (kRegionA + kRegionB + kRingFloats + kBandFloats) * 4;
  static_assert(GX * TN >= kCols, "the frequency tile must cover 101");
  static_assert(kFoldRows % KC == 0 && KC % 2 == 0,
                "KC must be even and divide 200");
  static_assert(TM % 2 == 0, "frames are loaded in pairs");
  static_assert(32 % LX == 0 && GX % LX == 0 && GY % (32 / LX) == 0,
                "a warp must tile a half's thread grid");
  static_assert(kStages >= 2, "the ring needs two slots");
  static_assert(kBytes <= 232448, "over the shared memory of a block");
};

__device__ __forceinline__ int reflect(int j, int n) {
  if (j < 0) j = -j;
  if (j >= n) j = 2 * (n - 1) - j;
  return j;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Chunk q of the walk (q < kChunks: the cosine's rows, then the sine's),
// KC packed rows, into ring slot q % kStages.  Commits one cp.async group,
// empty past the last chunk.
template <class C>
__device__ __forceinline__ void stage_chunk(float* ring, const float* cos_p,
                                            const float* sin_p, int q) {
  if (q < 2 * C::kChunks) {
    const float* src = (q < C::kChunks ? cos_p : sin_p)
                       + (q % C::kChunks) * C::KC * C::kRow;
    float* dst = ring + (q % C::kStages) * C::KC * C::kRow;
    for (int i = threadIdx.x * 4; i < C::KC * C::kRow; i += C::kThreads * 4)
      cp_async16(dst + i, src + i);
  }
  cp_async_commit();
}

// acc[i][s] += sum over every other row of a chunk (a and w point at this
// half's first) of a[r][i] * w[r][s]: TM samples and the thread's TN
// constants (packed, in the ring) loaded a row, TM * TN FMAs.
template <class C>
__device__ __forceinline__ void chunk_product(float (&acc)[C::TM][C::TN],
                                              const float* a,
                                              const float* w) {
#pragma unroll
  for (int r = 0; r < C::KC; r += 2) {
    float av[C::TM], wv[C::kPlanes * 4];
    if constexpr (C::TM % 4 == 0) {
#pragma unroll
      for (int i = 0; i < C::TM; i += 4) {
        const float4 v =
            *reinterpret_cast<const float4*>(a + r * C::kFoldStride + i);
        av[i] = v.x; av[i + 1] = v.y; av[i + 2] = v.z; av[i + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < C::TM; i += 2) {
        const float2 v =
            *reinterpret_cast<const float2*>(a + r * C::kFoldStride + i);
        av[i] = v.x; av[i + 1] = v.y;
      }
    }
#pragma unroll
    for (int p = 0; p < C::kPlanes; ++p) {
      const float4* src = reinterpret_cast<const float4*>(
          w + r * C::kRow + p * C::GX * 4);
      const float4 v = *src;
      wv[4 * p] = v.x; wv[4 * p + 1] = v.y;
      wv[4 * p + 2] = v.z; wv[4 * p + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int s = 0; s < C::TN; ++s)
        acc[i][s] = fmaf(av[i], wv[s], acc[i][s]);
  }
}

// The halves' sums meet in shared memory (x: [2][kFrames][101]).  Half 1
// holds P, the sum over even taps k, half 0 Q, over odd ones; afterwards
// half 1 holds P + Q, the spectrum at its frequencies f <= 100, and half 0
// P - Q, at 200 - f (the sine's up to its sign, which the power drops).
template <class C>
__device__ __forceinline__ void meet(float (&acc)[C::TM][C::TN], float* x,
                                     int half, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int s = 0; s < C::TN; ++s) {
      const int f = tx * C::TN + s;
      if (f < kCols) x[(half * C::kFrames + ty * C::TM + i) * kCols + f] =
          acc[i][s];
    }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int s = 0; s < C::TN; ++s) {
      const int f = tx * C::TN + s;
      if (f < kCols) {
        const float other =
            x[((1 - half) * C::kFrames + ty * C::TM + i) * kCols + f];
        acc[i][s] = half ? acc[i][s] + other : other - acc[i][s];
      }
    }
}

// One fold of the block's audio span (padded samples from f0 * 160 on)
// into fold [200][kFoldStride]: row k - 1, frame j holds x[k] + x[400-k]
// (sign 1; k = 200: x[200]) or x[k] - x[400-k] (sign -1; k = 200: 0).
template <class C>
__device__ __forceinline__ void fold_span(float* fold, const float* span,
                                          float sign) {
  for (int i = threadIdx.x; i < kFoldRows * C::kFrames; i += C::kThreads) {
    const int k = i % kFoldRows + 1, j = i / kFoldRows;
    const float x = span[j * kHop + k];
    const float y = k < kFft / 2 ? span[j * kHop + kFft - k] : 0.f;
    fold[(k - 1) * C::kFoldStride + j] =
        k < kFft / 2 || sign > 0.f ? fmaf(sign, y, x) : 0.f;
  }
}

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
log_mel_kernel(const float* __restrict__ audio,
               const float* __restrict__ cos_p,
               const float* __restrict__ sin_p,
               const int4* __restrict__ bands,
               const float* __restrict__ weights, float* __restrict__ out,
               int n_samples, int n_frames, int n_mels) {
  extern __shared__ __align__(16) float smem[];
  float* fold = smem;                  // [200][kFoldStride]: cosine, sine
  float* exchange = smem;              // then [2][kFrames][101]
  float* tile = smem;                  // then [n_mels][kTileStride]
  float* span = smem + C::kRegionA;    // [kSpan] padded samples
  float* power = span;                 // then [kFrames][201]
  float* ring = span + C::kRegionB;    // [kStages][KC][kRow]
  float* band_w = ring + C::kRingFloats;               // [n_mels][16]
  int* band_lo = reinterpret_cast<int*>(band_w + kMaxMels * kBandWidth);
  const int tid = threadIdx.x;
  const int half = tid / C::kHalfThreads, t = tid % C::kHalfThreads;
  const int warp = t / 32, lane = t % 32;
  constexpr int kLY = 32 / C::LX, kWX = C::GX / C::LX;
  const int tx = (warp % kWX) * C::LX + lane % C::LX;
  const int ty = (warp / kWX) * kLY + lane / C::LX;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * C::kFrames;
  const float* row = audio + (size_t)b * n_samples;

  // the first chunks' copies; the band table (each band's weights at the
  // start of the window of 4 * nq bins, the widest band's rounded up, that
  // the filterbank reads, moved down where it would pass bin 200); the
  // block's audio span, padded index p at sample p - 200 reflected at both
  // ends (numpy/torch "reflect", edge excluded), all loads in flight
  // before the first store
#pragma unroll
  for (int q = 0; q < C::kStages - 1; ++q)
    stage_chunk<C>(ring, cos_p, sin_p, q);
  const int nq = (__ldg(bands).w + 3) / 4;
  for (int i = tid; i < n_mels * kBandWidth; i += C::kThreads) {
    const int4 band = __ldg(bands + i / kBandWidth);   // bin, bins, offset
    const int start = min(band.x, kFreqs - 4 * nq);
    const int k = i % kBandWidth - (band.x - start);
    band_w[i] = k >= 0 && k < band.y ? __ldg(weights + band.z + k) : 0.f;
    if (i % kBandWidth == 0) band_lo[i / kBandWidth] = start;
  }
  {
    constexpr int kPer = (C::kSpan + C::kThreads - 1) / C::kThreads;
    const int p0 = f0 * kHop - kFft / 2;
    const int p_end = min(C::kSpan, (n_frames - f0 - 1) * kHop + kFft);
    float xs[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = u * C::kThreads + tid;
      xs[u] = i < p_end ? __ldg(row + reflect(p0 + i, n_samples)) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = u * C::kThreads + tid;
      if (i < C::kSpan) span[i] = xs[u];
    }
  }
  __syncthreads();
  fold_span<C>(fold, span, 1.f);       // the cosine fold: x[k] + x[400-k]

  // the two folded products as one walk over 2 * kChunks chunks through
  // the ring (chunk q + kStages - 1 is copied while chunk q is
  // multiplied), each half taking the rows of its parity of k: fold row r
  // is tap r + 1, so half 0 takes the odd taps.  The cosine sums wait in
  // `held` while the sine fold replaces the cosine fold.
  float acc[C::TM][C::TN], held[C::TM][C::TN];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int s = 0; s < C::TN; ++s) acc[i][s] = 0.f;
  for (int q = 0; q < 2 * C::kChunks; ++q) {
    cp_async_wait<C::kStages - 2>();   // this thread's copies of chunk q
    __syncthreads();                   // everyone's, and slot q - 1 is free
    if (q == C::kChunks) {             // the cosine product is done
      fold_span<C>(fold, span, -1.f);
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
#pragma unroll
        for (int s = 0; s < C::TN; ++s) {
          held[i][s] = acc[i][s];
          acc[i][s] = 0.f;
        }
      __syncthreads();
    }
    stage_chunk<C>(ring, cos_p, sin_p, q + C::kStages - 1);
    const int r0 = (q % C::kChunks) * C::KC + half;
    const float* a = fold + r0 * C::kFoldStride + ty * C::TM;
    const float* w = ring + (q % C::kStages) * C::KC * C::kRow
                     + half * C::kRow + tx * 4;
    chunk_product<C>(acc, a, w);
  }
  __syncthreads();                     // the exchange's region is free
  meet<C>(held, exchange, half, tx, ty);
  __syncthreads();
  meet<C>(acc, exchange, half, tx, ty);
  // power = re^2 + im^2; half 0 leaves bin 100 (its own mirror) to half 1
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int s = 0; s < C::TN; ++s) {
      const int c = tx * C::TN + s;
      if (half ? c < kCols : c < kCols - 1)
        power[(ty * C::TM + i) * kFreqs + (half ? c : kFft / 2 - c)] =
            held[i][s] * held[i][s] + acc[i][s] * acc[i][s];
    }
  __syncthreads();

  // filterbank: a warp takes a mel band at a time, its lanes the frames;
  // each (frame, mel) sums the 4 * nq bins of the band's window into the
  // output tile, [mel][frame], then the tile is stored along n_mels
  constexpr int kPerLane = (C::kFrames + 31) / 32;
  for (int m = tid / 32; m < n_mels; m += C::kWarps) {
    const float4* w = reinterpret_cast<const float4*>(band_w
                                                      + m * kBandWidth);
    const float* p = power + band_lo[m] + tid % 32 * kFreqs;
    float sum[kPerLane];
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) sum[u] = 0.f;
#pragma unroll
    for (int g = 0; g < kBandWidth / 4; ++g) {
      if (g < nq) {
        const float4 wg = w[g];
#pragma unroll
        for (int u = 0; u < kPerLane; ++u) {
          if (tid % 32 + 32 * u < C::kFrames) {
            const float* pu = p + 32 * u * kFreqs + 4 * g;
            sum[u] = fmaf(wg.x, pu[0], sum[u]);
            sum[u] = fmaf(wg.y, pu[1], sum[u]);
            sum[u] = fmaf(wg.z, pu[2], sum[u]);
            sum[u] = fmaf(wg.w, pu[3], sum[u]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      const int j = tid % 32 + 32 * u;
      if (j < C::kFrames)
        tile[m * C::kTileStride + j] = log10f(fmaxf(sum[u], 1e-10f));
    }
  }
  __syncthreads();
  const int valid = min(C::kFrames, n_frames - f0);
  int j = tid / n_mels, m = tid % n_mels;
  const int dj = C::kThreads / n_mels, dm = C::kThreads % n_mels;
  for (; j < valid; j += dj, m += dm) {
    if (m >= n_mels) {
      m -= n_mels;
      if (++j >= valid) break;
    }
    out[((size_t)b * n_frames + f0 + j) * n_mels + m] =
        tile[m * C::kTileStride + j];
  }
}

template <class C>
int launch_mel(const void* audio, const void* cos_p, const void* sin_p,
               const void* bands, const void* weights, void* out, int batch,
               int n_samples, int n_frames, int n_mels,
               cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        log_mel_kernel<C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((n_frames + C::kFrames - 1) / C::kFrames, batch);
  log_mel_kernel<C><<<grid, C::kThreads, C::kBytes, stream>>>(
      (const float*)audio, (const float*)cos_p, (const float*)sin_p,
      (const int4*)bands, (const float*)weights, (float*)out, n_samples,
      n_frames, n_mels);
  return (int)cudaGetLastError();
}

// The packing a tile's constants need: {TN, GX} into tile[0..1].
template <class C>
int report_tile(void* tile) {
  static_cast<int*>(tile)[0] = C::TN;
  static_cast<int*>(tile)[1] = C::GX;
  return 0;
}

// 96 frames a block; two halves of 128 threads of 6 frames x 13
// frequencies, a warp 4 frequency groups x 8 frame groups; chunks of 20
// rows, 3 in the ring
using ShippedMel = MelCfg<6, 13, 8, 16, 4, 20, 3>;

}  // namespace

// tile: int[2] <- the frequencies a thread and the threads along them,
// the (tn, gx) for which ops/mel.py `pack_folded` packs mwx_log_mel's
// constants.
extern "C" int mwx_log_mel_tile(void* tile) {
  return report_tile<ShippedMel>(tile);
}

// audio [batch, n_samples] f32; cos_p and sin_p [200, 128] f32: columns
// 0..100 of the folded cosine (rows 1..200) and sine (rows 1..199, then a
// zero row) packed by ops/mel.py `pack_folded` for the reported tile;
// bands [n_mels, 4] int32 (first bin, bins, offset in weights, the widest
// band's bins: at most 16); weights [nnz] f32 -> out [batch, n_frames, n_mels] f32.  Requires
// n_samples > 200 and n_mels <= 128.
extern "C" int mwx_log_mel(const void* audio, const void* cos_p,
                           const void* sin_p, const void* bands,
                           const void* weights, void* out, int batch,
                           int n_samples, int n_frames, int n_mels,
                           void* stream) {
  if (batch <= 0 || n_frames <= 0) return 0;
  if (n_samples <= kFft / 2 || n_mels <= 0 || n_mels > kMaxMels)
    return (int)cudaErrorInvalidValue;
  return launch_mel<ShippedMel>(audio, cos_p, sin_p, bands, weights, out,
                                batch, n_samples, n_frames, n_mels,
                                (cudaStream_t)stream);
}
