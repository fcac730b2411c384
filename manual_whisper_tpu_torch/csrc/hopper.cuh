// Shared by the Hopper kernels (K2 to K6): shared-memory and cluster
// barriers, the Tensor Memory Accelerator (TMA), warpgroup products
// (wgmma; TF32 ones and the hi/lo split for K2 in float32), and tensor
// maps encoded on the host without a link against libcuda.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(arrivals) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// The thread announces `bytes` of TMA traffic to `bar` and arrives at it.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of `bar` with this parity has completed.  The last
// operand lets the hardware suspend the warp for up to that many
// nanoseconds while the phase is open.  A wait that never ends is a fault
// in the kernel's schedule: trap and let the launch fail rather than hang
// the device.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (int spin = 0; !done; ++spin) {
    asm volatile("{\n"
                 ".reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
                 "selp.u32 %0, 1, 0, p;\n"
                 "}\n"
                 : "=r"(done)
                 : "r"(bar), "r"(parity), "r"(1000000)
                 : "memory");
    if (spin > 2000) __trap();
  }
}

// One thread asks the Tensor Memory Accelerator for the box of `map` at
// (c0, c1), c0 along the contiguous dimension; the bytes land at `dst` and
// are counted at `bar`.  What lies outside the tensor arrives as zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}

// The same for a 3-D map: (c0, c1, c2), c2 the outermost dimension.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

// One thread asks for `bytes` contiguous bytes at `src` in device memory to
// be copied to `dst` in this block's shared memory, counted at `bar`: a
// 1-D bulk copy, no tensor map.  Both addresses and `bytes` are multiples
// of 16.  The bytes are read once: their L2 lines are the first to go.
__device__ __forceinline__ void bulk_load_once(uint32_t dst, const void* src,
                                               int bytes, uint32_t bar) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

// One thread stores the box at `src` to `map` at (c0, c1, c2) and waits
// until the TMA has read it (the shared memory may then be reused or
// released).  What falls outside the tensor is not written.  The threads
// that wrote the box must have run fence_async_proxy() and met this one
// at a barrier first.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n"
      "cp.async.bulk.commit_group;\n"
      "cp.async.bulk.wait_group.read 0;\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2)
      : "memory");
}

// Stores of this thread to shared memory become visible to the tensor
// cores' and the TMA's asynchronous reads.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The cluster barrier in halves.  A block may store to another block's
// shared memory only once that block runs and has set up its barriers:
// each thread arrives (relaxed: it orders nothing; the barriers' set-up is
// published by fence_mbarrier_init) when it starts and waits before its
// first such store, so the wait costs nothing by then.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Makes this thread's mbarrier_init visible to the cluster.
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The address of this block's shared `addr` in the shared memory of block
// `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Stores v at `addr` in another block's shared memory (a cluster_addr)
// and counts its 4 bytes at that block's mbarrier `bar`: the receiver
// waits on its own barrier, for exactly the bytes it expects, and no
// barrier across the cluster is needed.
__device__ __forceinline__ void st_async(uint32_t addr, float v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n"
      :: "r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

// Layout types of a shared-memory matrix descriptor (bits 62-63).
constexpr int kSwizzle128 = 1;
constexpr int kSwizzle64 = 2;

// Shared-memory matrix descriptor of a warpgroup product: start address,
// leading and stride byte offsets (each stored in 16-byte units) and the
// swizzle; the tiles are aligned to their swizzle atom, so the base offset
// is 0.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo,
                                              int layout = kSwizzle128) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | (uint64_t)layout << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// ---- TF32 products (K2 in float32: 3xTF32) --------------------------------

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero: a
// float32 bit pattern whose low 13 bits are zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// x as hi + lo, both TF32: hi = rna(x), lo = rna(x - hi) (x - hi is exact
// in float32); |x - hi - lo| <= 2^-22 |x|.  Three TF32 products, hi hi +
// hi lo + lo hi, then give a float32-class product: the dropped lo lo is
// below 2^-22 of it.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d[64, 64] (+)= a[64, 8] b[64, 8]^T in TF32 for one warpgroup, both
// operands K-major in shared memory (TF32 products take no transpose
// flag).  d[j] is the fragment of columns [8 j, 8 j + 8): rows 16 (warp %
// 4) + lane / 4 and + 8, columns 2 (lane % 4) + {0, 1}.
__device__ __forceinline__ void wgmma_tf32(float (&d)[8][4], uint64_t desc_a,
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64, 64] (+)= a[64, 8] b[64, 8]^T in TF32, a in registers: four TF32
// values a thread, rows lane / 4 and + 8 of the warp's 16 (a[0], a[2] and
// a[1], a[3]), columns lane % 4 (a[0], a[1]) and + 4 (a[2], a[3]); b
// K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[8][4],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

// The same at n = 32: d[64, 32] (+)= a[64, 8] b[32, 8]^T.
__device__ __forceinline__ void wgmma_tf32(float (&d)[4][4],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

// The SMs of the current device (132 on an H100 SXM).
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

// cuTensorMapEncodeTiled, fetched through the runtime so that the library
// needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor map of a row-major [depth, rows, cols] array (rank 3) or
// [rows, cols] matrix (rank 2, depth ignored), boxes of [1, box_rows,
// box_cols]; what a box holds outside the array, or past `rows` within its
// own depth index, reads as zero and is not written by a store.
bool encode_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                const void* ptr, int rank, int depth, int rows, int cols,
                int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)depth};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * elem_bytes,
                                 (cuuint64_t)rows * cols * elem_bytes};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, type, rank, const_cast<void*>(ptr), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Tensor map of a row-major [rows, cols] matrix, boxes of
// [box_rows, box_cols].
bool make_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
              const void* ptr, int rows, int cols, int box_rows, int box_cols,
              CUtensorMapSwizzle swizzle) {
  return encode_map(map, type, elem_bytes, ptr, 2, 1, rows, cols, box_rows,
                    box_cols, swizzle);
}

// Tensor map of a row-major [depth, rows, cols] array, boxes of
// [1, box_rows, box_cols].
bool make_map_3d(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                 const void* ptr, int depth, int rows, int cols, int box_rows,
                 int box_cols, CUtensorMapSwizzle swizzle) {
  return encode_map(map, type, elem_bytes, ptr, 3, depth, rows, cols,
                    box_rows, box_cols, swizzle);
}

}  // namespace
