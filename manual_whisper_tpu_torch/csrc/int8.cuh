// int8 codes to bf16, exact: shared by K6's matvec and tile product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Four int8 codes of one word -> two bf16 pairs, exact.  A code c is
// (c & 0x7F) - (c < 0 ? 128 : 0).  A byte b < 128 under the high byte 0x43
// reads as the bf16 128 + b, and the byte 0x80 there as 256.  So one byte
// permute builds 128 + (c & 0x7F) for two codes, another builds 128 or 256
// from their sign bits, and one packed bf16 subtraction leaves the codes.
__device__ __forceinline__ uint32_t sub_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a),
                                   *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&d);
}

__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo,
                                       uint32_t& hi) {
  const uint32_t mag = w & 0x7F7F7F7Fu;
  const uint32_t sgn = w & 0x80808080u;
  lo = sub_bf16x2(__byte_perm(mag, 0x43434343u, 0x5140),
                  __byte_perm(sgn, 0x43434343u, 0x5140));
  hi = sub_bf16x2(__byte_perm(mag, 0x43434343u, 0x5342),
                  __byte_perm(sgn, 0x43434343u, 0x5342));
}

}  // namespace
