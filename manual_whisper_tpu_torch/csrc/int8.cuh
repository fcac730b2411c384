// Shared by the int8 kernels (K5, K6): widen 16 int8 values of one 16-byte
// load to float32 (exact).
#pragma once

#include <cuda_runtime.h>

__device__ inline void unpack16_i8(const uint4& u, float* f) {
  const char4* c = reinterpret_cast<const char4*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[4 * i] = (float)c[i].x;
    f[4 * i + 1] = (float)c[i].y;
    f[4 * i + 2] = (float)c[i].z;
    f[4 * i + 3] = (float)c[i].w;
  }
}
