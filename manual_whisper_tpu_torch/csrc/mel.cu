// K1: fused Whisper log-mel frontend for Hopper (sm_90a).
//
// Replaces `_mel_kernel` / `unnormalized_log_mel_pallas` of
// manual_whisper_tpu/ops/mel_pallas.py.  Computes, per frame f of each batch
// row, log10(max(mel, 1e-10)) with
//   spec  = frame[f, 0:400] @ dft[400, 402]        (Hann window fused in)
//   power = re^2 + im^2                            [201]
//   mel   = power @ filters[201, n_mels]
// in float32 (no TF32: the 400-term sums feed a log10, which amplifies
// error near the 1e-10 floor).
//
// Unlike the TPU kernel, this one builds the frames itself: frame f is
// samples [f*160 - 200, f*160 + 200) of the audio with reflect padding
// applied by index, so the [B, F, 400] frame tensor is never written, and
// any frame count is accepted (the TPU's 600-frame blocks were a VMEM
// tiling constraint).
//
// Bound on the H100: about 2*F*(400*402 + 201*n_mels) float32 operations
// against (T + F*n_mels)*4 bytes per row, so it is bound by the f32 (non
// tensor-core) rate.  Design: one block per 32 frames; the audio span of
// those frames sits in shared memory and each of 201 threads accumulates
// the real and imaginary parts of one frequency for all 32 frames in
// registers, reading each DFT column element once per block.  The power
// spectrum then replaces the audio in shared memory for the filterbank.

#include <cuda_runtime.h>

namespace {

constexpr int kFft = 400;
constexpr int kHop = 160;
constexpr int kFreqs = kFft / 2 + 1;           // 201
constexpr int kFramesPerBlock = 32;
constexpr int kFramesPerItem = 8;              // filterbank register tile
constexpr int kThreads = 256;
constexpr int kSpan = (kFramesPerBlock - 1) * kHop + kFft;   // 5360 samples
constexpr int kPower = kFramesPerBlock * kFreqs;             // 6432 floats
constexpr int kSmem = kSpan > kPower ? kSpan : kPower;

__global__ void __launch_bounds__(kThreads)
log_mel_kernel(const float* __restrict__ audio, const float* __restrict__ dft,
               const float* __restrict__ filters, float* __restrict__ out,
               int n_samples, int n_frames, int n_mels) {
  __shared__ float buf[kSmem];
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kFramesPerBlock;
  const int tid = threadIdx.x;
  const float* row = audio + (size_t)b * n_samples;

  // audio span in reflect-padded coordinates: padded index p is sample
  // p - 200, mirrored at both ends (numpy/torch "reflect", edge excluded)
  const int padded_len = n_samples + kFft;
  for (int i = tid; i < kSpan; i += kThreads) {
    const int p = f0 * kHop + i;
    float x = 0.f;
    if (p < padded_len) {
      int j = p - kFft / 2;
      if (j < 0) j = -j;
      if (j >= n_samples) j = 2 * (n_samples - 1) - j;
      x = row[j];
    }
    buf[i] = x;
  }
  __syncthreads();

  float re[kFramesPerBlock], im[kFramesPerBlock];
#pragma unroll
  for (int f = 0; f < kFramesPerBlock; ++f) re[f] = im[f] = 0.f;
  const int c = tid;
  if (c < kFreqs) {
    for (int k = 0; k < kFft; ++k) {
      const float d_re = dft[k * 2 * kFreqs + c];
      const float d_im = dft[k * 2 * kFreqs + kFreqs + c];
#pragma unroll
      for (int f = 0; f < kFramesPerBlock; ++f) {
        const float x = buf[f * kHop + k];
        re[f] = fmaf(x, d_re, re[f]);
        im[f] = fmaf(x, d_im, im[f]);
      }
    }
  }
  __syncthreads();                       // every thread is done with audio
  if (c < kFreqs) {
#pragma unroll
    for (int f = 0; f < kFramesPerBlock; ++f)
      buf[f * kFreqs + c] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  const int groups = kFramesPerBlock / kFramesPerItem;
  for (int item = tid; item < n_mels * groups; item += kThreads) {
    const int m = item % n_mels;
    const int g = item / n_mels;
    float acc[kFramesPerItem];
#pragma unroll
    for (int i = 0; i < kFramesPerItem; ++i) acc[i] = 0.f;
    for (int fr = 0; fr < kFreqs; ++fr) {
      const float w = filters[fr * n_mels + m];
#pragma unroll
      for (int i = 0; i < kFramesPerItem; ++i)
        acc[i] = fmaf(buf[(g * kFramesPerItem + i) * kFreqs + fr], w, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < kFramesPerItem; ++i) {
      const int f = f0 + g * kFramesPerItem + i;
      if (f < n_frames)
        out[((size_t)b * n_frames + f) * n_mels + m] =
            log10f(fmaxf(acc[i], 1e-10f));
    }
  }
}

}  // namespace

// audio [batch, n_samples] f32, dft [400, 402] f32, filters [201, n_mels]
// f32 -> out [batch, n_frames, n_mels] f32.  Requires n_samples > 200.
extern "C" int mwx_log_mel(const void* audio, const void* dft,
                           const void* filters, void* out, int batch,
                           int n_samples, int n_frames, int n_mels,
                           void* stream) {
  if (batch <= 0 || n_frames <= 0) return 0;
  if (n_samples <= kFft / 2 || n_mels <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((n_frames + kFramesPerBlock - 1) / kFramesPerBlock, batch);
  log_mel_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)audio, (const float*)dft, (const float*)filters,
      (float*)out, n_samples, n_frames, n_mels);
  return (int)cudaGetLastError();
}
