// The seven rounding policies of the linear fake-quant kernels, shared by
// the forward (fake_quant.cu) and the backward (fake_quant_bwd.cu) so that
// both round a quotient to the same integer.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ppq {

// Codes of ppq_tpu_torch/kernels/quant.py ROUNDING_CODES.
enum Rounding {
  HALF_EVEN = 0,
  HALF_UP = 1,
  HALF_DOWN = 2,
  HALF_TOWARDS_ZERO = 3,
  HALF_FAR_FROM_ZERO = 4,
  UP = 5,
  DOWN = 6,
};

__device__ __forceinline__ float sign_of(float v) {
  return (v > 0.f ? 1.f : 0.f) - (v < 0.f ? 1.f : 0.f);
}

template <int R>
__device__ __forceinline__ float round_value(float v) {
  if (R == HALF_EVEN) return rintf(v);
  if (R == HALF_UP) return floorf(v + 0.5f);
  if (R == HALF_DOWN) return ceilf(v - 0.5f);
  if (R == HALF_TOWARDS_ZERO) return sign_of(v) * ceilf(fabsf(v) - 0.5f);
  if (R == HALF_FAR_FROM_ZERO) return sign_of(v) * floorf(fabsf(v) + 0.5f);
  if (R == UP) return ceilf(v);
  return floorf(v);
}

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

// Blocks of `threads` for `work` items in a grid-stride loop: enough to fill
// the card, no more than 32 per SM.
inline int grid_for(int64_t work, int threads) {
  int64_t blocks = (work + threads - 1) / threads;
  int64_t cap = (int64_t)sm_count() * 32;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace ppq
