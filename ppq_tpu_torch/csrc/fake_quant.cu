// Linear fake-quant forward, tensorwise and channelwise, for sm_90a.
//
// Replaces the TPU kernels of ppq_tpu/kernels/quant.py: `_quant_fwd_t_kernel`
// (tensorwise, reached through `pallas_linear_quant`) and `_quant_fwd_c_kernel`
// (channelwise, reached through `_channelwise_fwd`).
//
//   y = (clip(round(x / s) + o, qmin, qmax) - o) * s      (codes: y = q - o)
//
// What bounds it on an H100: device memory. Each element is read once and
// written once (8 bytes) for a handful of flops, far below the ~20 flop/byte
// ridge of fp32 at 3.35 TB/s. So the design is one pass: 16-byte (float4)
// loads and stores, a grid-stride loop over enough blocks to fill the card,
// and the scale and offset as kernel arguments (tensorwise) or read from a
// small device vector that stays in L1/L2 (channelwise).
//
// Channelwise keeps the tensor's own layout: the channel of flat index i is
// (i / inner) % C, so the JAX wrapper's transpose and padding are not needed.
//
// Numerics match the JAX reference `x / s` path bit for bit:
//   * division is IEEE round-to-nearest (__fdiv_rn), never a reciprocal;
//   * half-to-even rounding is rintf (roundf rounds half away from zero);
//   * the clip uses comparisons, so a NaN stays a NaN as in jnp.clip;
//   * built without --use_fast_math and with -fmad=false, so no fused
//     multiply-add changes a rounding.
// The offset arrives already rounded (the wrapper rounds it, as
// quantization/qfunction.py does).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <int R, bool CODES>
__device__ __forceinline__ float quant_one(float x, float s, float o,
                                           float qmin, float qmax) {
  float q = round_value<R>(__fdiv_rn(x, s)) + o;
  q = q < qmin ? qmin : q;  // a NaN compares false and stays a NaN
  q = q > qmax ? qmax : q;
  float c = q - o;
  return CODES ? c : c * s;
}

template <int R, bool CODES>
__global__ void fake_quant_tensor_kernel(const float* __restrict__ x,
                                         float* __restrict__ y, int64_t n,
                                         int64_t n_vec, float s, float o,
                                         float qmin, float qmax) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t start = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* y4 = reinterpret_cast<float4*>(y);
  for (int64_t i = start; i < n_vec; i += stride) {
    float4 v = x4[i];
    v.x = quant_one<R, CODES>(v.x, s, o, qmin, qmax);
    v.y = quant_one<R, CODES>(v.y, s, o, qmin, qmax);
    v.z = quant_one<R, CODES>(v.z, s, o, qmin, qmax);
    v.w = quant_one<R, CODES>(v.w, s, o, qmin, qmax);
    y4[i] = v;
  }
  for (int64_t i = n_vec * 4 + start; i < n; i += stride)
    y[i] = quant_one<R, CODES>(x[i], s, o, qmin, qmax);
}

template <int R, bool CODES, typename Index>
__global__ void fake_quant_channel_kernel(const float* __restrict__ x,
                                          float* __restrict__ y, Index n,
                                          Index n_vec,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ offset,
                                          Index channels, Index inner,
                                          float qmin, float qmax) {
  const Index stride = (Index)gridDim.x * blockDim.x;
  const Index start = (Index)blockIdx.x * blockDim.x + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* y4 = reinterpret_cast<float4*>(y);
  for (Index i = start; i < n_vec; i += stride) {
    float4 v = x4[i];
    float* e = reinterpret_cast<float*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      Index c = ((i * 4 + k) / inner) % channels;
      e[k] = quant_one<R, CODES>(e[k], scale[c], offset[c], qmin, qmax);
    }
    y4[i] = v;
  }
  for (Index i = n_vec * 4 + start; i < n; i += stride) {
    Index c = (i / inner) % channels;
    y[i] = quant_one<R, CODES>(x[i], scale[c], offset[c], qmin, qmax);
  }
}

int grid_for(int64_t work, int threads) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  int64_t blocks = (work + threads - 1) / threads;
  int64_t cap = (int64_t)sms * 32;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <int R, bool CODES>
void launch_tensor(const float* x, float* y, int64_t n, float s, float o,
                   float qmin, float qmax, cudaStream_t stream) {
  const int threads = 256;
  int64_t n_vec = (aligned16(x) && aligned16(y)) ? n / 4 : 0;
  int blocks = grid_for(n_vec > 0 ? n_vec : n, threads);
  fake_quant_tensor_kernel<R, CODES><<<blocks, threads, 0, stream>>>(
      x, y, n, n_vec, s, o, qmin, qmax);
}

template <int R, bool CODES>
void launch_channel(const float* x, float* y, int64_t n, const float* s,
                    const float* o, int64_t channels, int64_t inner,
                    float qmin, float qmax, cudaStream_t stream) {
  const int threads = 256;
  int64_t n_vec = (aligned16(x) && aligned16(y)) ? n / 4 : 0;
  int blocks = grid_for(n_vec > 0 ? n_vec : n, threads);
  // 32-bit index arithmetic when it fits: 64-bit division is slow
  if (n < (int64_t)UINT32_MAX - (int64_t)blocks * threads * 4) {
    fake_quant_channel_kernel<R, CODES, uint32_t><<<blocks, threads, 0, stream>>>(
        x, y, (uint32_t)n, (uint32_t)n_vec, s, o, (uint32_t)channels,
        (uint32_t)inner, qmin, qmax);
  } else {
    fake_quant_channel_kernel<R, CODES, uint64_t><<<blocks, threads, 0, stream>>>(
        x, y, (uint64_t)n, (uint64_t)n_vec, s, o, (uint64_t)channels,
        (uint64_t)inner, qmin, qmax);
  }
}

#define DISPATCH_ROUNDING(rounding, codes, FN, ...)                \
  switch (rounding) {                                              \
    case HALF_EVEN:                                                \
      codes ? FN<HALF_EVEN, true>(__VA_ARGS__)                     \
            : FN<HALF_EVEN, false>(__VA_ARGS__);                   \
      break;                                                       \
    case HALF_UP:                                                  \
      codes ? FN<HALF_UP, true>(__VA_ARGS__)                       \
            : FN<HALF_UP, false>(__VA_ARGS__);                     \
      break;                                                       \
    case HALF_DOWN:                                                \
      codes ? FN<HALF_DOWN, true>(__VA_ARGS__)                     \
            : FN<HALF_DOWN, false>(__VA_ARGS__);                   \
      break;                                                       \
    case HALF_TOWARDS_ZERO:                                        \
      codes ? FN<HALF_TOWARDS_ZERO, true>(__VA_ARGS__)             \
            : FN<HALF_TOWARDS_ZERO, false>(__VA_ARGS__);           \
      break;                                                       \
    case HALF_FAR_FROM_ZERO:                                       \
      codes ? FN<HALF_FAR_FROM_ZERO, true>(__VA_ARGS__)            \
            : FN<HALF_FAR_FROM_ZERO, false>(__VA_ARGS__);          \
      break;                                                       \
    case UP:                                                       \
      codes ? FN<UP, true>(__VA_ARGS__) : FN<UP, false>(__VA_ARGS__); \
      break;                                                       \
    case DOWN:                                                     \
      codes ? FN<DOWN, true>(__VA_ARGS__)                          \
            : FN<DOWN, false>(__VA_ARGS__);                        \
      break;                                                       \
    default:                                                       \
      return (int)cudaErrorInvalidValue;                           \
  }

}  // namespace

extern "C" int ppq_fake_quant_tensorwise(const float* x, float* y, int64_t n,
                                         float s, float o, float qmin,
                                         float qmax, int rounding, int codes,
                                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  DISPATCH_ROUNDING(rounding, codes, launch_tensor, x, y, n, s, o, qmin, qmax,
                    st);
  return (int)cudaGetLastError();
}

extern "C" int ppq_fake_quant_channelwise(const float* x, float* y, int64_t n,
                                          const float* s, const float* o,
                                          int64_t channels, int64_t inner,
                                          float qmin, float qmax, int rounding,
                                          int codes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  DISPATCH_ROUNDING(rounding, codes, launch_channel, x, y, n, s, o, channels,
                    inner, qmin, qmax, st);
  return (int)cudaGetLastError();
}
