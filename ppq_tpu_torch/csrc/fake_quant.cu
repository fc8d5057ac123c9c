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
// ridge of fp32 at 3.35 TB/s. So the design is one pass of 16-byte (float4)
// loads and stores, with several loads in flight a thread before any is
// converted. Tensorwise: a grid-stride loop, the scale and offset kernel
// arguments or one device scalar each.
//
// Channelwise keeps the tensor's own layout, outer * C runs of `inner`
// contiguous floats, run r of channel r % C, so the JAX wrapper's
// transpose and padding are not needed. Two integer divisions and two
// scale loads an element would make the instructions, not the bytes, set
// the pace, so channel_index.cuh's walk (shared with floating.cu) finds the
// channel once a float4 by multiply-high and shift, and element by element
// only where a float4 crosses a run's end (conv1's inner of 147, a bias or
// a Gemm weight on its last axis with inner 1). One launch, no host work
// beyond it, whatever the layout.
//
// Numerics match the JAX reference `x / s` path bit for bit:
//   * division is IEEE round-to-nearest (__fdiv_rn), never a reciprocal;
//   * half-to-even rounding is rintf (roundf rounds half away from zero);
//   * the clip uses comparisons, so a NaN stays a NaN as in jnp.clip;
//   * built without --use_fast_math and with -fmad=false, so no fused
//     multiply-add changes a rounding.
// A tensorwise host offset arrives already rounded (the wrapper rounds it,
// as quantization/qfunction.py does); an offset read from the card, every
// channelwise one included, is rounded here with rintf, which is
// torch.round's and jnp.round's half-to-even.

#include <cuda_runtime.h>
#include <stdint.h>

#include "channel_index.cuh"
#include "rounding.cuh"

using namespace ppq;

namespace {

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
                                         const float* __restrict__ s_dev,
                                         const float* __restrict__ o_dev,
                                         float qmin, float qmax) {
  if (s_dev != nullptr) {  // a scale that lives on the card (LSQ training)
    s = *s_dev;
    o = rintf(*o_dev);
  }
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

// Channelwise, any layout: channel_index.cuh's walk with this op. An
// element of channel c takes scale[c] and rintf(offset[c]), read once a
// float4 that stays in one run.
template <int R, bool CODES>
struct ChannelQuant {
  const float* scale;
  const float* offset;
  float qmin, qmax;

  template <typename Index>
  __device__ __forceinline__ float2 param(Index c) const {
    return make_float2(scale[c], rintf(offset[c]));
  }
  __device__ __forceinline__ float operator()(float x, float2 so) const {
    return quant_one<R, CODES>(x, so.x, so.y, qmin, qmax);
  }
};

template <int R, bool CODES>
void launch_tensor(const float* x, float* y, int64_t n, float s, float o,
                   const float* s_dev, const float* o_dev, float qmin,
                   float qmax, cudaStream_t stream) {
  const int threads = 256;
  int64_t n_vec = (aligned16(x) && aligned16(y)) ? n / 4 : 0;
  int blocks = grid_for(n_vec > 0 ? n_vec : n, threads);
  fake_quant_tensor_kernel<R, CODES><<<blocks, threads, 0, stream>>>(
      x, y, n, n_vec, s, o, s_dev, o_dev, qmin, qmax);
}

template <int R, bool CODES>
void launch_channel(const float* x, float* y, int64_t n, const float* s,
                    const float* o, int64_t channels, int64_t inner,
                    float qmin, float qmax, cudaStream_t stream) {
  launch_channel_walk(x, y, n, channels, inner,
                      ChannelQuant<R, CODES>{s, o, qmin, qmax}, stream);
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
  DISPATCH_ROUNDING(rounding, codes, launch_tensor, x, y, n, s, o, nullptr,
                    nullptr, qmin, qmax, st);
  return (int)cudaGetLastError();
}

// The same kernel with scale and offset read from the card: a trainable
// scale never crosses to the host. The offset is rounded in the kernel.
extern "C" int ppq_fake_quant_tensorwise_dev(const float* x, float* y,
                                             int64_t n, const float* s,
                                             const float* o, float qmin,
                                             float qmax, int rounding,
                                             int codes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (s == nullptr || o == nullptr) return (int)cudaErrorInvalidValue;
  DISPATCH_ROUNDING(rounding, codes, launch_tensor, x, y, n, 1.f, 0.f, s, o,
                    qmin, qmax, st);
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

#ifdef PPQ_MEASURE
// A measurement build only (nvcc -DPPQ_MEASURE, chip_smoke.py --quant): the
// channelwise walk's loads and stores without its arithmetic (y = x; the
// channel it finds goes unused).
struct ChannelCopy {
  template <typename Index>
  __device__ __forceinline__ int param(Index) const { return 0; }
  __device__ __forceinline__ float operator()(float x, int) const { return x; }
};

extern "C" int ppq_fake_quant_channelwise_copy(const float* x, float* y,
                                               int64_t n, int64_t channels,
                                               int64_t inner, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  launch_channel_walk(x, y, n, channels, inner, ChannelCopy{},
                      (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
#endif
