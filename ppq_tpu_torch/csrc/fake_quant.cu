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
// contiguous floats, run r of channel r % C (channel_index.cuh), so the JAX
// wrapper's transpose and padding are not needed. Two integer divisions
// and two scale loads an element would make the instructions, not the
// bytes, set the pace, so a grid-stride loop finds the channel once a
// float4 by multiply-high and shift, and element by element only where a
// float4 crosses a run's end (conv1's inner of 147, a bias or a Gemm
// weight on its last axis with inner 1). One launch, no host work beyond
// it, whatever the layout.
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

constexpr int CHANNEL_THREADS = 256;  // a block of the channelwise kernel
constexpr int LOADS = 4;  // float4 loads a thread has in flight

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

// Four elements of one channel: the scale and the rounded offset are the
// caller's registers.
template <int R, bool CODES>
__device__ __forceinline__ void quant_four(float4& v, float s, float o,
                                           float qmin, float qmax) {
  v.x = quant_one<R, CODES>(v.x, s, o, qmin, qmax);
  v.y = quant_one<R, CODES>(v.y, s, o, qmin, qmax);
  v.z = quant_one<R, CODES>(v.z, s, o, qmin, qmax);
  v.w = quant_one<R, CODES>(v.w, s, o, qmin, qmax);
}

// Channelwise, any layout: a grid-stride loop over float4s, a thread's LOADS
// of them a grid apart and in flight together (a tensor smaller than the
// grid gives each thread one, over as many SMs as it fills). The channel is
// found once a float4 (two multiply-highs, channel_index.cuh); only a float4
// that crosses a run's end (inner not a multiple of 4, or below 4) steps
// element by element. QUANT false is a measurement build's variant: the
// loads and stores alone (y = x).
template <int R, bool CODES, typename Div, bool QUANT = true>
__global__ void __launch_bounds__(CHANNEL_THREADS)
fake_quant_channel_kernel(const float* __restrict__ x, float* __restrict__ y,
                       typename IndexOf<Div>::type n,
                       typename IndexOf<Div>::type n_vec,
                       const float* __restrict__ scale,
                       const float* __restrict__ offset, ChannelIndex<Div> at,
                       float qmin, float qmax) {
  using Index = typename IndexOf<Div>::type;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* y4 = reinterpret_cast<float4*>(y);
  const Index grid = (Index)gridDim.x * CHANNEL_THREADS;
  for (Index base = (Index)blockIdx.x * CHANNEL_THREADS + threadIdx.x;
       base < n_vec; base += grid * LOADS) {
    float4 v[LOADS];
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
      const Index j = base + k * grid;
      if (j < n_vec) v[k] = x4[j];
    }
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
      const Index j = base + k * grid;
      if (j >= n_vec) continue;
      if (!QUANT) {
        y4[j] = v[k];
        continue;
      }
      Index c, w;
      at.locate(j * 4, c, w);
      if (w + 3 < at.inner.d) {
        quant_four<R, CODES>(v[k], scale[c], rintf(offset[c]), qmin, qmax);
      } else {
        float* e = reinterpret_cast<float*>(&v[k]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q > 0) at.step(c, w);
          e[q] = quant_one<R, CODES>(e[q], scale[c], rintf(offset[c]), qmin,
                                     qmax);
        }
      }
      y4[j] = v[k];
    }
  }
  // the tail, or every element when x or y is not 16-byte aligned
  for (Index i = n_vec * 4 + (Index)blockIdx.x * CHANNEL_THREADS + threadIdx.x;
       i < n; i += grid) {
    if (!QUANT) {
      y[i] = x[i];
      continue;
    }
    const Index c = at.channel(i);
    y[i] = quant_one<R, CODES>(x[i], scale[c], rintf(offset[c]), qmin, qmax);
  }
}

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

// QUANT false: the measurement build's copy variant.
template <int R, bool CODES, bool QUANT = true>
void launch_channel(const float* x, float* y, int64_t n, const float* s,
                    const float* o, int64_t channels, int64_t inner,
                    float qmin, float qmax, cudaStream_t stream) {
  const bool aligned = aligned16(x) && aligned16(y);
  const int64_t n_vec = aligned ? n / 4 : 0;
  // one float4 a thread up to one wave of the card (8 blocks an SM), then
  // up to LOADS
  int64_t blocks =
      ((n_vec > 0 ? n_vec : n) + CHANNEL_THREADS - 1) / CHANNEL_THREADS;
  if (blocks > 8 * (int64_t)sm_count()) blocks = 8 * (int64_t)sm_count();
  if (n < INT32_MAX) {
    ChannelIndex<FastDiv32> at{FastDiv32::make((uint32_t)inner),
                               FastDiv32::make((uint32_t)channels)};
    fake_quant_channel_kernel<R, CODES, FastDiv32, QUANT>
        <<<(int)blocks, CHANNEL_THREADS, 0, stream>>>(x, y, (uint32_t)n,
                                              (uint32_t)n_vec, s, o, at, qmin,
                                              qmax);
  } else {
    ChannelIndex<PlainDiv64> at{PlainDiv64::make((uint64_t)inner),
                                PlainDiv64::make((uint64_t)channels)};
    fake_quant_channel_kernel<R, CODES, PlainDiv64, QUANT>
        <<<(int)blocks, CHANNEL_THREADS, 0, stream>>>(x, y, (uint64_t)n,
                                              (uint64_t)n_vec, s, o, at, qmin,
                                              qmax);
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
// channelwise kernel's loads and stores without its arithmetic (y = x).
extern "C" int ppq_fake_quant_channelwise_copy(const float* x, float* y,
                                               int64_t n, int64_t channels,
                                               int64_t inner, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  launch_channel<HALF_EVEN, false, false>(x, y, n, nullptr, nullptr, channels,
                                          inner, 0.f, 0.f,
                                          (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
#endif
