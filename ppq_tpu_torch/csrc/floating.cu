// Low-bit floating-point (FP8-style) fake-quant forward, tensorwise and
// channelwise, and its STE backward, for sm_90a.
//
// Replaces the TPU kernels of ppq_tpu/kernels/floating.py: `_fp_fwd_t_kernel`
// and `_fp_fwd_c_kernel` (reached through `pallas_floating_quant`, over
// `_float_round_block`) and `_fp_bwd_t_kernel` (reached through
// `pallas_floating_quant_bwd`).
//
//   forward   y  = float_round(clip(x / s, qmin, qmax)) * s
//   backward  dx = (qmin <= x / s <= qmax) ? g : 0
//
// float_round puts an fp32 value on the grid of a 1-sign / E-exponent /
// M-mantissa float: half-to-even cut of the mantissa on the fp32 bit pattern
// (add half of the dropped field, minus one, plus the bit that stays lowest;
// mask), clamp to +-max_val, and below the smallest normal snap to the
// subnormal grid rint(y / min_sub) * min_sub. The layout's constants arrive
// as arguments (max_val is 448 for E4M3 and 57344 for E5M2).
//
// What bounds them on an H100: device memory (8 bytes per element forward,
// 12 backward, a handful of integer and float operations each). One pass,
// 16-byte loads and stores, a grid-stride loop. The tensorwise scale is a
// kernel argument, or one float read from the card when it is a tensor there.
//
// The channelwise body keeps the tensor's own layout, outer * C runs of
// `inner` contiguous floats, run r of channel r % C, and walks it with the
// linear fake-quant's channelwise walk (channel_index.cuh): a grid-stride
// loop over float4s, several in flight a thread, at most one wave of 8
// blocks an SM; the channel found once a float4 by multiply-high and shift
// and its scale read once a float4; element by element only where a float4
// crosses a run's end; the unaligned tail element by element.
//
// Numerics match the plain version bit for bit: IEEE division (__fdiv_rn),
// clips by comparison (a NaN stays a NaN), rintf for half-to-even,
// -fmad=false. Unsigned 32-bit addition wraps like the int32 arithmetic of
// the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "channel_index.cuh"
#include "rounding.cuh"

using namespace ppq;

namespace {

struct Layout {
  int drop;           // 23 - mantissa bits
  uint32_t half_m1;   // (1 << (drop - 1)) - 1
  uint32_t keep;      // ~((1 << drop) - 1)
  float max_val;
  float min_normal;
  float min_sub;
};

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  v = v < lo ? lo : v;  // a NaN compares false and stays a NaN
  return v > hi ? hi : v;
}

__device__ __forceinline__ float float_round(float v, const Layout& f) {
  const uint32_t bits = __float_as_uint(v);
  const uint32_t lsb = (bits >> f.drop) & 1u;
  float y = __uint_as_float((bits + (f.half_m1 + lsb)) & f.keep);
  y = clip(y, -f.max_val, f.max_val);
  if (fabsf(y) < f.min_normal) y = rintf(__fdiv_rn(y, f.min_sub)) * f.min_sub;
  return y;
}

__device__ __forceinline__ float quant_one(float x, float s, float qmin,
                                           float qmax, const Layout& f) {
  return float_round(clip(__fdiv_rn(x, s), qmin, qmax), f) * s;
}

__global__ void floating_tensor_kernel(const float* __restrict__ x,
                                       float* __restrict__ y, int64_t n,
                                       int64_t n_vec, float s,
                                       const float* __restrict__ s_dev,
                                       float qmin, float qmax, Layout f) {
  if (s_dev != nullptr) s = *s_dev;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t start = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* y4 = reinterpret_cast<float4*>(y);
  for (int64_t i = start; i < n_vec; i += stride) {
    float4 v = x4[i];
    v.x = quant_one(v.x, s, qmin, qmax, f);
    v.y = quant_one(v.y, s, qmin, qmax, f);
    v.z = quant_one(v.z, s, qmin, qmax, f);
    v.w = quant_one(v.w, s, qmin, qmax, f);
    y4[i] = v;
  }
  for (int64_t i = n_vec * 4 + start; i < n; i += stride)
    y[i] = quant_one(x[i], s, qmin, qmax, f);
}

// Channelwise, any layout: channel_index.cuh's walk with this op. An
// element of channel c takes scale[c], read once a float4 that stays in one
// run.
struct ChannelFloating {
  const float* scale;
  float qmin, qmax;
  Layout f;

  template <typename Index>
  __device__ __forceinline__ float param(Index c) const { return scale[c]; }
  __device__ __forceinline__ float operator()(float x, float s) const {
    return quant_one(x, s, qmin, qmax, f);
  }
};

__device__ __forceinline__ float bwd_one(float x, float g, float s,
                                         float qmin, float qmax) {
  const float raw = __fdiv_rn(x, s);
  return (raw >= qmin && raw <= qmax) ? g : 0.f;  // a NaN is outside
}

__global__ void floating_bwd_kernel(const float* __restrict__ x,
                                    const float* __restrict__ g,
                                    float* __restrict__ dx, int64_t n,
                                    int64_t n_vec, float s,
                                    const float* __restrict__ s_dev,
                                    float qmin, float qmax) {
  if (s_dev != nullptr) s = *s_dev;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t start = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* dx4 = reinterpret_cast<float4*>(dx);
  for (int64_t i = start; i < n_vec; i += stride) {
    const float4 xv = x4[i];
    const float4 gv = g4[i];
    float4 d;
    d.x = bwd_one(xv.x, gv.x, s, qmin, qmax);
    d.y = bwd_one(xv.y, gv.y, s, qmin, qmax);
    d.z = bwd_one(xv.z, gv.z, s, qmin, qmax);
    d.w = bwd_one(xv.w, gv.w, s, qmin, qmax);
    dx4[i] = d;
  }
  for (int64_t i = n_vec * 4 + start; i < n; i += stride)
    dx[i] = bwd_one(x[i], g[i], s, qmin, qmax);
}

bool make_layout(int mantissa_bits, float max_val, float min_normal,
                 float min_sub, Layout* f) {
  if (mantissa_bits < 1 || mantissa_bits > 22) return false;
  f->drop = 23 - mantissa_bits;
  f->half_m1 = (1u << (f->drop - 1)) - 1u;
  f->keep = ~((1u << f->drop) - 1u);
  f->max_val = max_val;
  f->min_normal = min_normal;
  f->min_sub = min_sub;
  return true;
}

constexpr int THREADS = 256;

}  // namespace

// s_dev: the scale on the card, or null to take the host number s.
extern "C" int ppq_floating_quant_tensorwise(
    const float* x, float* y, int64_t n, float s, const float* s_dev,
    float qmin, float qmax, int mantissa_bits, float max_val,
    float min_normal, float min_sub, void* stream) {
  Layout f;
  if (!make_layout(mantissa_bits, max_val, min_normal, min_sub, &f))
    return (int)cudaErrorInvalidValue;
  int64_t n_vec = (aligned16(x) && aligned16(y)) ? n / 4 : 0;
  int blocks = grid_for(n_vec > 0 ? n_vec : n, THREADS);
  floating_tensor_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x, y, n, n_vec, s, s_dev, qmin, qmax, f);
  return (int)cudaGetLastError();
}

extern "C" int ppq_floating_quant_channelwise(
    const float* x, float* y, int64_t n, const float* s, int64_t channels,
    int64_t inner, float qmin, float qmax, int mantissa_bits, float max_val,
    float min_normal, float min_sub, void* stream) {
  Layout f;
  if (!make_layout(mantissa_bits, max_val, min_normal, min_sub, &f) ||
      n <= 0 || channels <= 0 || inner <= 0)
    return (int)cudaErrorInvalidValue;
  launch_channel_walk(x, y, n, channels, inner,
                      ChannelFloating{s, qmin, qmax, f},
                      (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

extern "C" int ppq_floating_quant_bwd(const float* x, const float* g,
                                      float* dx, int64_t n, float s,
                                      const float* s_dev, float qmin,
                                      float qmax, void* stream) {
  int64_t n_vec = (aligned16(x) && aligned16(g) && aligned16(dx)) ? n / 4 : 0;
  int blocks = grid_for(n_vec > 0 ? n_vec : n, THREADS);
  floating_bwd_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x, g, dx, n, n_vec, s, s_dev, qmin, qmax);
  return (int)cudaGetLastError();
}
