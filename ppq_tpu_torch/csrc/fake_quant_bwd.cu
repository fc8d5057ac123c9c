// Linear fake-quant backward (clip-aware STE + LSQ), tensorwise and
// channelwise, for sm_90a.
//
// Replaces the TPU kernels of ppq_tpu/kernels/quant.py: `_quant_bwd_t_kernel`
// (reached through `pallas_linear_quant_bwd`) and `_quant_bwd_c_kernel`
// (reached through `_channelwise_bwd`).
//
//   raw = x / s,  q_un = round(raw) + o,  inside = qmin <= q_un <= qmax
//   dx  = inside ? g : 0
//   ds  = sum g * (inside ? (q_un - o) - raw : (q_un < qmin ? qmin : qmax) - o)
//   do  = sum g * (inside ? 0 : s)
// with one (ds, do) for the tensor, or one per channel.
//
// What bounds it on an H100: device memory. One pass reads x and g and writes
// dx, 12 bytes per element for about a dozen flops, so the design is a single
// streaming pass that also carries the two sums: per-thread partial sums in
// registers, a warp-shuffle and shared-memory reduction per block, one
// (ds, do) partial per block written to a workspace, and a small second
// kernel that adds the partials in a fixed order (in double). There are no
// floating-point atomics, so the same inputs give the same bits on every run.
// The TPU kernel's sequential-grid accumulation has no counterpart here.
//
// Channelwise keeps the tensor's own layout (outer, C, inner): block (c, j)
// of a C x splits grid walks channel c's outer*inner elements, which lie in
// `outer` runs of `inner` contiguous floats, so neighbouring threads read
// neighbouring addresses whether the channel is axis 0 of a weight or axis 1
// of an activation. The second kernel adds a channel's `splits` partials.
//
// Numerics are the forward kernel's (fake_quant.cu): IEEE division, the same
// rounding table, comparisons that leave a NaN "inside" as jnp.where does,
// -fmad=false. The offset is rounded here (rintf).

#include <cuda_runtime.h>
#include <stdint.h>

#include "rounding.cuh"

using namespace ppq;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <int R>
__device__ __forceinline__ float bwd_one(float x, float g, float s, float o,
                                         float qmin, float qmax, float& ds,
                                         float& dof) {
  const float raw = __fdiv_rn(x, s);
  const float q_un = round_value<R>(raw) + o;
  const bool below = q_un < qmin;
  const bool above = q_un > qmax;
  const bool inside = !(below || above);  // a NaN is inside
  const float e = inside ? (q_un - o) - raw : ((below ? qmin : qmax) - o);
  ds += e * g;
  dof += (inside ? 0.f : s) * g;
  return inside ? g : 0.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum (ds, dof) over the block in a fixed order; thread 0 writes the pair.
__device__ __forceinline__ void block_store(float ds, float dof,
                                            float* __restrict__ out) {
  __shared__ float sh[2][WARPS];
  ds = warp_sum(ds);
  dof = warp_sum(dof);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sh[0][warp] = ds;
    sh[1][warp] = dof;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      a += sh[0][w];
      b += sh[1][w];
    }
    out[0] = a;
    out[1] = b;
  }
}

template <int R>
__global__ void bwd_tensor_kernel(const float* __restrict__ x,
                                  const float* __restrict__ g,
                                  float* __restrict__ dx, int64_t n,
                                  int64_t n_vec,
                                  const float* __restrict__ s_dev,
                                  const float* __restrict__ o_dev, float qmin,
                                  float qmax, float* __restrict__ partial) {
  const float s = *s_dev;
  const float o = rintf(*o_dev);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t start = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* dx4 = reinterpret_cast<float4*>(dx);
  float ds = 0.f, dof = 0.f;
  for (int64_t i = start; i < n_vec; i += stride) {
    const float4 xv = x4[i];
    const float4 gv = g4[i];
    float4 d;
    d.x = bwd_one<R>(xv.x, gv.x, s, o, qmin, qmax, ds, dof);
    d.y = bwd_one<R>(xv.y, gv.y, s, o, qmin, qmax, ds, dof);
    d.z = bwd_one<R>(xv.z, gv.z, s, o, qmin, qmax, ds, dof);
    d.w = bwd_one<R>(xv.w, gv.w, s, o, qmin, qmax, ds, dof);
    dx4[i] = d;
  }
  for (int64_t i = n_vec * 4 + start; i < n; i += stride)
    dx[i] = bwd_one<R>(x[i], g[i], s, o, qmin, qmax, ds, dof);
  block_store(ds, dof, partial + 2 * (int64_t)blockIdx.x);
}

// One warp adds `count` (ds, dof) partials: each lane its strided share in
// order, then a shuffle tree. The order depends only on `count`.
__global__ void sum_partials_tensor_kernel(const float* __restrict__ partial,
                                           int count, float* __restrict__ ds,
                                           float* __restrict__ dof) {
  double a = 0.0, b = 0.0;
  for (int i = threadIdx.x; i < count; i += 32) {
    a += (double)partial[2 * i];
    b += (double)partial[2 * i + 1];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  if (threadIdx.x == 0) {
    *ds = (float)a;
    *dof = (float)b;
  }
}

template <int R, typename Index>
__global__ void bwd_channel_kernel(const float* __restrict__ x,
                                   const float* __restrict__ g,
                                   float* __restrict__ dx,
                                   const float* __restrict__ scale,
                                   const float* __restrict__ offset,
                                   Index channels, Index inner,
                                   Index per_channel, float qmin, float qmax,
                                   float* __restrict__ partial) {
  const Index c = blockIdx.x;
  const Index splits = gridDim.y;
  const float s = scale[c];
  const float o = rintf(offset[c]);
  float ds = 0.f, dof = 0.f;
  for (Index e = (Index)blockIdx.y * blockDim.x + threadIdx.x; e < per_channel;
       e += splits * (Index)blockDim.x) {
    const Index run = e / inner;
    const Index i = (run * channels + c) * inner + (e - run * inner);
    dx[i] = bwd_one<R>(x[i], g[i], s, o, qmin, qmax, ds, dof);
  }
  block_store(ds, dof, partial + 2 * ((int64_t)c * splits + blockIdx.y));
}

// One thread per channel adds that channel's `splits` partials in order.
__global__ void sum_partials_channel_kernel(const float* __restrict__ partial,
                                            int64_t channels, int splits,
                                            float* __restrict__ ds,
                                            float* __restrict__ dof) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= channels) return;
  double a = 0.0, b = 0.0;
  for (int j = 0; j < splits; ++j) {
    a += (double)partial[2 * (c * splits + j)];
    b += (double)partial[2 * (c * splits + j) + 1];
  }
  ds[c] = (float)a;
  dof[c] = (float)b;
}

template <int R>
void launch_tensor(const float* x, const float* g, float* dx, int64_t n,
                   const float* s, const float* o, float qmin, float qmax,
                   float* partial, int blocks, float* ds, float* dof,
                   cudaStream_t stream) {
  int64_t n_vec = (aligned16(x) && aligned16(g) && aligned16(dx)) ? n / 4 : 0;
  bwd_tensor_kernel<R><<<blocks, THREADS, 0, stream>>>(
      x, g, dx, n, n_vec, s, o, qmin, qmax, partial);
  sum_partials_tensor_kernel<<<1, 32, 0, stream>>>(partial, blocks, ds, dof);
}

template <int R>
void launch_channel(const float* x, const float* g, float* dx, int64_t n,
                    const float* s, const float* o, int64_t channels,
                    int64_t inner, float qmin, float qmax, float* partial,
                    int splits, float* ds, float* dof, cudaStream_t stream) {
  const int64_t per_channel = n / channels;
  dim3 grid((unsigned)channels, (unsigned)splits);
  // 32-bit index arithmetic when it fits: 64-bit division is slow
  if (n + (int64_t)splits * THREADS < (int64_t)UINT32_MAX) {
    bwd_channel_kernel<R, uint32_t><<<grid, THREADS, 0, stream>>>(
        x, g, dx, s, o, (uint32_t)channels, (uint32_t)inner,
        (uint32_t)per_channel, qmin, qmax, partial);
  } else {
    bwd_channel_kernel<R, uint64_t><<<grid, THREADS, 0, stream>>>(
        x, g, dx, s, o, (uint64_t)channels, (uint64_t)inner,
        (uint64_t)per_channel, qmin, qmax, partial);
  }
  const int threads = 128;
  sum_partials_channel_kernel<<<(unsigned)((channels + threads - 1) / threads),
                                threads, 0, stream>>>(partial, channels,
                                                      splits, ds, dof);
}

#define DISPATCH_ROUNDING(rounding, FN, ...)                      \
  switch (rounding) {                                             \
    case HALF_EVEN: FN<HALF_EVEN>(__VA_ARGS__); break;            \
    case HALF_UP: FN<HALF_UP>(__VA_ARGS__); break;                \
    case HALF_DOWN: FN<HALF_DOWN>(__VA_ARGS__); break;            \
    case HALF_TOWARDS_ZERO: FN<HALF_TOWARDS_ZERO>(__VA_ARGS__); break;   \
    case HALF_FAR_FROM_ZERO: FN<HALF_FAR_FROM_ZERO>(__VA_ARGS__); break; \
    case UP: FN<UP>(__VA_ARGS__); break;                          \
    case DOWN: FN<DOWN>(__VA_ARGS__); break;                      \
    default: return (int)cudaErrorInvalidValue;                   \
  }

}  // namespace

// partial: workspace of 2 * blocks floats; ds, dof: one float each.
extern "C" int ppq_fake_quant_bwd_tensorwise(
    const float* x, const float* g, float* dx, int64_t n, const float* s,
    const float* o, float qmin, float qmax, int rounding, float* partial,
    int blocks, float* ds, float* dof, void* stream) {
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  DISPATCH_ROUNDING(rounding, launch_tensor, x, g, dx, n, s, o, qmin, qmax,
                    partial, blocks, ds, dof, st);
  return (int)cudaGetLastError();
}

// partial: workspace of 2 * channels * splits floats; ds, dof: `channels`
// floats each. x is (outer, channels, inner) in memory, n its element count.
extern "C" int ppq_fake_quant_bwd_channelwise(
    const float* x, const float* g, float* dx, int64_t n, const float* s,
    const float* o, int64_t channels, int64_t inner, float qmin, float qmax,
    int rounding, float* partial, int splits, float* ds, float* dof,
    void* stream) {
  if (splits < 1 || splits > 65535 || channels < 1 ||
      channels > (int64_t)INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  DISPATCH_ROUNDING(rounding, launch_channel, x, g, dx, n, s, o, channels,
                    inner, qmin, qmax, partial, splits, ds, dof, st);
  return (int)cudaGetLastError();
}
