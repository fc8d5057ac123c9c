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
// registers, a warp-shuffle and shared-memory reduction per block. There are
// no floating-point atomics, so the same inputs give the same bits on every
// run. The TPU kernel's sequential-grid accumulation has no counterpart here.
//
// Tensorwise: a grid-stride loop, one (ds, do) partial per block written to
// a workspace, and a small second kernel that adds the partials in a fixed
// order (in double).
//
// Channelwise keeps the tensor's own layout (outer, C, inner): channel c's
// elements lie in `outer` runs of `inner` contiguous floats, so neighbouring
// threads read neighbouring addresses whether the channel is axis 0 of a
// weight or axis 1 of an activation. One launch a call, on a grid of
// (channel, split) blocks whose plan comes from the host
// (kernels/quant.py `channelwise_bwd_plan`):
//   * the unit is a float4 where inner is a multiple of 4 and x, g, dx are
//     16-byte aligned, else a float; a unit's run comes from one
//     multiply-high (channel_index.cuh), never an integer division;
//   * each thread loads LOADS units of x and of g, a pass of the channel's
//     blocks apart, before it converts any of them, so several loads are in
//     flight;
//   * where inner is 1 (a Gemm weight stored (in, out), channels on the
//     last axis) a channel's elements lie a row apart: there the 32 lanes
//     of a warp take 32 neighbouring channels of a row, so each load is
//     one coalesced line, and the warps of a block take its rows;
//   * with one split (a weight on axis 0: its channels fill the card) a
//     block owns its channel and writes ds[c], do[c] itself;
//   * with several (few channels, many elements: axis 1 of an activation)
//     each block writes its partial to a workspace, and the block that
//     finishes a channel last, found by an integer counter per channel after
//     a __threadfence (as qmm.cu's split-K tiles are), adds the channel's
//     partials in index order in double and sets the counter back to 0 for
//     the next launch. The bits do not depend on which block is last.

// Numerics are the forward kernel's (fake_quant.cu): IEEE division, the same
// rounding table, comparisons that leave a NaN "inside" as jnp.where does,
// -fmad=false. The offset is rounded here (rintf).

#include <cuda_runtime.h>
#include <stdint.h>

#include "channel_index.cuh"
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

constexpr int LOADS = 4;  // units of x and of g a thread of the channelwise
                          // kernel loads before it converts any

template <int R, bool ARITH>
__device__ __forceinline__ float bwd_unit(float x, float g, float s, float o,
                                          float qmin, float qmax, float& ds,
                                          float& dof) {
  if (!ARITH) {  // the measurement build's variant: the traffic alone
    ds += x;
    dof += g;
    return g;
  }
  return bwd_one<R>(x, g, s, o, qmin, qmax, ds, dof);
}

template <int R, bool ARITH>
__device__ __forceinline__ float4 bwd_unit(float4 x, float4 g, float s,
                                           float o, float qmin, float qmax,
                                           float& ds, float& dof) {
  float4 d;
  d.x = bwd_unit<R, ARITH>(x.x, g.x, s, o, qmin, qmax, ds, dof);
  d.y = bwd_unit<R, ARITH>(x.y, g.y, s, o, qmin, qmax, ds, dof);
  d.z = bwd_unit<R, ARITH>(x.z, g.z, s, o, qmin, qmax, ds, dof);
  d.w = bwd_unit<R, ARITH>(x.w, g.w, s, o, qmin, qmax, ds, dof);
  return d;
}

// Block (c, j) of a (channels, splits) grid. T is float4 or float (the
// unit); channel c has `units` of them, in runs of `run.d` (inner / its
// width), run r of the channel at unit (r * channels + c) * run.d. Block j
// takes the channel's units j * THREADS + t + i * splits * THREADS.
template <int R, typename T, typename Div, bool ARITH = true>
__global__ void __launch_bounds__(THREADS)
bwd_channel_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   T* __restrict__ dx, const float* __restrict__ scale,
                   const float* __restrict__ offset, Div run,
                   typename IndexOf<Div>::type channels,
                   typename IndexOf<Div>::type units, float qmin, float qmax,
                   float* __restrict__ partial,
                   unsigned* __restrict__ counters, float* __restrict__ ds_out,
                   float* __restrict__ do_out) {
  using Index = typename IndexOf<Div>::type;
  const Index c = blockIdx.x;
  const unsigned split = blockIdx.y, splits = gridDim.y;
  const float s = ARITH ? scale[c] : 1.f;
  const float o = ARITH ? rintf(offset[c]) : 0.f;
  const Index step = (Index)splits * THREADS;
  float ds = 0.f, dof = 0.f;
  for (Index base = (Index)split * THREADS + threadIdx.x; base < units;
       base += step * LOADS) {
    Index at[LOADS];
    T xv[LOADS], gv[LOADS];
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
      const Index e = base + k * step;
      if (e < units) {
        const Index r = run.div(e);
        at[k] = (r * channels + c) * run.d + (e - r * run.d);
        xv[k] = x[at[k]];
        gv[k] = g[at[k]];
      }
    }
#pragma unroll
    for (int k = 0; k < LOADS; ++k)
      if (base + k * step < units)
        dx[at[k]] =
            bwd_unit<R, ARITH>(xv[k], gv[k], s, o, qmin, qmax, ds, dof);
  }

  // the block's sums: warps by shuffle, then the warps in order in double
  __shared__ float sh[2][WARPS];
  __shared__ bool last;
  ds = warp_sum(ds);
  dof = warp_sum(dof);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sh[0][warp] = ds;
    sh[1][warp] = dof;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double a = 0.0, b = 0.0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      a += (double)sh[0][w];
      b += (double)sh[1][w];
    }
    if (splits == 1) {
      ds_out[c] = (float)a;
      do_out[c] = (float)b;
    } else {
      float* p = partial + 2 * ((int64_t)c * splits + split);
      p[0] = (float)a;
      p[1] = (float)b;
      __threadfence();  // the partial is visible before the count is
      last = atomicAdd(&counters[c], 1u) == splits - 1;
    }
  }
  if (splits == 1) return;
  __syncthreads();
  if (!last || warp != 0) return;
  // the channel's last block: one warp adds its partials in index order
  __threadfence();
  const float* p = partial + 2 * (int64_t)c * splits;
  double a = 0.0, b = 0.0;
  for (unsigned i = lane; i < splits; i += 32) {
    a += (double)__ldcg(p + 2 * i);
    b += (double)__ldcg(p + 2 * i + 1);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  if (lane == 0) {
    ds_out[c] = (float)a;
    do_out[c] = (float)b;
    counters[c] = 0u;  // for the next launch on this stream
  }
}

// inner == 1: x is (rows, channels) row-major. Block (t, j) of a
// (ceil(channels / 32), splits) grid: lane l takes channel t * 32 + l, warp
// w the rows j * WARPS + w + i * splits * WARPS. The last block of a tile
// of 32 channels (one counter a tile) folds the tile's partials.
template <int R, typename Index, bool ARITH = true>
__global__ void __launch_bounds__(THREADS)
bwd_columns_kernel(const float* __restrict__ x, const float* __restrict__ g,
                   float* __restrict__ dx, const float* __restrict__ scale,
                   const float* __restrict__ offset, Index channels,
                   Index rows, float qmin, float qmax,
                   float* __restrict__ partial,
                   unsigned* __restrict__ counters, float* __restrict__ ds_out,
                   float* __restrict__ do_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Index c = (Index)blockIdx.x * 32 + lane;
  const bool live = c < channels;
  const unsigned split = blockIdx.y, splits = gridDim.y;
  const float s = ARITH && live ? scale[c] : 1.f;
  const float o = ARITH && live ? rintf(offset[c]) : 0.f;
  const Index step = (Index)splits * WARPS;
  float ds = 0.f, dof = 0.f;
  for (Index base = (Index)split * WARPS + warp; base < rows;
       base += step * LOADS) {
    float xv[LOADS], gv[LOADS];
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
      const Index r = base + k * step;
      if (live && r < rows) {
        xv[k] = x[r * channels + c];
        gv[k] = g[r * channels + c];
      }
    }
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
      const Index r = base + k * step;
      if (live && r < rows)
        dx[r * channels + c] =
            bwd_unit<R, ARITH>(xv[k], gv[k], s, o, qmin, qmax, ds, dof);
    }
  }

  // each channel's sum over the block's warps, in order, in double
  __shared__ float sh[2][WARPS][32];
  sh[0][warp][lane] = ds;
  sh[1][warp][lane] = dof;
  __syncthreads();
  if (warp != 0) return;
  double a = 0.0, b = 0.0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    a += (double)sh[0][w][lane];
    b += (double)sh[1][w][lane];
  }
  if (splits == 1) {
    if (live) {
      ds_out[c] = (float)a;
      do_out[c] = (float)b;
    }
    return;
  }
  float* p = partial + 2 * ((int64_t)c * splits + split);
  if (live) {
    p[0] = (float)a;
    p[1] = (float)b;
  }
  __threadfence();  // every lane's partial is visible before the count is
  __syncwarp();
  unsigned count = 0;
  if (lane == 0) count = atomicAdd(&counters[blockIdx.x], 1u);
  if (__shfl_sync(0xffffffffu, count, 0) != splits - 1) return;
  // the tile's last block: each lane adds its channel's partials in order
  __threadfence();
  a = b = 0.0;
  if (live) {
    const float* q = partial + 2 * (int64_t)c * splits;
    for (unsigned j = 0; j < splits; ++j) {
      a += (double)__ldcg(q + 2 * j);
      b += (double)__ldcg(q + 2 * j + 1);
    }
    ds_out[c] = (float)a;
    do_out[c] = (float)b;
  }
  if (lane == 0) counters[blockIdx.x] = 0u;  // for the next launch
}

template <int R, typename T, typename Div, bool ARITH>
void launch_channel_as(const float* x, const float* g, float* dx,
                       const float* s, const float* o, Div run, int64_t channels,
                       int64_t units, float qmin, float qmax, float* partial,
                       unsigned* counters, int splits, float* ds, float* dof,
                       cudaStream_t stream) {
  using Index = typename IndexOf<Div>::type;
  const dim3 grid((unsigned)channels, (unsigned)splits);
  bwd_channel_kernel<R, T, Div, ARITH><<<grid, THREADS, 0, stream>>>(
      reinterpret_cast<const T*>(x), reinterpret_cast<const T*>(g),
      reinterpret_cast<T*>(dx), s, o, run, (Index)channels, (Index)units, qmin,
      qmax, partial, counters, ds, dof);
}

// vec: 4 (runs of float4 units; inner % 4 == 0, pointers aligned), 1 (runs
// of floats) or 0 (inner == 1: a warp's lanes on 32 channels of a row).
template <int R, bool ARITH = true>
void launch_channel(const float* x, const float* g, float* dx, int64_t n,
                    const float* s, const float* o, int64_t channels,
                    int64_t inner, float qmin, float qmax, int vec,
                    float* partial, unsigned* counters, int splits, float* ds,
                    float* dof, cudaStream_t stream) {
  if (vec == 0) {
    const dim3 grid((unsigned)((channels + 31) / 32), (unsigned)splits);
    if (n < INT32_MAX)
      bwd_columns_kernel<R, uint32_t, ARITH><<<grid, THREADS, 0, stream>>>(
          x, g, dx, s, o, (uint32_t)channels, (uint32_t)(n / channels), qmin,
          qmax, partial, counters, ds, dof);
    else
      bwd_columns_kernel<R, uint64_t, ARITH><<<grid, THREADS, 0, stream>>>(
          x, g, dx, s, o, (uint64_t)channels, (uint64_t)(n / channels), qmin,
          qmax, partial, counters, ds, dof);
    return;
  }
  const int64_t run_units = inner / vec;
  const int64_t units = n / channels / vec;
  if (n < INT32_MAX) {
    const FastDiv32 run = FastDiv32::make((uint32_t)run_units);
    if (vec == 4)
      launch_channel_as<R, float4, FastDiv32, ARITH>(
          x, g, dx, s, o, run, channels, units, qmin, qmax, partial, counters,
          splits, ds, dof, stream);
    else
      launch_channel_as<R, float, FastDiv32, ARITH>(
          x, g, dx, s, o, run, channels, units, qmin, qmax, partial, counters,
          splits, ds, dof, stream);
  } else {
    const PlainDiv64 run = PlainDiv64::make((uint64_t)run_units);
    if (vec == 4)
      launch_channel_as<R, float4, PlainDiv64, ARITH>(
          x, g, dx, s, o, run, channels, units, qmin, qmax, partial, counters,
          splits, ds, dof, stream);
    else
      launch_channel_as<R, float, PlainDiv64, ARITH>(
          x, g, dx, s, o, run, channels, units, qmin, qmax, partial, counters,
          splits, ds, dof, stream);
  }
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

// x is (outer, channels, inner) in memory, n its element count; vec 4, 1 or
// 0 (launch_channel), splits >= 1 (kernels/quant.py `channelwise_bwd_plan`).
// With splits > 1, partial: a workspace of 2 * channels * splits floats,
// counters: unsigned ints that are 0 (each launch leaves them so), one a
// channel (vec 4, 1) or one a tile of 32 channels (vec 0); unused with one
// split. ds, dof: `channels` floats each.
static bool channel_args_ok(const float* x, const float* g, float* dx,
                            int64_t n, int64_t channels, int64_t inner, int vec,
                            const float* partial, const unsigned* counters,
                            int splits) {
  if (n <= 0 || channels < 1 || channels > (int64_t)INT32_MAX || inner < 1 ||
      n % (channels * inner) != 0 || splits < 1 || splits > 65535)
    return false;
  if (splits > 1 && !(partial && counters)) return false;
  if (vec == 4)
    return inner % 4 == 0 && aligned16(x) && aligned16(g) && aligned16(dx);
  return vec == 1 || (vec == 0 && inner == 1);
}

extern "C" int ppq_fake_quant_bwd_channelwise(
    const float* x, const float* g, float* dx, int64_t n, const float* s,
    const float* o, int64_t channels, int64_t inner, float qmin, float qmax,
    int rounding, int vec, int splits, float* partial, unsigned* counters,
    float* ds, float* dof, void* stream) {
  if (!channel_args_ok(x, g, dx, n, channels, inner, vec, partial, counters,
                       splits))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  DISPATCH_ROUNDING(rounding, launch_channel, x, g, dx, n, s, o, channels,
                    inner, qmin, qmax, vec, partial, counters, splits, ds, dof,
                    st);
  return (int)cudaGetLastError();
}

#ifdef PPQ_MEASURE
// A measurement build only (nvcc -DPPQ_MEASURE, chip_smoke.py --quant): the
// channelwise kernel's loads, stores and sums without its arithmetic
// (dx = g, the sums of x and of g), on the same plan.
extern "C" int ppq_fake_quant_bwd_channelwise_copy(
    const float* x, const float* g, float* dx, int64_t n, int64_t channels,
    int64_t inner, int vec, int splits, float* partial, unsigned* counters,
    float* ds, float* dof, void* stream) {
  if (!channel_args_ok(x, g, dx, n, channels, inner, vec, partial, counters,
                       splits))
    return (int)cudaErrorInvalidValue;
  launch_channel<HALF_EVEN, false>(x, g, dx, n, nullptr, nullptr, channels,
                                   inner, 0.f, 0.f, vec, partial, counters,
                                   splits, ds, dof, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
#endif
