// The channel of an element of a tensor quantized along one axis, without an
// integer division per element.
//
// A tensor of shape (outer, C, inner), in its own layout, is outer * C runs
// of `inner` contiguous floats; run r has channel r % C. The channel of flat
// index i is therefore (i / inner) % C. The card has no integer divider: a
// 32-bit `/` or `%` by a value known only at run time is a sequence of some
// twenty instructions. Both divisors are fixed for a launch, so the host
// computes a multiplier and a shift for each once, and the card divides with
// one multiply-high, one add and one shift (the method of Granlund and
// Montgomery, as PyTorch's IntDivider does it).
//
// Shared by the kernels that split a flat index: the channelwise walk at
// the end of this file (fake_quant.cu's and floating.cu's channelwise
// bodies: the channel of a float4), fake_quant_bwd.cu (a channel's element
// of its runs), kv_write.cu's bank_write (a 16-byte vector's buffer, slot
// and place in its row).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "rounding.cuh"

namespace ppq {

// n / d for 0 <= n < 2^31 and 1 <= d < 2^31.
struct FastDiv32 {
  uint32_t d, magic, shift;

  static FastDiv32 make(uint32_t divisor) {
    FastDiv32 f;
    f.d = divisor;
    f.shift = 0;
    while (f.shift < 32 && (1ull << f.shift) < divisor) ++f.shift;
    f.magic = (uint32_t)(((1ull << 32) * ((1ull << f.shift) - divisor)) /
                             divisor + 1);
    return f;
  }
  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return (__umulhi(n, magic) + n) >> shift;
  }
  __device__ __forceinline__ uint32_t mod(uint32_t n) const {
    return n - div(n) * d;
  }
};

// The same interface for a divisor that is a power of two: a shift and a
// mask.
struct ShiftDiv32 {
  uint32_t d, shift;

  static ShiftDiv32 make(uint32_t divisor) {
    ShiftDiv32 f{divisor, 0};
    while ((1u << f.shift) < divisor) ++f.shift;
    return f;
  }
  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return n >> shift;
  }
  __device__ __forceinline__ uint32_t mod(uint32_t n) const {
    return n & (d - 1);
  }
};

inline bool power_of_two(uint64_t v) { return v != 0 && (v & (v - 1)) == 0; }

// The same interface in 64 bits, by plain division: for tensors of 2^31
// elements or more, where the multiplier above no longer holds.
struct PlainDiv64 {
  uint64_t d;

  static PlainDiv64 make(uint64_t divisor) { return PlainDiv64{divisor}; }
  __device__ __forceinline__ uint64_t div(uint64_t n) const { return n / d; }
  __device__ __forceinline__ uint64_t mod(uint64_t n) const { return n % d; }
};

// Index types that go with each divider.
template <typename Div> struct IndexOf;
template <> struct IndexOf<FastDiv32> { using type = uint32_t; };
template <> struct IndexOf<ShiftDiv32> { using type = uint32_t; };
template <> struct IndexOf<PlainDiv64> { using type = uint64_t; };

// Position of flat index i: its channel and its place in its run.
template <typename Div>
struct ChannelIndex {
  using Index = typename IndexOf<Div>::type;
  Div inner, channels;

  __device__ __forceinline__ void locate(Index i, Index& c, Index& w) const {
    const Index run = inner.div(i);
    w = i - run * inner.d;
    c = channels.mod(run);
  }
  __device__ __forceinline__ Index channel(Index i) const {
    return channels.mod(inner.div(i));
  }
  // From one element to the next: one step along the run, into the next
  // channel (wrapping to 0 after the last) where the run ends.
  __device__ __forceinline__ void step(Index& c, Index& w) const {
    if (++w == inner.d) {
      w = 0;
      c = (c + 1 == channels.d) ? 0 : c + 1;
    }
  }
};

// ---------------------------------------------------------------------------
// The channelwise walk: y[i] = op(x[i], op.param(c)) for the channel c of
// flat index i, in the tensor's own layout. What bounds it on an H100 is
// device memory (8 bytes an element), so a grid-stride loop over float4s,
// a thread's WALK_LOADS of them a grid apart and in flight together, at
// most one wave of 8 blocks an SM (a tensor smaller than that gives each
// thread one float4, over as many SMs as it fills). The channel is found
// once a float4 (two multiply-highs) and op.param read once for its four
// elements; only a float4 that crosses a run's end (inner not a multiple
// of 4, or below 4) steps element by element. The tail, or every element
// when x or y is not 16-byte aligned, goes element by element.
//
// Op: `template <typename Index> P param(Index c) const` (what an element
// of channel c needs, read from the card) and `float operator()(float x,
// P p) const`, both __device__.

constexpr int WALK_THREADS = 256;  // a block
constexpr int WALK_LOADS = 4;      // float4 loads a thread has in flight

template <typename Div, typename Op>
__global__ void __launch_bounds__(WALK_THREADS)
channel_walk_kernel(const float* __restrict__ x, float* __restrict__ y,
                    typename IndexOf<Div>::type n,
                    typename IndexOf<Div>::type n_vec, ChannelIndex<Div> at,
                    Op op) {
  using Index = typename IndexOf<Div>::type;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* y4 = reinterpret_cast<float4*>(y);
  const Index grid = (Index)gridDim.x * WALK_THREADS;
  for (Index base = (Index)blockIdx.x * WALK_THREADS + threadIdx.x;
       base < n_vec; base += grid * WALK_LOADS) {
    float4 v[WALK_LOADS];
#pragma unroll
    for (int k = 0; k < WALK_LOADS; ++k) {
      const Index j = base + k * grid;
      if (j < n_vec) v[k] = x4[j];
    }
#pragma unroll
    for (int k = 0; k < WALK_LOADS; ++k) {
      const Index j = base + k * grid;
      if (j >= n_vec) continue;
      Index c, w;
      at.locate(j * 4, c, w);
      float* e = reinterpret_cast<float*>(&v[k]);
      if (w + 3 < at.inner.d) {
        const auto p = op.param(c);
#pragma unroll
        for (int q = 0; q < 4; ++q) e[q] = op(e[q], p);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q > 0) at.step(c, w);
          e[q] = op(e[q], op.param(c));
        }
      }
      y4[j] = v[k];
    }
  }
  for (Index i = n_vec * 4 + (Index)blockIdx.x * WALK_THREADS + threadIdx.x;
       i < n; i += grid)
    y[i] = op(x[i], op.param(at.channel(i)));
}

// The walk over n elements of `channels` runs of `inner`, on `stream`:
// 32-bit indices by multiply-high below 2^31 elements, plain 64-bit
// division from there.
template <typename Op>
void launch_channel_walk(const float* x, float* y, int64_t n,
                         int64_t channels, int64_t inner, const Op& op,
                         cudaStream_t stream) {
  const int64_t n_vec = (aligned16(x) && aligned16(y)) ? n / 4 : 0;
  int64_t blocks = ((n_vec > 0 ? n_vec : n) + WALK_THREADS - 1) / WALK_THREADS;
  if (blocks > 8 * (int64_t)sm_count()) blocks = 8 * (int64_t)sm_count();
  if (n < INT32_MAX) {
    ChannelIndex<FastDiv32> at{FastDiv32::make((uint32_t)inner),
                               FastDiv32::make((uint32_t)channels)};
    channel_walk_kernel<FastDiv32, Op><<<(int)blocks, WALK_THREADS, 0, stream>>>(
        x, y, (uint32_t)n, (uint32_t)n_vec, at, op);
  } else {
    ChannelIndex<PlainDiv64> at{PlainDiv64::make((uint64_t)inner),
                                PlainDiv64::make((uint64_t)channels)};
    channel_walk_kernel<PlainDiv64, Op><<<(int)blocks, WALK_THREADS, 0, stream>>>(
        x, y, (uint64_t)n, (uint64_t)n_vec, at, op);
  }
}

}  // namespace ppq
