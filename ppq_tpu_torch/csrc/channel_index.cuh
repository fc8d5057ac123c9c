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
// Shared by the kernels that split a flat index: fake_quant.cu and
// fake_quant_bwd.cu (a channel's element of its runs), kv_write.cu's
// bank_write (a 16-byte vector's buffer, slot and place in its row).
// floating.cu's channelwise body divides per element still and can take it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace ppq
