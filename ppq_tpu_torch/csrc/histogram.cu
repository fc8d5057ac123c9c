// Calibration histogram for sm_90a:
//   counts[b] += #{ i : clip(int(v_i / scale), 0, bins - 1) == b },
//   v_i = |x_i| (absolute) or x_i (signed; negative values fall in bin 0).
//
// Replaces the TPU kernel `_hist_kernel` of ppq_tpu/kernels/histogram.py
// (`pallas_histogram`). The TPU has no fast scatter, so that kernel turns the
// histogram into a one-hot contraction on the matrix unit. Hopper has fast
// shared-memory atomics, so this is a histogram again:
//   * each block keeps a sub-histogram of `bins` 32-bit counters in shared
//     memory (16 KB at 4096 bins);
//   * lanes of a warp that fall in the same bin are merged with
//     __match_any_sync first, so the post-ReLU spike at bin 0 costs one
//     shared atomic per warp and not 32;
//   * at the end each block adds its non-zero bins to the 64-bit global
//     counts with one atomic per bin;
//   * the ragged tail is handled by the grid-stride loop, so there is no pad
//     count to take out of bin 0.
// What bounds it on an H100: device memory, 4 bytes read per element and no
// write but the bins. Loads are 16-byte (float4).
//
// Counts are exact 64-bit integers and the kernel adds into the caller's
// running counts, so a calibration folds its batches on the card in int64.
// Index semantics equal the JAX reference `(v / scale).astype(int32)` then
// clip: IEEE division, and __float2int_rz truncates toward zero and
// saturates (a NaN gives 0), as XLA's convert does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int bin_of(float v, float scale, int bins,
                                      bool absolute) {
  if (absolute) v = fabsf(v);
  int idx = __float2int_rz(__fdiv_rn(v, scale));
  idx = idx < 0 ? 0 : idx;
  return idx > bins - 1 ? bins - 1 : idx;
}

// All 32 lanes call this together (the loops below are warp-uniform), so
// the full mask is exact. idx < 0 marks a lane with no element.
__device__ __forceinline__ void count(unsigned int* hist, int idx) {
  unsigned int peers = __match_any_sync(0xffffffffu, idx);
  if (idx >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&hist[idx], (unsigned int)__popc(peers));
}

template <bool ABS_VALUE>
__global__ void histogram_kernel(const float* __restrict__ x, int64_t n,
                                 int64_t n_vec, float scale, int bins,
                                 unsigned long long* __restrict__ out) {
  extern __shared__ unsigned int hist[];
  for (int b = threadIdx.x; b < bins; b += blockDim.x) hist[b] = 0;
  __syncthreads();

  // blockDim.x is a multiple of 32: every lane of a warp runs the same
  // number of iterations, from the warp's first index
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  const int64_t warp_start =
      (int64_t)blockIdx.x * blockDim.x + (threadIdx.x - lane);
  const float4* x4 = reinterpret_cast<const float4*>(x);
  for (int64_t base = warp_start; base < n_vec; base += stride) {
    const int64_t i = base + lane;
    const bool ok = i < n_vec;
    float4 v = ok ? x4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    count(hist, ok ? bin_of(v.x, scale, bins, ABS_VALUE) : -1);
    count(hist, ok ? bin_of(v.y, scale, bins, ABS_VALUE) : -1);
    count(hist, ok ? bin_of(v.z, scale, bins, ABS_VALUE) : -1);
    count(hist, ok ? bin_of(v.w, scale, bins, ABS_VALUE) : -1);
  }
  for (int64_t base = n_vec * 4 + warp_start; base < n; base += stride) {
    const int64_t i = base + lane;
    count(hist, i < n ? bin_of(x[i], scale, bins, ABS_VALUE) : -1);
  }
  __syncthreads();

  for (int b = threadIdx.x; b < bins; b += blockDim.x) {
    unsigned int c = hist[b];
    if (c) atomicAdd(&out[b], (unsigned long long)c);
  }
}

}  // namespace

extern "C" int ppq_histogram(const float* x, int64_t n, float scale, int bins,
                             int absolute, long long* out, void* stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const int threads = 1024;
  const size_t shared = (size_t)bins * sizeof(unsigned int);
  int64_t n_vec = (((uintptr_t)x & 15u) == 0) ? n / 4 : 0;
  int64_t work = n_vec > 0 ? n_vec : n;
  int64_t blocks = (work + threads - 1) / threads;
  // two blocks per SM: enough loads in flight, and few bin flushes
  if (blocks > 2 * (int64_t)sms) blocks = 2 * (int64_t)sms;
  if (blocks < 1) blocks = 1;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* o = reinterpret_cast<unsigned long long*>(out);
  if (absolute)
    histogram_kernel<true><<<(int)blocks, threads, shared, st>>>(
        x, n, n_vec, scale, bins, o);
  else
    histogram_kernel<false><<<(int)blocks, threads, shared, st>>>(
        x, n, n_vec, scale, bins, o);
  return (int)cudaGetLastError();
}
