// In-place writes of new K/V codes into the serving engine's buffers, for
// sm_90a. Pure copies in 16-byte vectors; the destination column or row
// comes from device memory, so the host never waits for it.
//
//   bank_write:   for every array j and slot b,
//                 dst_j[b, col, :] = src_j[b, 0, :]
//                 over up to MAX_BANK arrays (B, CH, row) in one launch.
//   window_write: for every array j, layer l and slot b,
//                 dst_j[l, b, pos[b] : pos[b] + n, :] = src_j[l, b, :, :]
//                 over arrays (L, B, S, row) <- (L, B, n, row).
//
// They replace the TPU kernels of ppq_tpu/kernels/bank_write.py
// (`bank_write_inplace`) and ppq_tpu/kernels/window_write.py
// (`window_write_inplace`). Those exist because XLA rewrites a whole buffer
// for a one-column update, and they start one DMA per (array) or (slot,
// array) from a single sequential program with a few copies in flight. On
// the card an indexed assignment is already in place, so what the kernel
// buys is one launch where PyTorch would take one per array (32 a decode
// step at 16 layers) and no host-side index: a grid of (slot, array) or
// (slot, layer, array) blocks, each copying its contiguous piece. What
// bounds them: bytes, each read once and written once; at 4 MB (bank) they
// are launch-bound, at 134 MB (window, 32 steps of a 16-layer, 128-slot
// burst) memory-bound.
//
// A column or a window that does not fit its destination is skipped, never
// written out of bounds, and sets a bit of *fault (4 for a column, 8 for a
// window) that the caller reads when it chooses (`loader.read_faults`): the
// callers guarantee that it fits, and a broken guarantee shows there. (The
// JAX package's TPU kernels do not check: their DMA gets the index as it
// is.)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_BANK = 128;
constexpr int MAX_WINDOW = 8;

struct BankArgs {
  void* dst[MAX_BANK];
  const void* src[MAX_BANK];
};

struct WindowArgs {
  void* dst[MAX_WINDOW];
  const void* src[MAX_WINDOW];
};

// grid (B, arrays); row_vecs 16-byte vectors per (slot, column);
// dst_slot_vecs vectors between two slots of a destination.
__global__ void bank_write_kernel(BankArgs args, const int* __restrict__ col,
                                  int CH, int64_t row_vecs,
                                  int64_t dst_slot_vecs, int* fault) {
  const int c = *col;
  if (c < 0 || c >= CH) {
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
      atomicOr(fault, 4);
    return;
  }
  const int64_t b = blockIdx.x;
  const int4* src = static_cast<const int4*>(args.src[blockIdx.y]) + b * row_vecs;
  int4* dst = static_cast<int4*>(args.dst[blockIdx.y]) + b * dst_slot_vecs +
              (int64_t)c * row_vecs;
  for (int64_t i = threadIdx.x; i < row_vecs; i += blockDim.x) dst[i] = src[i];
}

// grid (B, L, arrays); row_vecs 16-byte vectors per cache row.
__global__ void window_write_kernel(WindowArgs args,
                                    const int* __restrict__ pos, int64_t B,
                                    int64_t S, int64_t n, int64_t row_vecs,
                                    int* fault) {
  const int64_t b = blockIdx.x, l = blockIdx.y;
  const int64_t p = pos[b];
  if (p < 0 || p + n > S) {
    if (l == 0 && blockIdx.z == 0 && threadIdx.x == 0) atomicOr(fault, 8);
    return;
  }
  const int4* src = static_cast<const int4*>(args.src[blockIdx.z]) +
                    (l * B + b) * n * row_vecs;
  int4* dst = static_cast<int4*>(args.dst[blockIdx.z]) +
              ((l * B + b) * S + p) * row_vecs;
  const int64_t count = n * row_vecs;
  for (int64_t i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

}  // namespace

// dsts, srcs: host arrays of n_arrays device pointers; col: device int32.
// row_bytes: bytes of one (slot, column); dst_slot_bytes: bytes between two
// slots of a destination (CH * row_bytes when it is contiguous); fault: one
// device int32.
extern "C" int ppq_bank_write(const void* const* dsts, const void* const* srcs,
                              int n_arrays, int64_t B, int64_t CH,
                              int64_t row_bytes, int64_t dst_slot_bytes,
                              const void* col, void* fault, void* stream) {
  if (n_arrays <= 0 || n_arrays > MAX_BANK || B <= 0 || B > 2147483647 ||
      CH <= 0 || row_bytes <= 0 || row_bytes % 16 != 0 ||
      dst_slot_bytes % 16 != 0)
    return (int)cudaErrorInvalidValue;
  BankArgs args;
  for (int j = 0; j < n_arrays; ++j) {
    args.dst[j] = const_cast<void*>(dsts[j]);
    args.src[j] = srcs[j];
  }
  const int64_t row_vecs = row_bytes / 16;
  const int threads = row_vecs >= 256 ? 256 : (row_vecs > 32 ? 64 : 32);
  const dim3 grid((unsigned int)B, (unsigned int)n_arrays);
  bank_write_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      args, static_cast<const int*>(col), (int)CH, row_vecs,
      dst_slot_bytes / 16, static_cast<int*>(fault));
  return (int)cudaGetLastError();
}

// dsts: n_arrays device pointers to (L, B, S, row) arrays; srcs: to
// (L, B, n, row) arrays, all contiguous; pos: device int32 (B,); fault: one
// device int32.
extern "C" int ppq_window_write(const void* const* dsts,
                                const void* const* srcs, int n_arrays,
                                int64_t L, int64_t B, int64_t S, int64_t n,
                                int64_t row_bytes, const void* pos,
                                void* fault, void* stream) {
  if (n_arrays <= 0 || n_arrays > MAX_WINDOW || L <= 0 || L > 65535 ||
      B <= 0 || B > 2147483647 || S <= 0 || n <= 0 || row_bytes <= 0 ||
      row_bytes % 16 != 0)
    return (int)cudaErrorInvalidValue;
  WindowArgs args;
  for (int j = 0; j < n_arrays; ++j) {
    args.dst[j] = const_cast<void*>(dsts[j]);
    args.src[j] = srcs[j];
  }
  const dim3 grid((unsigned int)B, (unsigned int)L, (unsigned int)n_arrays);
  window_write_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      args, static_cast<const int*>(pos), B, S, n, row_bytes / 16,
      static_cast<int*>(fault));
  return (int)cudaGetLastError();
}
