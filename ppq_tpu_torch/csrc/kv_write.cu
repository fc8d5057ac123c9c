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
//   pool_write:   for every layer l, slot b, token t < T and plane p (K, V),
//                 at position q = pos[b] + t, row = tables[b, q / BLK],
//                 pool[l, row, p, q % BLK, :] = src_p[l, b, t, :] and
//                 scale[l, row, p, :, q % BLK] = scale_src_p[l, b, :, t].
//
// They replace the TPU kernels of ppq_tpu/kernels/bank_write.py
// (`bank_write_inplace`), ppq_tpu/kernels/window_write.py
// (`window_write_inplace`) and ppq_tpu/kernels/pool_write.py (`pool_write`).
// The first two exist because XLA rewrites a whole buffer for a one-column
// update, and they start one DMA per (array) or (slot, array) from a single
// sequential program with a few copies in flight. On the card an indexed
// assignment is already in place, so what the kernel buys is one launch
// where PyTorch would take one per array (32 a decode step at 16 layers) and
// no host-side index. What bounds them: bytes, each read once and written
// once; at 4 MB (bank) they are launch-bound, at 134 MB (window, 32 steps
// of a 16-layer, 128-slot burst) memory-bound.
//
// bank_write covers (array, slot, vector) as one flat range of 16-byte
// vectors (262,144 at 32 arrays of 128 slots of 1 KiB rows), grid-stride,
// a few blocks an SM, each thread loading BANK_LOADS vectors before it
// stores any. A vector's array and place in its source come from the flat
// index by a shift (or a multiply-high); the source address does not depend
// on the column, so the loads are issued before the column, read once a
// thread, is known. window_write keeps a grid of (slot, layer, array)
// blocks, each copying its contiguous piece.

// pool_write, the paged KV cache's write (a burst's 32 columns or a prefill
// window into the block pool, all layers in one launch). The TPU kernel
// reads, merges and writes back whole destination blocks (two 256-row
// blocks a (layer, slot) for 32 new rows), because its DMA moves blocks and
// XLA's scatter moves rows one at a time. On the card a thread block per
// (slot, layer, plane) writes only the rows the window touches, in place,
// 16 bytes a thread, each row's pool row read from the block table on the
// device; the scales follow, 4 bytes each, token-minor so that both sides
// stay coalesced. What bounds it: bytes, the new codes and scales read once
// and written once (277 MB for a 32-step burst of the 16-layer, 128-slot
// model, 0.083 ms at 3.35 TB/s). Row 0 of the pool is the trash row that
// inactive slots and unallocated table entries point at: nothing is written
// there (many slots would race on it, and nothing reads it unmasked), nor
// for a slot whose `active` entry is 0.
//
// A column or a window that does not fit its destination is skipped, never
// written out of bounds, and sets a bit of *fault (4 for a column, 8 for a
// window; for pool_write 16 for a position outside the block table and 32
// for a table row outside the pool) that the caller reads when it chooses
// (`loader.read_faults`): the callers guarantee that it fits, and a broken
// guarantee shows there. (The JAX package's TPU kernels do not check: their
// DMA gets the index as it is. Its pool writer clamps the second block of a
// window that crosses the table's last column to the first, so the tokens
// past the end wrap into the start of that block.)

#include <cuda_runtime.h>
#include <stdint.h>

#include "channel_index.cuh"
#include "rounding.cuh"

using namespace ppq;

namespace {

constexpr int MAX_BANK = 128;
constexpr int MAX_WINDOW = 8;

// 2 KiB of launch arguments: an empty kernel that takes them launches
// within 0.0003 ms of one that takes 16 bytes (chip_smoke.py --attention,
// measurement build), so the table is not sized to the launch.
struct BankArgs {
  void* dst[MAX_BANK];
  const void* src[MAX_BANK];
};

struct WindowArgs {
  void* dst[MAX_WINDOW];
  const void* src[MAX_WINDOW];
};

constexpr int BANK_THREADS = 256;
constexpr int BANK_LOADS = 4;  // vectors a thread loads before it stores any

// A flat range of `total` 16-byte vectors: vector f is vector `rem` =
// f % per_array.d of array j = f / per_array.d's (B, 1, row) source, and in
// its destination slot b = rem / row.d, vector rem % row.d of column *col.
template <typename Div>
__global__ void __launch_bounds__(BANK_THREADS)
bank_write_kernel(BankArgs args, const int* __restrict__ col, int CH,
                  Div per_array, Div row, typename IndexOf<Div>::type total,
                  int64_t dst_slot_vecs, int* fault) {
  using Index = typename IndexOf<Div>::type;
  const int c = __ldg(col);  // its round trip overlaps the loads below
  const Index grid = (Index)gridDim.x * BANK_THREADS;
  for (Index base = (Index)blockIdx.x * BANK_THREADS + threadIdx.x;
       base < total; base += grid * BANK_LOADS) {
    int4 v[BANK_LOADS];
    Index j[BANK_LOADS], rem[BANK_LOADS];
#pragma unroll
    for (int k = 0; k < BANK_LOADS; ++k) {
      const Index f = base + k * grid;
      if (f < total) {
        j[k] = per_array.div(f);
        rem[k] = f - j[k] * per_array.d;
        v[k] = static_cast<const int4*>(args.src[j[k]])[rem[k]];
      }
    }
    if (c < 0 || c >= CH) {
      if (blockIdx.x == 0 && threadIdx.x == 0) atomicOr(fault, 4);
      return;
    }
#pragma unroll
    for (int k = 0; k < BANK_LOADS; ++k) {
      if (base + k * grid < total) {
        const Index b = row.div(rem[k]);
        static_cast<int4*>(args.dst[j[k]])[(int64_t)b * dst_slot_vecs +
                                           (int64_t)c * row.d +
                                           (rem[k] - b * row.d)] = v[k];
      }
    }
  }
}

template <typename Div>
void launch_bank(const BankArgs& args, const int* col, int CH, uint64_t B,
                 uint64_t row_vecs, uint64_t total, int64_t dst_slot_vecs,
                 int* fault, cudaStream_t stream) {
  using Index = typename IndexOf<Div>::type;
  int64_t blocks = (int64_t)((total + BANK_THREADS * BANK_LOADS - 1) /
                             (BANK_THREADS * BANK_LOADS));
  if (blocks > 4 * (int64_t)sm_count()) blocks = 4 * (int64_t)sm_count();
  bank_write_kernel<Div><<<(unsigned)blocks, BANK_THREADS, 0, stream>>>(
      args, col, CH, Div::make((Index)(B * row_vecs)), Div::make((Index)row_vecs),
      (Index)total, dst_slot_vecs, fault);
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

struct PoolArgs {
  int4* pool;              // (L, NB, 2, BLK, row) codes
  float* scale;            // (L, NB, 2, KV, BLK), or null
  const int4* src[2];      // K, V: (L, B, T, row), contiguous
  const float* ssrc[2];    // K, V scales: element [l, b, h, t] at
                           // l * s_l + b * s_b + h * s_kv + t * s_t
  const int* tables;       // (B, MB)
  const int* pos;          // (B,)
  const unsigned char* active;  // (B,), or null (all active)
  int* fault;
  int64_t B, T, NB, MB, BLK, row_vecs, KV, s_l, s_b, s_kv, s_t;
};

// The pool row of position q of slot b, 0 for none (trash, skipped), -1 for
// a position outside the table, -2 for a table row outside the pool.
__device__ __forceinline__ int64_t pool_row(const PoolArgs& a, int64_t b,
                                            int64_t q) {
  if (q < 0 || q >= a.MB * a.BLK) return -1;
  const int64_t row = a.tables[b * a.MB + q / a.BLK];
  if (row < 0 || row >= a.NB) return -2;
  return row;
}

// grid (B, L, 2 planes).
__global__ void pool_write_kernel(PoolArgs a) {
  const int64_t b = blockIdx.x, l = blockIdx.y;
  const int plane = blockIdx.z;
  if (a.active && !a.active[b]) return;
  const int64_t p0 = a.pos[b];
  const int4* src = a.src[plane] + (l * a.B + b) * a.T * a.row_vecs;
  const int64_t count = a.T * a.row_vecs;
  for (int64_t i = threadIdx.x; i < count; i += blockDim.x) {
    const int64_t t = i / a.row_vecs, vec = i - t * a.row_vecs;
    const int64_t row = pool_row(a, b, p0 + t);
    if (row <= 0) {
      if (row < 0 && vec == 0 && plane == 0)
        atomicOr(a.fault, row == -1 ? 16 : 32);
      continue;
    }
    const int64_t off = (p0 + t) % a.BLK;
    a.pool[(((l * a.NB + row) * 2 + plane) * a.BLK + off) * a.row_vecs + vec] =
        src[i];
  }
  if (!a.scale) return;
  const float* ssrc = a.ssrc[plane] + l * a.s_l + b * a.s_b;
  for (int64_t i = threadIdx.x; i < a.KV * a.T; i += blockDim.x) {
    const int64_t h = i / a.T, t = i - h * a.T;
    const int64_t row = pool_row(a, b, p0 + t);
    if (row <= 0) continue;
    const int64_t off = (p0 + t) % a.BLK;
    a.scale[(((l * a.NB + row) * 2 + plane) * a.KV + h) * a.BLK + off] =
        ssrc[h * a.s_kv + t * a.s_t];
  }
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
      CH <= 0 || CH > 2147483647 || row_bytes <= 0 || row_bytes % 16 != 0 ||
      dst_slot_bytes % 16 != 0)
    return (int)cudaErrorInvalidValue;
  BankArgs args;
  for (int j = 0; j < n_arrays; ++j) {
    args.dst[j] = const_cast<void*>(dsts[j]);
    args.src[j] = srcs[j];
  }
  const uint64_t row_vecs = (uint64_t)row_bytes / 16;
  const uint64_t total = (uint64_t)n_arrays * B * row_vecs;
  const int* c = static_cast<const int*>(col);
  int* f = static_cast<int*>(fault);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (total >= (uint64_t)INT32_MAX)
    launch_bank<PlainDiv64>(args, c, (int)CH, B, row_vecs, total,
                            dst_slot_bytes / 16, f, st);
  else if (power_of_two(B) && power_of_two(row_vecs))
    launch_bank<ShiftDiv32>(args, c, (int)CH, B, row_vecs, total,
                            dst_slot_bytes / 16, f, st);
  else
    launch_bank<FastDiv32>(args, c, (int)CH, B, row_vecs, total,
                           dst_slot_bytes / 16, f, st);
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

// pool: (L, NB, 2, BLK, row_bytes) codes; scale: (L, NB, 2, KV, BLK) f32 or
// null; k, v: (L, B, T, row_bytes), contiguous; ks, vs: f32 scales with
// element [l, b, h, t] at l * s_l + b * s_b + h * s_kv + t * s_t (null with
// a null scale pool); tables: (B, MB) int32; pos: (B,) int32; active: (B,)
// bytes, or null; fault: one int32. All device pointers.
extern "C" int ppq_pool_write(void* pool, void* scale, const void* k,
                              const void* v, const void* ks, const void* vs,
                              const void* tables, const void* pos,
                              const void* active, void* fault, int64_t L,
                              int64_t B, int64_t T, int64_t NB, int64_t MB,
                              int64_t BLK, int64_t row_bytes, int64_t KV,
                              int64_t s_l, int64_t s_b, int64_t s_kv,
                              int64_t s_t, void* stream) {
  if (L <= 0 || L > 65535 || B <= 0 || B > 2147483647 || T <= 0 || NB <= 0 ||
      MB <= 0 || BLK <= 0 || row_bytes <= 0 || row_bytes % 16 != 0 ||
      (scale && (KV <= 0 || !ks || !vs)))
    return (int)cudaErrorInvalidValue;
  PoolArgs a;
  a.pool = static_cast<int4*>(pool);
  a.scale = static_cast<float*>(scale);
  a.src[0] = static_cast<const int4*>(k);
  a.src[1] = static_cast<const int4*>(v);
  a.ssrc[0] = static_cast<const float*>(ks);
  a.ssrc[1] = static_cast<const float*>(vs);
  a.tables = static_cast<const int*>(tables);
  a.pos = static_cast<const int*>(pos);
  a.active = static_cast<const unsigned char*>(active);
  a.fault = static_cast<int*>(fault);
  a.B = B;
  a.T = T;
  a.NB = NB;
  a.MB = MB;
  a.BLK = BLK;
  a.row_vecs = row_bytes / 16;
  a.KV = KV;
  a.s_l = s_l;
  a.s_b = s_b;
  a.s_kv = s_kv;
  a.s_t = s_t;
  const dim3 grid((unsigned int)B, (unsigned int)L, 2u);
  pool_write_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

#ifdef PPQ_MEASURE
// A measurement build only (nvcc -DPPQ_MEASURE, chip_smoke.py --attention):
// what a launch costs for the size of its arguments, an empty kernel that
// takes bank_write's 2 KiB pointer table against one that takes 16 bytes.
struct SmallArgs {
  const void* a;
  const void* b;
};

__global__ void empty_bank_args_kernel(BankArgs) {}
__global__ void empty_small_args_kernel(SmallArgs) {}

extern "C" int ppq_empty_launch_args(int table, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (table) {
    BankArgs args = {};
    empty_bank_args_kernel<<<1, 32, 0, st>>>(args);
  } else {
    empty_small_args_kernel<<<1, 32, 0, st>>>(SmallArgs{nullptr, nullptr});
  }
  return (int)cudaGetLastError();
}
#endif
