// Fused dequant-matmul for weight-only INT8 and INT4 serving on sm_90a:
//   qmm_int8:   out[m, f] = ((x[m, :] . w[:, f]) * scale[f]) [* row[m]]
//                           [+ residual[m, f]]
//   qmm_int4:   the same with w packed split-half: byte row r of the
//               (D/2, F) weight holds w[r] in its low nibble and w[r + D/2]
//               in its high nibble
//   qmm_gateup: g = (x . w[:, j]) * scale[j] [* row], u the same at column
//               j + F/2; out[m, j] = g * sigmoid(g) * u (INT8 or INT4 weight)
// x is bf16 (M, D), w is int8 (D, F) row-major, the dot accumulates in f32,
// the whole epilogue runs in f32 in that order, and there is one cast to the
// output type.
//
// Replaces the TPU kernels `_qmm8_kernel` / `_mk_qmm8_ex` (`qmm_int8`),
// `_mk_qmm4_ex` (`qmm_int4`), `_qmm8_gu_kernel` and `_qmm4_gu_kernel`
// (`qmm_gateup`, both bodies) of ppq_tpu/kernels/qmm.py.
// The TPU kernel keeps the whole activation in its fast memory and streams
// (D, TF) weight panels through a sequential grid. Here blocks run in
// parallel and nothing carries over. Common to every body:
//   * a block owns a 128-row output tile of 128 weight columns (one panel of
//     128, or gate-up's two of 64, j and j + F/2, against one x tile, with
//     silu(g) * u applied to the accumulators, so the (M, F) projection
//     never reaches device memory) and sums a range of the contraction
//     depth in steps of 64;
//   * split-K: S blocks share a tile's depth (grid z); each writes its f32
//     partial tile to a workspace, and the last to arrive adds the S
//     partials in the fixed order s = 0 .. S-1 and runs the epilogue, in the
//     same launch (finish). S comes from the weight's shape and the body
//     alone (kernels/qmm.py `_splits`): the quickest by the body's cost
//     model of waves, steps and partial tiles for one row tile, each split
//     at least 4 steps deep; 1 where the column tiles alone fill the card.
//     It does not depend on M, so a row's sums are taken in the same order
//     whatever the batch;
//   * a ring of `cp.async.cg` copies keeps x (bf16; shared by every block,
//     so it comes from L2) and the raw weight of the next three steps in
//     flight while one step is converted and multiplied;
//   * the weight becomes bf16 on chip, exactly, in a tile kept transposed
//     (k contiguous) under an XOR swizzle that keeps the stores and the
//     tensor cores' reads off each other's banks;
//   * a 128 x 128 tile holds 64 f32 accumulators a thread, so one block an
//     SM runs without spills (two, at 128 registers, spilled and ran 1.5x
//     slower: PERF.md);
//   * the epilogue issues all its loads (residual, scales, row scales)
//     before it uses any.
// The INT8 bodies (qmm8_kernel): a 4-stage ring; the biased byte becomes
// the low mantissa bits of 2^23 and 2^23 + 128 is taken off in f32; the
// product is `mma.sync.m16n8k16` on bf16 fragments loaded from shared
// memory, 8 warps as 4 (rows) x 2 (columns).
// The INT4 bodies (qmm4_kernel), split-half packed: a step reads 32 packed
// rows (half the INT8 bytes) and x[:, k0 : k0 + 32] beside x[:, D/2 + k0 :
// D/2 + k0 + 32]; a packed byte's low nibble is k in [0, 32) of the step and
// its high nibble k in [32, 64), each made bf16 by one bf16x2 fma on its
// biased value. The product is `wgmma.mma_async.m64n128k16`: two
// warpgroups, each 64 rows of the tile, read x and the weight tile from
// shared memory in the 128-byte swizzle; the weight tile is double-buffered
// and the products are asynchronous, so step i + 1's conversion runs while
// step i's products are in flight.
// What bounds them on an H100 at the decode shapes (M = 128) is latency,
// not bytes or operations: D * F weight bytes (half that for INT4) against
// 2 * M * D * F operations are about 2.5 us each at D = 2048, F = 4096, but
// a 64-deep step of a 128 x 128 tile costs ~1.2 us on mma.sync, whatever
// the ring's depth (the products, fragments through shared memory, and the
// loads barely overlap), and ~0.8 us on wgmma, three times the tensor
// cores' time: the warps that multiply also convert and load (PERF.md).
//
// The epilogue uses __fmul_rn / __fadd_rn so that no multiply-add is
// contracted: scale, row scale and residual round one by one, as in the
// plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // rows of x per block
constexpr int BK = 64;        // contraction depth per step
constexpr int THREADS = 256;  // 8 warps: 4 along rows, 2 along columns
constexpr int LDA = BK + 8;   // bf16 elements per x row in shared memory
constexpr int KW = BK / 2;    // 32-bit words (bf16 pairs) per weight column

// INT8 bodies: 128 weight columns a step through a STAGES-deep ring; a ring
// slot holds the x tile (BM x LDA bf16) and the raw weight (BK rows of
// WLD bytes, rows padded by 16 bytes), then the bf16 weight tile follows
constexpr int STAGES = 4;
constexpr int WCOLS = 128;
constexpr int WLD = WCOLS + 16;
constexpr int SLOT_X = BM * LDA * 2;
constexpr int SLOT = SLOT_X + BK * WLD;
constexpr int RING_BYTES = STAGES * SLOT + WCOLS * KW * 4;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from global to shared memory, asynchronously; bytes < 16 fills
// the rest with zeros (0: all zeros, src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Word index of (column n, k pair kw) in the transposed weight tile.
__device__ __forceinline__ int b_index(int n, int kw) {
  return n * KW + (kw ^ ((((n >> 3) ^ n) & 7) << 2));
}

// Two INT8 weight values as a pair of bf16, given biased (b ^ 0x80, in
// 0..255): byte j of each word goes into the low mantissa bits of 2^23,
// 2^23 + 128 comes off in f32 (exact), and the two floats' top halves are
// the bf16 pair (exact for |v| <= 128).
__device__ __forceinline__ uint32_t pack_bf16_biased(uint32_t even,
                                                     uint32_t odd, int j) {
  const uint32_t sel = 0x7540u | (uint32_t)j;
  const float lo = __fsub_rn(__uint_as_float(__byte_perm(even, 0x4B000000u,
                                                         sel)),
                             8388736.0f);
  const float hi = __fsub_rn(__uint_as_float(__byte_perm(odd, 0x4B000000u,
                                                         sel)),
                             8388736.0f);
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}

__device__ __forceinline__ float silu_mul(float g, float u) {
  const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-g)));
  return __fmul_rn(__fmul_rn(g, sig), u);
}

// One BK step of the block's product: the x tile As (BM x LDA) against
// NPAN weight tiles of BN columns at Bs, Bs + BN * KW, ... into the warp's
// accumulators (rows warp_m * 32 + [0, 32), columns warp_n * NT * 8 +
// [0, NT * 8) of each panel).
template <int NT, int NPAN>
__device__ __forceinline__ void mma_step(float (&acc)[NPAN][2][NT][4],
                                         const __nv_bfloat16* As,
                                         const uint32_t* Bs, int warp_m,
                                         int warp_n, int g, int c) {
  constexpr int BN = 16 * NT;
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const __nv_bfloat16* base =
          &As[(warp_m * 32 + mt * 16 + g) * LDA + ks * 16 + 2 * c];
      a[mt][0] = *reinterpret_cast<const uint32_t*>(base);
      a[mt][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LDA);
      a[mt][2] = *reinterpret_cast<const uint32_t*>(base + 8);
      a[mt][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LDA + 8);
    }
#pragma unroll
    for (int p = 0; p < NPAN; ++p) {
      const uint32_t* tile = Bs + p * BN * KW;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = warp_n * (NT * 8) + nt * 8 + g;
        uint32_t b[2];
        b[0] = tile[b_index(n, ks * 8 + c)];
        b[1] = tile[b_index(n, ks * 8 + c + 4)];
        mma_bf16(acc[p][0][nt], a[0], b);
        mma_bf16(acc[p][1][nt], a[1], b);
      }
    }
  }
}

// Returns t * scale [* row], gate-up: silu of that times u * scale_u
// [* row]; one rounding at a time, as the plain version rounds.
template <bool GATEUP>
__device__ __forceinline__ float scaled(float t, float u, float sg, float su,
                                        const float* row_scale, float rs) {
  t = __fmul_rn(t, sg);
  if (row_scale) t = __fmul_rn(t, rs);
  if (GATEUP) {
    u = __fmul_rn(u, su);
    if (row_scale) u = __fmul_rn(u, rs);
    t = silu_mul(t, u);
  }
  return t;
}

// N neighbouring outputs of one row, from index `at` of the (M, Fo) output:
// one cast, one store.
template <int N>
__device__ __forceinline__ void store(const float (&v)[N], size_t at,
                                      void* __restrict__ out, int out_f32) {
  if (out_f32) {
    float* o = static_cast<float*>(out) + at;
#pragma unroll
    for (int e = 0; e < N; e += 2)
      *reinterpret_cast<float2*>(o + e) = make_float2(v[e], v[e + 1]);
  } else {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + at;
#pragma unroll
    for (int e = 0; e < N; e += 2)
      *reinterpret_cast<__nv_bfloat162*>(o + e) =
          __floats2bfloat162_rn(v[e], v[e + 1]);
  }
}

// The end of every body. S = 1 (gridDim.z): the epilogue on the thread's
// accumulators, where element e of tile (p, mt, nt) is row rows + 16 mt + g
// (+8 for e >= 2) and column cols + 8 nt + 2 c + (e & 1) of panel p of the
// block's tile (the layout of mma.sync's m16n8 tiles and of wgmma's
// m64nN accumulators alike). S > 1, split-K across the z blocks of a tile:
// every block writes its partial sums to its plane of ws (S, M, Fw) and
// counts itself in; the block that arrives last resets the counter for the
// next launch and, for each output, adds the S planes in the order
// s = 0 .. S-1 and applies the same epilogue. The others just return. The
// order of the sum does not depend on which block arrives last, so two
// launches on the same inputs agree bit for bit.
template <int MT, int NT, bool GATEUP>
__device__ __forceinline__ void finish(
    float (&acc)[GATEUP ? 2 : 1][MT][NT][4], const float* __restrict__ scale,
    const float* __restrict__ row_scale, const void* __restrict__ residual,
    int residual_f32, void* __restrict__ out, int out_f32, int M, int Fo,
    float* ws, int* counters, int m0, int n0, int rows, int cols, int g,
    int c) {
  constexpr int NPAN = GATEUP ? 2 : 1;
  constexpr int BN = WCOLS / NPAN;
  const int S = gridDim.z;
  if (S == 1) {
    // the epilogue's inputs for every output the thread writes, loaded
    // before any is used
    float sc[NPAN][NT][2], rs[MT][2];
    float2 res[MT][2][NT];
#pragma unroll
    for (int p = 0; p < NPAN; ++p)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          sc[p][nt][e] = scale[p * Fo + n0 + cols + nt * 8 + 2 * c + e];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + rows + mt * 16 + g + half * 8;
        rs[mt][half] = row_scale && row < M ? row_scale[row] : 1.0f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const size_t at = (size_t)row * Fo + n0 + cols + nt * 8 + 2 * c;
          res[mt][half][nt] = make_float2(0.0f, 0.0f);
          if (GATEUP || !residual || row >= M) continue;
          res[mt][half][nt] = residual_f32
              ? *reinterpret_cast<const float2*>(
                    static_cast<const float*>(residual) + at)
              : __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                    static_cast<const __nv_bfloat16*>(residual) + at));
        }
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + rows + mt * 16 + g + half * 8;
        if (row >= M) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = n0 + cols + nt * 8 + 2 * c;
          const float r[2] = {res[mt][half][nt].x, res[mt][half][nt].y};
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = scaled<GATEUP>(acc[0][mt][nt][half * 2 + e],
                                  acc[NPAN - 1][mt][nt][half * 2 + e],
                                  sc[0][nt][e], sc[NPAN - 1][nt][e],
                                  row_scale, rs[mt][half]);
            if (!GATEUP && residual) v[e] = __fadd_rn(v[e], r[e]);
          }
          store<2>(v, (size_t)row * Fo + col, out, out_f32);
        }
      }
    }
    return;
  }

  __shared__ int last;
  const int Fw = NPAN * Fo;
  const size_t plane = (size_t)M * Fw;
#pragma unroll
  for (int p = 0; p < NPAN; ++p)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + rows + mt * 16 + g + half * 8;
        if (row >= M) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          __stcg(reinterpret_cast<float2*>(
                     ws + blockIdx.z * plane + (size_t)row * Fw + p * Fo +
                     n0 + cols + nt * 8 + 2 * c),
                 make_float2(acc[p][mt][nt][half * 2],
                             acc[p][mt][nt][half * 2 + 1]));
      }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* counter = counters + blockIdx.y * gridDim.x + blockIdx.x;
    last = atomicAdd(counter, 1) == S - 1;
    if (last) *counter = 0;  // every block of the tile has arrived
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the tile's outputs four columns a chunk, consecutive threads on
  // consecutive chunks (PER chunks a thread in each panel); plane s + 1's
  // loads go out before plane s is added
  constexpr int CH = BN / 4, PER = BM * CH / THREADS;
  float4 t[NPAN][PER], next[NPAN][PER];
  auto load = [&](float4 (&dst)[NPAN][PER], int s) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int v = threadIdx.x + k * THREADS;
      const int row = m0 + v / CH, col = n0 + (v % CH) * 4;
#pragma unroll
      for (int p = 0; p < NPAN; ++p)
        dst[p][k] = row < M
            ? __ldcg(reinterpret_cast<const float4*>(
                  ws + s * plane + (size_t)row * Fw + p * Fo + col))
            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  load(t, 0);
  load(next, 1);
  for (int s = 1; s < S; ++s) {
    float4 cur[NPAN][PER];
#pragma unroll
    for (int p = 0; p < NPAN; ++p)
#pragma unroll
      for (int k = 0; k < PER; ++k) cur[p][k] = next[p][k];
    if (s + 1 < S) load(next, s + 1);
#pragma unroll
    for (int p = 0; p < NPAN; ++p)
#pragma unroll
      for (int k = 0; k < PER; ++k)
        t[p][k] = make_float4(
            __fadd_rn(t[p][k].x, cur[p][k].x), __fadd_rn(t[p][k].y, cur[p][k].y),
            __fadd_rn(t[p][k].z, cur[p][k].z), __fadd_rn(t[p][k].w, cur[p][k].w));
  }
  // the epilogue's own inputs, every chunk's loads issued before any is
  // used (a thread's chunks share their columns): the residual's raw bits,
  // 16 bytes of f32 or 8 of bf16 a chunk
  const int col = n0 + (threadIdx.x % CH) * 4;
  float sg[4], su[4], rs[PER];
  uint4 raw[PER];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    sg[e] = scale[col + e];
    su[e] = GATEUP ? scale[Fo + col + e] : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int row = m0 + (threadIdx.x + k * THREADS) / CH;
    rs[k] = row_scale && row < M ? row_scale[row] : 1.0f;
    raw[k] = make_uint4(0u, 0u, 0u, 0u);
  }
  const bool has_res = !GATEUP && residual;
  if (has_res && residual_f32) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int row = m0 + (threadIdx.x + k * THREADS) / CH;
      if (row < M)
        raw[k] = *reinterpret_cast<const uint4*>(
            static_cast<const float*>(residual) + (size_t)row * Fo + col);
    }
  } else if (has_res) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int row = m0 + (threadIdx.x + k * THREADS) / CH;
      if (row < M) {
        const uint2 h = *reinterpret_cast<const uint2*>(
            static_cast<const __nv_bfloat16*>(residual) + (size_t)row * Fo +
            col);
        raw[k] = make_uint4(h.x, h.y, 0u, 0u);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int row = m0 + (threadIdx.x + k * THREADS) / CH;
    if (row >= M) continue;
    const float4 a = t[0][k], b = t[NPAN - 1][k];
    const float tv[4] = {a.x, a.y, a.z, a.w}, uv[4] = {b.x, b.y, b.z, b.w};
    float rv[4];
    if (residual_f32) {
      rv[0] = __uint_as_float(raw[k].x);
      rv[1] = __uint_as_float(raw[k].y);
      rv[2] = __uint_as_float(raw[k].z);
      rv[3] = __uint_as_float(raw[k].w);
    } else {
      const float2 lo = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&raw[k].x));
      const float2 hi = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&raw[k].y));
      rv[0] = lo.x, rv[1] = lo.y, rv[2] = hi.x, rv[3] = hi.y;
    }
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[e] = scaled<GATEUP>(tv[e], uv[e], sg[e], su[e], row_scale, rs[k]);
      if (has_res) o[e] = __fadd_rn(o[e], rv[e]);
    }
    store<4>(o, (size_t)row * Fo + col, out, out_f32);
  }
}

// The INT8 bodies. GATEUP: two 64-column panels, columns n and n + Fo, and
// the silu epilogue; Fo is then the output width and the weight has 2 * Fo
// columns. Grid (Fo / BN, row tiles, S); block z sums steps
// [z * per, min(D / BK, (z + 1) * per)).
template <bool GATEUP>
__global__ void __launch_bounds__(THREADS, 1)
qmm8_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ scale,
            const float* __restrict__ row_scale,
            const void* __restrict__ residual, int residual_f32,
            void* __restrict__ out, int out_f32, int M, int D, int Fo,
            float* __restrict__ ws, int* __restrict__ counters, int per) {
  constexpr int NPAN = GATEUP ? 2 : 1;
  constexpr int BN = WCOLS / NPAN;  // output columns of a tile
  constexpr int NT = BN / 16;       // 8-column tiles a warp, each panel
  const int Fw = GATEUP ? 2 * Fo : Fo;

  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* Bs = reinterpret_cast<uint32_t*>(smem + STAGES * SLOT);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * per;
  const int steps = min(D / BK, k_begin + per) - k_begin;

  float acc[NPAN][2][NT][4];
#pragma unroll
  for (int p = 0; p < NPAN; ++p)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][mt][nt][e] = 0.0f;

  // step i's copies into ring slot i % STAGES: x, BM rows of 8 16-byte
  // chunks (rows past M read as zeros); the weight, BK rows of 8 chunks of
  // 16 columns (panel p's columns at p * BN of the slot)
  auto issue = [&](int i) {
    unsigned char* slot = smem + (i % STAGES) * SLOT;
    const int k0 = (k_begin + i) * BK;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = tid + j * THREADS, r = v >> 3, ch = v & 7;
      const int row = m0 + r;
      cp_async16(slot + r * (LDA * 2) + ch * 16,
                 x + (size_t)(row < M ? row : 0) * D + k0 + ch * 8,
                 row < M ? 16 : 0);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int v = tid + j * THREADS, r = v >> 3, ch = v & 7;
      const int col = ch * 16;  // of the slot's 128
      cp_async16(slot + SLOT_X + r * WLD + col,
                 w + (size_t)(k0 + r) * Fw + (col / BN) * Fo + n0 + col % BN,
                 16);
    }
  };

  // the raw weight of a slot into the bf16 tile Bs: task v moves k pair kp
  // (rows 2 kp and 2 kp + 1) of 8 columns from 8 * ng; a warp's 32 tasks
  // take 4 k pairs by 8 column groups, so the stores to Bs meet no bank
  // twice
  auto convert = [&](int i) {
    const unsigned char* raw = smem + (i % STAGES) * SLOT + SLOT_X;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int v = tid + j * THREADS;
      const int kp = (v & 3) | (((v >> 5) & 7) << 2);
      const int ng = ((v >> 2) & 7) | (((v >> 8) & 1) << 3);
      const uint2 even =
          *reinterpret_cast<const uint2*>(raw + 2 * kp * WLD + ng * 8);
      const uint2 odd =
          *reinterpret_cast<const uint2*>(raw + (2 * kp + 1) * WLD + ng * 8);
      const uint32_t e[2] = {even.x ^ 0x80808080u, even.y ^ 0x80808080u};
      const uint32_t o[2] = {odd.x ^ 0x80808080u, odd.y ^ 0x80808080u};
#pragma unroll
      for (int b = 0; b < 8; ++b)
        Bs[b_index(ng * 8 + b, kp)] =
            pack_bf16_biased(e[b >> 2], o[b >> 2], b & 3);
    }
  };

  // STAGES - 1 steps in flight before the first is used; an empty group
  // where there is no step keeps one group a step for cp_async_wait
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < steps) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of step i landed
    // every thread's copies of step i landed, and step i - 1's products
    // are done: its ring slot and Bs are free
    __syncthreads();
    if (i + STAGES - 1 < steps) issue(i + STAGES - 1);
    cp_async_commit();
    convert(i);
    __syncthreads();
    mma_step<NT, NPAN>(
        acc,
        reinterpret_cast<const __nv_bfloat16*>(smem + (i % STAGES) * SLOT), Bs,
        warp_m, warp_n, g, c);
  }
  finish<2, NT, GATEUP>(acc, scale, row_scale, residual, residual_f32, out,
                        out_f32, M, Fo, ws, counters, m0, n0, warp_m * 32,
                        warp_n * (NT * 8), g, c);
}

// The INT4 bodies on wgmma (qmm4_kernel): a ring of STAGES4 slots, each the
// x tile (BM rows of 128 bytes, the 128-byte swizzle that wgmma reads) and
// the raw packed weight (BK / 2 rows of WLD bytes), 1024-byte aligned; then
// two bf16 weight tiles (WCOLS rows of 128 bytes, swizzled the same way)
constexpr int STAGES4 = 5;
constexpr int SWROW = 128;  // bytes of a 64-deep bf16 row: one swizzle atom
constexpr int SLOT4_X = BM * SWROW;
constexpr int SLOT4 = (SLOT4_X + BK / 2 * WLD + 1023) / 1024 * 1024;
constexpr int TILE4 = WCOLS * SWROW;
constexpr int RING4_BYTES = 1024 + STAGES4 * SLOT4 + 2 * TILE4;

// wgmma's view of a K-major tile of 128-byte rows in the 128-byte swizzle
// (chunk j of row r at chunk j ^ (r & 7)), 1024-byte aligned: the start
// address, the 1024 bytes between 8-row groups (SBO), LBO unused (1), and
// the swizzle mode (1: 128 bytes). A 16-deep slice starts 32 bytes on.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of the warpgroup's committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// stores to shared memory by ordinary instructions (and cp.async) become
// visible to wgmma's reads (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 128, f32, the warpgroup's accumulators) += A (64 x 16, bf16) *
// B (16 x 128, bf16), both K-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// keeps the compiler from moving reads or writes of the accumulators across
// this point (past a wgmma_wait)
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Column b (0..3) of two packed words (rows k even and k + 1) as two bf16
// pairs, both exact: PLANE 0 the low nibbles, PLANE 1 the high. The biased
// nibble n ^ 8 (0..15) becomes the mantissa of 128.0 in bf16, and one
// bf16x2 fma takes 136 off: (128 + (n ^ 8)) - 136 = the signed nibble.
template <int PLANE>
__device__ __forceinline__ uint32_t nibble_pair(uint32_t even, uint32_t odd,
                                                int b) {
  uint32_t t = __byte_perm(even, odd, (uint32_t)b | ((4u + b) << 8));
  if (PLANE == 1) t >>= 4;
  const uint32_t biased = (t & 0x000F000Fu) ^ 0x43084308u;
  uint32_t v;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(v)
      : "r"(biased), "r"(0x3F803F80u), "r"(0xC308C308u));
  return v;
}

// The INT4 bodies. GATEUP as for qmm8_kernel: the n128 operand is the two
// 64-column panels, so a thread's accumulators hold column j of the gate
// and of the up panel. The weight is (D/2, Fw) packed split-half, D the
// unpacked depth; step i reads packed rows [32 i, 32 i + 32) and the x
// columns [32 i, 32 i + 32) and [D/2 + 32 i, D/2 + 32 i + 32): the low
// nibbles are k in [0, 32) of the step, the high k in [32, 64). Two
// warpgroups, each 64 rows of the tile, issue four m64n128k16 products a
// step on the x slot and the bf16 weight tile; the tile is double-buffered,
// so step i + 1 is converted while step i's products are in flight. Grid
// and splits as for qmm8_kernel.
template <bool GATEUP>
__global__ void __launch_bounds__(THREADS, 1)
qmm4_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ scale,
            const float* __restrict__ row_scale,
            const void* __restrict__ residual, int residual_f32,
            void* __restrict__ out, int out_f32, int M, int D, int Fo,
            float* __restrict__ ws, int* __restrict__ counters, int per) {
  constexpr int NPAN = GATEUP ? 2 : 1;
  constexpr int BN = WCOLS / NPAN;  // output columns of a tile
  constexpr int NT = 16 / NPAN;     // 8-column tiles of each panel
  const int Fw = GATEUP ? 2 * Fo : Fo;

  extern __shared__ __align__(16) unsigned char smem[];
  // the swizzle is taken on shared addresses: align the ring to 1024 bytes
  const uint32_t base_addr = (uint32_t)__cvta_generic_to_shared(smem);
  unsigned char* ring = smem + ((1024 - (base_addr & 1023)) & 1023);
  const uint32_t ring_addr = (uint32_t)__cvta_generic_to_shared(ring);
  uint32_t* tiles = reinterpret_cast<uint32_t*>(ring + STAGES4 * SLOT4);
  const uint32_t tiles_addr = ring_addr + STAGES4 * SLOT4;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int wg = warp >> 2;  // warpgroup: rows 64 wg .. 64 wg + 63
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * per;
  const int steps = min(D / BK, k_begin + per) - k_begin;

  float acc[NPAN][1][NT][4];
  float (&d)[64] = reinterpret_cast<float (&)[64]>(acc);
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;

  // step i's copies into ring slot i % STAGES4: x, BM rows of 8 16-byte
  // chunks, chunk ch (0-3 the low half of the depth, 4-7 the high half) at
  // ch ^ (r & 7) of row r (rows past M read as zeros); the packed weight,
  // 32 rows of 8 chunks of 16 columns (panel p's columns at p * BN)
  auto issue = [&](int i) {
    unsigned char* slot = ring + (i % STAGES4) * SLOT4;
    const int k0 = (k_begin + i) * (BK / 2);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = tid + j * THREADS, r = v >> 3, ch = v & 7;
      const int row = m0 + r;
      cp_async16(slot + r * SWROW + ((ch ^ (r & 7)) << 4),
                 x + (size_t)(row < M ? row : 0) * D + (ch >> 2) * (D / 2) +
                     k0 + (ch & 3) * 8,
                 row < M ? 16 : 0);
    }
    const int r = tid >> 3, col = (tid & 7) * 16;
    cp_async16(slot + SLOT4_X + r * WLD + col,
               w + (size_t)(k0 + r) * Fw + (col / BN) * Fo + n0 + col % BN,
               16);
  };

  // the packed weight of a slot into bf16 tile t: lane l of warp v takes
  // packed rows 2 kp and 2 kp + 1 (kp = l & 15) of the 8 columns from
  // 8 * (2 v + (l >> 4)) and writes each column's low-nibble pair to word
  // kp and its high-nibble pair to word kp + 16 of the column's row. A
  // store's rows share their swizzle (the column's low three bits), and the
  // two halves of a warp write the two planes in the opposite order, so
  // its 32 words fall on 32 banks.
  auto convert = [&](int i, int t) {
    const unsigned char* raw = ring + (i % STAGES4) * SLOT4 + SLOT4_X;
    uint32_t* tile = tiles + t * (TILE4 / 4);
    const int kp = lane & 15, h = lane >> 4;
    const int ng = 2 * warp + h;
    const uint2 even =
        *reinterpret_cast<const uint2*>(raw + 2 * kp * WLD + ng * 8);
    const uint2 odd =
        *reinterpret_cast<const uint2*>(raw + (2 * kp + 1) * WLD + ng * 8);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const uint32_t ev = b < 4 ? even.x : even.y;
      const uint32_t od = b < 4 ? odd.x : odd.y;
      const uint32_t lo = nibble_pair<0>(ev, od, b & 3);
      const uint32_t hi = nibble_pair<1>(ev, od, b & 3);
      const int n = ng * 8 + b;
      uint32_t* row = tile + n * (SWROW / 4);
      row[(kp + 16 * h) ^ (b << 2)] = h ? hi : lo;
      row[(kp + 16 * (1 - h)) ^ (b << 2)] = h ? lo : hi;
    }
  };

  // STAGES4 - 2 steps in flight before the first is used (a slot is free
  // once the products of the step two before have completed); an empty
  // group where there is no step keeps one group a step for cp_async_wait
#pragma unroll
  for (int i = 0; i < STAGES4 - 2; ++i) {
    if (i < steps) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<STAGES4 - 3>();  // this thread's copies of step i landed
    // every thread's copies of step i landed, and step i - 2's products are
    // done (each warpgroup waited for them at step i - 1): its ring slot
    // and weight tile are free
    __syncthreads();
    if (i + STAGES4 - 2 < steps) issue(i + STAGES4 - 2);
    cp_async_commit();
    convert(i, i & 1);
    fence_proxy_async();
    __syncthreads();
    const uint32_t a = ring_addr + (i % STAGES4) * SLOT4 + wg * 64 * SWROW;
    const uint32_t b = tiles_addr + (i & 1) * TILE4;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n128k16(d, sw128_desc(a + kk * 32), sw128_desc(b + kk * 32));
    wgmma_commit();
    wgmma_wait<1>();  // step i - 1's products are done
  }
  wgmma_wait<0>();
  pin(d);
  finish<1, NT, GATEUP>(acc, scale, row_scale, residual, residual_f32, out,
                        out_f32, M, Fo, ws, counters, m0, n0,
                        64 * wg + 16 * (warp & 3), 0, g, c);
}

// Above 48 KB a block's shared memory must be asked for, once per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return bytes > 48 * 1024
      ? cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes)
      : cudaSuccess;
}

template <bool GATEUP, bool INT4>
int launch(const void* x, const void* w, const void* scale,
           const void* row_scale, const void* residual, int residual_f32,
           void* out, int out_f32, int64_t M, int64_t D, int64_t Fo,
           int splits, void* ws, void* counters, cudaStream_t stream) {
  // 128 weight columns a step: a 128-column tile, or gate-up's two of 64
  const int bn = WCOLS / (GATEUP ? 2 : 1);
  if (M <= 0 || D <= 0 || Fo <= 0 || D % BK != 0 || Fo % bn != 0)
    return (int)cudaErrorInvalidValue;
  // S splits of `per` steps each, the last one shorter, none empty
  const int steps = (int)(D / BK);
  const int per = splits > 0 ? (steps + splits - 1) / splits : 0;
  if (splits < 1 || (splits - 1) * per >= steps ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)(Fo / bn), (unsigned int)((M + BM - 1) / BM),
                  (unsigned int)splits);
  constexpr auto kernel = INT4 ? qmm4_kernel<GATEUP> : qmm8_kernel<GATEUP>;
  constexpr int bytes = INT4 ? RING4_BYTES : RING_BYTES;
  static const cudaError_t attr = allow_smem(kernel, bytes);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(row_scale),
      residual, residual_f32, out, out_f32, (int)M, (int)D, (int)Fo,
      static_cast<float*>(ws), static_cast<int*>(counters), per);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (M, D) bf16; w: (D, F) int8; scale: (F,) f32; row_scale: (M,) f32 or
// null; residual: (M, F) bf16 or f32, or null; out: (M, F) bf16 or f32.
// splits: S, the blocks that share a tile's depth; S > 1 takes ws, S * M * F
// floats, and counters, one int a tile, zero before the first launch (each
// launch leaves them zero).
extern "C" int ppq_qmm_int8(const void* x, const void* w, const void* scale,
                            const void* row_scale, const void* residual,
                            int residual_f32, void* out, int out_f32,
                            int64_t M, int64_t D, int64_t F, int splits,
                            void* ws, void* counters, void* stream) {
  return launch<false, false>(x, w, scale, row_scale, residual, residual_f32,
                              out, out_f32, M, D, F, splits, ws, counters,
                              static_cast<cudaStream_t>(stream));
}

// w: (D / 2, F) int8, split-half packed; D is the unpacked depth of x.
// splits, ws and counters as for ppq_qmm_int8.
extern "C" int ppq_qmm_int4(const void* x, const void* w, const void* scale,
                            const void* row_scale, const void* residual,
                            int residual_f32, void* out, int out_f32,
                            int64_t M, int64_t D, int64_t F, int splits,
                            void* ws, void* counters, void* stream) {
  return launch<false, true>(x, w, scale, row_scale, residual, residual_f32,
                             out, out_f32, M, D, F, splits, ws, counters,
                             static_cast<cudaStream_t>(stream));
}

// w: (D, 2 * Fo) int8, [gate | up]; scale: (2 * Fo,) f32; out: (M, Fo).
// splits as for ppq_qmm_int8, ws then S * M * 2 * Fo floats.
extern "C" int ppq_qmm_gateup(const void* x, const void* w, const void* scale,
                              const void* row_scale, void* out, int out_f32,
                              int64_t M, int64_t D, int64_t Fo, int splits,
                              void* ws, void* counters, void* stream) {
  return launch<true, false>(x, w, scale, row_scale, nullptr, 0, out,
                             out_f32, M, D, Fo, splits, ws, counters,
                             static_cast<cudaStream_t>(stream));
}

// w: (D / 2, 2 * Fo) int8, split-half packed [gate | up]; D unpacked.
// splits as for ppq_qmm_gateup.
extern "C" int ppq_qmm_gateup_int4(const void* x, const void* w,
                                   const void* scale, const void* row_scale,
                                   void* out, int out_f32, int64_t M,
                                   int64_t D, int64_t Fo, int splits, void* ws,
                                   void* counters, void* stream) {
  return launch<true, true>(x, w, scale, row_scale, nullptr, 0, out, out_f32,
                            M, D, Fo, splits, ws, counters,
                            static_cast<cudaStream_t>(stream));
}
