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
// parallel and nothing carries over, so each block owns a 128-row by 64- or
// 32-column output tile and loops over the contraction depth itself:
//   * the weight bytes are read from device memory once, as int8, 8 bytes a
//     thread; int8 -> bf16 is exact and happens in registers on the way to
//     shared memory, where the tile is kept transposed (k contiguous) so
//     that a tensor-core B fragment is one 32-bit load. An XOR swizzle keeps
//     both the transposed stores and the fragment loads off each other's
//     banks;
//   * the x tile (shared by every block, so it comes from L2) goes to shared
//     memory as bf16 with 16-byte copies, rows padded by 16 bytes;
//   * the product is `mma.sync.m16n8k16` on bf16 fragments with f32
//     accumulators: 8 warps as 4 (rows) x 2 (columns), each 32 rows wide;
//   * the next tile is prefetched into registers while the current one is
//     multiplied (one shared buffer, two barriers a step);
//   * gate-up multiplies two column panels of the same weight (j and
//     j + F/2) against one x tile and applies silu(g) * u to the
//     accumulators, so the (M, F) projection never reaches device memory;
//   * INT4: a step reads 64 packed rows once and unpacks them in registers
//     into two bf16 planes, lo = ((p & 15) ^ 8) - 8 and hi = p >> 4
//     (arithmetic), both exact; the lo plane multiplies x[:, k0 : k0 + 64]
//     and the hi plane x[:, D/2 + k0 : D/2 + k0 + 64], through the same
//     mma body. x and weight tiles double, so shared memory is dynamic.
// What bounds it on an H100 at the decode shapes (M = 128): D * F weight
// bytes against 2 * M * D * F operations are about level, 2.5 us each at
// D = 2048, F = 4096; INT4 halves the bytes (1.3 us at that shape), so the
// operations (2.2 us) bound it. This first version has neither wgmma nor TMA nor a
// deep pipeline, and a narrow weight (F = 2048) gives only 64 blocks for 132
// SMs: it is correct first; its time stands beside the bound in PERF.md.
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

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Word index of (column n, k pair kw) in the transposed weight tile.
__device__ __forceinline__ int b_index(int n, int kw) {
  return n * KW + (kw ^ ((((n >> 3) ^ n) & 7) << 2));
}

// The weight value a byte holds: PLANE 0 of an INT8 weight is the byte;
// of an INT4 weight, PLANE 0 is the low nibble sign-extended and PLANE 1 the
// high nibble (an arithmetic shift).
template <bool INT4, int PLANE>
__device__ __forceinline__ int weight_value(uint32_t word, int shift) {
  const int v = (int)(signed char)(word >> shift);
  if (!INT4) return v;
  return PLANE == 0 ? ((v & 15) ^ 8) - 8 : v >> 4;
}

// Two weight values (k even in the low half, k odd in the high half) as a
// pair of bf16: the top 16 bits of the float are exact for |v| <= 128.
template <bool INT4, int PLANE>
__device__ __forceinline__ uint32_t pack_bf16(uint32_t even, uint32_t odd,
                                              int shift) {
  const float lo = (float)weight_value<INT4, PLANE>(even, shift);
  const float hi = (float)weight_value<INT4, PLANE>(odd, shift);
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
}

__device__ __forceinline__ float silu_mul(float g, float u) {
  const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-g)));
  return __fmul_rn(__fmul_rn(g, sig), u);
}

// Shared memory of one block: PLANES x tiles (BM, LDA) bf16, then
// NPAN * PLANES weight tiles of BN * KW words.
template <int NT, bool GATEUP, bool INT4>
constexpr int smem_bytes() {
  return (INT4 ? 2 : 1) * BM * LDA * 2 +
         (GATEUP ? 2 : 1) * (INT4 ? 2 : 1) * 16 * NT * KW * 4;
}

// NT: 8-column tiles per warp (4: 64-column block, 2: 32-column block).
// GATEUP: two weight panels, columns n and n + Fo, and the silu epilogue;
// Fo is then the output width and the weight has 2 * Fo columns.
// INT4: the weight is (D/2, Fw) packed split-half; D is the unpacked depth.
template <int NT, bool GATEUP, bool INT4>
__global__ void __launch_bounds__(THREADS)
qmm_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ scale, const float* __restrict__ row_scale,
           const void* __restrict__ residual, int residual_f32,
           void* __restrict__ out, int out_f32, int M, int D, int Fo) {
  constexpr int BN = 16 * NT;
  constexpr int NPAN = GATEUP ? 2 : 1;
  constexpr int PLANES = INT4 ? 2 : 1;  // x tiles (and weight planes) a step
  constexpr int NG = BN / 8;            // 8-column groups per weight row
  constexpr int B_THREADS = KW * NG;    // threads that move weight bytes
  const int Fw = GATEUP ? 2 * Fo : Fo;  // columns of the weight
  const int Dx = INT4 ? D / 2 : D;      // packed rows; x offset of plane 1

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  // weight tile (panel p, plane q) at Bs + (p * PLANES + q) * BN * KW
  uint32_t* Bs = reinterpret_cast<uint32_t*>(smem + PLANES * BM * LDA * 2);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // this thread's share of a weight tile: rows 2*kp and 2*kp + 1, eight
  // columns from n0 + 8 * ng
  const int ng = tid % NG, kp = tid / NG;
  const bool moves_b = tid < B_THREADS;

  float acc[NPAN][2][NT][4];  // INT4: both planes sum into one accumulator
#pragma unroll
  for (int p = 0; p < NPAN; ++p)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][mt][nt][e] = 0.0f;

  uint4 a_reg[PLANES][4];
  uint2 b_reg[NPAN][2];

  auto load_tile = [&](int k0) {
#pragma unroll
    for (int q = 0; q < PLANES; ++q) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int v = tid + i * THREADS;
        const int row = m0 + (v >> 3);
        a_reg[q][i] = row < M
            ? *reinterpret_cast<const uint4*>(x + (size_t)row * D + q * Dx +
                                              k0 + (v & 7) * 8)
            : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    if (moves_b) {
#pragma unroll
      for (int p = 0; p < NPAN; ++p) {
        const int8_t* src = w + (size_t)(k0 + 2 * kp) * Fw + n0 + p * Fo + ng * 8;
        b_reg[p][0] = *reinterpret_cast<const uint2*>(src);
        b_reg[p][1] = *reinterpret_cast<const uint2*>(src + Fw);
      }
    }
  };

  auto store_tile = [&]() {
#pragma unroll
    for (int q = 0; q < PLANES; ++q) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int v = tid + i * THREADS;
        *reinterpret_cast<uint4*>(&As[q * BM * LDA + (v >> 3) * LDA +
                                      (v & 7) * 8]) = a_reg[q][i];
      }
    }
    if (moves_b) {
#pragma unroll
      for (int p = 0; p < NPAN; ++p) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t even = j < 4 ? b_reg[p][0].x : b_reg[p][0].y;
          const uint32_t odd = j < 4 ? b_reg[p][1].x : b_reg[p][1].y;
          const int at = b_index(ng * 8 + j, kp);
          Bs[(p * PLANES) * BN * KW + at] =
              pack_bf16<INT4, 0>(even, odd, 8 * (j & 3));
          if constexpr (INT4)
            Bs[(p * PLANES + 1) * BN * KW + at] =
                pack_bf16<INT4, 1>(even, odd, 8 * (j & 3));
        }
      }
    }
  };

  const int steps = Dx / BK;
  load_tile(0);
  store_tile();
  __syncthreads();
  for (int kt = 0; kt < steps; ++kt) {
    if (kt + 1 < steps) load_tile((kt + 1) * BK);
#pragma unroll
    for (int q = 0; q < PLANES; ++q) {
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const __nv_bfloat16* base = &As[q * BM * LDA +
              (warp_m * 32 + mt * 16 + g) * LDA + ks * 16 + 2 * c];
          a[mt][0] = *reinterpret_cast<const uint32_t*>(base);
          a[mt][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LDA);
          a[mt][2] = *reinterpret_cast<const uint32_t*>(base + 8);
          a[mt][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LDA + 8);
        }
#pragma unroll
        for (int p = 0; p < NPAN; ++p) {
          const uint32_t* tile = Bs + (p * PLANES + q) * BN * KW;
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
    __syncthreads();
    if (kt + 1 < steps) store_tile();
    __syncthreads();
  }

  // epilogue: accumulator element e of tile (mt, nt) is row g (+8 for
  // e >= 2), column 2 * c + (e & 1)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + warp_m * 32 + mt * 16 + g + half * 8;
      if (row >= M) continue;
      const float rs = row_scale ? row_scale[row] : 1.0f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = n0 + warp_n * (NT * 8) + nt * 8 + 2 * c;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float t = __fmul_rn(acc[0][mt][nt][half * 2 + e], scale[col + e]);
          if (row_scale) t = __fmul_rn(t, rs);
          if (GATEUP) {
            float u = __fmul_rn(acc[NPAN - 1][mt][nt][half * 2 + e],
                                scale[Fo + col + e]);
            if (row_scale) u = __fmul_rn(u, rs);
            t = silu_mul(t, u);
          }
          v[e] = t;
        }
        const size_t at = (size_t)row * Fo + col;
        if (!GATEUP && residual) {
          if (residual_f32) {
            const float2 r = *reinterpret_cast<const float2*>(
                static_cast<const float*>(residual) + at);
            v[0] = __fadd_rn(v[0], r.x);
            v[1] = __fadd_rn(v[1], r.y);
          } else {
            const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(
                static_cast<const __nv_bfloat16*>(residual) + at);
            v[0] = __fadd_rn(v[0], __bfloat162float(r.x));
            v[1] = __fadd_rn(v[1], __bfloat162float(r.y));
          }
        }
        if (out_f32) {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + at) =
              make_float2(v[0], v[1]);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(out) + at) =
              __floats2bfloat162_rn(v[0], v[1]);
        }
      }
    }
  }
}

template <int NT, bool GATEUP, bool INT4>
cudaError_t launch_tile(dim3 grid, const __nv_bfloat16* x, const int8_t* w,
                        const float* scale, const float* row_scale,
                        const void* residual, int residual_f32, void* out,
                        int out_f32, int M, int D, int Fo,
                        cudaStream_t stream) {
  constexpr int bytes = smem_bytes<NT, GATEUP, INT4>();
  // above 48 KB a block's shared memory must be asked for, once per
  // instantiation
  static const cudaError_t attr = bytes > 48 * 1024
      ? cudaFuncSetAttribute(qmm_kernel<NT, GATEUP, INT4>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes)
      : cudaSuccess;
  if (attr != cudaSuccess) return attr;
  qmm_kernel<NT, GATEUP, INT4><<<grid, THREADS, bytes, stream>>>(
      x, w, scale, row_scale, residual, residual_f32, out, out_f32, M, D, Fo);
  return cudaGetLastError();
}

template <bool GATEUP, bool INT4>
int launch(const void* x, const void* w, const void* scale,
           const void* row_scale, const void* residual, int residual_f32,
           void* out, int out_f32, int64_t M, int64_t D, int64_t Fo,
           int narrow, cudaStream_t stream) {
  if (M <= 0 || D <= 0 || Fo <= 0 || D % ((INT4 ? 2 : 1) * BK) != 0 ||
      Fo % 64 != 0)
    return (int)cudaErrorInvalidValue;
  const unsigned int row_tiles = (unsigned int)((M + BM - 1) / BM);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sp = static_cast<const float*>(scale);
  const auto* rp = static_cast<const float*>(row_scale);
  if (narrow)
    return (int)launch_tile<2, GATEUP, INT4>(
        dim3((unsigned int)(Fo / 32), row_tiles), xp, wp, sp, rp, residual,
        residual_f32, out, out_f32, (int)M, (int)D, (int)Fo, stream);
  return (int)launch_tile<4, GATEUP, INT4>(
      dim3((unsigned int)(Fo / 64), row_tiles), xp, wp, sp, rp, residual,
      residual_f32, out, out_f32, (int)M, (int)D, (int)Fo, stream);
}

}  // namespace

// x: (M, D) bf16; w: (D, F) int8; scale: (F,) f32; row_scale: (M,) f32 or
// null; residual: (M, F) bf16 or f32, or null; out: (M, F) bf16 or f32.
// narrow != 0 takes 32-column blocks (more blocks for a narrow weight).
extern "C" int ppq_qmm_int8(const void* x, const void* w, const void* scale,
                            const void* row_scale, const void* residual,
                            int residual_f32, void* out, int out_f32,
                            int64_t M, int64_t D, int64_t F, int narrow,
                            void* stream) {
  return launch<false, false>(x, w, scale, row_scale, residual, residual_f32,
                              out, out_f32, M, D, F, narrow,
                              static_cast<cudaStream_t>(stream));
}

// w: (D / 2, F) int8, split-half packed; D is the unpacked depth of x.
extern "C" int ppq_qmm_int4(const void* x, const void* w, const void* scale,
                            const void* row_scale, const void* residual,
                            int residual_f32, void* out, int out_f32,
                            int64_t M, int64_t D, int64_t F, int narrow,
                            void* stream) {
  return launch<false, true>(x, w, scale, row_scale, residual, residual_f32,
                             out, out_f32, M, D, F, narrow,
                             static_cast<cudaStream_t>(stream));
}

// w: (D, 2 * Fo) int8, [gate | up]; scale: (2 * Fo,) f32; out: (M, Fo).
extern "C" int ppq_qmm_gateup(const void* x, const void* w, const void* scale,
                              const void* row_scale, void* out, int out_f32,
                              int64_t M, int64_t D, int64_t Fo, int narrow,
                              void* stream) {
  return launch<true, false>(x, w, scale, row_scale, nullptr, 0, out,
                             out_f32, M, D, Fo, narrow,
                             static_cast<cudaStream_t>(stream));
}

// w: (D / 2, 2 * Fo) int8, split-half packed [gate | up]; D unpacked.
extern "C" int ppq_qmm_gateup_int4(const void* x, const void* w,
                                   const void* scale, const void* row_scale,
                                   void* out, int out_f32, int64_t M,
                                   int64_t D, int64_t Fo, int narrow,
                                   void* stream) {
  return launch<true, true>(x, w, scale, row_scale, nullptr, 0, out, out_f32,
                            M, D, Fo, narrow,
                            static_cast<cudaStream_t>(stream));
}
