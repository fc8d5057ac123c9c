// Decode attention over the int8 (or bf16) KV cache in fused pool blocks,
// for sm_90a: one step of single-query attention per slot and KV head that
// returns the unnormalised (acc, m, l) triple of an online softmax, so that
// the caller can merge it with the in-burst buffer before normalising.
//
//   for each slot b, KV head h, query row r (the rep heads of group h),
//   over the slot's filled positions t < seq_lens[b], block by block:
//     s[t]  = (q[b, h, r, :] . k[t, h, :]) (bf16 x code, f32 sum)
//             * k_scale[t, h] * (1 / sqrt(Dh))
//     m'    = max(m, max_t s);  corr = exp(m - m')
//     p[t]  = exp(s[t] - m');   l = l * corr + sum_t p[t]
//     acc   = acc * corr + sum_t bf16(p[t] * v_scale[t, h]) * v[t, h, :]
//
// Replaces the TPU kernels `_make_kernel` (`paged_attention_decode_fused`,
// queue row 11) and `_make_grouped_kernel` (`paged_attention_decode_grouped`,
// row 12) of ppq_tpu/kernels/paged_attention.py, with their layouts:
//   fused:   pool (NB, 2, BLK, KV*Dh), scales (NB, 2, KV, BLK), block
//            tables (B, MB): slot b's block j is pool row tables[b, j];
//   grouped: a block-major window (MB*B, 2, BLK, KV*Dh) whose row j*B + b
//            is slot b's block j, scales (MB*B, 2, KV, SCP), SCP =
//            max(BLK, 128) with the first BLK columns used. The TPU
//            kernel loops through the deepest fill of the slot's group of
//            `group` slots, and each slot masks its own surplus.
// The caller passes one layer's slab (the layer's offset is taken on the
// host).
//
// What the TPU design was for, and what stands here instead. The TPU kernels
// walk a sequential grid of (slot, block) steps, pay a fixed cost per step,
// and build a block-diagonal query so that all heads' logits come out of one
// 128-wide matrix product; the grouped kernel exists to spread that fixed
// cost over G slots. On the card blocks run in parallel and a step has no
// such cost: warps hold the rep query rows of a (slot, KV head) in
// registers and walk the slot's filled positions themselves, so neither the
// block-diagonal query nor the grouping changes the work. A slot's blocks
// past its own fill are all masked, so the grouped layout's loop bound (the
// group's deepest fill) is not read at all: `group` is only checked.
//
// What bounds rows 11 and 12: bytes, the filled K and V codes read once (a
// position past the slot's fill is not loaded, but among the first 16, see
// below) plus their scales; the operations are about 4 a code byte. The
// design (`paged_decode_kernel`; row 13's `buffered_decode_kernel`, at the
// end of the file, walks the same rings):
//   * a thread block holds one slot's KV heads (up to 16 warps), so that
//     the warps of all heads stream the same token rows side by side; each
//     head has NW warps, 2, or 1 where the window is SHALLOW, each warp
//     with its own online softmax (m, l, acc) and its own ring of stages
//     in shared memory. No barrier but one at the end, where a head's two
//     warps merge (a named barrier a head); a one-warp head's state is its
//     result. A pass covers 4 * NW positions, 4 a warp;
//   * a stage is PASSES passes (16 tokens a warp): the K and V head rows
//     and both scale rows of those tokens, copied with 16-byte `cp.async`
//     (a lane copies exactly the 16-byte chunks that it reads later, and
//     lanes 0 and 1 the 4 tokens' scales); one stage in flight while one is
//     multiplied, every stage of a shallow window at once;
//   * a lane (g, c) holds token g of the warp's 4 and the 16-element chunk
//     c of its head row: logits are 16 products a query row and 3 shuffles,
//     and the same lane multiplies p by its chunk of the V row, so p never
//     leaves the lane; the 4 token lanes' partial sums of acc are added
//     once at the end. A stage whose passes are all filled takes a path
//     with no branch between them, so their loads and products interleave;
//   * int8 codes become floats exactly at full rate: the code's byte, xor
//     0x80, goes into the low mantissa of 2^23 (`__byte_perm`) and 2^23 +
//     128 comes off (one integer op and one FADD a code; a conversion
//     instruction runs at an eighth of the FMA rate);
//   * positions 0..15 are copied before the fill is known, beside the loads
//     of the fill, q and the first table row, so a slot whose window is one
//     stage pays one round trip to device memory.
// The online softmax is updated once a stage: the running max moves by the
// stage's max, and p * v_scale rounds to bf16 against it, so the kernel and
// the plain version (which updates once a pool block) differ in where p
// rounds and in the order of f32 sums, within the attention tolerance.
// On the H100 the copies set the pace: a build without the arithmetic (a
// diagnostic, not kept) took most of the kernel's time (PERF.md).
//
// A slot with seq_lens == 0 returns m = -1e30, l = 0 and acc = 0 (the TPU
// kernel leaves acc undefined there; here it is defined). Inputs the caller
// must not give, and what happens if it does: a seq_lens entry outside
// [0, MB * BLK] is clamped there and sets bit 1 of *fault; a block-table row
// outside the pool is skipped (read as empty) and sets bit 2. The JAX
// package checks neither: its grid covers MB blocks, so a longer fill is cut
// there as here, and a table row goes to the DMA as it is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DH = 128;           // head dim the kernels take
constexpr int CHUNK = 16;         // elements of a head row per lane
constexpr int LANES_PER_ROW = DH / CHUNK;                 // 8
constexpr float NEG_INF = -1e30f;
constexpr int MAX_BLK = 2048;

// 16 consecutive bf16 values of a row as floats (exact: a shift).
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                           float (&v)[CHUNK]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint4 b = *reinterpret_cast<const uint4*>(p + 8);
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

struct Args {
  const __nv_bfloat16* q;  // (B, KV, REP, DH)
  const void* pool;        // one layer's slab
  const float* scale;      // one layer's scale slab, or null
  const int* tables;       // (B, MB); null for the grouped layout
  const int* seq_lens;     // (B,)
  float* acc;              // (B, KV, REP, DH)
  float* m;                // (B, KV, REP)
  float* l;                // (B, KV, REP)
  int* fault;
  int B, KV, MB, NB, BLK, SCP, group;
  int heads;               // KV heads a thread block (rows 11 and 12)
  float inv_sqrt;
};

// the k scales of a kernel's arguments, or null (stage_update)
__device__ __forceinline__ const float* scales_of(const Args& a) {
  return a.scale;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 16 bytes from global to shared memory, asynchronously (L2 only); bytes
// < 16 fills the rest with zeros (0: all zeros, src is not read)
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

// ---------------------------------------------------------------------------
// Rows 11 and 12: `paged_decode_kernel` (the design is at the top of the file).

constexpr int PER_WARP = 32 / LANES_PER_ROW;   // 4: a warp's tokens a pass
constexpr int PASSES = 4;        // passes a stage: 16 tokens a warp
constexpr int HEAD = 16;         // positions copied before the fill is known
constexpr int SHALLOW = 64;      // windows up to this many positions take
                                 // one warp a (slot, KV head)
// warps a thread block at most: the heads of a slot stream the same token
// rows side by side (128 registers a thread, or 255 at rep 4)
constexpr int MAX_WARPS(int rep) { return rep <= 2 ? 16 : 8; }

// The layout of an NW-warp (slot, KV head). A pass covers PASS positions,
// PER_WARP a warp; each warp's ring has STAGES stages, each holding the K
// rows, then the V rows of its ROWS tokens (token i * PER_WARP + g of pass
// i), then their k scales and v scales. After the loop a warp's ring holds
// its (acc, m, l) for the merge.
template <typename T, int NW>
struct Ring {
  static constexpr int THREADS = 32 * NW;
  static constexpr int PASS = PER_WARP * NW;
  static constexpr int HEAD_PASSES = HEAD / PASS;
  // a shallow window's stages all in flight at once; two stages a warp
  // otherwise (deeper rings measured slower on the card)
  static constexpr int STAGES = NW == 1 ? SHALLOW / (PASSES * PASS) : 2;
  static constexpr int ROWS = PASSES * PER_WARP;
  static constexpr int CODES = ROWS * DH * (int)sizeof(T);
  static constexpr int STAGE = 2 * CODES + 2 * ROWS * (int)sizeof(float);
  static constexpr int WARP = STAGES * STAGE;
  static constexpr int BLOCK = NW * WARP;
  static_assert(HEAD % PASS == 0 && HEAD_PASSES <= PASSES, "head in stage 0");
  static_assert(STAGES >= 2 && STAGES * PASSES <= 32, "live bits");
};

// 16 codes of a row in shared memory as floats, exactly: each biased byte
// (code ^ 0x80, in 0..255) goes into the low mantissa bits of 2^23 and
// 2^23 + 128 comes off. bf16 values widen by a shift.
__device__ __forceinline__ void smem_chunk(const int8_t* p, float (&v)[CHUNK]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u,
                         u.z ^ 0x80808080u, u.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[4 * i + k] = __fsub_rn(
          __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540u | k)),
          8388736.0f);
}

__device__ __forceinline__ void smem_chunk(const __nv_bfloat16* p,
                                           float (&v)[CHUNK]) {
  load_chunk(p, v);
}

// The rep query rows of (slot b, KV head h), this lane's chunk, as floats.
template <int REP>
__device__ __forceinline__ void load_q(const __nv_bfloat16* q, int b, int h,
                                       int KV, float (&qv)[REP][CHUNK]) {
  const int c = (threadIdx.x & 31) % LANES_PER_ROW;
  const __nv_bfloat16* qp = q + ((int64_t)(b * KV + h) * REP) * DH + c * CHUNK;
#pragma unroll
  for (int r = 0; r < REP; ++r) load_chunk(qp + r * DH, qv[r]);
}

// One pass's copies of one warp into `stage` (pass i of the stage): lane
// (g, c) copies chunk c of token g's K and V rows (`bytes` 16, or 0 for a
// position past the fill: zeros, nothing read), lanes 0 and 1 the warp's 4
// k and v scales. `row` is the pool row, `off` the warp's first position
// in it.
template <typename T, int NW>
__device__ __forceinline__ void copy_pass(unsigned char* stage, int i,
                                          const Args& a, int64_t row, int off,
                                          int h, int lane, int bytes) {
  constexpr int PER16 = 16 / (int)sizeof(T);   // elements a 16-byte copy
  using R = Ring<T, NW>;
  const int g = lane / LANES_PER_ROW, c = lane % LANES_PER_ROW;
  const int64_t KVDh = (int64_t)a.KV * DH;
  const T* kp = static_cast<const T*>(a.pool) +
                (row * 2 * a.BLK + off + g) * KVDh + h * DH + c * CHUNK;
  const T* vp = kp + (int64_t)a.BLK * KVDh;
  unsigned char* kd =
      stage + ((i * PER_WARP + g) * DH + c * CHUNK) * (int)sizeof(T);
#pragma unroll
  for (int e = 0; e < CHUNK / PER16; ++e) {
    cp_async16(kd + 16 * e, kp + e * PER16, bytes);
    cp_async16(kd + R::CODES + 16 * e, vp + e * PER16, bytes);
  }
  if (a.scale != nullptr && lane < 2)
    cp_async16(reinterpret_cast<float*>(stage + 2 * R::CODES) +
                   lane * R::ROWS + i * PER_WARP,
               a.scale + (row * 2 * a.KV + lane * a.KV + h) * a.SCP + off, 16);
}

// Row 13's copies of one pass (pass i of `stage`), from pointers that the
// caller moved to the pass's first position: k, v at this lane's chunk of
// its token's K and V rows (`bytes` as in copy_pass); s, for lanes 0 and 1,
// at the 4 positions' k scales (lane 0) or v scales (lane 1), 16-byte
// aligned, or null where the pool has no scales.
template <typename T, int NW>
__device__ __forceinline__ void copy_lane(unsigned char* stage, int i,
                                          int lane, const T* k, const T* v,
                                          const float* s, int bytes) {
  constexpr int PER16 = 16 / (int)sizeof(T);
  using R = Ring<T, NW>;
  const int g = lane / LANES_PER_ROW, c = lane % LANES_PER_ROW;
  unsigned char* kd =
      stage + ((i * PER_WARP + g) * DH + c * CHUNK) * (int)sizeof(T);
#pragma unroll
  for (int e = 0; e < CHUNK / PER16; ++e) {
    cp_async16(kd + 16 * e, k + e * PER16, bytes);
    cp_async16(kd + R::CODES + 16 * e, v + e * PER16, bytes);
  }
  if (s != nullptr && lane < 2)
    cp_async16(reinterpret_cast<float*>(stage + 2 * R::CODES) +
                   lane * R::ROWS + i * PER_WARP,
               s, 16);
}

// Row 13's v_eff = bf16(code * bf16(v_scale)) for a lane's chunk: two codes
// packed to bf16 (exact: 8-bit significands) and multiplied by the scale in
// bf16 (mul.rn.bf16x2, one rounding of the exact product). A conversion an
// element, a packed conversion of the f32 products and a round on the bit
// pattern give the same bits and measured no faster (PERF.md).
__device__ __forceinline__ void fold_chunk(float (&v)[CHUNK], float vs) {
  const __nv_bfloat162 s2 = __float2bfloat162_rn(vs);   // vs is bf16
#pragma unroll
  for (int e = 0; e < CHUNK; e += 2) {
    uint32_t two;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;"
        : "=r"(two)
        : "f"(v[e + 1]), "f"(v[e]));
    const __nv_bfloat162 prod =
        __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&two), s2);
    const uint32_t w = *reinterpret_cast<const uint32_t*>(&prod);
    v[e] = __uint_as_float(w << 16);
    v[e + 1] = __uint_as_float(w & 0xffff0000u);
  }
}

// One stage of a warp's online softmax: the logits of its tokens, the
// stage's max over the warp, p and its sum, then p (bf16) times the lane's
// chunk of each v row. FULL: every pass was copied and every position is
// filled, so no branch stands between the passes and their loads and
// products interleave; else bit i of `bits` says whether pass i was copied
// and t0 + i * PASS < len whether the lane's position counts (t0: its
// position in the stage's first pass). A stage with no filled position of
// this warp leaves (m, l, acc) as they are. The stage holds k and v scales
// where `a` has them (scales_of). FOLD: row 13's numerics (p rounded to
// bf16 alone, the v scale rounded to bf16 and folded into the values);
// else rows 11 and 12's, bf16(p * v_scale).
template <typename T, int REP, int NW, bool FULL, bool FOLD = false,
          typename A>
__device__ __forceinline__ void stage_update(
    const unsigned char* stage, uint32_t bits, int t0, int len, const A& a,
    const float (&qv)[REP][CHUNK], float (&acc)[REP][CHUNK],
    float (&m_run)[REP], float (&l_run)[REP]) {
  using R = Ring<T, NW>;
  const int lane = threadIdx.x & 31;
  const int g = lane / LANES_PER_ROW, c = lane % LANES_PER_ROW;
  const T* kst = reinterpret_cast<const T*>(stage) + g * DH + c * CHUNK;
  const T* vst = kst + R::CODES / (int)sizeof(T);
  const float* ksc = reinterpret_cast<const float*>(stage + 2 * R::CODES) + g;
  const float* vsc = ksc + R::ROWS;
  bool copied[PASSES], valid[PASSES];
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {
    copied[i] = FULL || ((bits >> i) & 1u);
    valid[i] = FULL || (copied[i] && t0 + i * R::PASS < len);
  }

  // logits: each lane's 16 products a query row, then 8 lanes a token
  float s[PASSES][REP];
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {
#pragma unroll
    for (int r = 0; r < REP; ++r) s[i][r] = 0.0f;
    if (!copied[i]) continue;      // uniform over the warp
    float kv[CHUNK];
    smem_chunk(kst + i * PER_WARP * DH, kv);
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int e = 0; e < CHUNK; ++e) s[i][r] = fmaf(qv[r][e], kv[e], s[i][r]);
  }
#pragma unroll
  for (int off = 1; off < LANES_PER_ROW; off <<= 1)
#pragma unroll
    for (int i = 0; i < PASSES; ++i)
#pragma unroll
      for (int r = 0; r < REP; ++r)
        s[i][r] += __shfl_xor_sync(0xffffffffu, s[i][r], off);
#pragma unroll
  for (int i = 0; i < PASSES; ++i)
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float x = scales_of(a) ? __fmul_rn(s[i][r], ksc[i * PER_WARP])
                                   : s[i][r];
      s[i][r] = valid[i] ? __fmul_rn(x, a.inv_sqrt) : NEG_INF;
    }

  // the stage's max over the warp, p and its sum
  float pv[PASSES][REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    float mx = s[0][r];
#pragma unroll
    for (int i = 1; i < PASSES; ++i) mx = fmaxf(mx, s[i][r]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    const float m_new = fmaxf(m_run[r], mx);
    const float corr = expf(m_run[r] - m_new);
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < PASSES; ++i) {
      const float p = valid[i] ? expf(s[i][r] - m_new) : 0.0f;
      sum += p;
      pv[i][r] = bf16_round(!FOLD && scales_of(a)
                                ? __fmul_rn(p, vsc[i * PER_WARP]) : p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 8);
    sum += __shfl_xor_sync(0xffffffffu, sum, 16);
    l_run[r] = __fadd_rn(__fmul_rn(l_run[r], corr), sum);
    m_run[r] = m_new;
    if (corr != 1.0f) {            // uniform over the warp
#pragma unroll
      for (int e = 0; e < CHUNK; ++e) acc[r][e] = __fmul_rn(acc[r][e], corr);
    }
  }

  // readout: p (bf16) times the lane's chunk of its token's v row
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {
    if (!valid[i]) continue;
    float vv[CHUNK];
    smem_chunk(vst + i * PER_WARP * DH, vv);
    if (FOLD && scales_of(a))
      fold_chunk(vv, bf16_round(vsc[i * PER_WARP]));
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int e = 0; e < CHUNK; ++e)
        acc[r][e] = fmaf(pv[i][r], vv[e], acc[r][e]);
  }
}

// Thread block (b, y): slot b's KV heads y * a.heads .. + a.heads - 1, NW
// warps each. NW = 1 for shallow windows (the warp's state is the result:
// no merge), 2 otherwise.
template <typename T, int REP, bool GROUPED, int NW>
__global__ void __launch_bounds__(32 * MAX_WARPS(REP), 1)
paged_decode_kernel(Args a) {
  using R = Ring<T, NW>;
  constexpr int PASS = R::PASS, STAGES = R::STAGES;
  constexpr uint32_t ALL = (1u << PASSES) - 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // warp (hw, warp): head hw of the block's a.heads, warp of its NW
  const int hw = threadIdx.x / (32 * NW);
  const int b = blockIdx.x, h = blockIdx.y * a.heads + hw;
  const int tid = threadIdx.x % (32 * NW);
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane / LANES_PER_ROW, c = lane % LANES_PER_ROW;
  unsigned char* const ring = smem_raw + (hw * NW + warp) * R::WARP;
  const int limit = a.MB * a.BLK;

  // Every load that needs nothing before it: the fill, the first block's
  // pool row, q, and this warp's positions among the first HEAD (copied
  // whatever the fill; a position past it is masked below).
  const int raw = a.seq_lens[b];
  const int64_t head = GROUPED ? b : a.tables[(int64_t)b * a.MB];
  const bool head_ok = GROUPED || (head >= 0 && head < a.NB);
  if (head_ok) {
#pragma unroll
    for (int i = 0; i < R::HEAD_PASSES; ++i)
      copy_pass<T, NW>(ring, i, a, head, i * PASS + PER_WARP * warp, h, lane,
                       16);
  }
  float qv[REP][CHUNK];
  load_q<REP>(a.q, b, h, a.KV, qv);

  const int len = min(max(raw, 0), limit);
  if (raw != len && h == 0 && tid == 0) atomicOr(a.fault, 1);
  const int nstages = (len + PASSES * PASS - 1) / (PASSES * PASS);
  if (len > 0 && !head_ok && tid == 0) atomicOr(a.fault, 2);
  // bit slot * PASSES + i: pass i of the ring's stage `slot` holds at least
  // one of this warp's filled positions
  uint32_t live = 0;
#pragma unroll
  for (int i = 0; i < R::HEAD_PASSES; ++i)
    if (head_ok && i * PASS + PER_WARP * warp < len) live |= 1u << i;

  // Copy stage k into its slot (the head of stage 0 is in already) and
  // commit one group, empty past the fill. One division a stage; the table
  // is read when a pass enters another block (a pass never crosses one).
  auto copy_stage = [&](int k) {
    const int slot = k % STAGES;
    unsigned char* stage = ring + slot * R::STAGE;
    if (k > 0) live &= ~(ALL << (slot * PASSES));
    const int i0 = k == 0 ? R::HEAD_PASSES : 0;
    int p0 = (k * PASSES + i0) * PASS;        // the pass's first position
    int j = p0 / a.BLK, off = p0 - j * a.BLK; // its block, and in the block
    int64_t row = -1;
    for (int i = i0; i < PASSES && p0 < len; ++i, p0 += PASS, off += PASS) {
      if (off == a.BLK) {
        ++j;
        off = 0;
        row = -1;
      }
      if (row < 0)
        row = GROUPED ? (int64_t)j * a.B + b : a.tables[(int64_t)b * a.MB + j];
      if (!GROUPED && (row < 0 || row >= a.NB)) {
        if (lane == 0) atomicOr(a.fault, 2);
        row = -1;
        continue;
      }
      const int first = p0 + PER_WARP * warp;   // the warp's first position
      if (first >= len) continue;
      copy_pass<T, NW>(stage, i, a, row, off + PER_WARP * warp, h, lane,
                       first + g < len ? 16 : 0);
      live |= 1u << (slot * PASSES + i);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) copy_stage(k);

  float acc[REP][CHUNK], m_run[REP], l_run[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m_run[r] = NEG_INF;
    l_run[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < CHUNK; ++e) acc[r][e] = 0.0f;
  }

  for (int k = 0; k < nstages; ++k) {
    cp_async_wait<STAGES - 2>();   // this lane's copies of stage k landed
    __syncwarp();                  // and every lane's; stage k - 1 is read
    copy_stage(k + STAGES - 1);
    const int slot = k % STAGES;
    const uint32_t bits = (live >> (slot * PASSES)) & ALL;
    const int t0 = k * PASSES * PASS + PER_WARP * warp + g;
    if (bits == ALL && (k + 1) * PASSES * PASS <= len)
      stage_update<T, REP, NW, true>(ring + slot * R::STAGE, bits, t0, len, a,
                                     qv, acc, m_run, l_run);
    else
      stage_update<T, REP, NW, false>(ring + slot * R::STAGE, bits, t0, len,
                                      a, qv, acc, m_run, l_run);
  }
  cp_async_wait<0>();

  // the 4 token lanes of each chunk
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int e = 0; e < CHUNK; ++e) {
      acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], 8);
      acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], 16);
    }
  const int64_t out0 = (int64_t)(b * a.KV + h) * REP;
  if (NW == 1) {                   // the warp's state is the result
    if (g == 0) {
#pragma unroll
      for (int r = 0; r < REP; ++r)
#pragma unroll
        for (int e = 0; e < CHUNK; e += 4)
          *reinterpret_cast<float4*>(a.acc + (out0 + r) * DH + c * CHUNK + e) =
              make_float4(acc[r][e], acc[r][e + 1], acc[r][e + 2],
                          acc[r][e + 3]);
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        a.m[out0 + r] = m_run[r];
        a.l[out0 + r] = l_run[r];
      }
    }
    return;
  }

  // the warps' states in a fixed order: each warp's acc and l rescaled to
  // the largest m. The ring is read (every copy waited for): it takes them.
  __syncwarp();
  float* mine = reinterpret_cast<float*>(ring);
  if (g == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int e = 0; e < CHUNK; e += 4)
        *reinterpret_cast<float4*>(mine + r * DH + c * CHUNK + e) =
            make_float4(acc[r][e], acc[r][e + 1], acc[r][e + 2], acc[r][e + 3]);
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      mine[REP * DH + r] = m_run[r];
      mine[REP * DH + REP + r] = l_run[r];
    }
  }
  // the head's NW warps meet at barrier 1 + hw (0 is __syncthreads')
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + hw), "n"(32 * NW) : "memory");
  const float* part =
      reinterpret_cast<const float*>(smem_raw + hw * NW * R::WARP);
  constexpr int WF = R::WARP / (int)sizeof(float);   // floats a warp
  for (int idx = tid; idx < REP * (DH + 1); idx += R::THREADS) {
    const int r = idx < REP * DH ? idx / DH : idx - REP * DH;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, part[w * WF + REP * DH + r]);
    // idx < REP * DH: an acc element; then one l a query row
    const int at = idx < REP * DH ? idx : REP * DH + REP + r;
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      v = fmaf(part[w * WF + at], expf(part[w * WF + REP * DH + r] - M), v);
    if (idx < REP * DH) {
      a.acc[out0 * DH + idx] = v;
    } else {
      a.m[out0 + r] = M;
      a.l[out0 + r] = v;
    }
  }
}

__global__ void empty_kernel() {}

// Above 48 KB a block's shared memory must be asked for, once per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return bytes > 48 * 1024
      ? cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes)
      : cudaSuccess;
}

// The KV heads a thread block of NW-warp heads takes: the most that divide
// KV within MAX_WARPS(rep) warps and a block's shared memory.
constexpr int SMEM_MAX = 227 * 1024;
int heads_for(int KV, int rep, int nw, int warp_bytes) {
  const int warps = MAX_WARPS(rep) < SMEM_MAX / warp_bytes
                        ? MAX_WARPS(rep) : SMEM_MAX / warp_bytes;
  int heads = warps / nw;
  while (heads > 1 && KV % heads) --heads;
  return heads < 1 ? 1 : heads;
}

template <typename T, int NW>
int heads_per_block(int KV, int rep) {
  return heads_for(KV, rep, NW, Ring<T, NW>::WARP);
}

template <typename T, int REP, bool GROUPED, int NW>
cudaError_t launch_decode(Args a, cudaStream_t stream) {
  using R = Ring<T, NW>;
  a.heads = heads_per_block<T, NW>(a.KV, REP);
  const auto kernel = paged_decode_kernel<T, REP, GROUPED, NW>;
  const cudaError_t rc = allow_smem(kernel, a.heads * R::BLOCK);
  if (rc != cudaSuccess) return rc;
  kernel<<<dim3((unsigned int)a.B, (unsigned int)(a.KV / a.heads)),
           a.heads * R::THREADS, a.heads * R::BLOCK, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int REP, bool GROUPED>
cudaError_t launch_width(const Args& a, cudaStream_t stream) {
  return (int64_t)a.MB * a.BLK <= SHALLOW
      ? launch_decode<T, REP, GROUPED, 1>(a, stream)
      : launch_decode<T, REP, GROUPED, 2>(a, stream);
}

template <typename T, bool GROUPED>
cudaError_t launch_rep(const Args& a, int rep, cudaStream_t stream) {
  switch (rep) {
    case 1: return launch_width<T, 1, GROUPED>(a, stream);
    case 2: return launch_width<T, 2, GROUPED>(a, stream);
    case 4: return launch_width<T, 4, GROUPED>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// What one SM holds of paged_decode_kernel<T, REP, false, NW>: out[0]
// blocks (the occupancy API), out[1] shared bytes a block, out[2] bytes of
// K and V codes a warp's stage, out[3] stages in a warp's ring, out[4]
// warps a block.
template <typename T, int REP, int NW>
int resident(int KV, int* out) {
  using R = Ring<T, NW>;
  const int heads = heads_per_block<T, NW>(KV, REP);
  const auto kernel = paged_decode_kernel<T, REP, false, NW>;
  const cudaError_t rc = allow_smem(kernel, heads * R::BLOCK);
  if (rc != cudaSuccess) return (int)rc;
  out[1] = heads * R::BLOCK;
  out[2] = 2 * R::CODES;
  out[3] = R::STAGES;
  out[4] = heads * NW;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kernel, heads * R::THREADS, heads * R::BLOCK);
}

template <typename T, int NW>
int resident_rep(int64_t rep, int KV, int* out) {
  switch (rep) {
    case 1: return resident<T, 1, NW>(KV, out);
    case 2: return resident<T, 2, NW>(KV, out);
    case 4: return resident<T, 4, NW>(KV, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Row 13, `paged_attention_decode_buffered` (`_make_buffered_kernel`): the
// frozen pool and the in-burst buffer in one online softmax, the context
// normalised. Separate K and V pools (NB, BLK, KV*DH), given as views with a
// block stride (one layer's planes of the fused (NB, 2, BLK, KV*DH) pool
// pass without a copy), scales (NB, KV, BLK) likewise; the buffer
// (B, NBUF, KV*DH) codes and (B, KV, NBUF) scales with a slot stride, of
// which columns [0, step] count. Its numerics are the TPU kernel's, which
// differ from rows 11 and 12 in one place: the v scale is rounded to bf16
// and folded into the values (v_eff = bf16(code * bf16(v_scale))), and p is
// rounded to bf16 alone. The TPU kernel carried (m, l, acc) in scratch
// across its sequential grid of (slot, block) steps and took the buffer at
// the last step.
//
// What bounds it: bytes, the filled K and V codes and scales and the
// buffer's valid columns read once (147 MB at 128 slots of fill 512 with 8
// KV heads, 0.044 ms at 3.35 TB/s). The design is rows 11 and 12's
// (`paged_decode_kernel`, at the top of the file): a thread block holds a
// slot's KV heads, one or two warps a head, each warp with its own online
// softmax and its own ring of `cp.async` stages, no barrier in the loop, a
// head's warps merged in a fixed order at the end, int8 codes widened by
// the biased-exponent trick. What row 13 adds:
//   * one walk over two segments: the pool positions [0, len) through the
//     block table, then the buffer columns [0, step] as a segment with its
//     own pass grid from column 0 (len is not a multiple of 4, and the
//     buffer's 4-column scale copies must stay aligned);
//   * the pool's first 16 positions and the buffer's first stage are both
//     copied before the fill is known: the buffer's address does not depend
//     on it, and its first stage has a slot of its own beside the ring, so
//     a slot whose pool part is one stage deep pays one round trip;
//   * separate K and V planes with block strides, scales with block
//     strides, the buffer with slot strides (`copy_lane`, from pointers
//     each lane sets once);
//   * the fold: a V element takes a multiply by bf16(v_scale), exact in
//     f32, and a round to bf16 (fold_chunk); p is rounded alone;
//   * the merge divides by max(l, 1e-30) and writes the context.
// The softmax is updated once a stage (16 positions a warp), as in rows 11
// and 12: p rounds to bf16 against a running max that differs from the
// plain version's once-a-block one, within the same tolerance.

// Row 13's shared memory a warp: the walk's STAGES stages of Ring<T, NW>,
// then one stage for the buffer's first, copied before the fill is known.
template <typename T, int NW>
struct BufRing {
  using R = Ring<T, NW>;
  static constexpr int SLOTS = R::STAGES + 1;
  static constexpr int WARP = SLOTS * R::STAGE;
  static constexpr int BLOCK = NW * WARP;
  static_assert(SLOTS * PASSES <= 32, "live bits");
};

struct BufArgs {
  const __nv_bfloat16* q;  // (B, KV, REP, DH)
  const void* kp;          // (NB, BLK, KV*DH) rows, block stride kp_blk
  const void* vp;
  const float* ks;         // (NB, KV, BLK), block stride ks_blk, or null
  const float* vs;
  const int* tables;       // (B, MB)
  const int* seq_lens;     // (B,)
  const void* kb;          // (B, NBUF, KV*DH), slot stride kb_slot
  const void* vb;
  const float* ksb;        // (B, KV, NBUF), slot stride ksb_slot, or null
  const float* vsb;
  float* ctx;              // (B, KV, REP, DH)
  int* fault;
  int64_t kp_blk, vp_blk, ks_blk, vs_blk, kb_slot, vb_slot, ksb_slot,
      vsb_slot;
  int B, KV, MB, NB, BLK, NBUF;
  int ncols;               // buffer columns that count: min(step + 1, NBUF)
  int heads;               // KV heads a thread block
  float inv_sqrt;
};

__device__ __forceinline__ const float* scales_of(const BufArgs& a) {
  return a.ks;
}

// Thread block (b, y): slot b's KV heads y * a.heads .. + a.heads - 1, NW
// warps each. Stage k of a warp's walk is pool stage k for k < npool, then
// buffer stage k - npool; the buffer's first stage lives in slot STAGES,
// every other stage k in ring slot k % STAGES. ARITH false is a measurement
// build's variant: the copies and waits alone (ctx is the empty merge's).
template <typename T, int REP, int NW, bool ARITH = true>
__global__ void __launch_bounds__(32 * MAX_WARPS(REP), 1)
buffered_decode_kernel(BufArgs a) {
  using R = Ring<T, NW>;
  constexpr int PASS = R::PASS, STAGES = R::STAGES, SPAN = PASSES * PASS;
  constexpr uint32_t ALL = (1u << PASSES) - 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hw = threadIdx.x / (32 * NW);
  const int b = blockIdx.x, h = blockIdx.y * a.heads + hw;
  const int tid = threadIdx.x % (32 * NW);
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane / LANES_PER_ROW, c = lane % LANES_PER_ROW;
  const int mine = PER_WARP * warp;   // the warp's first position in a pass
  unsigned char* const ring =
      smem_raw + (hw * NW + warp) * BufRing<T, NW>::WARP;
  const int64_t KVDh = (int64_t)a.KV * DH;
  const bool scaled = a.ks != nullptr;

  // This lane's chunk of its token's K and V head rows in pool block 0 and
  // in the slot's buffer, and the scale row that lanes 0 (k) and 1 (v)
  // copy from (a position p of block `row` or column p adds row * stride
  // and p rows); pass i of `stage` takes the warp's 4 positions from `off`
  // in pool row `row`, or from buffer column `col`.
  const int64_t lane_off = g * KVDh + h * DH + c * CHUNK;
  const T* const k_pool = static_cast<const T*>(a.kp) + lane_off;
  const T* const v_pool = static_cast<const T*>(a.vp) + lane_off;
  const T* const k_buf = static_cast<const T*>(a.kb) + b * a.kb_slot + lane_off;
  const T* const v_buf = static_cast<const T*>(a.vb) + b * a.vb_slot + lane_off;
  const float* const s_pool =
      !scaled ? nullptr : (lane ? a.vs : a.ks) + (int64_t)h * a.BLK;
  const int64_t s_blk = lane ? a.vs_blk : a.ks_blk;
  const float* const s_buf = !scaled ? nullptr
      : (lane ? a.vsb + b * a.vsb_slot : a.ksb + b * a.ksb_slot) +
        (int64_t)h * a.NBUF;
  auto pool_pass = [&](unsigned char* stage, int i, int64_t row, int off,
                       int bytes) {
    const int64_t at = off * KVDh;
    copy_lane<T, NW>(stage, i, lane, k_pool + row * a.kp_blk + at,
                     v_pool + row * a.vp_blk + at,
                     scaled ? s_pool + row * s_blk + off : nullptr, bytes);
  };
  auto buffer_pass = [&](unsigned char* stage, int i, int col) {
    const int64_t at = col * KVDh;
    copy_lane<T, NW>(stage, i, lane, k_buf + at, v_buf + at,
                     scaled ? s_buf + col : nullptr,
                     col + g < a.ncols ? 16 : 0);
  };

  // Every copy that needs nothing before it: the fill, the first block's
  // pool row, q, the warp's positions among the pool's first HEAD (copied
  // whatever the fill; a position past it is masked below) and its columns
  // of the buffer's first stage, into the slot beside the ring.
  const int raw = a.seq_lens[b];
  const int64_t head = a.tables[(int64_t)b * a.MB];
  const bool head_ok = head >= 0 && head < a.NB;
  if (head_ok) {
#pragma unroll
    for (int i = 0; i < R::HEAD_PASSES; ++i)
      pool_pass(ring, i, head, i * PASS + mine, 16);
  }
  // bit slot * PASSES + i: pass i of slot `slot` holds at least one of this
  // warp's counted positions
  uint32_t live = 0;
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {
    if (i * PASS + mine < a.ncols) {
      buffer_pass(ring + STAGES * R::STAGE, i, i * PASS + mine);
      live |= 1u << (STAGES * PASSES + i);
    }
  }
  float qv[REP][CHUNK];
  load_q<REP>(a.q, b, h, a.KV, qv);

  const int len = min(max(raw, 0), a.MB * a.BLK);
  if (raw != len && h == 0 && tid == 0) atomicOr(a.fault, 1);
  if (len > 0 && !head_ok && tid == 0) atomicOr(a.fault, 2);
#pragma unroll
  for (int i = 0; i < R::HEAD_PASSES; ++i)
    if (head_ok && i * PASS + mine < len) live |= 1u << i;
  const int npool = (len + SPAN - 1) / SPAN;
  const int total = npool + (a.ncols + SPAN - 1) / SPAN;

  // Copy stage k into its slot and commit one group (empty for the
  // buffer's first stage, which is in already, and past the walk's end).
  auto copy_stage = [&](int k) {
    const int slot = k % STAGES;
    unsigned char* stage = ring + slot * R::STAGE;
    if (k < npool) {
      if (k > 0) live &= ~(ALL << (slot * PASSES));
      const int i0 = k == 0 ? R::HEAD_PASSES : 0;
      int p0 = (k * PASSES + i0) * PASS;        // the pass's first position
      int j = p0 / a.BLK, off = p0 - j * a.BLK; // its block, and in the block
      int64_t row = -1;
      for (int i = i0; i < PASSES && p0 < len; ++i, p0 += PASS, off += PASS) {
        if (off == a.BLK) {
          ++j;
          off = 0;
          row = -1;
        }
        if (row < 0) row = a.tables[(int64_t)b * a.MB + j];
        if (row < 0 || row >= a.NB) {
          if (lane == 0) atomicOr(a.fault, 2);
          row = -1;
          continue;
        }
        const int first = p0 + mine;
        if (first >= len) continue;
        pool_pass(stage, i, row, off + mine, first + g < len ? 16 : 0);
        live |= 1u << (slot * PASSES + i);
      }
    } else if (k > npool && k < total) {
      live &= ~(ALL << (slot * PASSES));
      const int c0 = (k - npool) * SPAN + mine;
      for (int i = 0; i < PASSES && c0 + i * PASS < a.ncols; ++i) {
        buffer_pass(stage, i, c0 + i * PASS);
        live |= 1u << (slot * PASSES + i);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) copy_stage(k);

  float acc[REP][CHUNK], m_run[REP], l_run[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m_run[r] = NEG_INF;
    l_run[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < CHUNK; ++e) acc[r][e] = 0.0f;
  }

  for (int k = 0; k < total; ++k) {
    cp_async_wait<STAGES - 2>();   // this lane's copies of stage k landed
    __syncwarp();                  // and every lane's; stage k - 1 is read
    copy_stage(k + STAGES - 1);
    if (!ARITH) continue;
    const bool buffer = k >= npool;
    const int slot = k == npool ? STAGES : k % STAGES;
    const int seg = buffer ? k - npool : k;   // the stage in its segment
    const int n = buffer ? a.ncols : len;
    const uint32_t bits = (live >> (slot * PASSES)) & ALL;
    const int t0 = seg * SPAN + mine + g;
    if (bits == ALL && (seg + 1) * SPAN <= n)
      stage_update<T, REP, NW, true, true>(
          ring + slot * R::STAGE, bits, t0, n, a, qv, acc, m_run, l_run);
    else
      stage_update<T, REP, NW, false, true>(
          ring + slot * R::STAGE, bits, t0, n, a, qv, acc, m_run, l_run);
  }
  cp_async_wait<0>();

  // the 4 token lanes of each chunk
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int e = 0; e < CHUNK; ++e) {
      acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], 8);
      acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], 16);
    }
  const int64_t out0 = (int64_t)(b * a.KV + h) * REP;
  if (NW == 1) {                   // the warp's state is the result
    if (g == 0) {
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float l = fmaxf(l_run[r], 1e-30f);
#pragma unroll
        for (int e = 0; e < CHUNK; e += 4)
          *reinterpret_cast<float4*>(a.ctx + (out0 + r) * DH + c * CHUNK + e) =
              make_float4(acc[r][e] / l, acc[r][e + 1] / l, acc[r][e + 2] / l,
                          acc[r][e + 3] / l);
      }
    }
    return;
  }

  // the warps' states in a fixed order: each warp's acc and l rescaled to
  // the largest m, then the context. The ring is read (every copy waited
  // for): it takes them.
  __syncwarp();
  float* part_mine = reinterpret_cast<float*>(ring);
  if (g == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int e = 0; e < CHUNK; e += 4)
        *reinterpret_cast<float4*>(part_mine + r * DH + c * CHUNK + e) =
            make_float4(acc[r][e], acc[r][e + 1], acc[r][e + 2], acc[r][e + 3]);
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      part_mine[REP * DH + r] = m_run[r];
      part_mine[REP * DH + REP + r] = l_run[r];
    }
  }
  // the head's NW warps meet at barrier 1 + hw (0 is __syncthreads')
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + hw), "n"(32 * NW) : "memory");
  const float* part = reinterpret_cast<const float*>(
      smem_raw + hw * NW * BufRing<T, NW>::WARP);
  constexpr int WF = BufRing<T, NW>::WARP / (int)sizeof(float);
  for (int idx = tid; idx < REP * DH; idx += 32 * NW) {
    const int r = idx / DH;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, part[w * WF + REP * DH + r]);
    float v = 0.0f, l = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float scale = expf(part[w * WF + REP * DH + r] - M);
      v = fmaf(part[w * WF + idx], scale, v);
      l = fmaf(part[w * WF + REP * DH + REP + r], scale, l);
    }
    a.ctx[out0 * DH + idx] = v / fmaxf(l, 1e-30f);
  }
}

template <typename T, int REP, int NW, bool ARITH = true>
cudaError_t launch_buffered(BufArgs a, cudaStream_t stream) {
  using Q = BufRing<T, NW>;
  a.heads = heads_for(a.KV, REP, NW, Q::WARP);
  const auto kernel = buffered_decode_kernel<T, REP, NW, ARITH>;
  const cudaError_t rc = allow_smem(kernel, a.heads * Q::BLOCK);
  if (rc != cudaSuccess) return rc;
  kernel<<<dim3((unsigned int)a.B, (unsigned int)(a.KV / a.heads)),
           a.heads * 32 * NW, a.heads * Q::BLOCK, stream>>>(a);
  return cudaGetLastError();
}

// One warp a head where the pool's window and the counted buffer columns
// together are SHALLOW positions or fewer, two otherwise.
template <typename T, int REP>
cudaError_t launch_buffered_width(const BufArgs& a, cudaStream_t stream) {
  return (int64_t)a.MB * a.BLK + a.ncols <= SHALLOW
      ? launch_buffered<T, REP, 1>(a, stream)
      : launch_buffered<T, REP, 2>(a, stream);
}

template <typename T>
cudaError_t launch_buffered_rep(const BufArgs& a, int rep,
                                cudaStream_t stream) {
  switch (rep) {
    case 1: return launch_buffered_width<T, 1>(a, stream);
    case 2: return launch_buffered_width<T, 2>(a, stream);
    case 4: return launch_buffered_width<T, 4>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Row 13's arguments, checked: false for what the kernel does not take.
bool buffered_args(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* tables, const void* seq_lens, const void* kb,
    const void* vb, const void* ksb, const void* vsb, void* ctx, void* fault,
    int pool_bf16, int64_t B, int64_t KV, int64_t dh, int64_t MB, int64_t NB,
    int64_t BLK, int64_t nbuf, int64_t step, int64_t kp_blk, int64_t vp_blk,
    int64_t ks_blk, int64_t vs_blk, int64_t kb_slot, int64_t vb_slot,
    int64_t ksb_slot, int64_t vsb_slot, float inv_sqrt, BufArgs* a) {
  const int64_t per16 = pool_bf16 ? 8 : 16;     // codes a 16-byte copy
  const bool scaled = ks != nullptr;
  if (B <= 0 || B > 2147483647 || KV <= 0 || KV > 65535 || dh != DH ||
      MB <= 0 || NB <= 0 || BLK <= 0 || BLK % HEAD != 0 || BLK > MAX_BLK ||
      nbuf <= 0 || nbuf > MAX_BLK || step < 0 ||
      (int64_t)MB * BLK > 2147483647 || (vs == nullptr) == scaled ||
      (ksb == nullptr) == scaled || (vsb == nullptr) == scaled ||
      ((uintptr_t)q | (uintptr_t)kp | (uintptr_t)vp | (uintptr_t)kb |
       (uintptr_t)vb) % 16 != 0 ||
      (kp_blk | vp_blk | kb_slot | vb_slot) % per16 != 0)
    return false;
  // the scales' 4-position copies: rows and their starts 16-byte aligned
  if (scaled && (((uintptr_t)ks | (uintptr_t)vs | (uintptr_t)ksb |
                  (uintptr_t)vsb) % 16 != 0 || nbuf % 4 != 0 ||
                 (ks_blk | vs_blk | ksb_slot | vsb_slot) % 4 != 0))
    return false;
  a->q = static_cast<const __nv_bfloat16*>(q);
  a->kp = kp;
  a->vp = vp;
  a->ks = static_cast<const float*>(ks);
  a->vs = static_cast<const float*>(vs);
  a->tables = static_cast<const int*>(tables);
  a->seq_lens = static_cast<const int*>(seq_lens);
  a->kb = kb;
  a->vb = vb;
  a->ksb = static_cast<const float*>(ksb);
  a->vsb = static_cast<const float*>(vsb);
  a->ctx = static_cast<float*>(ctx);
  a->fault = static_cast<int*>(fault);
  a->kp_blk = kp_blk;
  a->vp_blk = vp_blk;
  a->ks_blk = ks_blk;
  a->vs_blk = vs_blk;
  a->kb_slot = kb_slot;
  a->vb_slot = vb_slot;
  a->ksb_slot = ksb_slot;
  a->vsb_slot = vsb_slot;
  a->B = (int)B;
  a->KV = (int)KV;
  a->MB = (int)MB;
  a->NB = (int)NB;
  a->BLK = (int)BLK;
  a->NBUF = (int)nbuf;
  a->ncols = (int)(step < nbuf ? step + 1 : nbuf);
  a->heads = 1;
  a->inv_sqrt = inv_sqrt;
  return true;
}

}  // namespace

// q: (B, KV, rep, dh) bf16; pool: one layer's (NB, 2, BLK, KV*dh) int8 or
// bf16 (pool_bf16 != 0); scale: (NB, 2, KV, SCP) f32 or null; tables:
// (B, MB) int32 for the fused layout, null for the grouped one (group > 0,
// NB = MB * B); seq_lens: (B,) int32; acc (B, KV, rep, dh), m and l
// (B, KV, rep) f32; fault: one int32, or'ed with the bits above. BLK a
// multiple of 16 (a pass never crosses a block) up to MAX_BLK; q, pool and
// scale 16-byte aligned (the copies are 16 bytes).
extern "C" int ppq_paged_attention(const void* q, const void* pool,
                                   const void* scale, const void* tables,
                                   const void* seq_lens, void* acc, void* m,
                                   void* l, void* fault, int pool_bf16,
                                   int64_t B, int64_t KV, int64_t rep,
                                   int64_t dh, int64_t MB, int64_t NB,
                                   int64_t BLK, int64_t SCP, int64_t group,
                                   float inv_sqrt, void* stream) {
  const bool grouped = group > 0;
  if (B <= 0 || B > 2147483647 || KV <= 0 || KV > 65535 || dh != DH ||
      MB <= 0 || NB <= 0 || BLK <= 0 || BLK % HEAD != 0 ||
      BLK > MAX_BLK || SCP < BLK || SCP % 4 != 0 ||
      (int64_t)MB * BLK > 2147483647 ||
      (grouped && (B % group != 0 || NB != MB * B)) ||
      (!grouped && tables == nullptr) ||
      ((uintptr_t)q | (uintptr_t)pool | (uintptr_t)scale) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.pool = pool;
  a.scale = static_cast<const float*>(scale);
  a.tables = static_cast<const int*>(tables);
  a.seq_lens = static_cast<const int*>(seq_lens);
  a.acc = static_cast<float*>(acc);
  a.m = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  a.fault = static_cast<int*>(fault);
  a.B = (int)B;
  a.KV = (int)KV;
  a.MB = (int)MB;
  a.NB = (int)NB;
  a.BLK = (int)BLK;
  a.SCP = (int)SCP;
  a.group = (int)group;
  a.inv_sqrt = inv_sqrt;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (pool_bf16)
    rc = grouped ? launch_rep<__nv_bfloat16, true>(a, (int)rep, s)
                 : launch_rep<__nv_bfloat16, false>(a, (int)rep, s);
  else
    rc = grouped ? launch_rep<int8_t, true>(a, (int)rep, s)
                 : launch_rep<int8_t, false>(a, (int)rep, s);
  return (int)rc;
}

// q: (B, KV, rep, dh) bf16; kp, vp: pool planes, rows of KV*dh int8 or bf16
// (pool_bf16 != 0), block strides kp_blk, vp_blk (elements); ks, vs:
// (NB, KV, BLK) f32 views with block strides, or null; tables (B, MB) and
// seq_lens (B,) int32; kb, vb: (B, nbuf, KV*dh) with slot strides; ksb, vsb:
// (B, KV, nbuf) f32 with slot strides, or null; step: buffer columns
// [0, step] count (clamped to nbuf - 1); ctx: (B, KV, rep, dh) f32; fault:
// one int32. BLK a multiple of 16 up to MAX_BLK, nbuf up to MAX_BLK; q,
// codes and their strides 16-byte aligned; scales, their strides and nbuf
// aligned to 4 floats (the copies are 16 bytes).
extern "C" int ppq_paged_attention_buffered(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* tables, const void* seq_lens, const void* kb,
    const void* vb, const void* ksb, const void* vsb, void* ctx, void* fault,
    int pool_bf16, int64_t B, int64_t KV, int64_t rep, int64_t dh, int64_t MB,
    int64_t NB, int64_t BLK, int64_t nbuf, int64_t step, int64_t kp_blk,
    int64_t vp_blk, int64_t ks_blk, int64_t vs_blk, int64_t kb_slot,
    int64_t vb_slot, int64_t ksb_slot, int64_t vsb_slot, float inv_sqrt,
    void* stream) {
  BufArgs a;
  if (!buffered_args(q, kp, vp, ks, vs, tables, seq_lens, kb, vb, ksb, vsb,
                     ctx, fault, pool_bf16, B, KV, dh, MB, NB, BLK, nbuf,
                     step, kp_blk, vp_blk, ks_blk, vs_blk, kb_slot, vb_slot,
                     ksb_slot, vsb_slot, inv_sqrt, &a))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return (int)(pool_bf16 ? launch_buffered_rep<__nv_bfloat16>(a, (int)rep, s)
                         : launch_buffered_rep<int8_t>(a, (int)rep, s));
}

#ifdef PPQ_MEASURE
// A measurement build only (nvcc -DPPQ_MEASURE, chip_smoke.py --attention):
// row 13 on an int8 pool at rep 2 (path G's) with `warps` (1 or 2) warps a
// KV head whatever the window, or (copies != 0, two warps) the copies and
// waits without the arithmetic (ctx is the empty merge's).
extern "C" int ppq_paged_attention_buffered_measure(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* tables, const void* seq_lens, const void* kb,
    const void* vb, const void* ksb, const void* vsb, void* ctx, void* fault,
    int64_t B, int64_t KV, int64_t MB, int64_t NB, int64_t BLK, int64_t nbuf,
    int64_t step, int64_t kp_blk, int64_t vp_blk, int64_t ks_blk,
    int64_t vs_blk, int64_t kb_slot, int64_t vb_slot, int64_t ksb_slot,
    int64_t vsb_slot, float inv_sqrt, int warps, int copies, void* stream) {
  BufArgs a;
  if ((warps != 1 && warps != 2) ||
      !buffered_args(q, kp, vp, ks, vs, tables, seq_lens, kb, vb, ksb, vsb,
                     ctx, fault, 0, B, KV, DH, MB, NB, BLK, nbuf, step,
                     kp_blk, vp_blk, ks_blk, vs_blk, kb_slot, vb_slot,
                     ksb_slot, vsb_slot, inv_sqrt, &a))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (copies) return (int)launch_buffered<int8_t, 2, 2, false>(a, s);
  return (int)(warps == 1 ? launch_buffered<int8_t, 2, 1>(a, s)
                          : launch_buffered<int8_t, 2, 2>(a, s));
}
#endif

// One launch of an empty kernel on `stream`: the launch floor that rows 11
// and 12 at shallow fills are read against (chip_smoke.py --attention).
extern "C" int ppq_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

// What one SM holds of rows 11 and 12's kernel for an int8 (pool_bf16 0)
// or bf16 pool, `rep` query rows and KV heads, and a shallow window (one
// warp a (slot, KV head)) or not (two): out[0] blocks (the occupancy API),
// out[1] shared bytes a block, out[2] bytes of K and V codes a warp's
// stage, out[3] stages in a warp's ring, out[4] warps a block.
extern "C" int ppq_paged_attention_occupancy(int pool_bf16, int64_t rep,
                                             int64_t KV, int shallow,
                                             void* out) {
  int* o = static_cast<int*>(out);
  if (KV <= 0 || KV > 65535) return (int)cudaErrorInvalidValue;
  if (pool_bf16)
    return shallow ? resident_rep<__nv_bfloat16, 1>(rep, (int)KV, o)
                   : resident_rep<__nv_bfloat16, 2>(rep, (int)KV, o);
  return shallow ? resident_rep<int8_t, 1>(rep, (int)KV, o)
                 : resident_rep<int8_t, 2>(rep, (int)KV, o);
}
