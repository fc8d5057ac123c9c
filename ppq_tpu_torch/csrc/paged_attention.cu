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
//            max(BLK, 128) with the first BLK columns used. The loop runs
//            through the deepest fill of the slot's group of `group` slots,
//            and each slot masks its own surplus, as the TPU kernel does.
// The caller passes one layer's slab (the layer's offset is taken on the
// host).
//
// What the TPU design was for, and what stands here instead. The TPU kernels
// walk a sequential grid of (slot, block) steps, pay a fixed cost per step,
// and build a block-diagonal query so that all heads' logits come out of one
// 128-wide matrix product; the grouped kernel exists to spread that fixed
// cost over G slots. On the card blocks run in parallel and a step has no
// such cost: one thread block per (slot, KV head) holds the rep query rows
// in registers and loops over the slot's filled blocks itself, so neither
// the block-diagonal query nor the grouping changes the work. What bounds
// the kernel is bytes: the filled K and V codes, read once (a position past
// the slot's fill is never loaded), plus the scales; the operations (4 rep
// flops a code byte) are far below the card's rate. The layout of a thread
// block: 4 warps, each lane one 16-element chunk of a token's head row
// (one 16-byte load of codes), 8 lanes to a row, 16 tokens a pass:
//   * logits: each lane multiplies its chunk against the query rows kept in
//     registers, and 8 lanes sum by shuffles; the row's logits of a block go
//     to shared memory;
//   * the block's max and sum of p are reductions over the block; p times
//     the v scale is rounded to bf16, as the TPU kernel's product operand;
//   * the readout accumulates p * v for the lane's chunk and tokens in
//     registers across all blocks (rescaled by corr at each block); the
//     partial sums of the 16 token lanes are added once at the end.
// A simple kernel first: no cp.async or TMA pipeline yet.
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

constexpr int DH = 128;           // head dim the kernel takes
constexpr int THREADS = 128;      // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 16;         // elements of a head row per lane
constexpr int LANES_PER_ROW = DH / CHUNK;                 // 8
constexpr int TOKENS_PER_PASS = THREADS / LANES_PER_ROW;  // 16
constexpr float NEG_INF = -1e30f;
constexpr int MAX_BLK = 2048;

// 16 consecutive values of a row as floats (both conversions exact).
__device__ __forceinline__ void load_chunk(const int8_t* p, float (&v)[CHUNK]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[4 * i + k] = (float)(signed char)(w[i] >> (8 * k));
}

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
  float inv_sqrt;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The shared memory of a thread block: a block's logits (then p) for each
// query row, the warps' partial maxima and sums, and the final per-warp
// sums of acc.
struct Smem {
  float* s_buf;    // REP * width
  float* red_max;  // WARPS * REP
  float* red_sum;  // WARPS * REP
  float* fin;      // WARPS * REP * DH
};

template <int REP>
__device__ __forceinline__ Smem carve(float* smem, int width) {
  Smem m;
  m.s_buf = smem;
  m.red_max = m.s_buf + REP * width;
  m.red_sum = m.red_max + WARPS * REP;
  m.fin = m.red_sum + WARPS * REP;
  return m;
}

template <int REP>
size_t smem_bytes(int width) {
  return sizeof(float) * ((size_t)REP * width + 2 * WARPS * REP +
                          WARPS * REP * DH);
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

// One block of nv positions into the running (m, l, acc). kb, vb point at
// this lane's chunk of the block's first row (rows KVDh apart); ksc, vsc at
// the block's scales of this head, or null. FOLD_V: row 13's numerics, the v
// scale rounded to bf16 and folded into the values, p rounded alone; else
// rows 11 and 12's, bf16(p * v_scale). Every branch is uniform over the
// thread block.
template <typename T, int REP, bool FOLD_V>
__device__ __forceinline__ void online_block(
    const T* kb, const T* vb, int64_t KVDh, const float* ksc,
    const float* vsc, int nv, const float (&qv)[REP][CHUNK],
    float (&acc)[REP][CHUNK], float (&m_run)[REP], float (&l_run)[REP],
    const Smem& sm, int width, float inv_sqrt) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = lane / LANES_PER_ROW, c = lane % LANES_PER_ROW;
  // logits of the block's filled positions
  for (int t0 = 0; t0 < nv; t0 += TOKENS_PER_PASS) {
    const int t = t0 + warp * (32 / LANES_PER_ROW) + sub;
    float part[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) part[r] = 0.0f;
    if (t < nv) {
      float kv[CHUNK];
      load_chunk(kb + t * KVDh, kv);
#pragma unroll
      for (int r = 0; r < REP; ++r)
#pragma unroll
        for (int i = 0; i < CHUNK; ++i) part[r] += qv[r][i] * kv[i];
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      part[r] += __shfl_xor_sync(0xffffffffu, part[r], 1);
      part[r] += __shfl_xor_sync(0xffffffffu, part[r], 2);
      part[r] += __shfl_xor_sync(0xffffffffu, part[r], 4);
    }
    if (c == 0 && t < nv) {
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float s = part[r];
        if (ksc) s = __fmul_rn(s, ksc[t]);
        sm.s_buf[r * width + t] = __fmul_rn(s, inv_sqrt);
      }
    }
  }
  __syncthreads();

  // the block's max, then p and its sum
  float m_new[REP], corr[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    float v = NEG_INF;
    for (int t = tid; t < nv; t += THREADS) v = fmaxf(v, sm.s_buf[r * width + t]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) sm.red_max[warp * REP + r] = v;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    float v = sm.red_max[r];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v = fmaxf(v, sm.red_max[w * REP + r]);
    m_new[r] = fmaxf(m_run[r], v);
    corr[r] = expf(m_run[r] - m_new[r]);
    float sum = 0.0f;
    for (int t = tid; t < nv; t += THREADS) {
      const float p = expf(sm.s_buf[r * width + t] - m_new[r]);
      sum += p;
      const float pv = (!FOLD_V && vsc) ? __fmul_rn(p, vsc[t]) : p;
      sm.s_buf[r * width + t] = bf16_round(pv);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) sm.red_sum[warp * REP + r] = sum;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    float sum = sm.red_sum[r];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) sum += sm.red_sum[w * REP + r];
    l_run[r] = __fadd_rn(__fmul_rn(l_run[r], corr[r]), sum);
    m_run[r] = m_new[r];
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) acc[r][i] = __fmul_rn(acc[r][i], corr[r]);
  }

  // readout: p (bf16) times the lane's chunk of each filled v row
  for (int t0 = 0; t0 < nv; t0 += TOKENS_PER_PASS) {
    const int t = t0 + warp * (32 / LANES_PER_ROW) + sub;
    if (t < nv) {
      float vv[CHUNK];
      load_chunk(vb + t * KVDh, vv);
      if (FOLD_V && vsc) {
        const float vsc_t = bf16_round(vsc[t]);
#pragma unroll
        for (int i = 0; i < CHUNK; ++i) vv[i] = bf16_round(vv[i] * vsc_t);
      }
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float p = sm.s_buf[r * width + t];
#pragma unroll
        for (int i = 0; i < CHUNK; ++i) acc[r][i] += p * vv[i];
      }
    }
  }
  __syncthreads();
}

// The token lanes' partial sums of acc: across the 4 row groups of a warp
// into sm.fin, one (REP, DH) slice per warp; the caller adds the warps'
// slices in a fixed order.
template <int REP>
__device__ __forceinline__ void park_acc(float (&acc)[REP][CHUNK],
                                         const Smem& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane / LANES_PER_ROW, c = lane % LANES_PER_ROW;
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      acc[r][i] += __shfl_xor_sync(0xffffffffu, acc[r][i], 8);
      acc[r][i] += __shfl_xor_sync(0xffffffffu, acc[r][i], 16);
    }
  if (sub == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int i = 0; i < CHUNK; ++i)
        sm.fin[(warp * REP + r) * DH + c * CHUNK + i] = acc[r][i];
  }
  __syncthreads();
}

template <int REP>
__device__ __forceinline__ float warp_sum(const Smem& sm, int idx) {
  float v = sm.fin[idx];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) v += sm.fin[w * REP * DH + idx];
  return v;
}

template <int REP>
__device__ __forceinline__ void reset(float (&acc)[REP][CHUNK],
                                      float (&m_run)[REP], float (&l_run)[REP]) {
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m_run[r] = NEG_INF;
    l_run[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) acc[r][i] = 0.0f;
  }
}

template <typename T, int REP, bool GROUPED>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(Args a) {
  extern __shared__ float smem[];
  const Smem sm = carve<REP>(smem, a.BLK);
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int c = (tid & 31) % LANES_PER_ROW;
  const int64_t KVDh = (int64_t)a.KV * DH;
  const int limit = a.MB * a.BLK;

  const int raw = a.seq_lens[b];
  const int len = min(max(raw, 0), limit);
  if (raw != len && h == 0 && tid == 0) atomicOr(a.fault, 1);
  int reach = len;                 // the fill the loop runs through
  if (GROUPED) {
    const int g0 = (b / a.group) * a.group;
    for (int i = g0; i < g0 + a.group; ++i)
      reach = max(reach, min(max(a.seq_lens[i], 0), limit));
  }
  const int nblk = (reach + a.BLK - 1) / a.BLK;

  float qv[REP][CHUNK], acc[REP][CHUNK], m_run[REP], l_run[REP];
  load_q<REP>(a.q, b, h, a.KV, qv);
  reset<REP>(acc, m_run, l_run);
  for (int j = 0; j < nblk; ++j) {
    const int nv = min(len - j * a.BLK, a.BLK);
    if (nv <= 0) continue;         // the group's surplus: all masked, a no-op
    int64_t row;
    if (GROUPED) {
      row = (int64_t)j * a.B + b;
    } else {
      row = a.tables[(int64_t)b * a.MB + j];
      if (row < 0 || row >= a.NB) {
        if (h == 0 && tid == 0) atomicOr(a.fault, 2);
        continue;
      }
    }
    const T* kb = static_cast<const T*>(a.pool) + row * 2 * a.BLK * KVDh +
                  h * DH + c * CHUNK;
    const float* ksc = a.scale ? a.scale + (row * 2 * a.KV + h) * a.SCP
                               : nullptr;
    online_block<T, REP, false>(kb, kb + (int64_t)a.BLK * KVDh, KVDh, ksc,
                                ksc ? ksc + (int64_t)a.KV * a.SCP : nullptr,
                                nv, qv, acc, m_run, l_run, sm, a.BLK,
                                a.inv_sqrt);
  }

  park_acc<REP>(acc, sm);
  const int64_t out0 = (int64_t)(b * a.KV + h) * REP;
  for (int idx = tid; idx < REP * DH; idx += THREADS)
    a.acc[out0 * DH + idx] = warp_sum<REP>(sm, idx);
  if (tid < REP) {
    a.m[out0 + tid] = m_run[tid];
    a.l[out0 + tid] = l_run[tid];
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
// rounded to bf16 alone. The design is row 11's (one thread block per slot
// and KV head, a block's logits in shared memory), with the buffer taken as
// one more block after the slot's last filled one; the TPU kernel carried
// (m, l, acc) in scratch across its sequential grid instead. What bounds it:
// bytes, the filled K and V codes and scales and the buffer's valid columns
// read once (147 MB at 128 slots of fill 512 with 8 KV heads, 0.044 ms at
// 3.35 TB/s).

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
  int B, KV, MB, NB, BLK, NBUF, step, s_width;
  float inv_sqrt;
};

template <typename T, int REP>
__global__ void __launch_bounds__(THREADS)
buffered_attention_kernel(BufArgs a) {
  extern __shared__ float smem[];
  const Smem sm = carve<REP>(smem, a.s_width);
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int c = (tid & 31) % LANES_PER_ROW;
  const int64_t KVDh = (int64_t)a.KV * DH;
  const int64_t lane_off = h * DH + c * CHUNK;
  const int limit = a.MB * a.BLK;

  const int raw = a.seq_lens[b];
  const int len = min(max(raw, 0), limit);
  if (raw != len && h == 0 && tid == 0) atomicOr(a.fault, 1);

  float qv[REP][CHUNK], acc[REP][CHUNK], m_run[REP], l_run[REP];
  load_q<REP>(a.q, b, h, a.KV, qv);
  reset<REP>(acc, m_run, l_run);
  const int nblk = (len + a.BLK - 1) / a.BLK;
  for (int j = 0; j < nblk; ++j) {
    const int64_t row = a.tables[(int64_t)b * a.MB + j];
    if (row < 0 || row >= a.NB) {
      if (h == 0 && tid == 0) atomicOr(a.fault, 2);
      continue;
    }
    online_block<T, REP, true>(
        static_cast<const T*>(a.kp) + row * a.kp_blk + lane_off,
        static_cast<const T*>(a.vp) + row * a.vp_blk + lane_off, KVDh,
        a.ks ? a.ks + row * a.ks_blk + (int64_t)h * a.BLK : nullptr,
        a.vs ? a.vs + row * a.vs_blk + (int64_t)h * a.BLK : nullptr,
        min(len - j * a.BLK, a.BLK), qv, acc, m_run, l_run, sm, a.s_width,
        a.inv_sqrt);
  }
  // the in-burst buffer: columns [0, step]
  online_block<T, REP, true>(
      static_cast<const T*>(a.kb) + b * a.kb_slot + lane_off,
      static_cast<const T*>(a.vb) + b * a.vb_slot + lane_off, KVDh,
      a.ksb ? a.ksb + b * a.ksb_slot + (int64_t)h * a.NBUF : nullptr,
      a.vsb ? a.vsb + b * a.vsb_slot + (int64_t)h * a.NBUF : nullptr,
      min(a.step + 1, a.NBUF), qv, acc, m_run, l_run, sm, a.s_width,
      a.inv_sqrt);

  park_acc<REP>(acc, sm);
  const int64_t out0 = (int64_t)(b * a.KV + h) * REP;
  for (int idx = tid; idx < REP * DH; idx += THREADS)
    a.ctx[out0 * DH + idx] = warp_sum<REP>(sm, idx) /
                             fmaxf(l_run[idx / DH], 1e-30f);
}

template <typename T, int REP>
cudaError_t launch_buffered(const BufArgs& a, cudaStream_t stream) {
  buffered_attention_kernel<T, REP>
      <<<dim3((unsigned int)a.B, (unsigned int)a.KV), THREADS,
         smem_bytes<REP>(a.s_width), stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_buffered_rep(const BufArgs& a, int rep, cudaStream_t stream) {
  switch (rep) {
    case 1: return launch_buffered<T, 1>(a, stream);
    case 2: return launch_buffered<T, 2>(a, stream);
    case 4: return launch_buffered<T, 4>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int REP, bool GROUPED>
cudaError_t launch_one(const Args& a, cudaStream_t stream) {
  paged_attention_kernel<T, REP, GROUPED>
      <<<dim3((unsigned int)a.B, (unsigned int)a.KV), THREADS,
         smem_bytes<REP>(a.BLK), stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool GROUPED>
cudaError_t launch_rep(const Args& a, int rep, cudaStream_t stream) {
  switch (rep) {
    case 1: return launch_one<T, 1, GROUPED>(a, stream);
    case 2: return launch_one<T, 2, GROUPED>(a, stream);
    case 4: return launch_one<T, 4, GROUPED>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, KV, rep, dh) bf16; pool: one layer's (NB, 2, BLK, KV*dh) int8 or
// bf16 (pool_bf16 != 0); scale: (NB, 2, KV, SCP) f32 or null; tables:
// (B, MB) int32 for the fused layout, null for the grouped one (group > 0,
// NB = MB * B); seq_lens: (B,) int32; acc (B, KV, rep, dh), m and l
// (B, KV, rep) f32; fault: one int32, or'ed with the bits above.
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
      MB <= 0 || NB <= 0 || BLK <= 0 || BLK % TOKENS_PER_PASS != 0 ||
      BLK > MAX_BLK || SCP < BLK || (int64_t)MB * BLK > 2147483647 ||
      (grouped && (B % group != 0 || NB != MB * B)) ||
      (!grouped && tables == nullptr))
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
// [0, step] count; ctx: (B, KV, rep, dh) f32; fault: one int32.
extern "C" int ppq_paged_attention_buffered(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* tables, const void* seq_lens, const void* kb,
    const void* vb, const void* ksb, const void* vsb, void* ctx, void* fault,
    int pool_bf16, int64_t B, int64_t KV, int64_t rep, int64_t dh, int64_t MB,
    int64_t NB, int64_t BLK, int64_t nbuf, int64_t step, int64_t kp_blk,
    int64_t vp_blk, int64_t ks_blk, int64_t vs_blk, int64_t kb_slot,
    int64_t vb_slot, int64_t ksb_slot, int64_t vsb_slot, float inv_sqrt,
    void* stream) {
  if (B <= 0 || B > 2147483647 || KV <= 0 || KV > 65535 || dh != DH ||
      MB <= 0 || NB <= 0 || BLK <= 0 || BLK > MAX_BLK || nbuf <= 0 ||
      nbuf > MAX_BLK || step < 0 || (int64_t)MB * BLK > 2147483647 ||
      (ks == nullptr) != (vs == nullptr) ||
      (ksb == nullptr) != (ks == nullptr))
    return (int)cudaErrorInvalidValue;
  BufArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.kp = kp;
  a.vp = vp;
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.tables = static_cast<const int*>(tables);
  a.seq_lens = static_cast<const int*>(seq_lens);
  a.kb = kb;
  a.vb = vb;
  a.ksb = static_cast<const float*>(ksb);
  a.vsb = static_cast<const float*>(vsb);
  a.ctx = static_cast<float*>(ctx);
  a.fault = static_cast<int*>(fault);
  a.kp_blk = kp_blk;
  a.vp_blk = vp_blk;
  a.ks_blk = ks_blk;
  a.vs_blk = vs_blk;
  a.kb_slot = kb_slot;
  a.vb_slot = vb_slot;
  a.ksb_slot = ksb_slot;
  a.vsb_slot = vsb_slot;
  a.B = (int)B;
  a.KV = (int)KV;
  a.MB = (int)MB;
  a.NB = (int)NB;
  a.BLK = (int)BLK;
  a.NBUF = (int)nbuf;
  a.step = (int)(step < nbuf ? step : nbuf - 1);
  a.s_width = (int)(BLK > nbuf ? BLK : nbuf);
  a.inv_sqrt = inv_sqrt;
  const auto s = static_cast<cudaStream_t>(stream);
  return (int)(pool_bf16 ? launch_buffered_rep<__nv_bfloat16>(a, (int)rep, s)
                         : launch_buffered_rep<int8_t>(a, (int)rep, s));
}
