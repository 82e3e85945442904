// Decode attention straight off a k-quantile-coded paged KV pool, for sm_90a.
//
// Replaces the TPU kernel `paged_quant_attention` of
// src/repro/kernels/paged_attn.py:227 (body `_kernel`, `_dequant_page`, and
// the combine epilogue).  One query position per sequence attends over the
// pages its block-table row names: gather by block table, unpack (two codes
// per byte at 4 bits), dequantize per (row, head) as mu + sigma *
// table[code], scores * D^-1/2, optional cap * tanh(s / cap), causal and
// sliding-window mask on the logical row, online softmax in f32, split over
// the rows into (m, l, acc) partials that a second kernel merges.
//
// What bounds it on this card: the coded pool bytes, one pass over every
// valid row's K and V codes and their bf16 stats (69 MB at kv8, B = 16,
// 2048 rows, 8 heads of 128: 21 us at 3.35 TB/s).  The work per element
// (lookup, multiply, add) is then the next limit.  Two bodies, picked by
// the wrapper's fixed rule (kernels/paged_attn.py:attn_route):
//
//   * bf16 queries (the engine's): `paged_attn_tc_kernel`, tensor cores.
//     A block per (sequence, split, group of up to 8 kv heads) keeps all of
//     its heads: 16 consumer warps (8 above D = 128), so at 8 heads two
//     warps per head take alternate 16-row groups and fold their states in
//     the block at the end.  What the design does about the bounds:
//       - a producer warp streams chunks of 16 rows (never across a page)
//         through a ring of three stages in dynamic shared memory by 1-D
//         bulk copies (cp.async.bulk, mbarrier complete_tx): each row's
//         codes of the block's heads are one contiguous run, copied to a
//         row stride of 16 mod 128 bytes so the fragment loads below meet
//         no bank conflict, and each chunk's four stat arrays are one copy
//         each;
//         no consumer spends an instruction on a global address;
//       - S = Q K^T on mma.sync m16n8k16 (bf16 in, f32 sums): the head's
//         G <= 8 queries are the A operand, staged once, unscaled; K is the
//         B operand.  The head dims are permuted consistently on both sides
//         (a lane's four k positions are four adjacent dims), so a lane
//         fetches its codes of a row with one 32-bit (kv8) or 16-bit (kv4)
//         load;
//       - O^T += V^T P^T, also m16n8k16: the 16 head dims of a tile are the
//         M rows, the 8 query columns are N, 16 rows are K.  The score
//         fragment of two n-tiles is exactly the B fragment of P (the
//         FlashAttention-2 register reuse, transposed), so P never leaves
//         registers; the accumulator is 16 x D f32 over all lanes (D / 4
//         per lane) with no padded rows, rescaled only when a running max
//         grows;
//       - K and V fragments are built in registers from the staged codes
//         with no bf16 tile in shared memory: each element is
//         bf16(mu + sigma * t[c]) with a separate f32 multiply and add,
//         the plain version's own bf16 value, so the two differ only in
//         the order of the f32 sums and in where P is rounded (the plain
//         version rounds the normalized weights, the kernel the running-
//         max-relative ones).  The level table has a 256-byte row per
//         stored byte, one word (kv8) or the pair of nibble levels (kv4)
//         per lane, so a lookup is a byte permute and a load that meets no
//         other lane's bank;
//       - the combine is a programmatic dependent launch, so its launch
//         overlaps this kernel's tail.
//   * f32 queries: `paged_attn_kernel`, CUDA cores (off the engine path).
//     A block per (batch, kv head, split) keeps its G queries in registers;
//     8 warps walk rows, a group of 16 lanes (32 above D = 128) per row
//     with the head dimension spread over the group; the next row is
//     fetched while the current one is processed; the row statistics are
//     factored out of the per-element work: q.k = mu_k * sum(q) + sigma_k *
//     sum(q_d * t[c_d]) and sum_r p_r v_r = sum_r p_r mu_r + sum_r (p_r
//     sigma_r) t[c_rd].
// In both, only the rows between the window's start and the causal bound
// (and inside the table) are visited, and that range, not the table width,
// is divided among the splits.  Softmax runs in base 2.
//
// Edge behaviour kept from the reference: the running max starts at -1e30
// (finite), masked rows add nothing (rows past q_pos, outside the window,
// sink pages, pages past the table width), a split that sees only masked
// rows emits m = -1e30, l = 0, acc = 0 and an all-masked query combines to
// exact zeros.
//
// Deterministic: fixed traversal and merge order, no atomics.  Plain C
// interface; the caller allocates every buffer and passes the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;  // warps per block
constexpr float NEG_INF = -1e30f;

template <int LANES>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// NB code bytes of one lane, as little-endian words; only the first
// `n_valid` bytes exist (a lane at the ragged end of the head dimension).
template <int NB>
__device__ __forceinline__ void load_bytes(uint32_t (&dst)[(NB + 3) / 4],
                                           const uint8_t* __restrict__ p,
                                           bool aligned, int n_valid) {
#pragma unroll
  for (int i = 0; i < (NB + 3) / 4; ++i) dst[i] = 0;
  if (n_valid <= 0) return;
  if (aligned && n_valid == NB) {
    if constexpr (NB == 1) {
      dst[0] = p[0];
    } else if constexpr (NB == 2) {
      dst[0] = *reinterpret_cast<const uint16_t*>(p);
    } else if constexpr (NB == 4) {
      dst[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      static_assert(NB == 8, "1, 2, 4 or 8 code bytes per lane");
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      dst[0] = v.x;
      dst[1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NB; ++i)
      if (i < n_valid) dst[i / 4] |= (uint32_t)p[i] << (8 * (i % 4));
  }
}

// One pool row of one kv head as a lane sees it: the raw code bytes of its
// 2 * PPL consecutive head-dim elements and the row's raw bf16 statistics.
template <int NB>
struct RowData {
  uint32_t k[(NB + 3) / 4], v[(NB + 3) / 4];
  __nv_bfloat16 kmu, ksg, vmu, vsg;

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < (NB + 3) / 4; ++i) k[i] = v[i] = 0;
    kmu = ksg = vmu = vsg = __float2bfloat16(0.0f);
  }
};

// A group of LPR lanes owns one row at a time; lane gl of the group owns
// the 2 * PPL head-dim elements from d0 = gl * 2 * PPL (PPL packed bytes at
// 4 bits, 2 * PPL bytes at 8 bits).
template <int BITS, int LPR, int PPL, int GMAX>
__global__ void __launch_bounds__(NW * 32)
paged_attn_kernel(const void* __restrict__ q, int q_bf16,
                  const uint8_t* __restrict__ k_codes,
                  const __nv_bfloat16* __restrict__ k_mu,
                  const __nv_bfloat16* __restrict__ k_sigma,
                  const uint8_t* __restrict__ v_codes,
                  const __nv_bfloat16* __restrict__ v_mu,
                  const __nv_bfloat16* __restrict__ v_sigma,
                  const int* __restrict__ block_tables,
                  const int* __restrict__ q_pos,
                  const float* __restrict__ table, float* __restrict__ m_part,
                  float* __restrict__ l_part, float* __restrict__ acc_part,
                  int H, int KV, int D, int page, int n_pages, int splits,
                  int window, float logit_cap) {
  constexpr int NLEV = 1 << BITS;
  constexpr int RPW = 32 / LPR;           // rows a warp holds at a time
  constexpr int NG = NW * RPW;            // row groups per block
  constexpr int EPL = 2 * PPL;            // elements per lane
  constexpr int DMAX = LPR * EPL;
  constexpr int NB = (BITS == 4) ? PPL : EPL;   // code bytes per lane
  constexpr float LOG2E = 1.4426950408889634f;
  __shared__ float s_table[NLEV];
  __shared__ float s_m[NW][GMAX];
  __shared__ float s_l[NW][GMAX];
  __shared__ float s_acc[NW][GMAX][DMAX];

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int split = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gl = lane % LPR;              // lane within its row group
  const int grp = threadIdx.x / LPR;      // row group within the block
  const int d0 = gl * EPL;
  const int G = H / KV;
  const int Dc = (BITS == 4) ? D / 2 : D;
  const bool aligned = (Dc % NB) == 0;
  const int n_valid = min(NB, Dc - gl * NB);   // this lane's bytes of a row

  for (int i = threadIdx.x; i < NLEV; i += NW * 32) s_table[i] = table[i];
  __syncthreads();

  // queries, pre-scaled by D^-1/2 (and by log2 e unless a logit cap has to
  // see the natural score first); zero past the head dimension
  const bool capped = logit_cap > 0.0f;
  const float scale = rsqrtf((float)D) * (capped ? 1.0f : LOG2E);
  float qv[GMAX][EPL], qsum[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    float sum = 0.0f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = d0 + e;
      float x = 0.0f;
      if (g < G && d < D) {
        const size_t off = ((size_t)b * H + (size_t)kvh * G + g) * D + d;
        x = q_bf16 ? __bfloat162float(
                         static_cast<const __nv_bfloat16*>(q)[off])
                   : static_cast<const float*>(q)[off];
      }
      qv[g][e] = x * scale;
      sum += qv[g][e];
    }
    qsum[g] = group_sum<LPR>(sum);
  }

  // online softmax state of this row group, in base 2: running max, sum of
  // weights, sum of weights * mu_v, and per element sum of weights *
  // sigma_v * t[code]
  float m_run[GMAX], l_run[GMAX], mu_run[GMAX], acc[GMAX][EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m_run[g] = NEG_INF;
    l_run[g] = 0.0f;
    mu_run[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.0f;
  }

  // Valid rows: lo_row <= row <= hi_row (causal bound, window, table width;
  // logical pages past the table count as masked).  Their pages are divided
  // evenly among the splits; this block walks rows [row_begin, row_end).
  const int qp = q_pos[b];
  const int hi_row = min(qp, n_pages * page - 1);
  const int lo_row = (window > qp) ? 0 : (qp - window + 1);
  int row_begin = 0, row_end = 0;
  if (hi_row >= lo_row) {
    const int p_lo = lo_row / page;
    const int n_pg = hi_row / page - p_lo + 1;
    const int pps = (n_pg + splits - 1) / splits;
    row_begin = max(lo_row, (p_lo + split * pps) * page);
    row_end = min(hi_row + 1, (p_lo + (split + 1) * pps) * page);
  }

  auto load_row = [&](RowData<NB>& d, int row) {
    const int j = row / page;                   // logical page
    const int r = row - j * page;
    const int pg = block_tables[(size_t)b * n_pages + j];
    const size_t base = ((size_t)pg * page + r) * KV + kvh;
    d.kmu = k_mu[base];
    d.ksg = k_sigma[base];
    d.vmu = v_mu[base];
    d.vsg = v_sigma[base];
    load_bytes<NB>(d.k, k_codes + base * Dc + gl * NB, aligned, n_valid);
    load_bytes<NB>(d.v, v_codes + base * Dc + gl * NB, aligned, n_valid);
  };
  auto code_of = [](const uint32_t* words, int e) -> int {
    if (BITS == 4) return (words[0] >> (4 * e)) & 0xF;
    return ((words[e / 4] >> (8 * (e % 4))) & 0xFF) ^ 0x80;  // stored + 128
  };

  RowData<NB> cur, nxt;
  cur.clear();
  nxt.clear();
  int row = row_begin + grp;
  bool have = row < row_end;
  if (have) load_row(cur, row);
  // the groups of a warp stay in step (a group without a row idles through
  // the shuffles), so the loop is uniform across the warp
  while (__any_sync(0xffffffffu, have)) {
    const int next_row = row + NG;
    const bool have_next = next_row < row_end;
    if (have_next) load_row(nxt, next_row);

    const float kmu = __bfloat162float(cur.kmu);
    const float ksg = __bfloat162float(cur.ksg);
    const float vmu = __bfloat162float(cur.vmu);
    const float vsg = __bfloat162float(cur.vsg);
    float kt[EPL], vt[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      kt[e] = s_table[code_of(cur.k, e)];
      vt[e] = s_table[code_of(cur.v, e)];
    }

#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) continue;
      float dot = 0.0f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) dot = fmaf(qv[g][e], kt[e], dot);
      dot = group_sum<LPR>(dot);
      float s = fmaf(ksg, dot, kmu * qsum[g]);
      if (capped) s = logit_cap * tanhf(s / logit_cap) * LOG2E;
      if (have) {
        if (s > m_run[g]) {                       // uniform across the group
          const float alpha = exp2f(m_run[g] - s);
          l_run[g] *= alpha;
          mu_run[g] *= alpha;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
          m_run[g] = s;
        }
        const float pe = exp2f(s - m_run[g]);
        const float ps = pe * vsg;
        l_run[g] += pe;
        mu_run[g] = fmaf(pe, vmu, mu_run[g]);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(ps, vt[e], acc[g][e]);
      }
    }

    cur = nxt;
    row = next_row;
    have = have_next;
  }

  // merge, in a fixed order: first the row groups of a warp (registers),
  // then the warps of the block (shared memory)
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] += mu_run[g];
    if (RPW == 2) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m_run[g], LPR % 32);
      const float l_o = __shfl_xor_sync(0xffffffffu, l_run[g], LPR % 32);
      const float mx = fmaxf(m_run[g], m_o);
      const float a_s = exp2f(m_run[g] - mx);
      const float a_o = exp2f(m_o - mx);
      l_run[g] = l_run[g] * a_s + l_o * a_o;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[g][e], LPR % 32);
        acc[g][e] = acc[g][e] * a_s + acc_o * a_o;
      }
      m_run[g] = mx;
    }
    if (lane < LPR) {
      if (lane == 0) {
        s_m[warp][g] = m_run[g];
        s_l[warp][g] = l_run[g];
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e) s_acc[warp][g][d0 + e] = acc[g][e];
    }
  }
  __syncthreads();

  const size_t pbase = (((size_t)b * splits + split) * KV + kvh) * G;
  for (int idx = threadIdx.x; idx < G * D; idx += NW * 32) {
    const int g = idx / D;
    const int d = idx % D;
    float mx = s_m[0][g];
#pragma unroll
    for (int wv = 1; wv < NW; ++wv) mx = fmaxf(mx, s_m[wv][g]);
    float l = 0.0f, a = 0.0f;
#pragma unroll
    for (int wv = 0; wv < NW; ++wv) {
      const float alpha = exp2f(s_m[wv][g] - mx);
      l = fmaf(alpha, s_l[wv][g], l);
      a = fmaf(alpha, s_acc[wv][g][d], a);
    }
    acc_part[(pbase + g) * D + d] = a;
    if (d == 0) {
      m_part[pbase + g] = mx;
      l_part[pbase + g] = l;
    }
  }
}

// Merge the splits: alpha_s = 2^(m_s - max m) (the partial maxima are kept
// in base 2), out = sum alpha_s acc_s / max(sum alpha_s l_s, 1e-30).  One
// block per (batch, head).
__global__ void paged_attn_combine_kernel(const float* __restrict__ m_part,
                                          const float* __restrict__ l_part,
                                          const float* __restrict__ acc_part,
                                          void* __restrict__ out, int out_bf16,
                                          int H, int D, int splits) {
  // launched as a programmatic dependent of the tensor-core body: wait
  // until that grid has finished and its partials are visible (returns at
  // once after an ordinary launch)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  float mx = NEG_INF;
  for (int s = 0; s < splits; ++s)
    mx = fmaxf(mx, m_part[((size_t)b * splits + s) * H + h]);
  float l = 0.0f;
  for (int s = 0; s < splits; ++s) {
    const size_t i = ((size_t)b * splits + s) * H + h;
    l = fmaf(exp2f(m_part[i] - mx), l_part[i], l);
  }
  const float denom = fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.0f;
    for (int s = 0; s < splits; ++s) {
      const size_t i = ((size_t)b * splits + s) * H + h;
      a = fmaf(exp2f(m_part[i] - mx), acc_part[i * D + d], a);
    }
    const float o = a / denom;
    const size_t oi = ((size_t)b * H + h) * D + d;
    if (out_bf16) {
      reinterpret_cast<__nv_bfloat16*>(out)[oi] = __float2bfloat16(o);
    } else {
      reinterpret_cast<float*>(out)[oi] = o;
    }
  }
}

struct Args {
  const void* q;
  int q_bf16;
  const uint8_t *k_codes, *v_codes;
  const __nv_bfloat16 *k_mu, *k_sigma, *v_mu, *v_sigma;
  const int *block_tables, *q_pos;
  const float* table;
  float *m_part, *l_part, *acc_part;
  int B, H, KV, D, page, n_pages, splits, window;
  float logit_cap;
  cudaStream_t stream;
};

template <int BITS, int LPR, int PPL, int GMAX>
void launch_one(const Args& a) {
  dim3 grid(a.B, a.KV, a.splits);
  paged_attn_kernel<BITS, LPR, PPL, GMAX><<<grid, NW * 32, 0, a.stream>>>(
      a.q, a.q_bf16, a.k_codes, a.k_mu, a.k_sigma, a.v_codes, a.v_mu,
      a.v_sigma, a.block_tables, a.q_pos, a.table, a.m_part, a.l_part,
      a.acc_part, a.H, a.KV, a.D, a.page, a.n_pages, a.splits, a.window,
      a.logit_cap);
}

template <int BITS, int LPR, int PPL>
int launch_g(const Args& a, int gmax) {
  switch (gmax) {
    case 1: launch_one<BITS, LPR, PPL, 1>(a); return 0;
    case 2: launch_one<BITS, LPR, PPL, 2>(a); return 0;
    case 4: launch_one<BITS, LPR, PPL, 4>(a); return 0;
    case 8:
      // 8 warps x 8 queries x 256 dims of merge scratch would not fit the
      // 48 KB of static shared memory
      if constexpr (LPR * PPL * 2 <= 128) {
        launch_one<BITS, LPR, PPL, 8>(a);
        return 0;
      }
      return -1;
    default: return -1;
  }
}

template <int BITS>
int launch_d(const Args& a, int gmax) {
  if (a.D <= 32) return launch_g<BITS, 16, 1>(a, gmax);
  if (a.D <= 64) return launch_g<BITS, 16, 2>(a, gmax);
  if (a.D <= 128) return launch_g<BITS, 16, 4>(a, gmax);
  return launch_g<BITS, 32, 4>(a, gmax);
}

// ---------------------------------------------------------------------------
// bf16 queries: the tensor-core body
// ---------------------------------------------------------------------------

constexpr int TC_ROWS = 16;     // rows of a chunk: one m16n8k16 step of P.V
constexpr int TC_STAGES = 3;    // the ring's depth (a fourth does not fit
                                // beside the level table and the queries)
constexpr int TC_MAX_DEVICES = 64;
constexpr int TC_SMEM_MAX = 232448;           // a block's dynamic shared memory
constexpr int TC_TAB_BYTES = 256 * 256;       // the level table (see below)
constexpr float LOG2E_F = 1.4426950408889634f;

// consumer warps of a block: 16 up to D = 128, 8 above, where a warp's
// accumulators and queries take twice the registers.  One producer warp
// more.
template <int DMAX>
__host__ __device__ constexpr int tc_warps() {
  return DMAX <= 128 ? 16 : 8;
}

// Up to D = 128 the queries wait in shared memory, each lane's A fragment
// of a k-step one 16-byte word {a0, 0, a2, 0} (room for 8 heads); above,
// in registers.
template <int DMAX>
__host__ __device__ constexpr int tc_q_bytes() {
  return DMAX <= 128 ? 8 * (DMAX / 16) * 32 * 16 : 0;
}

struct TcArgs {
  const __nv_bfloat16* q;                     // (B, H, D)
  const uint8_t *k_codes, *v_codes;           // (P, page, KV, Dc)
  const __nv_bfloat16 *k_mu, *k_sigma, *v_mu, *v_sigma;   // (P, page, KV)
  const int *block_tables, *q_pos;
  const float* table;
  float *m_part, *l_part, *acc_part;          // (B, splits, H[, D])
  int H, KV, D, page, n_pages, splits, window;
  int heads;        // kv heads of one block (8, 4, 2 or 1, dividing KV)
  int rs;           // staged row stride in bytes, 16 mod 128
  int stat_bytes;   // one staged stat array, 16-byte aligned
  int stage_bytes;  // one stage: 16 K rows, 16 V rows, four stat arrays
  int stages;       // TC_STAGES, or fewer where they do not fit
  float scale;      // D^-1/2 as f32
  float logit_cap;  // 0: none
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// arrives and raises the phase's expected transaction bytes
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar,
                                                   uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// waits for the phase of parity `parity` to complete; traps (a launch
// error, not a hang) if it has not after ~2^24 polls
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (int n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (n > (1 << 24)) __trap();
  }
}

// `bytes` (a multiple of 16) from global to shared, both 16-byte aligned;
// completion is counted on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// two floats -> bf16x2, each rounded to nearest even; `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (16 x 8) += A (16 x 16) . B (16 x 8), bf16 in, f32 sums
__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The plain version's element: bf16 of mu + sigma * t[c], a separate f32
// multiply and add (no contraction).
__device__ __forceinline__ float level(float t, float mu, float sigma) {
  return __fadd_rn(mu, __fmul_rn(sigma, t));
}

// The level table: 256 rows of 256 bytes at the start of dynamic shared
// memory, row b for the stored byte b, each lane reading its own bank.
// kv8: the float at b * 256 + 4 lane is t[b ^ 0x80] (the pool stores code
// - 128).  kv4: the float2 at b * 256 + 8 lane is (t[b & 15], t[b >> 4]),
// the levels of both nibbles.  The offset of byte i of `w` for this lane
// (lane_off = 4 lane or 8 lane) is one byte permute, lane_off | w.byte_i
// << 8, and the load adds the table's shared address as its immediate: the
// dynamic region starts right after the block's reserved shared memory
// (checked by the host and by the kernel), so a lookup is two
// instructions.
constexpr uint32_t TC_SMEM_BASE = 1024;

__device__ __forceinline__ float tab_f(uint32_t w, int i, uint32_t lane_off) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1+1024];\n"
      : "=f"(v) : "r"(__byte_perm(w, lane_off, 0x5504 | (i << 4))));
  return v;
}

__device__ __forceinline__ float2 tab_f2(uint32_t w, int i,
                                         uint32_t lane_off) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2+1024];\n"
      : "=f"(v.x), "=f"(v.y)
      : "r"(__byte_perm(w, lane_off, 0x5504 | (i << 4))));
  return v;
}

template <typename T>
__device__ __forceinline__ T lds(const uint8_t* smem, int off) {
  return *reinterpret_cast<const T*>(smem + off);
}

// Chunk gi of a sequence: logical page j, first row r0 within it, rows.
struct Chunk {
  int j, r0, rows;
};

__device__ __forceinline__ Chunk chunk_at(int gi, int cpp, int page) {
  Chunk c;
  c.j = gi / cpp;
  c.r0 = (gi - c.j * cpp) * TC_ROWS;
  c.rows = min(TC_ROWS, page - c.r0);
  return c;
}

// Grid (B, splits, KV / heads).  The valid rows lo_row..hi_row of sequence
// b are cut into chunks of 16 rows aligned to their page (a page of
// ceil(page / 16) chunks; the last may be short), numbered across pages, and
// split s walks chunks [c_begin, c_end): every valid row is in exactly one
// split's chunks (kernels/paged_attn.py:split_row_ranges mirrors this).
// Consumer warp w owns head w % heads and the chunks i (numbered over the
// split's) with i % slots == w / heads.
template <int BITS, int DMAX>
__global__ void __launch_bounds__((tc_warps<DMAX>() + 1) * 32, 1)
paged_attn_tc_kernel(const TcArgs a) {
  constexpr int NW = tc_warps<DMAX>();
  constexpr int NKS = DMAX / 16;     // k-steps of S, m-tiles of O
  extern __shared__ __align__(128) uint8_t smem[];

  constexpr int QB = tc_q_bytes<DMAX>();
  constexpr int RING = TC_TAB_BYTES + QB;            // the stages
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + RING + a.stages * a.stage_bytes);
  if (smem_u32(smem) != TC_SMEM_BASE) __trap();   // see tab_f

  const int b = blockIdx.x;
  const int split = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int page = a.page;
  const int Dc = BITS == 4 ? a.D / 2 : a.D;
  const int hb = a.heads * Dc;       // one row's code bytes of this block

  const int qp = a.q_pos[b];
  const int hi_row = min(qp, a.n_pages * page - 1);
  const int lo_row = (a.window > qp) ? 0 : (qp - a.window + 1);
  const int cpp = (page + TC_ROWS - 1) / TC_ROWS;
  int c_begin = 0, c_end = 0;
  if (hi_row >= lo_row) {
    const int g_lo = (lo_row / page) * cpp + (lo_row % page) / TC_ROWS;
    const int g_hi = (hi_row / page) * cpp + (hi_row % page) / TC_ROWS;
    const int per = (g_hi - g_lo + a.splits) / a.splits;
    c_begin = min(g_lo + split * per, g_hi + 1);
    c_end = min(c_begin + per, g_hi + 1);
  }
  const int n_chunks = c_end - c_begin;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(smem_u32(&bars[s]), 1);                     // full
      mbar_init(smem_u32(&bars[TC_STAGES + s]), NW);    // empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NW) {
    // producer: one chunk per stage, lane r copying row r's K and V codes
    // of the block's heads and lanes 0-3 the four stat arrays
    for (int i = 0; i < n_chunks; ++i) {
      const int s = i % a.stages;
      if (i >= a.stages)
        mbar_wait(smem_u32(&bars[TC_STAGES + s]), (i / a.stages - 1) & 1);
      const Chunk c = chunk_at(c_begin + i, cpp, page);
      const size_t row0 =
          (size_t)a.block_tables[(size_t)b * a.n_pages + c.j] * page + c.r0;
      uint8_t* st = smem + RING + s * a.stage_bytes;
      const uint32_t full = smem_u32(&bars[s]);
      if (lane == 0)
        mbar_arrive_expect(full, c.rows * (2 * hb + 8 * a.KV));
      __syncwarp();
      if (lane < c.rows) {
        const size_t off =
            (row0 + lane) * (size_t)(a.KV * Dc) + (size_t)blockIdx.z * hb;
        bulk_copy(smem_u32(st + lane * a.rs), a.k_codes + off, hb, full);
        bulk_copy(smem_u32(st + (TC_ROWS + lane) * a.rs), a.v_codes + off, hb,
                  full);
      }
      if (lane < 4) {
        const __nv_bfloat16* src = lane == 0 ? a.k_mu
                                   : lane == 1 ? a.k_sigma
                                   : lane == 2 ? a.v_mu : a.v_sigma;
        bulk_copy(smem_u32(st + 2 * TC_ROWS * a.rs + lane * a.stat_bytes),
                  src + row0 * a.KV, c.rows * a.KV * 2, full);
      }
    }
    return;
  }

  // consumers: the level table first
#pragma unroll
  for (int k = 0; k < TC_TAB_BYTES / 16 / (NW * 32); ++k) {
    const int i = threadIdx.x + k * NW * 32;
    const int row = i / 16;        // the stored byte
    float4 v;
    if (BITS == 8) {
      const float t = a.table[row ^ 0x80];
      v = make_float4(t, t, t, t);
    } else {
      const float lo = a.table[row & 15], hi = a.table[row >> 4];
      v = make_float4(lo, hi, lo, hi);
    }
    reinterpret_cast<float4*>(smem)[i] = v;
  }

  const int head = warp % a.heads;
  const int slots = NW / a.heads;
  const int slot = warp / a.heads;
  const int kvh = blockIdx.z * a.heads + head;
  const int G = a.H / a.KV;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int nks = a.D / 16;
  const uint32_t lane_off = lane * (BITS == 8 ? 4 : 8);

  // queries of this head, the A operand of S (rows gid < G, the rest
  // zero): k-step ks holds dims 16 ks + 4 tig + {0, 1} (a0) and {2, 3}
  // (a2).  K's B fragment takes the same four dims of a row, so the
  // permutation of the sum over dims is the same on both sides.
  uint4 qa[QB ? 1 : NKS];
  const int q_off = TC_TAB_BYTES + head * NKS * 512 + lane * 16;
  {
    const __nv_bfloat16* qrow =
        a.q + ((size_t)b * a.H + kvh * G + gid) * a.D + 4 * tig;
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      uint2 v = make_uint2(0u, 0u);
      if (gid < G && ks < nks)
        v = *reinterpret_cast<const uint2*>(qrow + 16 * ks);
      const uint4 f = make_uint4(v.x, 0u, v.y, 0u);
      if (QB == 0)
        qa[QB ? 0 : ks] = f;
      else if (slot == 0)
        *reinterpret_cast<uint4*>(smem + q_off + ks * 512) = f;
    }
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(NW * 32) : "memory");

  const bool capped = a.logit_cap > 0.0f;
  // online softmax state: the running max of query gid (base 2), this
  // lane's share of its weight sum, and O^T: with d0 = 16 mt + 2 gid,
  // acc[mt] = {O[2 tig][d0], O[2 tig + 1][d0], O[2 tig][d0 + 1],
  // O[2 tig + 1][d0 + 1]}
  float m_run = NEG_INF, l_run = 0.0f;
  float acc[NKS][4];
#pragma unroll
  for (int mt = 0; mt < NKS; ++mt)
    acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.0f;

  for (int i = 0; i < n_chunks; ++i) {
    const int s = i % a.stages;
    const Chunk c = chunk_at(c_begin + i, cpp, page);
    const int row_base = c.j * page + c.r0;   // logical row of chunk row 0
    const int st = RING + s * a.stage_bytes;   // stage offset
    const int stat = st + 2 * TC_ROWS * a.rs + 2 * kvh;   // k_mu of row 0
    const int sb = a.stat_bytes;
    mbar_wait(smem_u32(&bars[s]), (i / a.stages) & 1);
    if (i % slots == slot) {
      // K: this lane's rows gid (n-tile 0) and gid + 8
      float kmu[2], ksg[2];
      int koff[2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int r = gid + 8 * jj;
        const int so = stat + r * a.KV * 2;
        kmu[jj] = __bfloat162float(lds<__nv_bfloat16>(smem, so));
        ksg[jj] = __bfloat162float(lds<__nv_bfloat16>(smem, so + sb));
        koff[jj] = st + r * a.rs + head * Dc + (BITS == 8 ? 4 : 2) * tig;
      }
      // the rows of this lane's scores and of its P / V fragments
      int rr[4];
      bool ok[4];
      float vmu[4], vsg[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        rr[k] = 2 * tig + (k & 1) + 8 * (k >> 1);
        const int row = row_base + rr[k];
        ok[k] = rr[k] < c.rows && row >= lo_row && row <= hi_row;
        // a masked row's V is exactly zero, whatever the stage holds
        const int so = stat + rr[k] * a.KV * 2 + 2 * sb;
        vmu[k] = ok[k] ? __bfloat162float(lds<__nv_bfloat16>(smem, so))
                       : 0.0f;
        vsg[k] = ok[k] ? __bfloat162float(lds<__nv_bfloat16>(smem, so + sb))
                       : 0.0f;
      }

      // S (queries x 16 rows) = Q K^T, f32 sums of exact bf16 products;
      // rows 8-15 of A are zero, and so stay sc[jj][2..3]
      float sc[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks) {
        if (ks >= nks) break;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float mu = kmu[jj], sg = ksg[jj];
          uint32_t b0, b1;
          if (BITS == 8) {
            const uint32_t w = lds<uint32_t>(smem, koff[jj] + 16 * ks);
            b0 = pack_bf16(
                level(tab_f(w, 0, lane_off), mu, sg),
                level(tab_f(w, 1, lane_off), mu, sg));
            b1 = pack_bf16(
                level(tab_f(w, 2, lane_off), mu, sg),
                level(tab_f(w, 3, lane_off), mu, sg));
          } else {
            const uint32_t w = lds<uint16_t>(smem, koff[jj] + 8 * ks);
            const float2 t0 = tab_f2(w, 0, lane_off);
            const float2 t1 = tab_f2(w, 1, lane_off);
            b0 = pack_bf16(level(t0.x, mu, sg), level(t0.y, mu, sg));
            b1 = pack_bf16(level(t1.x, mu, sg), level(t1.y, mu, sg));
          }
          const uint4 qf = QB ? lds<uint4>(smem, q_off + ks * 512)
                              : qa[QB ? 0 : ks];
          mma(sc[jj], qf.x, qf.y, qf.z, qf.w, b0, b1);
        }
      }

      // base-2 logits of query gid at rows rr[0..3], as the plain version
      // scales them (the product, then * D^-1/2, then the cap)
      float x[4] = {sc[0][0], sc[0][1], sc[1][0], sc[1][1]};
      float mx = NEG_INF;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float v = __fmul_rn(x[k], a.scale);
        if (capped)
          v = __fmul_rn(a.logit_cap, tanhf(__fdiv_rn(v, a.logit_cap)));
        x[k] = ok[k] ? __fmul_rn(v, LOG2E_F) : NEG_INF;
        mx = fmaxf(mx, x[k]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      const float alpha = exp2f(m_run - m_new);
      float p[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) p[k] = ok[k] ? exp2f(x[k] - m_new) : 0.0f;
      l_run = l_run * alpha + ((p[0] + p[1]) + (p[2] + p[3]));
      m_run = m_new;
      // the accumulators need rescaling only when a running max grew
      const bool grew = __any_sync(0xffffffffu, alpha != 1.0f);
      const float al0 = __shfl_sync(0xffffffffu, alpha, 8 * tig);
      const float al1 = __shfl_sync(0xffffffffu, alpha, 8 * tig + 4);
      // P^T's B fragment is this lane's own score fragment
      const uint32_t pb0 = pack_bf16(p[0], p[1]);
      const uint32_t pb1 = pack_bf16(p[2], p[3]);

      if (grew) {
#pragma unroll
        for (int mt = 0; mt < NKS; ++mt) {
          acc[mt][0] *= al0;
          acc[mt][1] *= al1;
          acc[mt][2] *= al0;
          acc[mt][3] *= al1;
        }
      }

      // O^T (dims x queries) += V^T P^T
      const int voff = st + TC_ROWS * a.rs + head * Dc
                       + (BITS == 8 ? 2 * gid : gid);
#pragma unroll
      for (int mt = 0; mt < NKS; ++mt) {
        if (mt >= nks) break;
        float lo[4], hi[4];   // dims d0 and d0 + 1 of rows rr[k]
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = voff + rr[k] * a.rs;
          if (BITS == 8) {
            const uint32_t w = lds<uint16_t>(smem, e + 16 * mt);
            lo[k] = level(tab_f(w, 0, lane_off), vmu[k],
                          vsg[k]);
            hi[k] = level(tab_f(w, 1, lane_off), vmu[k],
                          vsg[k]);
          } else {
            const uint32_t w = lds<uint8_t>(smem, e + 8 * mt);
            const float2 t = tab_f2(w, 0, lane_off);
            lo[k] = level(t.x, vmu[k], vsg[k]);
            hi[k] = level(t.y, vmu[k], vsg[k]);
          }
        }
        mma(acc[mt], pack_bf16(lo[0], lo[1]), pack_bf16(hi[0], hi[1]),
            pack_bf16(lo[2], lo[3]), pack_bf16(hi[2], hi[3]), pb0, pb1);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&bars[TC_STAGES + s]));
  }

  // the split's partials, one set per head
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
  const size_t pbase = ((size_t)b * a.splits + split) * a.H + (size_t)kvh * G;
  auto write_partials = [&]() {
    if (tig == 0 && gid < G) {
      a.m_part[pbase + gid] = m_run;
      a.l_part[pbase + gid] = l_run;
    }
#pragma unroll
    for (int mt = 0; mt < NKS; ++mt) {
      if (mt >= nks) break;
      const int d0 = 16 * mt + 2 * gid;
      if (2 * tig < G)
        *reinterpret_cast<float2*>(a.acc_part + (pbase + 2 * tig) * a.D +
                                   d0) = make_float2(acc[mt][0], acc[mt][2]);
      if (2 * tig + 1 < G)
        *reinterpret_cast<float2*>(a.acc_part + (pbase + 2 * tig + 1) * a.D +
                                   d0) = make_float2(acc[mt][1], acc[mt][3]);
    }
  };
  if (slots == 1) {
    write_partials();
    return;
  }
  // slots 1.. leave their state in shared memory, in their own fragment
  // layout (the table's room: every lookup is done after the barrier);
  // slot 0 folds them in, in order, and writes the split's partials
  constexpr int SW = NKS * 4 + 2;                   // words per lane
  float* s_st = reinterpret_cast<float*>(smem);     // [NW - heads][SW][32]
  asm volatile("bar.sync 1, %0;\n" :: "n"(NW * 32) : "memory");
  if (slot != 0) {
    float* w = s_st + (warp - a.heads) * SW * 32 + lane;
#pragma unroll
    for (int mt = 0; mt < NKS; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j) w[(mt * 4 + j) * 32] = acc[mt][j];
    w[NKS * 4 * 32] = m_run;
    w[(NKS * 4 + 1) * 32] = l_run;
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(NW * 32) : "memory");
  if (slot != 0) return;
  for (int sl = 1; sl < slots; ++sl) {
    const float* w = s_st + (sl * a.heads + head - a.heads) * SW * 32 + lane;
    const float m_o = w[NKS * 4 * 32];
    const float mx = fmaxf(m_run, m_o);
    const float a_s = exp2f(m_run - mx), a_o = exp2f(m_o - mx);
    l_run = l_run * a_s + w[(NKS * 4 + 1) * 32] * a_o;
    m_run = mx;
    const float s0 = __shfl_sync(0xffffffffu, a_s, 8 * tig);
    const float s1 = __shfl_sync(0xffffffffu, a_s, 8 * tig + 4);
    const float o0 = __shfl_sync(0xffffffffu, a_o, 8 * tig);
    const float o1 = __shfl_sync(0xffffffffu, a_o, 8 * tig + 4);
#pragma unroll
    for (int mt = 0; mt < NKS; ++mt) {
      acc[mt][0] = acc[mt][0] * s0 + w[(mt * 4 + 0) * 32] * o0;
      acc[mt][1] = acc[mt][1] * s1 + w[(mt * 4 + 1) * 32] * o1;
      acc[mt][2] = acc[mt][2] * s0 + w[(mt * 4 + 2) * 32] * o0;
      acc[mt][3] = acc[mt][3] * s1 + w[(mt * 4 + 3) * 32] * o1;
    }
  }
  write_partials();
}

template <int BITS, int DMAX>
int tc_launch(const TcArgs& a, int dev, dim3 grid, int smem,
              cudaStream_t stream) {
  // the attribute is set once per kernel and device
  static bool ready[TC_MAX_DEVICES] = {};
  if (!ready[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attn_tc_kernel<BITS, DMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM_MAX);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  paged_attn_tc_kernel<BITS, DMAX>
      <<<grid, (tc_warps<DMAX>() + 1) * 32, smem, stream>>>(a);
  return 0;
}

template <int BITS>
int tc_launch_d(const TcArgs& a, int dev, dim3 grid, int smem,
                cudaStream_t stream) {
  if (a.D <= 64) return tc_launch<BITS, 64>(a, dev, grid, smem, stream);
  if (a.D <= 128) return tc_launch<BITS, 128>(a, dev, grid, smem, stream);
  return tc_launch<BITS, 256>(a, dev, grid, smem, stream);
}

}  // namespace

// Returns 0 on success, a cudaError_t value if a launch was refused, or a
// negative value for an argument the kernel does not take (an odd D at 4
// bits, D > 256, H / KV > 8, H / KV > 4 together with D > 128, bits other
// than 4 or 8).  An odd D at 8 bits takes the byte-wise code load
// (`load_bytes`, `aligned` false): a lane's codes past D are never scored
// (their queries are 0) and never stored.
extern "C" int paged_attn_launch(
    const void* q, int q_bf16, const void* k_codes, const void* k_mu,
    const void* k_sigma, const void* v_codes, const void* v_mu,
    const void* v_sigma, const int* block_tables, const int* q_pos,
    const float* table, float* m_part, float* l_part, float* acc_part,
    void* out, int B, int H, int KV, int D, int page, int n_pages, int splits,
    int bits, int window, float logit_cap, void* stream_ptr) {
  if (B <= 0 || H <= 0 || KV <= 0 || D <= 0 || page <= 0 || n_pages <= 0 ||
      splits <= 0)
    return -2;
  if (bits != 4 && bits != 8) return -3;
  if ((bits == 4 && D % 2) || D > 256 || H % KV) return -4;
  const int G = H / KV;
  if (G > 8) return -5;
  const int gmax = G <= 1 ? 1 : (G <= 2 ? 2 : (G <= 4 ? 4 : 8));
  Args a;
  a.q = q;
  a.q_bf16 = q_bf16;
  a.k_codes = static_cast<const uint8_t*>(k_codes);
  a.v_codes = static_cast<const uint8_t*>(v_codes);
  a.k_mu = static_cast<const __nv_bfloat16*>(k_mu);
  a.k_sigma = static_cast<const __nv_bfloat16*>(k_sigma);
  a.v_mu = static_cast<const __nv_bfloat16*>(v_mu);
  a.v_sigma = static_cast<const __nv_bfloat16*>(v_sigma);
  a.block_tables = block_tables;
  a.q_pos = q_pos;
  a.table = table;
  a.m_part = m_part;
  a.l_part = l_part;
  a.acc_part = acc_part;
  a.B = B;
  a.H = H;
  a.KV = KV;
  a.D = D;
  a.page = page;
  a.n_pages = n_pages;
  a.splits = splits;
  a.window = window;
  a.logit_cap = logit_cap;
  a.stream = static_cast<cudaStream_t>(stream_ptr);
  const int rc = (bits == 4) ? launch_d<4>(a, gmax) : launch_d<8>(a, gmax);
  if (rc != 0) return rc;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = D < 128 ? 32 * ((D + 31) / 32) : 128;
  paged_attn_combine_kernel<<<B * H, threads, 0, a.stream>>>(
      m_part, l_part, acc_part, out, q_bf16, H, D, splits);
  return static_cast<int>(cudaGetLastError());
}


// The tensor-core body for bf16 queries, then the combine.  Returns 0 on
// success, a cudaError_t value if a launch was refused, or a negative value
// for an argument it does not take: D not a multiple of 16 or above 256,
// H / KV > 8, a page not a multiple of 8, a row's code bytes of one block's
// heads not a multiple of 16, a pool pointer not 16-byte aligned (q: 8),
// a stage that does not fit shared memory, a device ordinal past
// TC_MAX_DEVICES, or a card whose reserved shared memory is not the 1 KB
// `tab_f` assumes.  `m_part`
// and `l_part` hold B * splits * H floats, `acc_part` D times as many.
extern "C" int paged_attn_tc_launch(
    const void* q, const void* k_codes, const void* k_mu, const void* k_sigma,
    const void* v_codes, const void* v_mu, const void* v_sigma,
    const int* block_tables, const int* q_pos, const float* table,
    float* m_part, float* l_part, float* acc_part, void* out, int B, int H,
    int KV, int D, int page, int n_pages, int splits, int bits, int window,
    float scale, float logit_cap, void* stream_ptr) {
  if (B <= 0 || H <= 0 || KV <= 0 || D <= 0 || page <= 0 || n_pages <= 0 ||
      splits <= 0)
    return -2;
  if (bits != 4 && bits != 8) return -3;
  if (D % 16 || D > 256 || H % KV) return -4;
  if (H / KV > 8) return -5;
  if (page % 8) return -6;
  const int heads = KV % 8 == 0 ? 8 : KV % 4 == 0 ? 4 : KV % 2 == 0 ? 2 : 1;
  const int Dc = bits == 4 ? D / 2 : D;
  const int hb = heads * Dc;
  if (hb % 16) return -7;
  for (const void* p : {k_codes, v_codes, k_mu, k_sigma, v_mu, v_sigma})
    if (reinterpret_cast<uintptr_t>(p) % 16) return -8;
  if (reinterpret_cast<uintptr_t>(q) % 8) return -8;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= TC_MAX_DEVICES) return -9;
  static int reserved[TC_MAX_DEVICES] = {};   // read once per device
  if (reserved[dev] == 0) {
    err = cudaDeviceGetAttribute(&reserved[dev],
                                 cudaDevAttrReservedSharedMemoryPerBlock, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (reserved[dev] != static_cast<int>(TC_SMEM_BASE)) return -11;
  TcArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k_codes = static_cast<const uint8_t*>(k_codes);
  a.v_codes = static_cast<const uint8_t*>(v_codes);
  a.k_mu = static_cast<const __nv_bfloat16*>(k_mu);
  a.k_sigma = static_cast<const __nv_bfloat16*>(k_sigma);
  a.v_mu = static_cast<const __nv_bfloat16*>(v_mu);
  a.v_sigma = static_cast<const __nv_bfloat16*>(v_sigma);
  a.block_tables = block_tables;
  a.q_pos = q_pos;
  a.table = table;
  a.m_part = m_part;
  a.l_part = l_part;
  a.acc_part = acc_part;
  a.H = H;
  a.KV = KV;
  a.D = D;
  a.page = page;
  a.n_pages = n_pages;
  a.splits = splits;
  a.window = window;
  a.heads = heads;
  a.rs = hb + (16 - hb % 128 + 128) % 128;
  a.stat_bytes = (TC_ROWS * KV * 2 + 15) / 16 * 16;
  a.stage_bytes = 2 * TC_ROWS * a.rs + 4 * a.stat_bytes;
  a.scale = scale;
  a.logit_cap = logit_cap;
  const int fixed = TC_TAB_BYTES + 2 * TC_STAGES * 8 +
                    (D <= 64    ? tc_q_bytes<64>()
                     : D <= 128 ? tc_q_bytes<128>()
                                : tc_q_bytes<256>());
  const int fit = (TC_SMEM_MAX - fixed) / a.stage_bytes;
  if (fit < 1) return -10;
  a.stages = min(TC_STAGES, fit);
  const int smem = fixed + a.stages * a.stage_bytes;
  const dim3 grid(B, splits, KV / heads);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int rc = bits == 8 ? tc_launch_d<8>(a, dev, grid, smem, stream)
                           : tc_launch_d<4>(a, dev, grid, smem, stream);
  if (rc != 0) return rc;
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = D < 128 ? 32 * ((D + 31) / 32) : 128;
  // the combine is a programmatic dependent launch: its launch overlaps
  // the tail of this grid, and it waits for the partials itself
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, paged_attn_combine_kernel,
                           (const float*)m_part, (const float*)l_part,
                           (const float*)acc_part, out, 1, H, D, splits);
  return static_cast<int>(err);
}
