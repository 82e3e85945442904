// Decode attention straight off a k-quantile-coded paged KV pool, for sm_90a.
//
// Replaces the TPU kernel `paged_quant_attention` of
// src/repro/kernels/paged_attn.py (body `_kernel`, `_dequant_page`, and the
// combine epilogue).  One query position per sequence attends over the pages
// its block-table row names: gather by block table, unpack (two codes per
// byte at 4 bits), dequantize per (row, head) as mu + sigma * table[code],
// scores * D^-1/2, optional cap * tanh(s / cap), causal and sliding-window
// mask on the logical row, online softmax in f32, split over the page axis
// into (m, l, acc) partials that a second kernel merges.
//
// What bounds it: the coded pool bytes (one pass over every valid row's K
// and V codes and their bf16 stats); in this version still the instructions
// spent per row.  What the design does about it: nothing is materialized
// densely; a block (batch, kv head, split) keeps its G = H / KV queries in
// registers; its 8 warps walk rows, a group of 16 lanes (32 above D = 128)
// per row with the head dimension spread over the group, each lane fetching
// its codes of a row with one load.  Only the pages that hold an unmasked row
// are visited, and it is that valid range — not the table width — that is
// divided among the splits, so a short sequence in a wide table still
// spreads over the blocks.  A group's walk is a chain of dependent loads, so
// the next row's codes and stats are fetched before the current row is
// processed.  The row statistics are factored out of the per-element work:
// q.k = mu_k * sum(q) + sigma_k * sum(q_d * t[c_d]) and
// sum_r p_r v_r = sum_r p_r mu_r + sum_r (p_r sigma_r) t[c_rd], so an element
// costs one table lookup and one multiply-add per query.  Softmax runs in
// base 2 (scores pre-multiplied by log2 e).
//
// Edge behaviour kept from the reference: the running max starts at -1e30
// (finite), masked rows add nothing, a split that sees only masked rows
// emits m = -1e30, l = 0, acc = 0 and an all-masked query combines to exact
// zeros; logical pages past the table width count as masked.
//
// Deterministic: fixed traversal order, no atomics.  Plain C interface; the
// caller allocates every buffer and passes the stream.

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

}  // namespace

// Returns 0 on success, a cudaError_t value if a launch was refused, or a
// negative value for an argument the kernel does not take (odd D, D > 256,
// H / KV > 8, H / KV > 4 together with D > 128, bits other than 4 or 8).
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
  if (D % 2 || D > 256 || H % KV) return -4;
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
