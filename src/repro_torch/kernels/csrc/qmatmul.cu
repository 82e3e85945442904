// Dequant-fused matmuls over k-quantile-coded weights, for sm_90a.
//
//   out (M, N) = a (M, K) @ dequant(w) (K, N)
//   qmatmul     : dequant(w)[k, n] = mu[n] + sigma[n] * table[code[k, n]]
//   qmatmul_lut : dequant(w)[k, n] = lut[code[k, n], n]  (or lut[code] for
//                 one codebook shared by every column)
//   qmatmul_a8  : a[m, k] = a_codes[m, k] * scale[m]  (int8 activation
//                 codes, a scale per row or one for all), Gaussian levels
//
// Replaces the TPU kernels `qmatmul`, `qmatmul_lut` and `qmatmul_a8` of
// src/repro/kernels/qmatmul.py (bodies `_kernel`, `_kernel_lut`,
// `_kernel_a8`, `_unpack_dequant`).  `w` is row-major (K, N/2) uint8 at 4
// bits (low nibble = even column, high nibble = odd column) or (K, N) int8
// at 8 bits (stored code - 128).  `table` holds the 2^bits standardized
// levels and is built once by the caller, so no erfinv runs here.
//
// What bounds them: at decode shapes (M <= 32) the coded weight bytes; at
// prefill shapes the multiply-adds.  A block owns a (BM, 128) output tile
// and loops over its K range; K is split across blocks so that narrow
// outputs still fill the card.  Weights are read once per M tile as packed
// bytes.
//
// qmatmul and qmatmul_lut.  The level of a code (`WM`, a template
// argument): the Gaussian formula from a shared-memory table and
// per-column statistics; a shared codebook of k levels copied to shared
// memory (the engine's per-tensor `q_lut`); or a (k, N) per-column codebook
// read through the read-only cache (a 128-column tile of it is 128 KB at
// k = 256, more than a block's static shared memory, and the TPU kernel's k
// select passes are a TPU workaround for slow gathers).  Two bodies:
//   * bf16 activations: the weight tile is dequantized into shared memory,
//     rounded to bf16 (as the TPU kernel rounds its scratch tile to the
//     activations' dtype) and multiplied on the tensor cores, mma.sync
//     m16n8k16 bf16 x bf16 -> f32, fragments fetched with ldmatrix
//     (transposed for the weights, whose stored direction N is not the
//     direction a fragment packs); a stage is prefetched into registers one
//     iteration ahead;
//   * f32 activations: f32 levels, f32 FMAs on the CUDA cores.
//
// qmatmul_a8 (the reference engine's numerics, f32 `code * scale` against
// f32 levels; the TPU kernel's bf16 rounding of both is not followed) runs
// on the tensor cores and is exact there.  Per-column statistics and
// per-row scales factor out of the sum:
//   out[m, n] = s_m * (mu_n * R_m + sigma_n * D_mn),
//   R_m = sum_k c_mk (int32, exact),  D_mn = sum_k c_mk * T[q_kn],
//   T[q] = h[q] + d[q] + l[q]  (three bf16 parts, `ref.level_split`; their
//   sum is T exactly).
// A code c in [-128, 127] is exact in bf16 and each product c * h, c * d,
// c * l is exact in f32 (8 x 8 significant bits), so three mma.sync
// products with f32 accumulation give the f32 sum; they differ from the
// plain version only in the order of the sum and in where mu, sigma and s
// are applied.  h is accumulated on its own and d, l into a second
// accumulator added last, so the small parts are never added into the
// large sum (measured on the card against the exact f64 sum at W4 / W8,
// M = 16 and 256: ~1e-6 for the split accumulators, ~1e-5 for all three
// parts in one accumulator, ~5e-6 for the plain version).
// What bounds it on this card: at decode shapes the weight bytes, at
// prefill the three tensor-core products (3 * 2 M K N at the bf16 rate);
// in between, the shared-memory traffic of building fragments.  What the
// design does about that:
//   * packed weight bytes and int8 activation codes go through a ring of
//     NS stages in shared memory by cp.async.cg 16-byte copies (4 stages
//     at W4, 3 at W8), so later stages are in flight while one is used;
//   * the codes of a stage are converted to bf16 once per block (with
//     their row sums, by dp4a) and fetched as A fragments by ldmatrix;
//   * each thread builds its B fragments in registers straight from the
//     staged bytes: one 8-byte (W4) or 16-byte (W8) load per staged row
//     covers the warp's 16 columns, and a code's three parts come from one
//     8-byte table entry ({h | d << 16, l}), replicated so the lanes of a
//     half-warp never meet in a bank at W4; no FMA or convert per weight.
//
// Determinism: a split writes its partial sums to a scratch buffer and a
// second kernel adds the splits in a fixed order (no atomics).  Every output
// element is accumulated over k in ascending order inside a split, and the
// split count depends on (K, N) only, so a row's result does not depend on
// M or on which rows share the call.
//
// Plain C interface; the caller allocates every buffer and passes the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;   // K rows per stage of the CUDA-core body
constexpr int MBK = 64;  // K rows per stage of the tensor-core body
constexpr int BN = 128;  // output columns per block

// how a code becomes a level
constexpr int W_GAUSS = 0;       // mu[n] + sigma[n] * table[code]
constexpr int W_LUT_SHARED = 1;  // lut[code], one codebook for all columns
constexpr int W_LUT_COL = 2;     // lut[code * N + n]

struct Args {
  const void* a;
  const float* a_scale;          // qmatmul_a8: (M,) per row, or one value
  int scale_per_row;
  const uint8_t* w;
  const float* mu;               // W_GAUSS: (N,) statistics, (k,) levels
  const float* sigma;
  const float* table;
  const uint16_t* split;         // qmatmul_a8: (3, k) bf16 parts of table
  const float* lut;              // W_LUT_*: (k,) or (k, N) levels
  float* part;                   // (splitk, M, N) partial sums
  int M, K, N, kchunk;
};

template <int WM>
__device__ __forceinline__ float level(int code, float mu, float sigma,
                                       const float* s_table,
                                       const float* lut, int n, int N) {
  if (WM == W_GAUSS)  // separate multiply and add: the plain version's rounding
    return __fadd_rn(mu, __fmul_rn(sigma, s_table[code]));
  if (WM == W_LUT_SHARED) return s_table[code];
  return n < N ? __ldg(lut + (size_t)code * N + n) : 0.0f;
}

// ---------------------------------------------------------------------------
// f32 activations: CUDA-core body (qmatmul, qmatmul_lut)
// ---------------------------------------------------------------------------

// TX threads along N each own TN columns as TN/4 float4 chunks (chunk c of
// thread tx starts at column c*TX*4 + tx*4, so a warp's float4 reads are
// contiguous); TY threads along M each own TM rows.  TX * TN == BN.
template <int BITS, int TX, int TY, int TM, int TN, int WM>
__global__ void __launch_bounds__(TX * TY) qmatmul_kernel(const Args p) {
  static_assert(TX * TN == BN, "tile width");
  static_assert(MBK % BK == 0, "kchunk is a multiple of both stages");
  static_assert(TN % 4 == 0, "float4 chunks");
  constexpr int NT = TX * TY;
  constexpr int BM = TY * TM;
  constexpr int NLEV = 1 << BITS;
  constexpr int CPB = (BITS == 4) ? 2 : 1;  // codes per byte
  constexpr int CPG = 4 * CPB;              // codes per 4-byte group
  constexpr int G4 = BN / CPG;              // 4-byte groups per tile row
  constexpr int AS = BK + 1;                // padded row stride of the A tile
  constexpr int NC = TN / 4;

  __shared__ float s_table[NLEV];
  __shared__ float s_mu[WM == W_GAUSS ? BN : 1];
  __shared__ float s_sigma[WM == W_GAUSS ? BN : 1];
  __shared__ float s_a[BM * AS];
  __shared__ __align__(16) float s_w[BK * BN];

  const int M = p.M, K = p.K, N = p.N, kchunk = p.kchunk;
  const uint8_t* __restrict__ w = p.w;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int k_begin = split * kchunk;
  const int k_end = min(K, k_begin + kchunk);
  const int ldw = N / CPB;                  // bytes per weight row
  const int byte0 = n0 / CPB;
  const bool vec_ok = (ldw % 4 == 0) &&
                      ((reinterpret_cast<uintptr_t>(w) & 3) == 0);

  if (WM != W_LUT_COL) {
    const float* src = WM == W_GAUSS ? p.table : p.lut;
    for (int i = tid; i < NLEV; i += NT) s_table[i] = src[i];
  }
  if (WM == W_GAUSS) {
    for (int i = tid; i < BN; i += NT) {
      const int n = n0 + i;
      s_mu[i] = n < N ? p.mu[n] : 0.0f;
      s_sigma[i] = n < N ? p.sigma[n] : 0.0f;
    }
  }
  __syncthreads();

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    // activations: (BM, BK) tile, zero outside M and the split's K range
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK;
      const int kk = i % BK;
      const int m = m0 + r;
      const int k = k0 + kk;
      float v = 0.0f;
      if (m < M && k < k_end)
        v = static_cast<const float*>(p.a)[(size_t)m * K + k];
      s_a[r * AS + kk] = v;
    }
    // weights: packed bytes -> codes -> levels, (BK, BN) f32 in shared
    for (int g = tid; g < BK * G4; g += NT) {
      const int kk = g / G4;
      const int gb = g % G4;
      const int k = k0 + kk;
      const int bcol = byte0 + gb * 4;
      uint32_t bits = 0;
      const bool in_k = k < k_end;
      if (in_k) {
        const uint8_t* wp = w + (size_t)k * ldw + bcol;
        if (vec_ok && bcol + 4 <= ldw) {
          bits = *reinterpret_cast<const uint32_t*>(wp);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (bcol + j < ldw) bits |= (uint32_t)wp[j] << (8 * j);
        }
      }
      float vals[CPG];
#pragma unroll
      for (int j = 0; j < CPG; ++j) {
        int code;
        if (BITS == 4) {
          code = (bits >> (4 * j)) & 0xF;
        } else {
          code = ((bits >> (8 * j)) & 0xFF) ^ 0x80;  // stored code + 128
        }
        const int col = gb * CPG + j;
        const float lv = level<WM>(
            code, WM == W_GAUSS ? s_mu[col] : 0.0f,
            WM == W_GAUSS ? s_sigma[col] : 0.0f, s_table, p.lut, n0 + col,
            N);
        vals[j] = in_k ? lv : 0.0f;
      }
      float4* dst = reinterpret_cast<float4*>(&s_w[kk * BN + gb * CPG]);
#pragma unroll
      for (int j = 0; j < CPG / 4; ++j)
        dst[j] = make_float4(vals[4 * j], vals[4 * j + 1], vals[4 * j + 2],
                             vals[4 * j + 3]);
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = s_a[(ty * TM + i) * AS + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 wv = *reinterpret_cast<const float4*>(
            &s_w[kk * BN + c * TX * 4 + tx * 4]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][c * 4 + 0] = fmaf(av[i], wv.x, acc[i][c * 4 + 0]);
          acc[i][c * 4 + 1] = fmaf(av[i], wv.y, acc[i][c * 4 + 1]);
          acc[i][c * 4 + 2] = fmaf(av[i], wv.z, acc[i][c * 4 + 2]);
          acc[i][c * 4 + 3] = fmaf(av[i], wv.w, acc[i][c * 4 + 3]);
        }
      }
    }
    __syncthreads();
  }

  float* dst = p.part + (size_t)split * M * N;
  const bool vec_out = (N % 4 == 0);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int n = n0 + c * TX * 4 + tx * 4;
      float* o = dst + (size_t)m * N + n;
      if (vec_out && n + 3 < N) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[i][c * 4 + 0], acc[i][c * 4 + 1],
                        acc[i][c * 4 + 2], acc[i][c * 4 + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) o[j] = acc[i][c * 4 + j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 activations: tensor-core body (qmatmul, qmatmul_lut)
// ---------------------------------------------------------------------------

constexpr int MMA_NT = 256;         // 8 warps; warp w owns columns [16w, 16w+16)
constexpr int A_LD = MBK + 8;       // padded row strides (bf16 elements):
constexpr int W_LD = BN + 8;        //   rows stay 16-byte aligned for ldmatrix

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// MT = BM / 16 row tiles per block.  A stage is fetched into registers one
// iteration ahead of its use (packed weight bytes and activation chunks), so
// the loads of stage i+1 are in flight while stage i is dequantized into
// shared memory and multiplied.
template <int BITS, int MT, int WM>
__global__ void __launch_bounds__(MMA_NT) qmatmul_mma_kernel(const Args p) {
  constexpr int BM = MT * 16;
  constexpr int NLEV = 1 << BITS;
  constexpr int CPB = (BITS == 4) ? 2 : 1;  // codes per byte
  constexpr int CPG = 4 * CPB;              // codes per 4-byte group
  constexpr int G4 = BN / CPG;              // 4-byte groups per tile row
  constexpr int ROWS_PER_PASS = MMA_NT / G4;
  constexpr int PASSES = MBK / ROWS_PER_PASS;
  constexpr int A_CHUNKS = BM * (MBK / 8);  // 16-byte chunks of the A tile
  constexpr int APT = (A_CHUNKS + MMA_NT - 1) / MMA_NT;

  __shared__ float s_table[NLEV];
  __shared__ __align__(16) __nv_bfloat16 s_a[BM * A_LD];
  __shared__ __align__(16) __nv_bfloat16 s_w[MBK * W_LD];

  const int M = p.M, K = p.K, N = p.N, kchunk = p.kchunk;
  const __nv_bfloat16* __restrict__ a =
      static_cast<const __nv_bfloat16*>(p.a);
  const uint8_t* __restrict__ w = p.w;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int k_begin = split * kchunk;
  const int k_end = min(K, k_begin + kchunk);
  const int ldw = N / CPB;                  // bytes per weight row
  const bool vec_w = (ldw % 4 == 0) &&
                     ((reinterpret_cast<uintptr_t>(w) & 3) == 0);
  const bool vec_a = (K % 8 == 0) &&
                     ((reinterpret_cast<uintptr_t>(a) & 15) == 0);

  if (WM != W_LUT_COL) {
    const float* src = WM == W_GAUSS ? p.table : p.lut;
    for (int i = tid; i < NLEV; i += MMA_NT) s_table[i] = src[i];
  }

  // this thread always dequantizes the same CPG columns: keep their
  // statistics in registers
  const int gb = tid % G4;
  const int kk0 = tid / G4;
  const int bcol = n0 / CPB + gb * 4;
  float r_mu[CPG], r_sigma[CPG];
#pragma unroll
  for (int j = 0; j < CPG; ++j) {
    const int n = n0 + gb * CPG + j;
    r_mu[j] = (WM == W_GAUSS && n < N) ? p.mu[n] : 0.0f;
    r_sigma[j] = (WM == W_GAUSS && n < N) ? p.sigma[n] : 0.0f;
  }
  __syncthreads();

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.0f;

  // global -> registers: one stage's packed weight bytes and A chunks,
  // zero outside M, N and the split's K range
  auto fetch = [&](int k0, uint32_t (&wb)[PASSES], uint4 (&av)[APT]) {
#pragma unroll
    for (int pass = 0; pass < PASSES; ++pass) {
      const int k = k0 + kk0 + pass * ROWS_PER_PASS;
      uint32_t bits = 0;
      if (k < k_end) {
        const uint8_t* wp = w + (size_t)k * ldw + bcol;
        if (vec_w && bcol + 4 <= ldw) {
          bits = *reinterpret_cast<const uint32_t*>(wp);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (bcol + j < ldw) bits |= (uint32_t)wp[j] << (8 * j);
        }
      }
      wb[pass] = bits;
    }
#pragma unroll
    for (int t = 0; t < APT; ++t) {
      const int c = tid + t * MMA_NT;
      const int r = c / (MBK / 8);
      const int k = k0 + (c % (MBK / 8)) * 8;
      const int m = m0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (c < A_CHUNKS && m < M && k < k_end) {
        const __nv_bfloat16* src = a + (size_t)m * K + k;
        if (vec_a && k + 8 <= k_end) {
          v = *reinterpret_cast<const uint4*>(src);
        } else {
          __align__(16) __nv_bfloat16 tmp[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            tmp[j] = (k + j < k_end) ? src[j] : __float2bfloat16(0.0f);
          v = *reinterpret_cast<const uint4*>(tmp);
        }
      }
      av[t] = v;
    }
  };

  // registers -> shared: codes -> f32 levels -> bf16 (MBK, BN) tile, and
  // the (BM, MBK) activation tile
  auto stage = [&](int k0, const uint32_t (&wb)[PASSES],
                   const uint4 (&av)[APT]) {
#pragma unroll
    for (int pass = 0; pass < PASSES; ++pass) {
      const int kk = kk0 + pass * ROWS_PER_PASS;
      const bool in_k = k0 + kk < k_end;
      const uint32_t bits = wb[pass];
      uint32_t packed[CPG / 2];
#pragma unroll
      for (int j = 0; j < CPG; j += 2) {
        int c0, c1;
        if (BITS == 4) {
          c0 = (bits >> (4 * j)) & 0xF;
          c1 = (bits >> (4 * j + 4)) & 0xF;
        } else {
          c0 = ((bits >> (8 * j)) & 0xFF) ^ 0x80;   // stored code + 128
          c1 = ((bits >> (8 * j + 8)) & 0xFF) ^ 0x80;
        }
        // f32 level (the plain version's rounding), then rounded to bf16
        // like the plain version's weight
        const int n = n0 + gb * CPG + j;
        float l0 = level<WM>(c0, r_mu[j], r_sigma[j], s_table, p.lut, n, N);
        float l1 = level<WM>(c1, r_mu[j + 1], r_sigma[j + 1], s_table, p.lut,
                             n + 1, N);
        if (!in_k) l0 = l1 = 0.0f;
        packed[j / 2] = pack_bf16(l0, l1);
      }
      __nv_bfloat16* dst = &s_w[kk * W_LD + gb * CPG];
      if (BITS == 4) {
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
      } else {
        *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
      }
    }
#pragma unroll
    for (int t = 0; t < APT; ++t) {
      const int c = tid + t * MMA_NT;
      if (c < A_CHUNKS)
        *reinterpret_cast<uint4*>(
            &s_a[(c / (MBK / 8)) * A_LD + (c % (MBK / 8)) * 8]) = av[t];
    }
  };

  // ldmatrix lane addressing, the same for A (rows = m) and W (rows = k):
  // lanes 0-15 name rows 0-15 at column 0, lanes 16-31 the same rows at
  // column 8
  const int frag_row = lane & 15;
  const int frag_col = (lane >> 4) * 8;

  uint32_t wb_cur[PASSES], wb_next[PASSES];
  uint4 av_cur[APT], av_next[APT];
  if (k_begin < k_end) fetch(k_begin, wb_cur, av_cur);

  for (int k0 = k_begin; k0 < k_end; k0 += MBK) {
    const bool more = k0 + MBK < k_end;
    if (more) fetch(k0 + MBK, wb_next, av_next);
    stage(k0, wb_cur, av_cur);
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < MBK / 16; ++ks) {
      uint32_t bfrag[4];   // {b0, b1} of column tile 0, {b0, b1} of tile 1
      ldmatrix_x4_trans(bfrag, smem_u32(&s_w[(ks * 16 + frag_row) * W_LD +
                                             warp * 16 + frag_col]));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t afrag[4];
        ldmatrix_x4(afrag, smem_u32(&s_a[(mt * 16 + frag_row) * A_LD +
                                         ks * 16 + frag_col]));
        mma_bf16(acc[mt][0], afrag, bfrag[0], bfrag[1]);
        mma_bf16(acc[mt][1], afrag, bfrag[2], bfrag[3]);
      }
    }
    __syncthreads();

    if (more) {
#pragma unroll
      for (int i = 0; i < PASSES; ++i) wb_cur[i] = wb_next[i];
#pragma unroll
      for (int i = 0; i < APT; ++i) av_cur[i] = av_next[i];
    }
  }

  // accumulator layout: c0,c1 -> row lane/4, columns 2*(lane%4) + {0,1};
  // c2,c3 -> row lane/4 + 8
  float* dst = p.part + (size_t)split * M * N;
  const bool vec_out = (N % 2 == 0);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int n = n0 + warp * 16 + nt * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + mt * 16 + (lane >> 2) + h * 8;
        if (m >= M || n >= N) continue;
        float* o = dst + (size_t)m * N + n;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (vec_out && n + 1 < N) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          o[0] = v0;
          if (n + 1 < N) o[1] = v1;
        }
      }
    }
  }
}

template <int BITS, int MT, int WM>
void launch_mma(const Args& p, int splitk, cudaStream_t stream) {
  dim3 grid((p.N + BN - 1) / BN, (p.M + MT * 16 - 1) / (MT * 16), splitk);
  qmatmul_mma_kernel<BITS, MT, WM><<<grid, MMA_NT, 0, stream>>>(p);
}

template <int BITS, int WM>
int launch_mma_bm(int bm, const Args& p, int splitk, cudaStream_t stream) {
  switch (bm) {
    case 8:     // the narrowest tensor-core tile is 16 rows
    case 16:
      launch_mma<BITS, 1, WM>(p, splitk, stream);
      return 0;
    case 32:
      launch_mma<BITS, 2, WM>(p, splitk, stream);
      return 0;
    case 64:
      launch_mma<BITS, 4, WM>(p, splitk, stream);
      return 0;
    default:
      return -1;
  }
}

// ---------------------------------------------------------------------------
// int8 activation codes: exact tensor-core body (qmatmul_a8)
// ---------------------------------------------------------------------------

constexpr int A8_PAD = 16;   // bytes added to each staged row: the rows a
                             // warp reads together fall in distinct banks

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING));
}

// 16 bytes global -> shared, the first `nbytes` from `src` and zeros after
// them: by cp.async where both sides are 16-byte aligned (`vec`), else by
// plain byte copies (visible after the next __syncthreads, like the rest).
__device__ __forceinline__ void copy16(void* dst, const uint8_t* src,
                                       int nbytes, bool vec,
                                       const uint8_t* base) {
  if (vec) {
    cp_async16(smem_u32(dst), nbytes > 0 ? src : base, nbytes);
  } else {
    uint8_t* d = static_cast<uint8_t*>(dst);
#pragma unroll
    for (int j = 0; j < 16; ++j) d[j] = j < nbytes ? src[j] : 0;
  }
}

// Shared memory of the A8 body (dynamic: a W8 block at 64 rows exceeds
// the 48 KB of static shared memory), in bytes.
template <int BITS, int MT>
struct A8Smem {
  static constexpr int BM = MT * 16;
  static constexpr int NS = BITS == 4 ? 4 : 3;       // ring stages
  static constexpr int WROW = BN * BITS / 8;         // packed bytes per row
  static constexpr int WS = WROW + A8_PAD;           // staged row stride
  static constexpr int NLEV = 1 << BITS;
  // copies of the level table: lane j reads copy j % COPIES, so the 16
  // lanes of a half-warp's 8-byte loads meet no bank twice at W4
  static constexpr int COPIES = BITS == 4 ? 16 : 8;
  static constexpr int W = 0;                                  // weight ring
  static constexpr int A8 = W + NS * MBK * WS;                 // code ring
  static constexpr int AB = A8 + NS * BM * MBK;                // bf16 codes
  static constexpr int LUT = AB + BM * A_LD * 2;               // level parts
  static constexpr int R = LUT + NLEV * COPIES * 8;            // row sums
  static constexpr int BYTES = R + BM * 4;
};

// MT = BM / 16 row tiles per block; warp w owns columns [16w, 16w+16) as
// two 8-column mma tiles.
// Blocks per SM the registers must admit: the 16-row tile of decode shapes
// hides the latency of its stages with more blocks; wider tiles need the
// registers for their accumulators.
template <int BITS, int MT>
__global__ void __launch_bounds__(MMA_NT, MT == 1 ? 4 : 2)
    qmatmul_a8_mma_kernel(const Args p) {
  using L = A8Smem<BITS, MT>;
  constexpr int BM = L::BM, NS = L::NS, WROW = L::WROW, WS = L::WS;
  constexpr int COPIES = L::COPIES;
  constexpr int W_CHUNKS = MBK * WROW / 16;  // 16-byte chunks of a stage
  constexpr int WPT = W_CHUNKS / MMA_NT;
  constexpr int A_CHUNKS = BM * MBK / 16;    // <= MMA_NT: one per thread
  static_assert(W_CHUNKS % MMA_NT == 0, "weight chunks per thread");
  static_assert(A_CHUNKS <= MMA_NT && A_CHUNKS % 32 == 0, "code chunks");

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* s_w = smem + L::W;                  // [NS][MBK][WS] packed bytes
  int8_t* s_a8 = reinterpret_cast<int8_t*>(smem + L::A8);  // [NS][BM][MBK]
  __nv_bfloat16* s_ab =                        // [BM][A_LD] the codes, bf16
      reinterpret_cast<__nv_bfloat16*>(smem + L::AB);
  // [code][copy]: {h | d << 16, l}, the bf16 parts of the code's level
  uint2* s_lut = reinterpret_cast<uint2*>(smem + L::LUT);
  int* s_r = reinterpret_cast<int*>(smem + L::R);          // [BM] R_m

  const int M = p.M, K = p.K, N = p.N;
  const uint8_t* __restrict__ a = static_cast<const uint8_t*>(p.a);
  const uint8_t* __restrict__ w = p.w;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;     // fragment column (B) / row (C)
  const int tig = lane & 3;      // fragment k pair (B) / column pair (C)
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int k_begin = split * p.kchunk;
  const int k_end = min(K, k_begin + p.kchunk);
  const int ldw = N * BITS / 8;              // bytes per weight row
  const int wbyte0 = n0 * BITS / 8;
  const bool vec_w = (ldw % 16 == 0) &&
                     ((reinterpret_cast<uintptr_t>(w) & 15) == 0);
  const bool vec_a = (K % 16 == 0) &&
                     ((reinterpret_cast<uintptr_t>(a) & 15) == 0);

  // one stage: (MBK, 128) packed weight bytes and (BM, MBK) codes, zero
  // outside M, N and the split's K range
  auto load_stage = [&](int k0, int buf) {
#pragma unroll
    for (int t = 0; t < WPT; ++t) {
      const int c = tid + t * MMA_NT;
      const int r = c / (WROW / 16);
      const int col = (c % (WROW / 16)) * 16;
      const int k = k0 + r;
      const int gcol = wbyte0 + col;
      const int nbytes = k < k_end ? max(0, min(16, ldw - gcol)) : 0;
      copy16(&s_w[(buf * MBK + r) * WS + col], w + (size_t)k * ldw + gcol,
             nbytes, vec_w, w);
    }
    if (tid < A_CHUNKS) {
      const int r = tid / (MBK / 16);
      const int kk = (tid % (MBK / 16)) * 16;
      const int m = m0 + r;
      const int k = k0 + kk;
      const int nbytes = m < M ? max(0, min(16, k_end - k)) : 0;
      copy16(&s_a8[(buf * BM + r) * MBK + kk], a + (size_t)m * K + k, nbytes,
             vec_a, a);
    }
  };

  const int nk = (k_end - k_begin + MBK - 1) / MBK;   // <= 0: empty split
#pragma unroll
  for (int st = 0; st < NS - 1; ++st) {
    if (st < nk) load_stage(k_begin + st * MBK, st);
    cp_async_commit();
  }
  // the level table, while the first stages are in flight
  for (int i = tid; i < L::NLEV * COPIES; i += MMA_NT) {
    const int c = i / COPIES;
    s_lut[i] = make_uint2(
        (uint32_t)p.split[c] | ((uint32_t)p.split[L::NLEV + c] << 16),
        (uint32_t)p.split[2 * L::NLEV + c]);
  }

  float acc_h[MT][2][4], acc_dl[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc_h[mt][nt][j] = acc_dl[mt][nt][j] = 0.0f;
  int rpart = 0;                 // this thread's 16 codes of each stage
  const uint2* lut = s_lut + (lane % COPIES);
  const int frag_row = lane & 15;      // ldmatrix lane addressing, as in
  const int frag_col = (lane >> 4) * 8;  // the bf16 body

  for (int it = 0; it < nk; ++it) {
    cp_async_wait<NS - 2>();   // this thread's copies of stage `it` landed
    __syncthreads();           // everyone's; and stage it-1 is consumed
    if (it + NS - 1 < nk)
      load_stage(k_begin + (it + NS - 1) * MBK, (it + NS - 1) % NS);
    cp_async_commit();
    const int buf = it % NS;

    // the stage's codes to bf16 (exact), once per block; their row sums
    if (tid < A_CHUNKS) {
      const int r = tid / (MBK / 16);
      const int kk = (tid % (MBK / 16)) * 16;
      const uint4 v =
          *reinterpret_cast<const uint4*>(&s_a8[(buf * BM + r) * MBK + kk]);
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
      uint32_t packed[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        rpart = __dp4a((int)words[q], 0x01010101, rpart);
        const int c0 = (int)(int8_t)(words[q] & 0xFF);
        const int c1 = (int)(int8_t)((words[q] >> 8) & 0xFF);
        const int c2 = (int)(int8_t)((words[q] >> 16) & 0xFF);
        const int c3 = (int)(int8_t)(words[q] >> 24);
        packed[2 * q] = pack_bf16((float)c0, (float)c1);
        packed[2 * q + 1] = pack_bf16((float)c2, (float)c3);
      }
      uint4* dst = reinterpret_cast<uint4*>(&s_ab[r * A_LD + kk]);
      dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
    }
    __syncthreads();
    const uint8_t* sw = s_w + buf * MBK * WS;

#pragma unroll
    for (int ks = 0; ks < MBK / 16; ++ks) {
      // B fragments of the warp's two column tiles: b0 holds rows k, k+1
      // (k = 2 tig), b1 rows k+8, k+9, of column gid.  Each staged row's
      // bytes of the warp's 16 columns are loaded once (8 at W4, 16 at W8)
      uint32_t bh[2][2], bd[2][2], bl[2][2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int k = ks * 16 + tig * 2 + half * 8;
        int c[2][2];                         // [nt][row k, k+1]
#pragma unroll
        for (int dr = 0; dr < 2; ++dr) {
          const uint8_t* row = sw + (k + dr) * WS;
          if (BITS == 4) {
            const uint2 q = *reinterpret_cast<const uint2*>(row + warp * 8);
            c[0][dr] = (q.x >> (4 * gid)) & 15;
            c[1][dr] = (q.y >> (4 * gid)) & 15;
          } else {
            const uint4 q = *reinterpret_cast<const uint4*>(row + warp * 16);
            const int sh = 8 * (gid & 3);
            c[0][dr] = (((gid >> 2) ? q.y : q.x) >> sh & 0xFF) ^ 0x80;
            c[1][dr] = (((gid >> 2) ? q.w : q.z) >> sh & 0xFF) ^ 0x80;
          }
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const uint2 e0 = lut[c[nt][0] * COPIES];
          const uint2 e1 = lut[c[nt][1] * COPIES];
          bh[nt][half] = __byte_perm(e0.x, e1.x, 0x5410);
          bd[nt][half] = __byte_perm(e0.x, e1.x, 0x7632);
          bl[nt][half] = __byte_perm(e0.y, e1.y, 0x5410);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t af[4];
        ldmatrix_x4(af, smem_u32(&s_ab[(mt * 16 + frag_row) * A_LD +
                                       ks * 16 + frag_col]));
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma_bf16(acc_dl[mt][nt], af, bl[nt][0], bl[nt][1]);
          mma_bf16(acc_dl[mt][nt], af, bd[nt][0], bd[nt][1]);
          mma_bf16(acc_h[mt][nt], af, bh[nt][0], bh[nt][1]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // R: the four threads of a row (consecutive lanes) hold its four chunks
  if (tid < A_CHUNKS) {
    rpart += __shfl_xor_sync(0xffffffffu, rpart, 1);
    rpart += __shfl_xor_sync(0xffffffffu, rpart, 2);
    if ((tid & 3) == 0) s_r[tid >> 2] = rpart;
  }
  __syncthreads();

  // accumulator layout: c0,c1 -> row gid, columns 2 tig + {0,1}; c2,c3 ->
  // row gid + 8.  part = s_m (mu_n R_m + sigma_n D_mn)
  float* dst = p.part + (size_t)split * M * N;
  const bool vec_out = (N % 2 == 0);
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int n = n0 + warp * 16 + nt * 8 + tig * 2;
    if (n >= N) continue;
    const bool two = n + 1 < N;
    const float mu0 = p.mu[n], sg0 = p.sigma[n];
    const float mu1 = two ? p.mu[n + 1] : 0.0f;
    const float sg1 = two ? p.sigma[n + 1] : 0.0f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + gid + h * 8;
        const int m = m0 + r;
        if (m >= M) continue;
        const float sc = p.a_scale[p.scale_per_row ? m : 0];
        const float rs = (float)s_r[r];
        const float d0 = acc_h[mt][nt][2 * h] + acc_dl[mt][nt][2 * h];
        const float d1 = acc_h[mt][nt][2 * h + 1] + acc_dl[mt][nt][2 * h + 1];
        const float v0 = sc * (mu0 * rs + sg0 * d0);
        const float v1 = sc * (mu1 * rs + sg1 * d1);
        float* o = dst + (size_t)m * N + n;
        if (vec_out && two) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          o[0] = v0;
          if (two) o[1] = v1;
        }
      }
    }
  }
}

template <int BITS, int MT>
int launch_a8(const Args& p, int splitk, cudaStream_t stream) {
  constexpr int bytes = A8Smem<BITS, MT>::BYTES;
  static bool ready = false;     // the attribute is set once per kernel
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        qmatmul_a8_mma_kernel<BITS, MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  dim3 grid((p.N + BN - 1) / BN, (p.M + MT * 16 - 1) / (MT * 16), splitk);
  qmatmul_a8_mma_kernel<BITS, MT><<<grid, MMA_NT, bytes, stream>>>(p);
  return 0;
}

template <int BITS>
int launch_a8_bm(int bm, const Args& p, int splitk, cudaStream_t stream) {
  switch (bm) {
    case 8:     // the narrowest tensor-core tile is 16 rows
    case 16:
      return launch_a8<BITS, 1>(p, splitk, stream);
    case 32:
      return launch_a8<BITS, 2>(p, splitk, stream);
    case 64:
      return launch_a8<BITS, 4>(p, splitk, stream);
    default:
      return -1;
  }
}

// Second pass: add the splits in ascending order and cast to the output type.
__global__ void qmatmul_reduce_kernel(const float* __restrict__ part,
                                      void* __restrict__ out, int out_bf16,
                                      int splitk, size_t mn) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = part[i];
  for (int sp = 1; sp < splitk; ++sp) s += part[(size_t)sp * mn + i];
  if (out_bf16) {
    reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(s);
  } else {
    reinterpret_cast<float*>(out)[i] = s;
  }
}

template <int BITS, int TX, int TY, int TM, int TN, int WM>
void launch_tile(const Args& p, int splitk, cudaStream_t stream) {
  constexpr int BM = TY * TM;
  dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, splitk);
  qmatmul_kernel<BITS, TX, TY, TM, TN, WM><<<grid, TX * TY, 0, stream>>>(p);
}

template <int BITS, int WM>
int launch_bm(int bm, const Args& p, int splitk, cudaStream_t stream) {
  switch (bm) {
    case 8:
      launch_tile<BITS, 32, 8, 1, 4, WM>(p, splitk, stream);
      return 0;
    case 16:
      launch_tile<BITS, 32, 8, 2, 4, WM>(p, splitk, stream);
      return 0;
    case 32:
      launch_tile<BITS, 32, 8, 4, 4, WM>(p, splitk, stream);
      return 0;
    case 64:
      launch_tile<BITS, 16, 16, 4, 8, WM>(p, splitk, stream);
      return 0;
    default:
      return -1;
  }
}

// The tensor-core body for bf16 activations, the CUDA-core body for f32.
template <int WM>
int launch_body(int tensor_cores, int bits, int bm, const Args& p, int splitk,
                cudaStream_t stream) {
  if (tensor_cores)
    return bits == 4 ? launch_mma_bm<4, WM>(bm, p, splitk, stream)
                     : launch_mma_bm<8, WM>(bm, p, splitk, stream);
  return bits == 4 ? launch_bm<4, WM>(bm, p, splitk, stream)
                   : launch_bm<8, WM>(bm, p, splitk, stream);
}

int check_shape(int bits, int M, int K, int N, int splitk) {
  if (M <= 0 || K <= 0 || N <= 0 || splitk <= 0) return -2;
  if (bits != 4 && bits != 8) return -3;
  if (bits == 4 && (N % 2)) return -4;
  return 0;
}

Args make_args(int M, int K, int N, int splitk, float* part) {
  Args p = {};
  p.M = M;
  p.K = K;
  p.N = N;
  int kchunk = (K + splitk - 1) / splitk;
  p.kchunk = ((kchunk + MBK - 1) / MBK) * MBK;   // a multiple of both stages
  p.part = part;
  return p;
}

// Checks the body's launch, then adds the splits into `out`.
int reduce(int rc, const Args& p, void* out, int out_bf16, int splitk,
           cudaStream_t stream) {
  if (rc != 0) return rc;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t mn = (size_t)p.M * p.N;
  const int threads = 256;
  const unsigned blocks = (unsigned)((mn + threads - 1) / threads);
  qmatmul_reduce_kernel<<<blocks, threads, 0, stream>>>(p.part, out, out_bf16,
                                                        splitk, mn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point returns 0 on success, a cudaError_t value if a launch was
// refused, or a negative value for an argument the kernel does not take.

// a: (M, K) f32 (a_bf16 = 0) or bf16; Gaussian levels.
extern "C" int qmatmul_launch(const void* a, int a_bf16, const void* w,
                              int bits, const float* mu, const float* sigma,
                              const float* table, float* part, void* out,
                              int out_bf16, int M, int K, int N, int bm,
                              int splitk, void* stream_ptr) {
  const int bad = check_shape(bits, M, K, N, splitk);
  if (bad) return bad;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Args p = make_args(M, K, N, splitk, part);
  p.a = a;
  p.w = static_cast<const uint8_t*>(w);
  p.mu = mu;
  p.sigma = sigma;
  p.table = table;
  const int rc = launch_body<W_GAUSS>(a_bf16, bits, bm, p, splitk, stream);
  return reduce(rc, p, out, out_bf16, splitk, stream);
}

// a: (M, K) f32 or bf16; lut: (k,) shared by every column (lut_per_col = 0)
// or (k, N).
extern "C" int qmatmul_lut_launch(const void* a, int a_bf16, const void* w,
                                  int bits, const float* lut, int lut_per_col,
                                  float* part, void* out, int out_bf16, int M,
                                  int K, int N, int bm, int splitk,
                                  void* stream_ptr) {
  const int bad = check_shape(bits, M, K, N, splitk);
  if (bad) return bad;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Args p = make_args(M, K, N, splitk, part);
  p.a = a;
  p.w = static_cast<const uint8_t*>(w);
  p.lut = lut;
  const int rc =
      lut_per_col
          ? launch_body<W_LUT_COL>(a_bf16, bits, bm, p, splitk, stream)
          : launch_body<W_LUT_SHARED>(a_bf16, bits, bm, p, splitk, stream);
  return reduce(rc, p, out, out_bf16, splitk, stream);
}

// a_codes: (M, K) int8; scale: (M,) (scale_per_row = 1) or one f32 value;
// Gaussian levels; split: (3, 2^bits) bf16, the parts h, d, l of the level
// table (`ref.level_split`); exact products on the tensor cores.
extern "C" int qmatmul_a8_launch(const void* a_codes, const float* scale,
                                 int scale_per_row, const void* w, int bits,
                                 const float* mu, const float* sigma,
                                 const void* split, float* part, void* out,
                                 int out_bf16, int M, int K, int N, int bm,
                                 int splitk, void* stream_ptr) {
  const int bad = check_shape(bits, M, K, N, splitk);
  if (bad) return bad;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Args p = make_args(M, K, N, splitk, part);
  p.a = a_codes;
  p.a_scale = scale;
  p.scale_per_row = scale_per_row;
  p.w = static_cast<const uint8_t*>(w);
  p.mu = mu;
  p.sigma = sigma;
  p.split = static_cast<const uint16_t*>(split);
  const int rc = bits == 4 ? launch_a8_bm<4>(bm, p, splitk, stream)
                           : launch_a8_bm<8>(bm, p, splitk, stream);
  return reduce(rc, p, out, out_bf16, splitk, stream);
}
