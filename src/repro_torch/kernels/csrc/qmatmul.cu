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
// argument): the Gaussian formula mu[n] + sigma[n] * table[code]; a shared
// codebook of k levels (the engine's per-tensor `q_lut`); or a (k, N)
// per-column codebook.  Two bodies:
//   * bf16 activations (the engine's): the transposed product
//     out^T = W^T . a^T on the warpgroup tensor cores (wgmma m64nBMk16,
//     bf16 x bf16 -> f32).  Each of the block's two warpgroups owns 64
//     weight columns, the instruction's M; the instruction's N is the
//     block's BM tokens (16 at decode, up to 128 at prefill), so a weight
//     stage is decoded once per block however many tokens it serves.  What
//     the design does about the bounds:
//       - packed weight bytes and the bf16 activation tile stream through a
//         ring of NS stages in dynamic shared memory by cp.async.cg 16-byte
//         copies (5 stages up to 32 rows, 4 beyond), so later stages are in
//         flight while one is multiplied; mbarriers hand the stages over
//         (`full` when a stage's copies landed, `empty` when every warp's
//         wgmma on it is done), so the two warpgroups need not meet at a
//         block barrier every stage;
//       - the weight is the A operand, built in registers straight from the
//         staged bytes by table lookup (no weight tile in shared memory, no
//         ldmatrix, no arithmetic per weight element at W4).  The table
//         holds each level exactly as the plain version rounds it, bf16 of
//         the f32 mu + sigma * T (a separate multiply and add) or of the
//         codebook entry, so kernel and plain version multiply the same bf16
//         weight and differ only in the order of the f32 sum.  At W4 each
//         thread keeps its own 16 words {level in column gid, in column
//         gid + 8} in shared memory, one bank per lane, built while the
//         first stages load: a lookup never meets another lane's bank.  At
//         W8 (off the engine path; 256 levels would not fit per lane) the
//         level is computed per element from a shared f32 table;
//       - the activations are the B operand, read by the tensor cores from
//         the staged tile in the 128-byte swizzle (K-major: a token's 64
//         values of a stage are one 128-byte row);
//       - a prefill tile (64 rows or more) walks all of K in one block and
//         adds the splits' sums in the reduce kernel's order, so it writes
//         the result with no split-K scratch (at M = 256, N = 12800 and 8
//         splits that scratch is 105 MB written and read again) and no
//         second pass, and its bits are those of the split-K result.
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
// qmatmul_experts / qmatmul_lut_experts (the MoE expert matmuls, whose
// TPU-side counterpart is the reference's dequantize-everything einsum,
// src/repro/models/moe.py:102-105): E products of one shape in one launch.
// What bounds them is the weight bytes of the experts in use (16 tokens x
// top-8 use at most 128 of kimi_k2's 384); rows past rows[e] (on the
// device) are read as zeros and written as zeros, so the zeros a dropped
// token copy reads are exact.  Two bodies:
//   * bf16 activations at W4 (the engine's): qmatmul_experts_wg_kernel, a
//     persistent grid over the tiles of the experts in use, one producer
//     warp feeding a ring, four consumer warps on mma.sync (see there);
//   * W8 or f32 activations (off the engine path): the two bodies above
//     with the expert on the grid's z axis; a block with none of its rows
//     in use writes zeros and returns before it reads a weight byte.
//
// Determinism: a split writes its partial sums to a scratch buffer and a
// second kernel adds the splits in a fixed order (no atomics).  Every output
// element is accumulated over k in ascending order inside a split, and the
// split count depends on (K, N) only (and E for an expert call), so a row's
// result does not depend on M or on which rows share the call.
//
// Plain C interface; the caller allocates every buffer and passes the stream.

#include <cuda.h>
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
  void* out;                     // (M, N) f32 or bf16 (`out_bf16`): the
  int out_bf16;                  // result, where a block sums every split
  int M, K, N, kchunk;
  // expert calls (qmatmul_experts / qmatmul_lut_experts): E weights of
  // (K, N) one after another, E activation blocks of (M, K) and E output
  // blocks of (M, N); expert e reads only its first rows[e] rows.  Plain
  // calls: E = 1, rows = null.  `zsplit` is the grid's z extent per expert
  // (the split count, or 1 for a tile that sums its splits itself);
  // `direct`: the warpgroup body writes `out` itself (wg_writes_out).
  const int* rows;
  int E, zsplit, direct;
};

// The block's expert and split along the grid's z axis.
__device__ __forceinline__ void expert_split(const Args& p, int& e,
                                             int& split) {
  e = blockIdx.z / p.zsplit;
  split = blockIdx.z - e * p.zsplit;
}

// Rows of expert e that hold activations: rows[e] (at most M) for an
// expert call, all M otherwise.
__device__ __forceinline__ int rows_used(const Args& p, int e) {
  return p.rows ? min(p.M, max(0, __ldg(p.rows + e))) : p.M;
}

// A block none of whose rows an expert uses: zeros for its (bm, BN) tile,
// in the split's partial sums or (`to_out`) in the output, and no weight
// byte read.  A dropped token copy reads such a row and multiplies it by 0.
__device__ void zero_tile(const Args& p, int e, int split, int m0, int bm,
                          int n0, bool to_out) {
  for (int i = threadIdx.x; i < bm * BN; i += blockDim.x) {
    const int m = m0 + i / BN;
    const int n = n0 + i % BN;
    if (m >= p.M || n >= p.N) continue;
    const size_t o = ((size_t)e * p.M + m) * p.N + n;
    if (!to_out)
      p.part[(size_t)split * p.E * p.M * p.N + o] = 0.0f;
    else if (p.out_bf16)
      static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16(0.0f);
    else
      static_cast<float*>(p.out)[o] = 0.0f;
  }
}

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
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  int e, split;
  expert_split(p, e, split);
  const int Mv = rows_used(p, e);
  if (m0 >= Mv) {
    zero_tile(p, e, split, m0, BM, n0, false);
    return;
  }
  const int k_begin = split * kchunk;
  const int k_end = min(K, k_begin + kchunk);
  const int ldw = N / CPB;                  // bytes per weight row
  const uint8_t* __restrict__ w = p.w + (size_t)e * K * ldw;
  const float* __restrict__ a = static_cast<const float*>(p.a) +
                                (size_t)e * M * K;
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
      if (m < Mv && k < k_end) v = a[(size_t)m * K + k];
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

  float* dst = p.part + ((size_t)split * p.E + e) * M * N;
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
// Tensor-core helpers shared by the two tensor-core bodies
// ---------------------------------------------------------------------------

constexpr int MMA_NT = 256;   // 8 warps; warp w owns columns [16w, 16w+16)
constexpr int A_LD = MBK + 8; // padded row stride (bf16) of qmatmul_a8's code
                              // tile: rows stay 16-byte aligned for ldmatrix
constexpr int A8_PAD = 16;    // bytes added to each staged weight row: the
                              // rows a warp reads together fall in distinct
                              // banks

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

// two floats -> bf16x2, each rounded to nearest even; `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

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
// plain byte copies (which the caller's barrier or mbarrier arrival
// publishes with the copies).
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

// ---------------------------------------------------------------------------
// bf16 activations: warpgroup tensor-core body (qmatmul, qmatmul_lut)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// shared-memory writes of this thread (cp.async and plain stores) made
// visible to the tensor cores' operand reads, which go through the async
// proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keeps the compiler from moving accumulator reads across the wgmma wait
template <int NR>
__device__ __forceinline__ void fence_regs(float (&d)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a K-major bf16 operand in the 128-byte swizzle: rows of 64
// values (128 bytes), 8-row atoms of 1024 bytes one after another, the 16-
// byte chunk j of row r stored at chunk j ^ (r % 8).  A k16 step further
// along the row starts 32 bytes later.
__device__ __forceinline__ uint64_t wg_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4)
         | ((uint64_t)1 << 16)              // leading offset (unused here)
         | ((uint64_t)(1024 >> 4) << 32)    // stride: the next 8-row atom
         | ((uint64_t)1 << 62);             // 128-byte swizzle
}

// D (64, N) += A (64, 16) . B (16, N): f32 += bf16 x bf16, A from registers
// (the m16n8k16 A layout per warp, warp w of the group holding rows
// [16w, 16w+16)), B K-major from shared memory through `desc`.  D per
// thread: d[4j + {0,1}] at row gid, columns 8j + 2 tig + {0,1}; d[4j +
// {2,3}] at row gid + 8.
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Tiles of at least this many rows sum every split of K inside the block
// and write the result; narrower ones split K across blocks for the reduce
// kernel to add, or write the result too where there is one split.
constexpr int WG_IN_BLOCK_BM = 64;

// Whether the body writes the output itself, with no split-K scratch and no
// reduce pass: the warpgroup body (bf16 activations, `wg`) in a tile that
// sums its splits, or with a single split.  The one statement of the rule:
// the launch, the reduce and the caller's scratch size
// (qmatmul_scratch_splits) all read it.
constexpr bool wg_writes_out(int wg, int bm, int splitk) {
  return wg && (bm >= WG_IN_BLOCK_BM || splitk == 1);
}

// Shared memory of the warpgroup body (dynamic), in bytes.
template <int BITS, int BM>
struct WgSmem {
  static constexpr int NS = BM <= 32 ? 5 : 4;        // ring stages
  static constexpr int WROW = BN * BITS / 8;         // packed bytes per row
  static constexpr int WS = WROW + A8_PAD;           // staged row stride
  static constexpr int AST = BM * MBK * 2;           // bf16 activation stage
  static constexpr int A = 0;                        // activation ring
  static constexpr int W = A + NS * AST;             // weight ring
  // level table, 2 KB aligned: W4, per thread, 16 words {level of column
  // gid, of column gid + 8}; W8, the 256 f32 levels or codebook entries
  static constexpr int TAB = (W + NS * MBK * WS + 2047) / 2048 * 2048;
  static constexpr int TAB_BYTES = BITS == 4 ? MMA_NT * 16 * 4 : 256 * 4;
  static constexpr int BAR = TAB + TAB_BYTES;        // 2 NS mbarriers
  // a tile that sums the splits itself keeps their running sum here, a
  // word per thread and accumulator: [BM / 2][MMA_NT] f32
  static constexpr int TOT = BAR + 16 * NS;
  static constexpr int TOT_BYTES =
      BM >= WG_IN_BLOCK_BM ? BM / 2 * MMA_NT * 4 : 0;
  static constexpr int BYTES = TOT + TOT_BYTES + 2048;  // + room to align
                                                        // to 2 KB
  static_assert(AST % 1024 == 0, "activation stages hold whole atoms");
};

// The weight level of code c in column n, in f32: the plain version's
// rounding (a separate multiply and add for Gaussian levels).
template <int WM>
__device__ __forceinline__ float wlevel(const float* lut, int N, int c, int n,
                                        float mu, float sigma, float t) {
  if (WM == W_GAUSS) return __fadd_rn(mu, __fmul_rn(sigma, t));
  if (WM == W_LUT_SHARED) return t;
  return n < N ? __ldg(lut + (size_t)c * N + n) : 0.0f;
}

__device__ __forceinline__ void mbar_init(uint32_t addr, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(addr), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t addr) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(addr) : "memory");
}

// the phase cannot complete before this thread's cp.async copies landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t addr) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n"
               :: "r"(addr) : "memory");
}

// waits for the phase of parity `parity` to complete; traps (a launch
// error, not a hang) if it has not after ~2^24 polls
__device__ __forceinline__ void mbar_wait(uint32_t addr, int parity) {
  for (int n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (n > (1 << 24)) __trap();
  }
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// The transposed product out^T (N, M) = W^T (N, K) . a^T (K, M) on the
// warpgroup tensor cores.  Warpgroup g owns the block's columns [64g,
// 64g+64), the rows of its wgmma; the instruction's N is the block's BM
// tokens.  A (the weight) is built in registers from the staged bytes by
// table lookup; B (the activations) is read by the tensor cores from the
// staged (BM, 64) tile.  Every thread copies a share of each stage and
// arrives on the stage's `full` mbarrier; each warp arrives on its `empty`
// mbarrier once its wgmma on the stage is done, and the stage two behind is
// refilled when all have: the two warpgroups run up to a stage apart
// instead of meeting at a block barrier every stage.  A tile of
// WG_IN_BLOCK_BM rows or more walks all of K and adds the splits' sums in
// the reduce kernel's order (each split summed from zero, then left to
// right), so its bits equal the split-across-blocks result.
template <int BITS, int BM, int WM>
__global__ void __launch_bounds__(MMA_NT, BM <= 16 ? 4 : BM <= 32 ? 3
                                  : BM <= 64 ? 2 : 1)
    qmatmul_wg_kernel(const Args p) {
  constexpr bool IN_BLOCK = BM >= WG_IN_BLOCK_BM;
  using L = WgSmem<BITS, BM>;
  constexpr int NS = L::NS, WROW = L::WROW, WS = L::WS, AST = L::AST;
  constexpr int W_CHUNKS = MBK * WROW / 16;  // 16-byte chunks of a stage
  constexpr int WPT = W_CHUNKS / MMA_NT;
  constexpr int A_CHUNKS = BM * MBK / 8;
  constexpr int APT = (A_CHUNKS + MMA_NT - 1) / MMA_NT;
  static_assert(W_CHUNKS % MMA_NT == 0, "weight chunks per thread");
  static_assert(BM % 16 == 0 && BM <= 128, "wgmma N");

  extern __shared__ uint8_t wg_smem[];
  uint8_t* smem = wg_smem + ((2048 - (smem_u32(wg_smem) & 2047)) & 2047);
  uint8_t* s_a = smem + L::A;                  // [NS][BM][64] bf16, swizzled
  uint8_t* s_w = smem + L::W;                  // [NS][MBK][WS] packed bytes
  const uint32_t s_a_addr = smem_u32(s_a);
  const uint32_t full0 = smem_u32(smem + L::BAR);   // full[b], empty[b]:
  const uint32_t empty0 = full0 + 8 * NS;           // 8 bytes each

  const int M = p.M, K = p.K, N = p.N;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;     // A row (weight column) / D row
  const int tig = lane & 3;      // A k pair / D column (token) pair
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  int e, split;
  expert_split(p, e, split);
  const int Mv = rows_used(p, e);            // rows of a read; the rest 0
  const bool direct = p.direct;               // writes `out`, not `part`
  if (m0 >= Mv) {
    zero_tile(p, e, split, m0, BM, n0, direct);
    return;
  }
  const int k_begin = IN_BLOCK ? 0 : split * p.kchunk;
  const int k_end = IN_BLOCK ? K : min(K, k_begin + p.kchunk);
  const int ldw = N * BITS / 8;              // bytes per weight row
  const __nv_bfloat16* __restrict__ a =
      static_cast<const __nv_bfloat16*>(p.a) + (size_t)e * M * K;
  const uint8_t* __restrict__ w = p.w + (size_t)e * K * ldw;
  const int wbyte0 = n0 * BITS / 8;
  const bool vec_w = (ldw % 16 == 0) &&
                     ((reinterpret_cast<uintptr_t>(w) & 15) == 0);
  const bool vec_a = (K % 8 == 0) &&
                     ((reinterpret_cast<uintptr_t>(a) & 15) == 0);
  const uint8_t* a_bytes = reinterpret_cast<const uint8_t*>(a);
  const int col0 = n0 + warp * 16 + gid;     // this thread's two weight
  const int col1 = col0 + 8;                 // columns (A rows gid, gid+8)

  // one stage: (MBK, 128) packed weight bytes and the (BM, MBK) activation
  // tile, zero outside M, N and the split's K range; then this thread's
  // arrival on the stage's `full` barrier
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
#pragma unroll
    for (int t = 0; t < APT; ++t) {
      const int c = tid + t * MMA_NT;
      if (A_CHUNKS % MMA_NT == 0 || c < A_CHUNKS) {
        const int r = c >> 3;
        const int j = c & 7;
        const int m = m0 + r;
        const int k = k0 + 8 * j;
        const int nbytes = m < Mv ? 2 * max(0, min(8, k_end - k)) : 0;
        copy16(s_a + buf * AST + r * 128 + ((j ^ (r & 7)) << 4),
               a_bytes + ((size_t)m * K + k) * 2, nbytes, vec_a, a_bytes);
      }
    }
    mbar_arrive_cp_async(full0 + 8 * buf);   // and the plain stores, by
    mbar_arrive(full0 + 8 * buf);            // the release of the arrival
  };

  const int nk = (k_end - k_begin + MBK - 1) / MBK;   // <= 0: empty split
  if (tid == 0) {
    for (int b = 0; b < NS; ++b) {
      mbar_init(full0 + 8 * b, MMA_NT);
      mbar_init(empty0 + 8 * b, MMA_NT / 32);
    }
  }
  __syncthreads();
#pragma unroll
  for (int st = 0; st < NS - 2; ++st)
    if (st < nk) load_stage(k_begin + st * MBK, st);

  // the level table, while the first stages are in flight.  W4: each
  // thread writes, and later reads, only its own 16 words, one bank per
  // lane: word c = {bf16 level of code c in col0, in col1}.  W8: 256 f32
  // values shared by the block, the statistics in registers.
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem + L::TAB) +
                  warp * 16 * 32 + lane;
  float* s_t = reinterpret_cast<float*>(smem + L::TAB);
  float mu0 = 0.0f, sg0 = 0.0f, mu1 = 0.0f, sg1 = 0.0f;
  if (WM == W_GAUSS) {
    if (col0 < N) mu0 = p.mu[col0], sg0 = p.sigma[col0];
    if (col1 < N) mu1 = p.mu[col1], sg1 = p.sigma[col1];
  }
  if (BITS == 4) {
#pragma unroll 4
    for (int c = 0; c < 16; ++c) {
      const float t = WM == W_GAUSS ? __ldg(p.table + c)
                      : WM == W_LUT_SHARED ? __ldg(p.lut + c) : 0.0f;
      tab[c * 32] = pack_bf16(wlevel<WM>(p.lut, p.N, c, col0, mu0, sg0, t),
                              wlevel<WM>(p.lut, p.N, c, col1, mu1, sg1, t));
    }
  } else if (WM != W_LUT_COL) {
    s_t[tid] = WM == W_GAUSS ? p.table[tid] : p.lut[tid];
  }
  __syncthreads();
  // W4: the word of code c sits at tab_addr + 128 c, and tab_addr has bits
  // 7-10 clear, so one rotate and one and-or form the address
  const uint32_t tab_addr = smem_u32(tab);
  const int rot = (4 * gid - 7) & 31;        // nibble gid -> bits 7-10

  // the A fragments of one k16 step: a[0] = col0 at k 2 tig, +1; a[1] =
  // col1 at the same k; a[2], a[3] the same at k + 8.  A staged row's bytes
  // of the warp's 16 columns are loaded once (8 at W4, 16 at W8).
  auto build = [&](const uint8_t* sw, int ks, uint32_t (&af)[4]) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint8_t* row = sw + (ks * 16 + tig * 2 + half * 8) * WS;
      if (BITS == 4) {
        const uint2 q0 = *reinterpret_cast<const uint2*>(row + warp * 8);
        const uint2 q1 = *reinterpret_cast<const uint2*>(row + WS + warp * 8);
        auto look = [&](uint32_t q) {
          return lds32((__funnelshift_r(q, q, rot) & 0x780u) | tab_addr);
        };
        // col0: the low halves of rows k, k+1; col1: the high halves
        af[2 * half] = __byte_perm(look(q0.x), look(q1.x), 0x5410);
        af[2 * half + 1] = __byte_perm(look(q0.y), look(q1.y), 0x7632);
      } else {
        const uint4 q0 = *reinterpret_cast<const uint4*>(row + warp * 16);
        const uint4 q1 = *reinterpret_cast<const uint4*>(row + WS + warp * 16);
        const int sh = 8 * (gid & 3);
        const bool hi = gid >> 2;
        const int c00 = (((hi ? q0.y : q0.x) >> sh) & 0xFF) ^ 0x80;
        const int c01 = (((hi ? q1.y : q1.x) >> sh) & 0xFF) ^ 0x80;
        const int c10 = (((hi ? q0.w : q0.z) >> sh) & 0xFF) ^ 0x80;
        const int c11 = (((hi ? q1.w : q1.z) >> sh) & 0xFF) ^ 0x80;
        const bool tab_ok = WM != W_LUT_COL;
        auto lv = [&](int c, int col, float mu, float sg) {
          return wlevel<WM>(p.lut, p.N, c, col, mu, sg,
                            tab_ok ? s_t[c] : 0.0f);
        };
        af[2 * half] = pack_bf16(lv(c00, col0, mu0, sg0),
                                 lv(c01, col0, mu0, sg0));
        af[2 * half + 1] = pack_bf16(lv(c10, col1, mu1, sg1),
                                     lv(c11, col1, mu1, sg1));
      }
    }
  };

  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.0f;
  // the splits summed so far (IN_BLOCK): this thread's words, conflict-free
  float* total = reinterpret_cast<float*>(smem + L::TOT) + tid;
  bool first = true;                         // no split summed yet
  const int split_stages = p.kchunk / MBK;

  for (int it = 0; it < nk; ++it) {
    const int st = it + NS - 2;    // into the buffer of stage it - 2
    if (st < nk) {
      if (st >= NS) mbar_wait(empty0 + 8 * (st % NS), (st / NS - 1) & 1);
      load_stage(k_begin + st * MBK, st % NS);
    }
    if constexpr (IN_BLOCK) {
      if (it > 0 && it % split_stages == 0) {   // a split ends
#pragma unroll
        for (int i = 0; i < BM / 2; ++i) {
          total[i * MMA_NT] = first ? acc[i] : total[i * MMA_NT] + acc[i];
          acc[i] = 0.0f;
        }
        first = false;
      }
    }
    const int buf = it % NS;
    mbar_wait(full0 + 8 * buf, (it / NS) & 1);
    fence_proxy_async();
    const uint8_t* sw = s_w + buf * MBK * WS;
    uint32_t af[MBK / 16][4];
#pragma unroll
    for (int ks = 0; ks < MBK / 16; ++ks) build(sw, ks, af[ks]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < MBK / 16; ++ks)
      wgmma_rs(acc, af[ks], wg_desc(s_a_addr + buf * AST + ks * 32));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * buf);
  }

  // acc[4j + h] is (col0, token 8j + 2 tig + h), acc[4j + 2 + h] (col1, the
  // same token)
#pragma unroll
  for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 8 * j + 2 * tig + h;
      if (m >= M) continue;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = c ? col1 : col0;
        const int i = 4 * j + 2 * c + h;
        if (n >= N) continue;
        const size_t o = ((size_t)e * M + m) * N + n;
        if (!direct) {
          p.part[(size_t)split * p.E * M * N + o] = acc[i];
        } else {
          float v = acc[i];
          if constexpr (IN_BLOCK)
            if (!first) v = total[i * MMA_NT] + acc[i];
          if (p.out_bf16)
            static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16(v);
          else
            static_cast<float*>(p.out)[o] = v;
        }
      }
    }
  }
}

template <int BITS, int BM, int WM>
int launch_wg(const Args& p, int splitk, cudaStream_t stream) {
  constexpr int bytes = WgSmem<BITS, BM>::BYTES;
  static bool ready = false;     // the attribute is set once per kernel
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        qmatmul_wg_kernel<BITS, BM, WM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  Args q = p;
  q.zsplit = BM >= WG_IN_BLOCK_BM ? 1 : splitk;
  q.direct = wg_writes_out(1, BM, splitk);
  dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, q.zsplit * p.E);
  qmatmul_wg_kernel<BITS, BM, WM><<<grid, MMA_NT, bytes, stream>>>(q);
  return 0;
}

template <int BITS, int WM>
int launch_wg_bm(int bm, const Args& p, int splitk, cudaStream_t stream) {
  switch (bm) {
    case 8:     // the narrowest tile is 16 rows
    case 16:
      return launch_wg<BITS, 16, WM>(p, splitk, stream);
    case 32:
      return launch_wg<BITS, 32, WM>(p, splitk, stream);
    case 64:
      return launch_wg<BITS, 64, WM>(p, splitk, stream);
    case 128:
      return launch_wg<BITS, 128, WM>(p, splitk, stream);
    default:
      return -1;
  }
}

// ---------------------------------------------------------------------------
// The MoE expert matmuls with bf16 activations at W4 (qmatmul_experts /
// qmatmul_lut_experts): a persistent warp-specialised body
// ---------------------------------------------------------------------------

// Threads of the expert body: four consumer warps (32 of a tile's 128
// columns each) and one producer warp.
constexpr int XP_CONS = 128;                  // consumer threads
constexpr int XP_WARP = XP_CONS / 32;         // the producer warp's index
constexpr int XP_NT = XP_CONS + 32;

// The ring depth and the blocks an SM holds, by tile rows BM: the
// accumulators and the B fragments (BM / 2 words a thread each) set the
// registers, the stages the shared memory.  kernels/qmatmul.py
// (EXPERT_BLOCKS_PER_SM) sizes the persistent grid from the same counts;
// the launch checks that the card holds them.
constexpr int xp_blocks_per_sm(int bm) {
  return bm <= 8 ? 5 : bm <= 16 ? 4 : bm <= 32 ? 3 : 2;
}
constexpr int xp_stages(int bm) {
  return bm <= 8 ? 5 : 6;
}

// Shared memory of the expert body (dynamic), in bytes: the ring (BM x 64
// bf16 activations, each token's 128 bytes with 16-byte chunk j at j ^
// (token % 8); then 64 staged code rows of 128 columns, 64 bytes each with
// 16-byte chunk j at j ^ ((row / 2) % 4), so that the 8 rows an ldmatrix
// reads meet no bank twice: TMA's 64- and 128-byte swizzles), the
// per-thread level tables (as WgSmem's W4 table), the mbarriers, and each
// expert's rows and the list of experts in use.
template <int BM>
struct XpSmem {
  static constexpr int NS = xp_stages(BM);
  static constexpr int WS = BN / 2;                   // staged row stride
  static constexpr int AST = BM * MBK * 2;            // activation stage
  static constexpr int A = 0;
  static constexpr int W = A + NS * AST;
  static constexpr int TAB = W + NS * MBK * WS;
  static constexpr int BAR = TAB + XP_CONS * 32 * 4;  // 2 NS mbarriers
  static constexpr int LIST = BAR + 16 * NS;          // rows[E], used[E], n
  static int bytes(int E) { return LIST + 8 * E + 16; }
  static_assert(W % 16 == 0 && TAB % 16 == 0, "16-byte aligned stages");
};

struct XArgs {
  const __nv_bfloat16* a;        // (E, C, K)
  const uint8_t* w;              // (E, K, N / 2) packed W4 codes
  const float* mu;               // W_GAUSS: (N,) statistics, (16,) levels
  const float* sigma;
  const float* table;
  const float* lut;              // W_LUT_*: (16,) or (16, N) levels
  const int* rows;               // (E,) rows of each expert in use
  void* out;                     // (E, C, N) f32 or bf16 (`out_bf16`)
  int out_bf16;
  int E, C, K, N;
  int n_mb;                      // row blocks of BM per expert
  int tma;                       // the ring is filled by TMA (see below)
};

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t addr,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(addr), "r"(bytes) : "memory");
}

// one box of a 3-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(bar)
      : "memory");
}

// out[e] (C, N) = a[e] (C, K) . W[e] (K, N) for the experts in use; every
// row at or past rows[e] (every row of an idle expert) is written 0.
//
// The grid is persistent: G blocks (the card's SMs x xp_blocks_per_sm),
// fixed by the host from the tile shape and the SM count, never from
// `rows`.  Each block reads `rows` into shared memory and lists the experts
// in use in ascending order; the tiles (expert in use, row block, column
// block of 128), numbered expert-major, go to blocks round robin: tile t to
// block t mod G.  So an idle expert costs no block and no weight byte, and
// the tiles of one expert's column blocks run side by side (its activation
// rows stay in L2).  Rows at or past rows[e] are zeroed by plain stores,
// shared out over the blocks by (expert, row).
//
// Warp XP_WARP is the producer: it walks the block's tiles and their K
// stages in order and fills the ring (each stage's 64 code rows of 128
// columns and its BM x 64 activations), waiting on the stage's `empty`
// mbarrier before it refills it.  Where strides and bases are whole
// 16-byte units (every engine shape) one lane issues two TMA boxes a stage
// (3-D tensor maps over the (E, K, N/2) codes and the (E, C, K)
// activations, built on the host per call; their 64- and 128-byte
// swizzles are the layouts the consumers read) that complete on the
// stage's `full` mbarrier by transaction count; otherwise the warp's lanes
// copy 16-byte chunks by cp.async (rows past rows[e] and K zero filled)
// into the same layout.  Only TMA keeps the copies off the load/store
// pipe that the consumers' lookups saturate: with cp.async the loads alone
// took 0.392 ms and the consumers alone 0.444 ms at kimi_k2 `eg` decode,
// together 0.600 ms (PERF.md row 1c).  The ring runs across tiles: the
// next tile's first stages load while the current tile's last ones are
// multiplied and its output is stored.
//
// The four consumer warps issue no copy: each waits for a stage, reads the
// codes of its 32 columns by ldmatrix.trans (a lane gets 4 columns at two
// consecutive k, the A layout's k pair), builds its A fragments by table
// lookup (as qmatmul_wg_kernel; the levels are exactly the plain version's
// bf16 weights), reads the B fragments of the stage's activations by
// ldmatrix and multiplies by mma.sync m16n8k16 (weight columns the
// instruction's M, tokens its N), and releases the stage once its reads of
// it are done.  Not wgmma: at a decode step's 8 tokens the warpgroup
// instruction's N is 8, and four chained m64n8k16 a stage, with the next
// stage's fragments built under them, measured 0.46 of 0.85 ms at kimi_k2
// `eg` on the H100 (PERF.md row 1c).  What
// bounds the consumers now is the shared-memory pipe: one 4-byte lookup
// per weight (a wavefront per 32 weights) and the fragment loads.
// Each output element is summed over K in ascending order from zero in
// one block, whatever block takes its tile, so an expert's bits do not
// depend on the other experts of the call.
template <int BM, int WM>
__global__ void __launch_bounds__(XP_NT, xp_blocks_per_sm(BM))
    qmatmul_experts_wg_kernel(const XArgs p,
                              const __grid_constant__ CUtensorMap map_w,
                              const __grid_constant__ CUtensorMap map_a) {
  using L = XpSmem<BM>;
  constexpr int NS = L::NS, WS = L::WS, AST = L::AST;
  constexpr int WROW = BN / 2;                   // packed bytes of a row
  static_assert(BM % 8 == 0 && BM <= 64, "whole m16n8k16 token tiles");

  extern __shared__ __align__(128) uint8_t xp_smem[];
  uint8_t* smem = xp_smem;
  uint8_t* s_a = smem + L::A;
  uint8_t* s_w = smem + L::W;
  const uint32_t s_a_addr = smem_u32(s_a);
  const uint32_t full0 = smem_u32(smem + L::BAR);
  const uint32_t empty0 = full0 + 8 * NS;
  int* s_rows = reinterpret_cast<int*>(smem + L::LIST);
  int* s_used = s_rows + p.E;
  int* s_nused = s_used + p.E;

  const int E = p.E, C = p.C, K = p.K, N = p.N;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ncb = (N + BN - 1) / BN;
  const int nk = (K + MBK - 1) / MBK;
  const int ldw = N / 2;

  // the TMA swizzles address whole 512- and 1024-byte atoms: the stages
  // must start on them
  if (p.tma && (smem_u32(smem) & 1023)) __trap();
  if (tid == 0) {
    for (int b = 0; b < NS; ++b) {
      mbar_init(full0 + 8 * b, p.tma ? 1 : 32);
      mbar_init(empty0 + 8 * b, XP_CONS / 32);
    }
  }
  for (int e = tid; e < E; e += XP_NT)
    s_rows[e] = min(C, max(0, __ldg(p.rows + e)));
  __syncthreads();
  if (warp == 0) {       // the experts in use, ascending: a ballot scan
    int n = 0;
    for (int e0 = 0; e0 < E; e0 += 32) {
      const int e = e0 + lane;
      const bool in_use = e < E && s_rows[e] > 0;
      const unsigned m = __ballot_sync(0xffffffffu, in_use);
      if (in_use) s_used[n + __popc(m & ((1u << lane) - 1u))] = e;
      n += __popc(m);
    }
    if (lane == 0) *s_nused = n;
  }
  __syncthreads();
  const int n_tiles = *s_nused * p.n_mb * ncb;

  // tile t: expert s_used[t / (n_mb ncb)], row block, column block; false
  // where the row block holds no row in use (its rows are zeroed below)
  auto tile = [&](int t, int& e, int& m0, int& n0, int& mv) {
    const int per = p.n_mb * ncb;
    const int u = t / per;
    const int r = t - u * per;
    e = s_used[u];
    m0 = (r / ncb) * BM;
    n0 = (r % ncb) * BN;
    mv = s_rows[e];
    return m0 < mv;
  };

  if (warp == XP_WARP) {
    // ---- the producer ----
    const bool vec_w = (ldw % 16 == 0) &&
                       ((reinterpret_cast<uintptr_t>(p.w) & 15) == 0);
    const bool vec_a = (K % 8 == 0) &&
                       ((reinterpret_cast<uintptr_t>(p.a) & 15) == 0);
    const uint8_t* a_bytes = reinterpret_cast<const uint8_t*>(p.a);
    int q = 0;                                   // stages issued so far
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      int e, m0, n0, mv;
      if (!tile(t, e, m0, n0, mv)) continue;
      const uint8_t* w = p.w + (size_t)e * K * ldw;
      const size_t a0 = (size_t)e * C * K;
      const int wbyte0 = n0 / 2;
      for (int s = 0; s < nk; ++s, ++q) {
        const int buf = q % NS;
        if (q >= NS) mbar_wait(empty0 + 8 * buf, (q / NS - 1) & 1);
        const int k0 = s * MBK;
        if (p.tma) {
          // one box of codes (64 rows x 64 bytes, the 64-byte swizzle) and
          // one of activations (BM rows x 64 values, the 128-byte swizzle);
          // past K and C the boxes read zeros.  Rows in [rows[e], C) are
          // loaded too: a token's activations reach only its own output
          // column, which is not stored
          if (lane == 0) {
            const uint32_t bar = full0 + 8 * buf;
            mbar_arrive_expect_tx(bar, MBK * WROW + BM * MBK * 2);
            tma_load_3d(smem_u32(&s_w[buf * MBK * WS]), &map_w, wbyte0, k0,
                        e, bar);
            tma_load_3d(s_a_addr + buf * AST, &map_a, k0, m0, e, bar);
          }
          continue;
        }
#pragma unroll
        for (int i = 0; i < MBK * WROW / 16 / 32; ++i) {
          const int c = lane + 32 * i;
          const int r = c / (WROW / 16);
          const int col = (c % (WROW / 16)) * 16;
          const int k = k0 + r;
          const int gcol = wbyte0 + col;
          const int nbytes = k < K ? max(0, min(16, ldw - gcol)) : 0;
          copy16(&s_w[(buf * MBK + r) * WS + (col ^ (((r >> 1) & 3) << 4))],
                 w + (size_t)k * ldw + gcol, nbytes, vec_w, p.w);
        }
#pragma unroll
        for (int i = 0; i < (BM * 8 + 31) / 32; ++i) {
          const int c = lane + 32 * i;
          if (BM * 8 % 32 == 0 || c < BM * 8) {
            const int r = c >> 3;
            const int j = c & 7;
            const int m = m0 + r;
            const int k = k0 + 8 * j;
            const int nbytes = m < mv ? 2 * max(0, min(8, K - k)) : 0;
            copy16(s_a + buf * AST + r * 128 + ((j ^ (r & 7)) << 4),
                   a_bytes + (a0 + (size_t)m * K + k) * 2, nbytes, vec_a,
                   a_bytes);
          }
        }
        mbar_arrive_cp_async(full0 + 8 * buf);   // and the plain stores, by
        mbar_arrive(full0 + 8 * buf);            // the release of the arrival
      }
    }
    return;
  }

  // ---- the consumers ----
  // rows at or past rows[e], every expert's: zeros, a row a unit, the units
  // shared out over the blocks (while the producer fills the ring)
  {
    const size_t esz = p.out_bf16 ? 2 : 4;
    const bool vec_o = (N * esz) % 16 == 0 &&
                       (reinterpret_cast<uintptr_t>(p.out) & 15) == 0;
    for (int u = blockIdx.x; u < E * C; u += gridDim.x) {
      const int e = u / C;
      const int m = u - e * C;
      if (m < s_rows[e]) continue;
      uint8_t* row = static_cast<uint8_t*>(p.out) + (size_t)u * N * esz;
      if (vec_o) {
        for (int i = tid; i < (int)(N * esz / 16); i += XP_CONS)
          reinterpret_cast<uint4*>(row)[i] = make_uint4(0, 0, 0, 0);
      } else if (p.out_bf16) {
        for (int i = tid; i < N; i += XP_CONS)
          reinterpret_cast<__nv_bfloat16*>(row)[i] = __float2bfloat16(0.0f);
      } else {
        for (int i = tid; i < N; i += XP_CONS)
          reinterpret_cast<float*>(row)[i] = 0.0f;
      }
    }
  }

  const int gid = lane >> 2;
  const int tig = lane & 3;
  // this thread's level tables, one bank per lane: word (j, c) = {bf16
  // level of code c in column 4 gid + 2j of the warp's 32, in column
  // 4 gid + 2j + 1}, at tab[(16 j + c) * 32]
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem + L::TAB) +
                  warp * 32 * 32 + lane;
  const uint8_t* tab_bytes = reinterpret_cast<const uint8_t*>(tab);
  // the word of pair j for nibble n of a code register (see below)
  auto look = [&](int j, uint32_t w, int n) {
    return *reinterpret_cast<const uint32_t*>(
        tab_bytes + j * 2048 + (((w >> (4 * n)) & 0xFu) << 7));
  };
  // The codes of k rows [32 ks2, 32 ks2 + 32) of this warp's 16 bytes (32
  // columns) of the stage in `sw`, by one ldmatrix.x4.trans: lane l gives
  // row 32 ks2 + l, and register i of lane (gid, tig) holds 2 bytes (the 4
  // codes of columns 4 gid .. 4 gid + 3, low nibble first) of row 32 ks2 +
  // 8 i + 2 tig in its low half and of the next row in its high half.
  // Those are the k pairs of the m16n8k16 A layout: the fragments of k16
  // step 2 ks2 + kk for the warp's m16 tile j (A rows gid and gid + 8 are
  // columns 4 gid + 2j and 4 gid + 2j + 1) come from registers 2 kk (k
  // 2 tig, 2 tig + 1) and 2 kk + 1 (k 2 tig + 8, 2 tig + 9), nibbles 2j,
  // 2j + 4 and 2j + 1, 2j + 5.
  const int wchunk = (warp ^ ((lane >> 1) & 3)) << 4;   // see XpSmem
  auto load_codes = [&](const uint8_t* sw, int ks2, uint32_t (&cw)[4]) {
    ldmatrix_x4_trans(cw, smem_u32(sw + (32 * ks2 + lane) * WS + wchunk));
  };
  auto build = [&](const uint32_t (&cw)[4], uint32_t (&af)[2][2][4]) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t w = cw[2 * kk + h];
          af[kk][j][2 * h] = __byte_perm(look(j, w, 2 * j),
                                         look(j, w, 2 * j + 4), 0x5410);
          af[kk][j][2 * h + 1] = __byte_perm(look(j, w, 2 * j + 1),
                                             look(j, w, 2 * j + 5), 0x7632);
        }
  };
  // the B fragments of k16 steps 2 ks2 and 2 ks2 + 1 for tokens [8 nt,
  // 8 nt + 8) of the activation stage at `sa`: one ldmatrix.x4, matrix i
  // the 8 values k0 + 8 i of the 8 tokens (each a row of the 128-byte
  // swizzled tile)
  const int lrow = lane & 7;
  const int lmat = lane >> 3;
  auto load_b = [&](uint32_t sa, int ks2, int nt, uint32_t (&b)[4]) {
    const int r = 8 * nt + lrow;
    ldmatrix_x4(b, sa + r * 128 + (((4 * ks2 + lmat) ^ lrow) << 4));
  };

  float acc[2][BM / 8][4];
  int q = 0;                                     // stages consumed so far
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    int e, m0, n0, mv;
    if (!tile(t, e, m0, n0, mv)) continue;
    const int colw = n0 + 32 * warp + 4 * gid;   // this thread's 4 columns
#pragma unroll
    for (int j = 0; j < 2; ++j) {   // its level tables for the tile
      const int ca = colw + 2 * j, cb = ca + 1;
      float mua = 0.0f, sga = 0.0f, mub = 0.0f, sgb = 0.0f;
      if (WM == W_GAUSS) {
        if (ca < N) mua = __ldg(p.mu + ca), sga = __ldg(p.sigma + ca);
        if (cb < N) mub = __ldg(p.mu + cb), sgb = __ldg(p.sigma + cb);
      }
#pragma unroll 4
      for (int c = 0; c < 16; ++c) {
        const float tv = WM == W_GAUSS ? __ldg(p.table + c)
                         : WM == W_LUT_SHARED ? __ldg(p.lut + c) : 0.0f;
        tab[(16 * j + c) * 32] =
            pack_bf16(wlevel<WM>(p.lut, N, c, ca, mua, sga, tv),
                      wlevel<WM>(p.lut, N, c, cb, mub, sgb, tv));
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < BM / 8; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][i][r] = 0.0f;

    for (int s = 0; s < nk; ++s, ++q) {
      const int buf = q % NS;
      mbar_wait(full0 + 8 * buf, (q / NS) & 1);
      const uint8_t* sw = s_w + buf * MBK * WS;
      const uint32_t sa = s_a_addr + buf * AST;
      // every shared-memory matrix load of the stage first, so their
      // latencies overlap; then each half's lookups and products (the
      // lookups are plain loads, free to move ahead of the products)
      uint32_t cw[MBK / 32][4], b[MBK / 32][BM / 8][4];
#pragma unroll
      for (int ks2 = 0; ks2 < MBK / 32; ++ks2) {
        load_codes(sw, ks2, cw[ks2]);
#pragma unroll
        for (int nt = 0; nt < BM / 8; ++nt) load_b(sa, ks2, nt, b[ks2][nt]);
      }
#pragma unroll
      for (int ks2 = 0; ks2 < MBK / 32; ++ks2) {
        uint32_t af[2][2][4];
        build(cw[ks2], af);
#pragma unroll
        for (int nt = 0; nt < BM / 8; ++nt)
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              mma_bf16(acc[j][nt], af[kk][j], b[ks2][nt][2 * kk],
                       b[ks2][nt][2 * kk + 1]);
      }
      __syncwarp();             // this warp's reads of the stage are done
      if (lane == 0) mbar_arrive(empty0 + 8 * buf);
    }

    // acc[j][nt][2c + h] is (column colw + 2j + c, token 8 nt + 2 tig + h):
    // the two columns of a pair are one 4-byte (bf16) or 8-byte (f32)
    // store; rows at or past rows[e] were zeroed above
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 8 * nt + 2 * tig + h;
        if (m >= mv) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = colw + 2 * j;
          if (n >= N) continue;
          const float v0 = acc[j][nt][h], v1 = acc[j][nt][2 + h];
          const size_t o = ((size_t)e * C + m) * N + n;
          if (p.out_bf16)
            *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(p.out) +
                                         o) = pack_bf16(v0, v1);
          else
            *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) =
                make_float2(v0, v1);
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// A 3-D tensor map (dims innermost first, strides in bytes of dims 1 and
// 2) with the box {box0, box1, 1} and the given swizzle; 0 on success.
int encode_3d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
              cuuint64_t d0, cuuint64_t d1, cuuint64_t d2, cuuint64_t s1,
              cuuint64_t s2, cuuint32_t box0, cuuint32_t box1,
              CUtensorMapSwizzle swizzle) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess || !fn)
      return -9;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {s1, s2};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, type, 3, const_cast<void*>(base), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -10;
}

template <int BM, int WM>
int launch_xp(const XArgs& p, int grid, cudaStream_t stream) {
  const int bytes = XpSmem<BM>::bytes(p.E);
  static int set_bytes = 0;      // the attribute, raised as E needs
  if (bytes > set_bytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        qmatmul_experts_wg_kernel<BM, WM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    set_bytes = bytes;
  }
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, qmatmul_experts_wg_kernel<BM, WM>, XP_NT, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < xp_blocks_per_sm(BM)) return -8;  // the grid would not fit
  CUtensorMap map_w = {}, map_a = {};    // unread without TMA
  if (p.tma) {
    const cuuint64_t ldw = p.N / 2;
    int rc = encode_3d(&map_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.w, ldw, p.K,
                       p.E, ldw, ldw * p.K, BN / 2, MBK,
                       CU_TENSOR_MAP_SWIZZLE_64B);
    if (!rc)
      rc = encode_3d(&map_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.a, p.K, p.C,
                     p.E, (cuuint64_t)p.K * 2, (cuuint64_t)p.K * p.C * 2, MBK,
                     BM, CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc) return rc;
  }
  qmatmul_experts_wg_kernel<BM, WM><<<grid, XP_NT, bytes, stream>>>(
      p, map_w, map_a);
  return static_cast<int>(cudaGetLastError());
}

template <int WM>
int launch_xp_bm(int bm, const XArgs& p, int grid, cudaStream_t stream) {
  switch (bm) {
    case 8: return launch_xp<8, WM>(p, grid, stream);
    case 16: return launch_xp<16, WM>(p, grid, stream);
    case 32: return launch_xp<32, WM>(p, grid, stream);
    case 64: return launch_xp<64, WM>(p, grid, stream);
    default: return -1;
  }
}

// ---------------------------------------------------------------------------
// int8 activation codes: exact tensor-core body (qmatmul_a8)
// ---------------------------------------------------------------------------

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
  // ldmatrix lane addressing: lanes 0-15 name rows 0-15 at column 0,
  // lanes 16-31 the same rows at column 8
  const int frag_row = lane & 15;
  const int frag_col = (lane >> 4) * 8;

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
  Args q = p;
  q.zsplit = splitk;
  dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, splitk * p.E);
  qmatmul_kernel<BITS, TX, TY, TM, TN, WM><<<grid, TX * TY, 0, stream>>>(q);
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
    case 128:   // the widest CUDA-core tile is 64 rows
      launch_tile<BITS, 16, 16, 4, 8, WM>(p, splitk, stream);
      return 0;
    default:
      return -1;
  }
}

// The warpgroup body for bf16 activations, the CUDA-core body for f32.
template <int WM>
int launch_body(int tensor_cores, int bits, int bm, const Args& p, int splitk,
                cudaStream_t stream) {
  if (tensor_cores)
    return bits == 4 ? launch_wg_bm<4, WM>(bm, p, splitk, stream)
                     : launch_wg_bm<8, WM>(bm, p, splitk, stream);
  return bits == 4 ? launch_bm<4, WM>(bm, p, splitk, stream)
                   : launch_bm<8, WM>(bm, p, splitk, stream);
}

int check_shape(int bits, int M, int K, int N, int splitk) {
  if (M <= 0 || K <= 0 || N <= 0 || splitk <= 0) return -2;
  if (bits != 4 && bits != 8) return -3;
  if (bits == 4 && (N % 2)) return -4;
  return 0;
}

Args make_args(int M, int K, int N, int splitk, float* part, void* out,
               int out_bf16) {
  Args p = {};
  p.M = M;
  p.K = K;
  p.N = N;
  int kchunk = (K + splitk - 1) / splitk;
  p.kchunk = ((kchunk + MBK - 1) / MBK) * MBK;   // a multiple of both stages
  p.part = part;
  p.out = out;
  p.out_bf16 = out_bf16;
  p.E = 1;
  p.zsplit = splitk;
  return p;
}

// Checks the body's launch, then adds the splits into `out` unless the
// body wrote it (`written`).
int reduce(int rc, const Args& p, int splitk, bool written,
           cudaStream_t stream) {
  if (rc != 0) return rc;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || written) return static_cast<int>(err);
  const size_t mn = (size_t)p.E * p.M * p.N;
  const int threads = 256;
  const unsigned blocks = (unsigned)((mn + threads - 1) / threads);
  qmatmul_reduce_kernel<<<blocks, threads, 0, stream>>>(
      p.part, p.out, p.out_bf16, splitk, mn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point returns 0 on success, a cudaError_t value if a launch was
// refused, or a negative value for an argument the kernel does not take.

// The split-K scratch a call needs, in (M, N) f32 blocks per expert: none
// where the body writes the output itself, else one per split.  `wg`: the
// warpgroup body runs (bf16 activations, not qmatmul_a8).
extern "C" int qmatmul_scratch_splits(int wg, int bm, int splitk) {
  return wg_writes_out(wg, bm, splitk) ? 0 : splitk;
}

// E matmuls of one shape in one launch (E = 1: a plain call), expert e on
// the grid's z axis after its splits.  a: (E, M, K) f32 (a_bf16 = 0) or
// bf16; w: (E, K, N/2) uint8 or (E, K, N) int8, one after another; out:
// (E, M, N).  rows: null (every row used) or (E,) int32 on the device, the
// rows of expert e's block that hold activations: rows at or past rows[e]
// are read as zeros, and a block with none of its rows in use writes zeros
// and reads no weight byte.  The statistics (Gaussian levels) or the
// codebook are shared by the E experts.
extern "C" int qmatmul_launch(const void* a, int a_bf16, const void* w,
                              int bits, const float* mu, const float* sigma,
                              const float* table, const int* rows, int E,
                              float* part, void* out, int out_bf16, int M,
                              int K, int N, int bm, int splitk,
                              void* stream_ptr) {
  const int bad = E <= 0 ? -5 : check_shape(bits, M, K, N, splitk);
  if (bad) return bad;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Args p = make_args(M, K, N, splitk, part, out, out_bf16);
  p.a = a;
  p.w = static_cast<const uint8_t*>(w);
  p.mu = mu;
  p.sigma = sigma;
  p.table = table;
  p.rows = rows;
  p.E = E;
  const int rc = launch_body<W_GAUSS>(a_bf16, bits, bm, p, splitk, stream);
  return reduce(rc, p, splitk, wg_writes_out(a_bf16, bm, splitk), stream);
}

// The expert body with bf16 activations at W4 (qmatmul_experts_wg_kernel):
// a (E, C, K) bf16; w (E, K, N/2) packed codes; levels by `wm` (0: mu,
// sigma, table; 1: lut (16,) shared by every column; 2: lut (16, N)); rows
// (E,) int32 on the device; out (E, C, N) f32 or bf16, every element
// written.  bm: the tile rows (8, 16, 32 or 64); grid: the persistent
// grid, the card's SMs times xp_blocks_per_sm(bm) (-8 where the card does
// not hold that many blocks an SM).
extern "C" int qmatmul_experts_launch(const void* a, const void* w, int wm,
                                      const float* mu, const float* sigma,
                                      const float* table, const float* lut,
                                      const int* rows, int E, void* out,
                                      int out_bf16, int C, int K, int N,
                                      int bm, int grid, void* stream_ptr) {
  if (E <= 0 || C <= 0 || K <= 0 || N <= 0 || grid <= 0) return -2;
  if (N % 2) return -4;
  if (wm < W_GAUSS || wm > W_LUT_COL) return -5;
  XArgs p = {};
  p.a = static_cast<const __nv_bfloat16*>(a);
  p.w = static_cast<const uint8_t*>(w);
  p.mu = mu;
  p.sigma = sigma;
  p.table = table;
  p.lut = lut;
  p.rows = rows;
  p.out = out;
  p.out_bf16 = out_bf16;
  p.E = E;
  p.C = C;
  p.K = K;
  p.N = N;
  p.n_mb = (C + bm - 1) / bm;
  // TMA where its strides and base addresses are whole 16-byte units, the
  // producer's cp.async copies otherwise (both fill the same layout)
  p.tma = (N / 2) % 16 == 0 && K % 8 == 0 &&
          (reinterpret_cast<uintptr_t>(w) & 15) == 0 &&
          (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (wm == W_GAUSS) return launch_xp_bm<W_GAUSS>(bm, p, grid, stream);
  if (wm == W_LUT_SHARED)
    return launch_xp_bm<W_LUT_SHARED>(bm, p, grid, stream);
  return launch_xp_bm<W_LUT_COL>(bm, p, grid, stream);
}

// As qmatmul_launch with codebook levels: lut (k,) shared by every column
// (lut_per_col = 0) or (k, N).
extern "C" int qmatmul_lut_launch(const void* a, int a_bf16, const void* w,
                                  int bits, const float* lut, int lut_per_col,
                                  const int* rows, int E, float* part,
                                  void* out, int out_bf16, int M, int K,
                                  int N, int bm, int splitk,
                                  void* stream_ptr) {
  const int bad = E <= 0 ? -5 : check_shape(bits, M, K, N, splitk);
  if (bad) return bad;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Args p = make_args(M, K, N, splitk, part, out, out_bf16);
  p.a = a;
  p.w = static_cast<const uint8_t*>(w);
  p.lut = lut;
  p.rows = rows;
  p.E = E;
  const int rc =
      lut_per_col
          ? launch_body<W_LUT_COL>(a_bf16, bits, bm, p, splitk, stream)
          : launch_body<W_LUT_SHARED>(a_bf16, bits, bm, p, splitk, stream);
  return reduce(rc, p, splitk, wg_writes_out(a_bf16, bm, splitk), stream);
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
  Args p = make_args(M, K, N, splitk, part, out, out_bf16);
  p.a = a_codes;
  p.a_scale = scale;
  p.scale_per_row = scale_per_row;
  p.w = static_cast<const uint8_t*>(w);
  p.mu = mu;
  p.sigma = sigma;
  p.split = static_cast<const uint16_t*>(split);
  const int rc = bits == 4 ? launch_a8_bm<4>(bm, p, splitk, stream)
                           : launch_a8_bm<8>(bm, p, splitk, stream);
  return reduce(rc, p, splitk, false, stream);
}
