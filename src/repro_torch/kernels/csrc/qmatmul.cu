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
// The level of a code (`WM`, a template argument): the Gaussian formula from
// a shared-memory table and per-column statistics; a shared codebook of k
// levels copied to shared memory (the engine's per-tensor `q_lut`); or a
// (k, N) per-column codebook read through the read-only cache (a 128-column
// tile of it is 128 KB at k = 256, more than a block's static shared
// memory, and the TPU kernel's k select passes are a TPU workaround for slow
// gathers).  The activations (`AM`): f32 or bf16 values, or int8 codes
// times a scale, formed in f32 as `(float)code * scale[m]` -- the
// reference engine's own product (`lm.mm_a`) -- as the tile is staged.
//
// What bounds it: at decode shapes (M <= 32) the coded weight bytes; at
// prefill shapes the multiply-adds.  What the design does about it: weights
// are read once per M tile as packed bytes (4 bytes per thread along N, the
// stored direction) and dequantized through a shared-memory level table into
// a shared tile; a block owns a (BM, 128) output tile and loops over its K
// range; K is split across blocks so that narrow outputs still fill the
// card.  Two bodies share that frame:
//   * bf16 activations: the tile is rounded to bf16 (as the TPU kernel
//     rounds its scratch tile to the activations' dtype) and multiplied on
//     the tensor cores, mma.sync m16n8k16 bf16 x bf16 -> f32, fragments
//     fetched with ldmatrix (transposed for the weights, whose stored
//     direction N is not the direction a fragment packs);
//   * f32 activations, and int8 activation codes (the reference's engine
//     multiplies f32 `code * scale` by f32 levels; the TPU kernel's bf16
//     rounding of both is not followed): f32 levels, f32 FMAs on the CUDA
//     cores.
// wgmma, TMA and a multi-stage pipeline are left to a later change; so is
// a tensor-core A8 body (the codes are exact in bf16, the f32 levels are
// not: it would need a split-bf16 weight).
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
// what the activations are
constexpr int A_FLOAT = 0;       // f32 (CUDA-core body) or bf16 (tensor cores)
constexpr int A_I8 = 1;          // int8 codes times scale[m] (CUDA cores)

struct Args {
  const void* a;
  const float* a_scale;          // A_I8: (M,) per row, or one value
  int scale_per_row;
  const uint8_t* w;
  const float* mu;               // W_GAUSS: (N,) statistics, (k,) levels
  const float* sigma;
  const float* table;
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
// f32 activations: CUDA-core body
// ---------------------------------------------------------------------------

// TX threads along N each own TN columns as TN/4 float4 chunks (chunk c of
// thread tx starts at column c*TX*4 + tx*4, so a warp's float4 reads are
// contiguous); TY threads along M each own TM rows.  TX * TN == BN.
template <int BITS, int TX, int TY, int TM, int TN, int AM, int WM>
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
      if (m < M && k < k_end) {
        if (AM == A_I8) {
          const float sc = p.a_scale[p.scale_per_row ? m : 0];
          v = __fmul_rn(
              (float)static_cast<const int8_t*>(p.a)[(size_t)m * K + k], sc);
        } else {
          v = static_cast<const float*>(p.a)[(size_t)m * K + k];
        }
      }
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
// bf16 activations: tensor-core body
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

template <int BITS, int TX, int TY, int TM, int TN, int AM, int WM>
void launch_tile(const Args& p, int splitk, cudaStream_t stream) {
  constexpr int BM = TY * TM;
  dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, splitk);
  qmatmul_kernel<BITS, TX, TY, TM, TN, AM, WM><<<grid, TX * TY, 0, stream>>>(
      p);
}

template <int BITS, int AM, int WM>
int launch_bm(int bm, const Args& p, int splitk, cudaStream_t stream) {
  switch (bm) {
    case 8:
      launch_tile<BITS, 32, 8, 1, 4, AM, WM>(p, splitk, stream);
      return 0;
    case 16:
      launch_tile<BITS, 32, 8, 2, 4, AM, WM>(p, splitk, stream);
      return 0;
    case 32:
      launch_tile<BITS, 32, 8, 4, 4, AM, WM>(p, splitk, stream);
      return 0;
    case 64:
      launch_tile<BITS, 16, 16, 4, 8, AM, WM>(p, splitk, stream);
      return 0;
    default:
      return -1;
  }
}

// The tensor-core body for bf16 activations, the CUDA-core body otherwise.
template <int AM, int WM>
int launch_body(int tensor_cores, int bits, int bm, const Args& p, int splitk,
                cudaStream_t stream) {
  if (tensor_cores) {
    if (AM != A_FLOAT) return -6;
    return bits == 4 ? launch_mma_bm<4, WM>(bm, p, splitk, stream)
                     : launch_mma_bm<8, WM>(bm, p, splitk, stream);
  }
  return bits == 4 ? launch_bm<4, AM, WM>(bm, p, splitk, stream)
                   : launch_bm<8, AM, WM>(bm, p, splitk, stream);
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
  const int rc = launch_body<A_FLOAT, W_GAUSS>(a_bf16, bits, bm, p, splitk,
                                               stream);
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
          ? launch_body<A_FLOAT, W_LUT_COL>(a_bf16, bits, bm, p, splitk,
                                            stream)
          : launch_body<A_FLOAT, W_LUT_SHARED>(a_bf16, bits, bm, p, splitk,
                                               stream);
  return reduce(rc, p, out, out_bf16, splitk, stream);
}

// a_codes: (M, K) int8; scale: (M,) (scale_per_row = 1) or one f32 value;
// Gaussian levels; f32 products on the CUDA cores.
extern "C" int qmatmul_a8_launch(const void* a_codes, const float* scale,
                                 int scale_per_row, const void* w, int bits,
                                 const float* mu, const float* sigma,
                                 const float* table, float* part, void* out,
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
  p.table = table;
  const int rc = launch_body<A_I8, W_GAUSS>(0, bits, bm, p, splitk, stream);
  return reduce(rc, p, out, out_bf16, splitk, stream);
}
