// Deterministic k-quantile codec (quantize and dequantize), for sm_90a.
//
// Quantize, per element of w (G, R, C) with its statistics:
//   z = (w - mu) / sigma,   u = clip(Phi(z), eps, 1 - eps)
//   code = clip(floor(u k), 0, k - 1) - (128 if k == 256 else 0)   -> int8
//   (or, for k <= 16 on request, two codes a byte, low nibble first)
// Dequantize, per code c (int8, or two 4-bit codes per uint8 byte, low
// nibble first):
//   w = mu + sigma * table[c + (128 if k == 256 else 0)]         -> f32/bf16
//
// Replaces the TPU kernels `kquantile_quantize` and `kquantile_dequantize`
// of src/repro/kernels/kquantile.py (`_quant_kernel`, `_dequant_kernel`).
// Statistics are (G, 1, C) (per column) or (G, 1, 1) (per group), f32;
// `table` holds the k standardized levels Phi^-1((c + 1/2) / k), built once
// by the caller, so no erfinv runs here (the TPU kernel evaluates erf_inv per
// element because a TPU gather is slow; a shared-memory gather is not).
//
// What bounds it: bytes for dequantize, which reads 1 B (or half a byte)
// and writes 2 or 4 B an element; quantize (4 B read, 1 B or half a byte
// written) sits near the card's issue rate as well, since its correctly
// rounded division and erff are ~60 instructions an element.  A first,
// flat body walked every element with 64-bit index arithmetic (two 64-bit
// divisions a run of four, 64-bit steps, two statistics loads an element)
// and was issue-bound on it at 2.6-2.8x the byte bound.  What the design
// does about it: the index arithmetic leaves the per-element path.
//  * Per-column statistics (weights, embedding rows): a block is a tile of
//    TX chunks of VEC columns by a strip of rows; its (column tile, row
//    strip, group) comes from blockIdx once.  A thread loads its columns'
//    mu and sigma once, into registers, and walks down its rows with
//    32-bit offsets from the 64-bit group base.
//  * Per-group statistics (KV rows (rows * KV, 1, hd), per-tensor weights):
//    the tensor is one flat range of chunks (R * C a multiple of VEC, so no
//    chunk straddles a group); a chunk's group is one 32-bit division by a
//    constant, done as a multiply-high (`FastDiv`), and its two statistics
//    one cached load each.
//  * The prefill pool read (`dequant_paged_kernel`): the same walk over one
//    page of the pool, its id read from the block table once per block, so
//    the gather of codes and statistics is the kernel's own load.
// Every thread walks its chunks with ITER 16-byte loads in flight (`walk`),
// the first ones issued before the block's set-up (staging the level
// table, the barrier), and keeps a chunk as its raw words until it is used.
// A launch sizes the walks (1 to MAX_CHUNKS chunks) from the kernel's
// occupancy so that its last wave of blocks is at least 7/8 full.
// A chunk is 16 bytes of the wider side: 4 f32 or 8 bf16 values to
// quantize, 16 codes to dequantize (16 bytes of int8, 8 of nibbles).  Shapes
// whose rows (or groups) are not whole chunks, and pointers off a 16-byte
// boundary, take the scalar variant of the same bodies (a chunk of one
// element, two when packed); which one is a fixed rule on the shape, the
// dtypes and the pointers' alignment (kernels/kquantile.py: codec_route).
// A group of 2^31 elements or more is refused (the 32-bit offsets).
//
// Bit-exactness: every step is one correctly rounded f32 operation
// (__fdiv_rn / __fmul_rn / __fadd_rn / __fsub_rn, which nvcc does not
// contract into FMAs) in the order of the plain versions
// (ref.kquantile_codes_ref, ref.kquantile_dequant_ref), z / sqrt2 taken as
// z * (1 / sqrt2) on both sides, so codes equal the plain version's wherever
// erff equals torch's erf on the card (it is the same CUDA function), and
// dequantized values equal it always.
//
// The fused KV append (`kv_append_launch`) codes the fresh K and V rows of
// one layer and writes codes and statistics into the paged pool in one
// launch.  The reference codes these rows with jnp inside its jitted step
// (src/repro/models/lm.py: `kvq.quantize_kv`, then `.at[pages, rows].set`
// into six pool leaves), which XLA fuses; as eager ops around the quantize
// kernel above it was a chain of ~16 launches per layer and call (stack,
// casts, mean, deviation, clamp, the kernel, int4 packing, six index
// writes).  Per (row, head, K or V), with x the hd values in f32:
//   mu = bf16(mean(x)),  sigma = bf16(max(sqrt(mean((x - mean)^2)), 1e-8))
//   code = quant_elem(x, mu, sigma)  -> int8 (kv8) or nibbles (kv4)
// What bounds it: nothing of the card at the engine's shapes -- 100 KB
// moved at decode (16 rows, 8 heads, hd 128, bf16), 0.03 us of bytes; one
// launch is ~3 us -- but the host.  What the design does about it: one
// launch, no allocation, no host sync.  A group of lanes (a power of two,
// at most 32) holds one (row, head, K or V): the row is hd / VPL chunks of
// VPL values (VPL 2, 4 or 8, by the fixed rule of
// kernels/kquantile.py:append_layout on any even hd up to 256; VPL 1 for an
// odd hd, which kv8 takes and kv4, two codes a byte, does not), a lane
// loads its chunks with one wide load each (one load an element where rows
// are not whole 16-byte units), lanes past the last chunk add 0.  The group
// reduces the mean and the deviation in f32 by shuffles, rounds both to
// bf16 and codes against the rounded values (so codes and stored
// statistics agree, as in quantize_kv), packs each chunk's codes (kv4: low
// nibble first, as core/packing.py) and stores them, one store a chunk
// where code rows are whole 16-byte units, a byte at a time otherwise; the
// group's first lane stores the two statistics.  The statistics are reduced in another order than torch.mean
// / torch.std, so a bf16 statistic can land one ulp from the plain
// version's in rare rows; the codes of a row whose statistics agree are
// those of the plain version (quant_elem above).  A destination outside the
// pool traps (a launch error at the next sync), as an index write would.
//
// Plain C interface; the caller allocates every buffer and passes the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float EPS = 1e-6f;
constexpr float ONE_MINUS_EPS = 0.999999f;
constexpr float RSQRT2 = 0.7071067811865476f;
constexpr int THREADS = 256;
constexpr int MAX_K = 256;
// chunk loads a thread keeps in flight: quantize (f32 or bf16 in) and
// dequantize (16 codes, 32-64 bytes out a chunk); the most chunks a thread
// walks
constexpr int Q_ITER = 4;
constexpr int D_ITER = 4;
constexpr int MAX_CHUNKS = 32;

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float bf16_bits_to_f(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ uint32_t f_to_bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// four consecutive elements, 16-byte (f32) or 8-byte (bf16) aligned
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  o[0] = bf16_bits_to_f(v.x & 0xFFFFu);
  o[1] = bf16_bits_to_f(v.x >> 16);
  o[2] = bf16_bits_to_f(v.y & 0xFFFFu);
  o[3] = bf16_bits_to_f(v.y >> 16);
}

__device__ __forceinline__ int quant_elem(float w, float mu, float sigma,
                                          float kf, float kmax, int offset) {
  const float z = __fdiv_rn(__fsub_rn(w, mu), sigma);
  const float u = clampf(
      __fmul_rn(0.5f, __fadd_rn(1.0f, erff(__fmul_rn(z, RSQRT2)))), EPS,
      ONE_MINUS_EPS);
  return (int)clampf(floorf(__fmul_rn(u, kf)), 0.0f, kmax) - offset;
}

// ---- the codec's tiled bodies -------------------------------------------

// x / d for any 32-bit x, by a multiply-high (Granlund and Montgomery,
// PLDI 1994, fig. 4.1): m = floor(2^32 (2^l - d) / d) + 1, l = ceil(log2 d).
struct FastDiv {
  uint32_t d, m, l;
};

FastDiv make_fastdiv(uint32_t d) {
  uint32_t l = 0;
  while ((1ull << l) < d) ++l;
  const uint32_t m =
      d == 1 ? 0u
             : (uint32_t)(((1ull << 32) * ((1ull << l) - d)) / d + 1);
  return {d, m, l};
}

__device__ __forceinline__ uint32_t fast_div(const FastDiv& f, uint32_t x) {
  if (f.d == 1) return x;
  const uint32_t t = __umulhi(x, f.m);
  return (t + ((x - t) >> 1)) >> (f.l - 1);
}

// One chunk as loaded: its 16 bytes (or fewer) of values or codes, kept as
// raw words until they are used, so a chunk in flight costs 4 registers.
struct Raw {
  uint32_t w[4];
};

// VEC consecutive values of one chunk: one 16-byte load (WIDE), else VEC
// scalar loads
template <typename T, int VEC, bool WIDE>
__device__ __forceinline__ void load_vals(const T* p, Raw& r) {
  if constexpr (WIDE) {
    static_assert(VEC * sizeof(T) == 16, "a wide chunk is 16 bytes");
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    r.w[0] = v.x;
    r.w[1] = v.y;
    r.w[2] = v.z;
    r.w[3] = v.w;
  } else {
    static_assert(VEC <= 2, "a scalar chunk is one or two values");
    r.w[0] = r.w[1] = 0u;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if constexpr (sizeof(T) == 4)
        r.w[j] = __float_as_uint(__ldg(p + j));
      else
        r.w[0] |= (uint32_t)__bfloat16_as_ushort(__ldg(p + j)) << (16 * j);
    }
  }
}

// value j of a chunk's words, in f32 (bf16 -> f32 is exact)
template <typename T>
__device__ __forceinline__ float val_of(const Raw& r, int j) {
  if constexpr (sizeof(T) == 4) return __uint_as_float(r.w[j]);
  return bf16_bits_to_f((r.w[j / 2] >> (16 * (j % 2))) & 0xFFFFu);
}

// the bytes of VEC codes: VEC int8 codes, or VEC / 2 bytes of nibbles
template <int VEC, bool PACKED>
__host__ __device__ constexpr int code_bytes() {
  return PACKED ? VEC / 2 : VEC;
}

// the bytes of VEC codes as words: one load of code_bytes() bytes when
// WIDE (16 or 8), else byte loads
template <int VEC, bool PACKED, bool WIDE>
__device__ __forceinline__ void load_codes(const uint8_t* p, Raw& r) {
  constexpr int NB = code_bytes<VEC, PACKED>();
  r.w[0] = r.w[1] = r.w[2] = r.w[3] = 0u;
  if constexpr (WIDE && NB == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    r.w[0] = v.x;
    r.w[1] = v.y;
    r.w[2] = v.z;
    r.w[3] = v.w;
  } else if constexpr (WIDE && NB == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = v.x;
    r.w[1] = v.y;
  } else {
    static_assert(!WIDE, "a wide chunk is 8 or 16 code bytes");
#pragma unroll
    for (int b = 0; b < NB; ++b)
      r.w[b / 4] |= (uint32_t)__ldg(p + b) << (8 * (b % 4));
  }
}

// the table index of code j of a chunk's words
template <bool PACKED>
__device__ __forceinline__ int code_index(const Raw& r, int j, int offset,
                                          int kmask) {
  if (PACKED) return (r.w[j / 8] >> (4 * (j % 8))) & 0xF & kmask;
  return ((int)(int8_t)((r.w[j / 4] >> (8 * (j % 4))) & 0xFF) + offset) &
         kmask;
}

template <typename T, int VEC, bool WIDE>
__device__ __forceinline__ void store_vals(T* p, const float* v) {
  if constexpr (WIDE) {
    static_assert(VEC * sizeof(T) % 16 == 0, "whole 16-byte stores");
    constexpr int PER = 16 / sizeof(T);
#pragma unroll
    for (int q = 0; q < VEC / PER; ++q) {
      uint32_t w[4];
      if constexpr (sizeof(T) == 4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = __float_as_uint(v[q * PER + j]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[j] = f_to_bf16_bits(v[q * PER + 2 * j]) |
                 (f_to_bf16_bits(v[q * PER + 2 * j + 1]) << 16);
      }
      reinterpret_cast<uint4*>(p)[q] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if constexpr (sizeof(T) == 4)
        p[j] = v[j];
      else
        p[j] = __float2bfloat16_rn(v[j]);
    }
  }
}

// VEC codes into their bytes (element j: byte j, or nibble j low first) and
// one store of code_bytes() bytes (1, 2, 4 or 8)
template <int VEC, bool PACKED>
__device__ __forceinline__ void store_codes(uint8_t* p, const int* c) {
  constexpr int NB = code_bytes<VEC, PACKED>();
  static_assert(NB == 1 || NB == 2 || NB == 4 || NB == 8, "1-8 bytes");
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int bit = PACKED ? 4 * j : 8 * j;
    const uint32_t b =
        PACKED ? (uint32_t)(c[j] & 0xF) : (uint32_t)(uint8_t)c[j];
    w[bit / 32] |= b << (bit % 32);
  }
  if constexpr (NB == 8)
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  else if constexpr (NB == 4)
    *reinterpret_cast<uint32_t*>(p) = w[0];
  else if constexpr (NB == 2)
    *reinterpret_cast<uint16_t*>(p) = (uint16_t)w[0];
  else
    *p = (uint8_t)w[0];
}

// A thread's walk over its n chunks, t = 0 .. n - 1: `load(t, r)` fetches
// chunk t, `use(t, r)` consumes it.  ITER loads stay in flight: chunk
// t + ITER is requested before chunk t is used.  `prime` issues the first
// ITER loads, so a kernel can start them before its set-up (the level
// table, a barrier) and `walk` then runs the rest.
template <int ITER, typename Buf, typename Load>
__device__ __forceinline__ void prime(Buf* buf, int n, Load load) {
#pragma unroll
  for (int i = 0; i < ITER; ++i)
    if (i < n) load(i, buf[i]);
}

template <int ITER, typename Buf, typename Load, typename Use>
__device__ __forceinline__ void walk(Buf* buf, int n, Load load, Use use) {
  for (int t0 = 0; t0 < n; t0 += ITER) {
#pragma unroll
    for (int i = 0; i < ITER; ++i) {
      const int t = t0 + i;
      if (t < n) {
        const Buf r = buf[i];
        if (t + ITER < n) load(t + ITER, buf[i]);
        use(t, r);
      }
    }
  }
}

// A thread's VEC columns of per-column statistics: 16-byte loads in the
// vector body (the route has checked the statistics' alignment), else
// scalar ones
template <int VEC, bool WIDE>
__device__ __forceinline__ void col_stats(const float* __restrict__ mu,
                                          const float* __restrict__ sigma,
                                          int64_t at, float* m, float* s) {
  if constexpr (WIDE && VEC % 4 == 0) {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(mu + at) + q);
      const float4 b = __ldg(reinterpret_cast<const float4*>(sigma + at) + q);
      m[4 * q] = a.x;
      m[4 * q + 1] = a.y;
      m[4 * q + 2] = a.z;
      m[4 * q + 3] = a.w;
      s[4 * q] = b.x;
      s[4 * q + 1] = b.y;
      s[4 * q + 2] = b.z;
      s[4 * q + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      m[j] = __ldg(mu + at + j);
      s[j] = __ldg(sigma + at + j);
    }
  }
}

__device__ __forceinline__ void stage_table(float* s_table,
                                            const float* __restrict__ table,
                                            int k) {
  for (int i = threadIdx.x; i < k; i += THREADS) s_table[i] = table[i];
}

// Per-column launch geometry: a block is (1 << tx_log2) chunks of columns
// by rows_per_strip rows; blockIdx.x = (g * strips + strip) * tiles + tile
struct ColGrid {
  int R, C, tx_log2, tiles, strips, rows_per_strip;
};

// A thread's place in a per-column launch: its first column c0, first row
// r0, the rows between its chunks (ty_n), its group g and how many chunks
// it walks (0 past the row's end)
struct ColPlace {
  int c0, r0, ty_n, g, n;
};

template <int VEC>
__device__ __forceinline__ ColPlace col_place(const ColGrid& cg) {
  const int tile = blockIdx.x % cg.tiles;
  const int rest = blockIdx.x / cg.tiles;
  const int strip = rest % cg.strips;
  ColPlace p;
  p.g = rest / cg.strips;
  p.ty_n = THREADS >> cg.tx_log2;
  p.c0 = ((tile << cg.tx_log2) + (threadIdx.x & ((1 << cg.tx_log2) - 1))) *
         VEC;
  p.r0 = strip * cg.rows_per_strip + (threadIdx.x >> cg.tx_log2);
  const int r_end = min(cg.R, (strip + 1) * cg.rows_per_strip);
  p.n = p.c0 < cg.C && p.r0 < r_end ? (r_end - p.r0 + p.ty_n - 1) / p.ty_n
                                    : 0;
  return p;
}

// Per-group launch geometry: chunks_per_block consecutive chunks of the
// flat range of n_chunks; a group is cpg chunks
struct FlatGrid {
  long long n_chunks;
  int chunks_per_block;
  uint32_t cpg;
  FastDiv div_cpg;
};

template <typename T, int VEC, bool WIDE, bool PACKED>
__global__ void __launch_bounds__(THREADS)
quant_col_kernel(const T* __restrict__ w, const float* __restrict__ mu,
                 const float* __restrict__ sigma, uint8_t* __restrict__ out,
                 ColGrid cg, int k) {
  const ColPlace p = col_place<VEC>(cg);
  if (p.n == 0) return;
  // 32-bit offsets inside the group (R * C < 2^31), from its 64-bit base
  const int64_t gbase = (int64_t)p.g * cg.R * cg.C + p.c0;
  const T* wp = w + gbase + p.r0 * cg.C;
  const int step = p.ty_n * cg.C;
  auto load = [&](int t, Raw& r) {
    load_vals<T, VEC, WIDE>(wp + t * step, r);
  };
  Raw buf[Q_ITER];
  prime<Q_ITER>(buf, p.n, load);
  float m[VEC], s[VEC];
  col_stats<VEC, WIDE>(mu, sigma, (int64_t)p.g * cg.C + p.c0, m, s);
  const float kf = (float)k;
  const float kmax = (float)(k - 1);
  const int offset = k == 256 ? 128 : 0;
  constexpr int DIV = PACKED ? 2 : 1;
  uint8_t* op = out + gbase / DIV + p.r0 * (cg.C / DIV);
  const int ostep = step / DIV;
  walk<Q_ITER>(buf, p.n, load, [&](int t, const Raw& r) {
    int c[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      c[j] = quant_elem(val_of<T>(r, j), m[j], s[j], kf, kmax, offset);
    store_codes<VEC, PACKED>(op + t * ostep, c);
  });
}

template <typename T, int VEC, bool WIDE, bool PACKED>
__global__ void __launch_bounds__(THREADS)
quant_grp_kernel(const T* __restrict__ w, const float* __restrict__ mu,
                 const float* __restrict__ sigma, uint8_t* __restrict__ out,
                 FlatGrid fg, int k) {
  const long long b0 = (long long)blockIdx.x * fg.chunks_per_block;
  const int nb = (int)min((long long)fg.chunks_per_block, fg.n_chunks - b0);
  const int i0 = threadIdx.x;
  const int n = i0 < nb ? (nb - i0 + THREADS - 1) / THREADS : 0;
  if (n == 0) return;
  const T* wb = w + (b0 + i0) * VEC;
  auto load = [&](int t, Raw& r) {
    load_vals<T, VEC, WIDE>(wb + t * THREADS * VEC, r);
  };
  Raw buf[Q_ITER];
  prime<Q_ITER>(buf, n, load);
  const long long g0 = b0 / fg.cpg;                 // once per block
  const uint32_t rem0 = (uint32_t)(b0 - g0 * fg.cpg) + i0;
  const float kf = (float)k;
  const float kmax = (float)(k - 1);
  const int offset = k == 256 ? 128 : 0;
  constexpr int NB = code_bytes<VEC, PACKED>();
  uint8_t* ob = out + (b0 + i0) * NB;
  walk<Q_ITER>(buf, n, load, [&](int t, const Raw& r) {
    const long long g = g0 + fast_div(fg.div_cpg, rem0 + t * THREADS);
    const float m = __ldg(mu + g);
    const float s = __ldg(sigma + g);
    int c[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      c[j] = quant_elem(val_of<T>(r, j), m, s, kf, kmax, offset);
    store_codes<VEC, PACKED>(ob + t * THREADS * NB, c);
  });
}

template <typename T, int VEC, bool WIDE, bool PACKED>
__global__ void __launch_bounds__(THREADS)
dequant_col_kernel(const uint8_t* __restrict__ codes,
                   const float* __restrict__ mu,
                   const float* __restrict__ sigma,
                   const float* __restrict__ table, T* __restrict__ out,
                   ColGrid cg, int k) {
  const ColPlace p = col_place<VEC>(cg);
  constexpr int DIV = PACKED ? 2 : 1;
  const int64_t gbase = (int64_t)p.g * cg.R * cg.C + p.c0;
  const uint8_t* cp = codes + gbase / DIV + p.r0 * (cg.C / DIV);
  const int cstep = p.ty_n * (cg.C / DIV);
  auto load = [&](int t, Raw& r) {
    load_codes<VEC, PACKED, WIDE>(cp + t * cstep, r);
  };
  Raw buf[D_ITER];
  prime<D_ITER>(buf, p.n, load);          // in flight across the set-up
  float m[VEC], s[VEC];
  if (p.n) col_stats<VEC, WIDE>(mu, sigma, (int64_t)p.g * cg.C + p.c0, m, s);
  __shared__ float s_table[MAX_K];
  stage_table(s_table, table, k);
  __syncthreads();
  if (p.n == 0) return;
  const int offset = k == 256 ? 128 : 0;
  const int kmask = k - 1;                 // k is a power of two
  T* op = out + gbase + p.r0 * cg.C;
  const int ostep = p.ty_n * cg.C;
  walk<D_ITER>(buf, p.n, load, [&](int t, const Raw& r) {
    float v[VEC];
    // separate multiply and add: the plain version's rounding
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      v[j] = __fadd_rn(
          m[j],
          __fmul_rn(s[j], s_table[code_index<PACKED>(r, j, offset, kmask)]));
    store_vals<T, VEC, WIDE>(op + t * ostep, v);
  });
}

// The per-group dequantize walk shared by the dense entry and the paged
// one: a thread's chunks i0 + t * THREADS of a run of nb chunks from `cb`
// (codes) to `ob` (values); chunk i of the run belongs to group
// (rem0 + i) / cpg counted from the run's first, whose statistics `stat`
// returns as (mu, sigma).  The first loads are issued before the table is
// staged.
template <typename T, int VEC, bool WIDE, bool PACKED, typename Stat>
__device__ __forceinline__ void dequant_run(const uint8_t* __restrict__ cb,
                                            T* __restrict__ ob, int nb,
                                            uint32_t rem0, const FastDiv& dv,
                                            const float* __restrict__ table,
                                            int k, Stat stat) {
  constexpr int NB = code_bytes<VEC, PACKED>();
  const int i0 = threadIdx.x;
  const int n = i0 < nb ? (nb - i0 + THREADS - 1) / THREADS : 0;
  const uint8_t* cp = cb + i0 * NB;
  auto load = [&](int t, Raw& r) {
    load_codes<VEC, PACKED, WIDE>(cp + t * THREADS * NB, r);
  };
  Raw buf[D_ITER];
  prime<D_ITER>(buf, n, load);
  __shared__ float s_table[MAX_K];
  stage_table(s_table, table, k);
  __syncthreads();
  const int offset = k == 256 ? 128 : 0;
  const int kmask = k - 1;
  T* op = ob + i0 * VEC;
  walk<D_ITER>(buf, n, load, [&](int t, const Raw& r) {
    float m, s;
    stat(fast_div(dv, rem0 + i0 + t * THREADS), m, s);
    float v[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      v[j] = __fadd_rn(
          m, __fmul_rn(s, s_table[code_index<PACKED>(r, j, offset, kmask)]));
    store_vals<T, VEC, WIDE>(op + t * THREADS * VEC, v);
  });
}

template <typename T, int VEC, bool WIDE, bool PACKED>
__global__ void __launch_bounds__(THREADS)
dequant_grp_kernel(const uint8_t* __restrict__ codes,
                   const float* __restrict__ mu,
                   const float* __restrict__ sigma,
                   const float* __restrict__ table, T* __restrict__ out,
                   FlatGrid fg, int k) {
  const long long b0 = (long long)blockIdx.x * fg.chunks_per_block;
  const long long g0 = b0 / fg.cpg;                 // once per block
  const uint32_t rem0 = (uint32_t)(b0 - g0 * fg.cpg);
  const int nb = (int)min((long long)fg.chunks_per_block, fg.n_chunks - b0);
  dequant_run<T, VEC, WIDE, PACKED>(
      codes + b0 * code_bytes<VEC, PACKED>(), out + b0 * VEC, nb, rem0,
      fg.div_cpg, table, k, [=](uint32_t dg, float& m, float& s) {
        m = __ldg(mu + g0 + dg);
        s = __ldg(sigma + g0 + dg);
      });
}

// The prefill pool read: out[b, j * page + r, h, :] = dequant(pool page
// bt[b, j], row r, head h).  One page of the pool (page * KV * hd codes, its
// page * KV statistics pairs) is `frac` blocks of chunks_per_block chunks;
// a (row, head) is hd / VEC chunks.
struct PagedGrid {
  long long n_pool_pages;
  int frac, chunks_per_block, chunks_per_page, stats_per_page;
  FastDiv div_head;  // chunks of one (row, head)
};

template <typename T, typename I, int VEC, bool WIDE, bool PACKED>
__global__ void __launch_bounds__(THREADS)
dequant_paged_kernel(const uint8_t* __restrict__ codes,
                     const uint16_t* __restrict__ mu,
                     const uint16_t* __restrict__ sigma,
                     const I* __restrict__ block_tables,
                     const float* __restrict__ table, T* __restrict__ out,
                     PagedGrid pg, int k) {
  const int seg = blockIdx.x / pg.frac;          // b * n_pages + j
  const int f = blockIdx.x - seg * pg.frac;
  const long long page = (long long)__ldg(block_tables + seg);
  if (page < 0 || page >= pg.n_pool_pages) __trap();
  const int c_begin = f * pg.chunks_per_block;
  const int nb = min(pg.chunks_per_block, pg.chunks_per_page - c_begin);
  const int64_t src = page * pg.chunks_per_page + c_begin;
  const int64_t dst = (int64_t)seg * pg.chunks_per_page + c_begin;
  const uint16_t* mp = mu + page * pg.stats_per_page;
  const uint16_t* sp = sigma + page * pg.stats_per_page;
  dequant_run<T, VEC, WIDE, PACKED>(
      codes + src * code_bytes<VEC, PACKED>(), out + dst * VEC, nb,
      (uint32_t)c_begin, pg.div_head, table, k,
      // bf16 -> f32 is exact, as .to(torch.float32)
      [=](uint32_t rh, float& m, float& s) {
        m = bf16_bits_to_f(__ldg(mp + rh));
        s = bf16_bits_to_f(__ldg(sp + rh));
      });
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// `total` items in parts of at most `per` (a multiple of `unit`), evened
// out: the same number of parts, each a multiple of `unit`, none larger
// than needed
int even_part(long long total, long long per, int unit) {
  const long long parts = (total + per - 1) / per;
  const long long part = (total + parts - 1) / parts;
  return (int)((part + unit - 1) / unit * unit);
}

// Blocks of THREADS that the card holds at once for `kernel` (its SMs times
// the blocks an SM fits, given its registers and shared memory).
template <typename K>
long long resident_blocks(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  return (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
}

// Chunks a thread walks, 1 to MAX_CHUNKS, for a launch of blocks_at(n)
// blocks on a card that holds `cap` at once: the most whose last wave is
// at least 7/8 full, else the one with the fullest last wave.  A long walk
// shares a thread's set-up over more chunks; a full last wave keeps every
// SM streaming to the end.
template <typename F>
int pick_chunks(F blocks_at, long long cap) {
  int best = 1;
  double best_fill = 0.0;
  for (int n = MAX_CHUNKS; n >= 1; --n) {
    const long long b = blocks_at(n);
    const double fill = (double)b / (double)(((b + cap - 1) / cap) * cap);
    if (fill >= 0.875) return n;
    if (fill > best_fill) {
      best_fill = fill;
      best = n;
    }
  }
  return best;
}

// tiles of TX chunks across a row of cpr chunks: the widest TX <= 256 (a
// power of two) that wastes at most an eighth of the row's threads
ColGrid col_grid(long long G, long long R, long long C, int vec,
                 long long cap) {
  const long long cpr = (C + vec - 1) / vec;
  int tx_log2 = 8;
  while (tx_log2 > 0 && (1LL << (tx_log2 - 1)) >= cpr) --tx_log2;
  for (; tx_log2 > 0; --tx_log2) {
    const long long tx = 1LL << tx_log2;
    if (((cpr + tx - 1) / tx) * tx - cpr <= cpr / 8) break;
  }
  const int tiles = ceil_div(cpr, 1LL << tx_log2);
  const int ty = THREADS >> tx_log2;
  const int n = pick_chunks(
      [&](int c) { return G * tiles * ((R + ty * c - 1) / (ty * c)); }, cap);
  const int rows = even_part(R, (long long)ty * n, ty);
  return {(int)R, (int)C, tx_log2, tiles, ceil_div(R, rows), rows};
}

FlatGrid flat_grid(long long n_chunks, long long cpg, long long cap) {
  const int n = pick_chunks(
      [&](int c) { return (n_chunks + THREADS * c - 1) / (THREADS * c); },
      cap);
  const int cpb = even_part(n_chunks, (long long)THREADS * n, THREADS);
  return {n_chunks, cpb, (uint32_t)cpg, make_fastdiv((uint32_t)cpg)};
}

template <typename T, int VEC, bool WIDE, bool PACKED>
int quant_body(const void* w, const float* mu, const float* sigma,
               int per_col, void* out, int k, long long G, long long R,
               long long C, cudaStream_t stream) {
  const T* wp = static_cast<const T*>(w);
  uint8_t* op = static_cast<uint8_t*>(out);
  if (per_col) {
    static const long long cap =
        resident_blocks(quant_col_kernel<T, VEC, WIDE, PACKED>);
    const ColGrid cg = col_grid(G, R, C, VEC, cap);
    const long long blocks = G * cg.strips * (long long)cg.tiles;
    if (blocks > 0x7FFFFFFFLL) return -3;
    quant_col_kernel<T, VEC, WIDE, PACKED>
        <<<(unsigned)blocks, THREADS, 0, stream>>>(wp, mu, sigma, op, cg, k);
  } else {
    static const long long cap =
        resident_blocks(quant_grp_kernel<T, VEC, WIDE, PACKED>);
    const FlatGrid fg = flat_grid(G * R * C / VEC, R * C / VEC, cap);
    const long long blocks = (fg.n_chunks + fg.chunks_per_block - 1) /
                             fg.chunks_per_block;
    if (blocks > 0x7FFFFFFFLL) return -3;
    quant_grp_kernel<T, VEC, WIDE, PACKED>
        <<<(unsigned)blocks, THREADS, 0, stream>>>(wp, mu, sigma, op, fg, k);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC, bool WIDE, bool PACKED>
int dequant_body(const void* codes, const float* mu, const float* sigma,
                 int per_col, const float* table, void* out, int k,
                 long long G, long long R, long long C,
                 cudaStream_t stream) {
  const uint8_t* cp = static_cast<const uint8_t*>(codes);
  T* op = static_cast<T*>(out);
  if (per_col) {
    static const long long cap =
        resident_blocks(dequant_col_kernel<T, VEC, WIDE, PACKED>);
    const ColGrid cg = col_grid(G, R, C, VEC, cap);
    const long long blocks = G * cg.strips * (long long)cg.tiles;
    if (blocks > 0x7FFFFFFFLL) return -3;
    dequant_col_kernel<T, VEC, WIDE, PACKED>
        <<<(unsigned)blocks, THREADS, 0, stream>>>(cp, mu, sigma, table, op,
                                                   cg, k);
  } else {
    static const long long cap =
        resident_blocks(dequant_grp_kernel<T, VEC, WIDE, PACKED>);
    const FlatGrid fg = flat_grid(G * R * C / VEC, R * C / VEC, cap);
    const long long blocks = (fg.n_chunks + fg.chunks_per_block - 1) /
                             fg.chunks_per_block;
    if (blocks > 0x7FFFFFFFLL) return -3;
    dequant_grp_kernel<T, VEC, WIDE, PACKED>
        <<<(unsigned)blocks, THREADS, 0, stream>>>(cp, mu, sigma, table, op,
                                                   fg, k);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename I, int VEC, bool WIDE, bool PACKED>
int paged_body(const void* codes, const void* mu, const void* sigma,
               const void* block_tables, const float* table, void* out,
               int k, long long P, int page, int kv_heads, int hd, int B,
               int n_pages, cudaStream_t stream) {
  static const long long cap =
      resident_blocks(dequant_paged_kernel<T, I, VEC, WIDE, PACKED>);
  const long long cpp = (long long)page * kv_heads * hd / VEC;
  const long long segs = (long long)B * n_pages;
  const int n = pick_chunks(
      [&](int c) {
        return segs * ((cpp + THREADS * c - 1) / (THREADS * c));
      },
      cap);
  const int cpb = even_part(cpp, (long long)THREADS * n, THREADS);
  PagedGrid pg{P, ceil_div(cpp, cpb), cpb, (int)cpp, page * kv_heads,
               make_fastdiv((uint32_t)(hd / VEC))};
  const long long blocks = segs * pg.frac;
  if (cpp > 0x7FFFFFFFLL || blocks > 0x7FFFFFFFLL) return -3;
  dequant_paged_kernel<T, I, VEC, WIDE, PACKED>
      <<<(unsigned)blocks, THREADS, 0, stream>>>(
          static_cast<const uint8_t*>(codes),
          static_cast<const uint16_t*>(mu),
          static_cast<const uint16_t*>(sigma),
          static_cast<const I*>(block_tables), table, static_cast<T*>(out),
          pg, k);
  return static_cast<int>(cudaGetLastError());
}

// The chunk of a body: 16 bytes of the wider side when `vector` (the route
// has checked rows or groups are whole chunks and the pointers aligned),
// else one element (two when packed: one byte of codes).
template <typename T, bool PACKED>
int quant_route(int vector, const void* w, const float* mu,
                const float* sigma, int per_col, void* out, int k,
                long long G, long long R, long long C, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (vector) {
    if ((per_col ? C : R * C) % V || !aligned(w, 16) ||
        !aligned(out, code_bytes<V, PACKED>()) || !aligned(mu, 16) ||
        !aligned(sigma, 16))
      return -7;
    return quant_body<T, V, true, PACKED>(w, mu, sigma, per_col, out, k, G,
                                          R, C, stream);
  }
  return quant_body<T, PACKED ? 2 : 1, false, PACKED>(w, mu, sigma, per_col,
                                                      out, k, G, R, C,
                                                      stream);
}

template <typename T, bool PACKED>
int dequant_route(int vector, const void* codes, const float* mu,
                  const float* sigma, int per_col, const float* table,
                  void* out, int k, long long G, long long R, long long C,
                  cudaStream_t stream) {
  if (vector) {
    if ((per_col ? C : R * C) % 16 || !aligned(out, 16) ||
        !aligned(codes, code_bytes<16, PACKED>()) || !aligned(mu, 16) ||
        !aligned(sigma, 16))
      return -7;
    return dequant_body<T, 16, true, PACKED>(codes, mu, sigma, per_col,
                                             table, out, k, G, R, C, stream);
  }
  return dequant_body<T, PACKED ? 2 : 1, false, PACKED>(
      codes, mu, sigma, per_col, table, out, k, G, R, C, stream);
}

template <typename T, typename I, bool PACKED>
int paged_route(int vector, const void* codes, const void* mu,
                const void* sigma, const void* bt, const float* table,
                void* out, int k, long long P, int page, int kv_heads,
                int hd, int B, int n_pages, cudaStream_t stream) {
  if (vector) {
    if (hd % 16 || !aligned(out, 16) ||
        !aligned(codes, code_bytes<16, PACKED>()))
      return -7;
    return paged_body<T, I, 16, true, PACKED>(codes, mu, sigma, bt, table,
                                              out, k, P, page, kv_heads, hd,
                                              B, n_pages, stream);
  }
  return paged_body<T, I, PACKED ? 2 : 1, false, PACKED>(
      codes, mu, sigma, bt, table, out, k, P, page, kv_heads, hd, B, n_pages,
      stream);
}

// ---- the fused KV append ------------------------------------------------

constexpr int APPEND_THREADS = 256;

// One chunk of VPL consecutive values.  VEC: one wide load (VPL * 4 or
// VPL * 2 bytes; two 16-byte loads for f32 VPL = 8), which the caller only
// asks for where rows are whole 16-byte units and the row pointers 16-byte
// aligned; else one load an element.
template <int VPL>
__device__ __forceinline__ void load_chunk(const float* p, float* o,
                                           bool vec) {
  if constexpr (VPL == 1) {
    o[0] = __ldg(p);
  } else if (!vec) {
#pragma unroll
    for (int j = 0; j < VPL; ++j) o[j] = __ldg(p + j);
  } else if constexpr (VPL == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    o[0] = v.x;
    o[1] = v.y;
  } else {
#pragma unroll
    for (int j = 0; j < VPL; j += 4) load4(p + j, o + j);
  }
}
template <int VPL>
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float* o,
                                           bool vec) {
  if constexpr (VPL == 1) {
    o[0] = bf16_bits_to_f(__ldg(reinterpret_cast<const uint16_t*>(p)));
  } else if (!vec) {
    const uint16_t* q = reinterpret_cast<const uint16_t*>(p);
#pragma unroll
    for (int j = 0; j < VPL; ++j) o[j] = bf16_bits_to_f(__ldg(q + j));
  } else if constexpr (VPL == 2) {
    const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(p));
    o[0] = bf16_bits_to_f(w & 0xFFFFu);
    o[1] = bf16_bits_to_f(w >> 16);
  } else if constexpr (VPL == 4) {
    load4(p, o);
  } else {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[2 * j] = bf16_bits_to_f(w[j] & 0xFFFFu);
      o[2 * j + 1] = bf16_bits_to_f(w[j] >> 16);
    }
  }
}

// One chunk's BYTES code bytes (at most 8, little-endian in `packed`).
// VEC: one store of BYTES bytes, which the caller only asks for where code
// rows are whole 16-byte units and the code pointers 16-byte aligned; else
// one store a byte.
template <int BYTES>
__device__ __forceinline__ void store_chunk(uint8_t* dst,
                                            const uint32_t* packed,
                                            bool vec) {
  if (!vec) {
#pragma unroll
    for (int b = 0; b < BYTES; ++b)
      dst[b] = (uint8_t)(packed[b / 4] >> (8 * (b % 4)));
  } else if constexpr (BYTES == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
  } else if constexpr (BYTES == 4) {
    *reinterpret_cast<uint32_t*>(dst) = packed[0];
  } else if constexpr (BYTES == 2) {
    *reinterpret_cast<uint16_t*>(dst) = (uint16_t)packed[0];
  } else {
    static_assert(BYTES == 1, "1, 2, 4 or 8 code bytes a chunk");
    *dst = (uint8_t)packed[0];
  }
}

// sum over the `lanes` lanes (a power of two) of an aligned group of a warp;
// `mask` names exactly the group's lanes (a warp's other groups may have
// exited)
__device__ __forceinline__ float group_sum(float x, unsigned mask,
                                           int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(mask, x, off));
  return x;
}

// One group of 2^lanes_log2 lanes per (row, head, K or V); a warp holds
// 32 >> lanes_log2 of them.  A row of hd values is hd / VPL chunks; lane l
// takes chunks l, l + lanes, ... (at most CH of them).  Lanes past the last
// chunk load nothing and add 0 to both sums.  Codes: KV4 two per byte, else
// int8 with the k = 256 offset.  Statistics are stored as bf16 bits.
// WARP32: groups of 32 lanes known at compile time (the engine's head dims
// 112-256), so the group's indexing and shuffle tree are constants.
template <typename T, int VPL, int CH, bool WARP32, bool KV4>
__global__ void __launch_bounds__(APPEND_THREADS)
kv_append_kernel(const T* __restrict__ k, const T* __restrict__ v,
                 const int64_t* __restrict__ pages,
                 const int64_t* __restrict__ rows,
                 uint8_t* __restrict__ k_codes,
                 uint8_t* __restrict__ v_codes, uint16_t* __restrict__ k_mu,
                 uint16_t* __restrict__ k_sigma, uint16_t* __restrict__ v_mu,
                 uint16_t* __restrict__ v_sigma, int n_groups, int kv_heads,
                 long long n_pages, int page_size, int hd, int lanes_log2,
                 int vec_load, int vec_store) {
  constexpr int CODE_BYTES = KV4 ? VPL / 2 : VPL;  // per chunk
  if (WARP32) lanes_log2 = 5;
  const int lanes = 1 << lanes_log2;
  const int t = blockIdx.x * APPEND_THREADS + threadIdx.x;
  const int group = t >> lanes_log2;
  const int lane = t & (lanes - 1);
  // a group never straddles a warp, and its lanes exit or stay together
  if (group >= n_groups) return;
  const unsigned mask =
      lanes == 32 ? 0xFFFFFFFFu
                  : ((1u << lanes) - 1u) << ((threadIdx.x & 31) & ~(lanes - 1));
  const int n_chunks = hd / VPL;
  const int which = group & 1;  // 0: K, 1: V
  const int rh = group >> 1;    // row * kv_heads + head
  const int n = rh / kv_heads;
  const int h = rh - n * kv_heads;
  const T* src = (which ? v : k) + (int64_t)rh * hd;
  float x[CH][VPL];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int chunk = lane + c * lanes;
    if (chunk < n_chunks) {
      load_chunk<VPL>(src + chunk * VPL, x[c], vec_load);
    } else {
#pragma unroll
      for (int j = 0; j < VPL; ++j) x[c][j] = 0.0f;
    }
  }

  // the lane's values in chunk order, then the group's shuffle tree
  float s = x[0][0];
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int j = (c == 0); j < VPL; ++j) s = __fadd_rn(s, x[c][j]);
  const float mean = __fdiv_rn(group_sum(s, mask, lanes), (float)hd);
  float q = 0.0f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    if (lane + c * lanes < n_chunks) {
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const float d = __fsub_rn(x[c][j], mean);
        q = __fadd_rn(q, __fmul_rn(d, d));
      }
    }
  }
  float sd = __fsqrt_rn(__fdiv_rn(group_sum(q, mask, lanes), (float)hd));
  sd = sd < 1e-8f ? 1e-8f : sd;  // torch.clamp(min=): NaN stays NaN
  const uint32_t mu_b = f_to_bf16_bits(mean);
  const uint32_t sd_b = f_to_bf16_bits(sd);
  const float mu_r = bf16_bits_to_f(mu_b);
  const float sd_r = bf16_bits_to_f(sd_b);

  const long long page = pages[n];
  const long long row = rows[n];
  if (page < 0 || page >= n_pages || row < 0 || row >= page_size) __trap();
  const int64_t slot = ((int64_t)page * page_size + row) * kv_heads + h;
  uint8_t* dst = (which ? v_codes : k_codes) + slot * (KV4 ? hd / 2 : hd);

  constexpr int K = KV4 ? 16 : 256;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int chunk = lane + c * lanes;
    if (chunk >= n_chunks) continue;
    uint32_t packed[2] = {0u, 0u};  // CODE_BYTES <= 8
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int code = quant_elem(x[c][j], mu_r, sd_r, (float)K,
                                  (float)(K - 1), KV4 ? 0 : 128);
      // element j of the chunk: nibble j (kv4, low first) or byte j
      const int bit = (KV4 ? 4 : 8) * j;
      packed[bit / 32] |= (uint32_t)(code & (KV4 ? 0xF : 0xFF)) << (bit % 32);
    }
    store_chunk<CODE_BYTES>(dst + chunk * CODE_BYTES, packed, vec_store);
  }
  if (lane == 0) {
    (which ? v_mu : k_mu)[slot] = (uint16_t)mu_b;
    (which ? v_sigma : k_sigma)[slot] = (uint16_t)sd_b;
  }
}

template <typename T, int VPL, int CH, bool WARP32>
int append(const void* k, const void* v, const int64_t* pages,
           const int64_t* rows, void* const* leaves, int kv4, int n_rows,
           int kv_heads, long long n_pages, int page_size, int hd,
           int lanes_log2, int vec_load, int vec_store,
           cudaStream_t stream) {
  const int n_groups = 2 * n_rows * kv_heads;
  const long long threads = (long long)n_groups << lanes_log2;
  const unsigned blocks =
      (unsigned)((threads + APPEND_THREADS - 1) / APPEND_THREADS);
  auto* kc = static_cast<uint8_t*>(leaves[0]);
  auto* km = static_cast<uint16_t*>(leaves[1]);
  auto* ks = static_cast<uint16_t*>(leaves[2]);
  auto* vc = static_cast<uint8_t*>(leaves[3]);
  auto* vm = static_cast<uint16_t*>(leaves[4]);
  auto* vs = static_cast<uint16_t*>(leaves[5]);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  if constexpr (VPL % 2 == 0) {   // kv4 packs whole bytes: VPL even
    if (kv4) {
      kv_append_kernel<T, VPL, CH, WARP32, true><<<blocks, APPEND_THREADS, 0,
                                                   stream>>>(
          kp, vp, pages, rows, kc, vc, km, ks, vm, vs, n_groups, kv_heads,
          n_pages, page_size, hd, lanes_log2, vec_load, vec_store);
      return static_cast<int>(cudaGetLastError());
    }
  } else {
    if (kv4) return -6;
  }
  kv_append_kernel<T, VPL, CH, WARP32, false><<<blocks, APPEND_THREADS, 0,
                                                stream>>>(
      kp, vp, pages, rows, kc, vc, km, ks, vm, vs, n_groups, kv_heads,
      n_pages, page_size, hd, lanes_log2, vec_load, vec_store);
  return static_cast<int>(cudaGetLastError());
}

// The layout (VPL values a chunk, 2^lanes_log2 lanes a group) is chosen by
// the caller (kernels/kquantile.py:append_layout); here it is only checked
// to be one the kernel can run: whole chunks, at most 32 lanes and 4 chunks
// a lane (8 at VPL 1, an odd hd at kv8, with scalar loads and stores).
template <typename T>
int append_layout_body(int vpl, int lanes_log2, int hd, const void* k,
                       const void* v, const int64_t* pages,
                       const int64_t* rows, void* const* leaves, int kv4,
                       int n_rows, int kv_heads, long long n_pages,
                       int page_size, int vec_load, int vec_store,
                       cudaStream_t stream) {
  if (hd <= 0 || hd > 256 || (kv4 && hd % 2) || lanes_log2 < 0 ||
      lanes_log2 > 5 || (vpl != 1 && vpl != 2 && vpl != 4 && vpl != 8) ||
      hd % vpl || (vpl == 1 && (vec_load || vec_store)))
    return -6;
  const int lanes = 1 << lanes_log2;
  const int ch = (hd / vpl + lanes - 1) / lanes;
#define KV_APPEND_ARGS                                                     \
  k, v, pages, rows, leaves, kv4, n_rows, kv_heads, n_pages, page_size, hd, \
      lanes_log2, vec_load, vec_store, stream
  if (vpl == 8 && ch == 1)
    return lanes == 32 ? append<T, 8, 1, true>(KV_APPEND_ARGS)
                       : append<T, 8, 1, false>(KV_APPEND_ARGS);
  if (vpl == 4 && ch == 1)
    return lanes == 32 ? append<T, 4, 1, true>(KV_APPEND_ARGS)
                       : append<T, 4, 1, false>(KV_APPEND_ARGS);
  if (vpl == 4 && ch == 2) return append<T, 4, 2, false>(KV_APPEND_ARGS);
  if (vpl == 2 && ch == 1) return append<T, 2, 1, false>(KV_APPEND_ARGS);
  if (vpl == 2 && ch == 2) return append<T, 2, 2, false>(KV_APPEND_ARGS);
  if (vpl == 2 && ch <= 4) return append<T, 2, 4, false>(KV_APPEND_ARGS);
  if (vpl == 1 && ch == 1) return append<T, 1, 1, false>(KV_APPEND_ARGS);
  if (vpl == 1 && ch == 2) return append<T, 1, 2, false>(KV_APPEND_ARGS);
  if (vpl == 1 && ch <= 4) return append<T, 1, 4, false>(KV_APPEND_ARGS);
  if (vpl == 1 && ch <= 8) return append<T, 1, 8, false>(KV_APPEND_ARGS);
#undef KV_APPEND_ARGS
  return -6;
}

int check_args(long long G, long long R, long long C, int k) {
  if (G <= 0 || R <= 0 || C <= 0) return -2;
  if (R * C > 0x7FFFFFFFLL) return -3;   // a group of 2^31 elements or more
  if (k < 2 || k > MAX_K || (k & (k - 1))) return -4;
  return 0;
}

}  // namespace

// Returns 0 on success, a cudaError_t value if the launch was refused, or a
// negative value for an argument the kernel does not take (-7: `vector`
// asked for a shape or pointer the vector body does not take).
// `packed`: codes are written (G, R, C/2) uint8, two 4-bit codes per byte
// (k <= 16, C even); else (G, R, C) int8.  `vector`: the 16-byte body, else
// the scalar one (kernels/kquantile.py: codec_route).
extern "C" int kquantile_quantize_launch(const void* w, int w_bf16,
                                         const float* mu, const float* sigma,
                                         int per_col, void* out, int packed,
                                         int vector, int k, long long G,
                                         long long R, long long C,
                                         void* stream_ptr) {
  const int rc_ok = check_args(G, R, C, k);
  if (rc_ok != 0) return rc_ok;
  if (packed && (k > 16 || (C % 2))) return -5;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (w_bf16)
    return packed ? quant_route<__nv_bfloat16, true>(
                        vector, w, mu, sigma, per_col, out, k, G, R, C, stream)
                  : quant_route<__nv_bfloat16, false>(
                        vector, w, mu, sigma, per_col, out, k, G, R, C, stream);
  return packed ? quant_route<float, true>(vector, w, mu, sigma, per_col, out,
                                           k, G, R, C, stream)
                : quant_route<float, false>(vector, w, mu, sigma, per_col,
                                            out, k, G, R, C, stream);
}

// `packed`: codes are (G, R, C/2) uint8, two 4-bit codes per byte (k <= 16,
// C even); else (G, R, C) int8.
extern "C" int kquantile_dequantize_launch(const void* codes, int packed,
                                           const float* mu,
                                           const float* sigma, int per_col,
                                           const float* table, void* out,
                                           int out_bf16, int vector, int k,
                                           long long G, long long R,
                                           long long C, void* stream_ptr) {
  const int rc_ok = check_args(G, R, C, k);
  if (rc_ok != 0) return rc_ok;
  if (packed && (k > 16 || (C % 2))) return -5;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (out_bf16)
    return packed ? dequant_route<__nv_bfloat16, true>(
                        vector, codes, mu, sigma, per_col, table, out, k, G,
                        R, C, stream)
                  : dequant_route<__nv_bfloat16, false>(
                        vector, codes, mu, sigma, per_col, table, out, k, G,
                        R, C, stream);
  return packed ? dequant_route<float, true>(vector, codes, mu, sigma,
                                             per_col, table, out, k, G, R, C,
                                             stream)
                : dequant_route<float, false>(vector, codes, mu, sigma,
                                              per_col, table, out, k, G, R,
                                              C, stream);
}

// The prefill pool read.  codes: one layer's pool (P, page, kv_heads, hd)
// int8 (kv8) or (.., hd / 2) uint8 (kv4), contiguous; mu, sigma: (P, page,
// kv_heads) bf16; block_tables: (B, n_pages) int32 or int64 (`bt_int64`);
// table: the 2^kv_bits levels; out: (B, n_pages * page, kv_heads, hd) f32
// or bf16.  A page id outside [0, P) traps.
extern "C" int kquantile_dequantize_paged_launch(
    const void* codes, int kv_bits, const void* mu, const void* sigma,
    const void* block_tables, int bt_int64, const float* table, void* out,
    int out_bf16, int vector, long long P, int page, int kv_heads, int hd,
    int B, int n_pages, void* stream_ptr) {
  if (P <= 0 || page <= 0 || kv_heads <= 0 || hd <= 0 || B <= 0 ||
      n_pages <= 0)
    return -2;
  if (kv_bits != 4 && kv_bits != 8) return -4;
  if (kv_bits == 4 && hd % 2) return -5;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int k = 1 << kv_bits;
  const bool kv4 = kv_bits == 4;
#define PAGED(T, I, PK)                                                      \
  paged_route<T, I, PK>(vector, codes, mu, sigma, block_tables, table, out, \
                        k, P, page, kv_heads, hd, B, n_pages, stream)
  if (out_bf16) {
    if (bt_int64)
      return kv4 ? PAGED(__nv_bfloat16, long long, true)
                 : PAGED(__nv_bfloat16, long long, false);
    return kv4 ? PAGED(__nv_bfloat16, int, true)
               : PAGED(__nv_bfloat16, int, false);
  }
  if (bt_int64)
    return kv4 ? PAGED(float, long long, true) : PAGED(float, long long, false);
  return kv4 ? PAGED(float, int, true) : PAGED(float, int, false);
#undef PAGED
}

// The fused KV append.  k, v: (n_rows, kv_heads, hd) contiguous, f32 or
// bf16 (`kv_bf16`); pages, rows: (n_rows,) int64 destinations; leaves: the
// six contiguous pool leaves of one layer in the order k_codes, k_mu,
// k_sigma, v_codes, v_mu, v_sigma -- codes (n_pages, page_size, kv_heads,
// hd) int8 (kv8) or (.., hd / 2) uint8 (kv4), statistics (n_pages,
// page_size, kv_heads) bf16.  hd is at most 256 and even at kv4;
// (vpl, lanes_log2) is its layout; vec_load / vec_store ask for wide loads of k, v / stores of
// codes (see load_chunk, store_chunk).
extern "C" int kv_append_launch(const void* k, const void* v, int kv_bf16,
                                const void* pages, const void* rows,
                                void* k_codes, void* k_mu, void* k_sigma,
                                void* v_codes, void* v_mu, void* v_sigma,
                                int kv_bits, int n_rows, int kv_heads, int hd,
                                int vpl, int lanes_log2, int vec_load,
                                int vec_store, long long n_pages,
                                int page_size, void* stream_ptr) {
  if (n_rows <= 0 || kv_heads <= 0 || n_pages <= 0 || page_size <= 0)
    return -2;
  if (kv_bits != 4 && kv_bits != 8) return -4;
  if ((long long)n_rows * kv_heads * 2 * 32 > 0x7FFFFFFFLL) return -3;
  void* leaves[6] = {k_codes, k_mu, k_sigma, v_codes, v_mu, v_sigma};
  const int64_t* pp = static_cast<const int64_t*>(pages);
  const int64_t* rp = static_cast<const int64_t*>(rows);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int kv4 = kv_bits == 4;
  return kv_bf16
             ? append_layout_body<__nv_bfloat16>(
                   vpl, lanes_log2, hd, k, v, pp, rp, leaves, kv4, n_rows,
                   kv_heads, n_pages, page_size, vec_load, vec_store, stream)
             : append_layout_body<float>(
                   vpl, lanes_log2, hd, k, v, pp, rp, leaves, kv4, n_rows,
                   kv_heads, n_pages, page_size, vec_load, vec_store,
                   stream);
}
