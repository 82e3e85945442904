// Deterministic k-quantile codec (quantize and dequantize), for sm_90a.
//
// Quantize, per element of w (G, R, C) with its statistics:
//   z = (w - mu) / sigma,   u = clip(Phi(z), eps, 1 - eps)
//   code = clip(floor(u k), 0, k - 1) - (128 if k == 256 else 0)   -> int8
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
// What bounds it: bytes.  Quantize reads 4 B (f32) and writes 1 B per
// element; dequantize reads 1 B (or half a byte) and writes 2 or 4 B.  The
// quantize arithmetic (erff and a dozen operations) stays under the memory
// time.  What the design does about it: one flat grid-stride pass in which a
// thread takes runs of 4 consecutive elements with one wide load and one wide
// store each (16 B of f32, 8 B of bf16, 4 B of codes, 2 B of packed codes)
// and a scalar tail; the group and column of a run's first element are
// computed once and advanced element by element, so any shape works -- the
// KV append's (2 B S KV, 1, head_dim) with per-row statistics, ragged C --
// and no padded copy is made.  The TPU kernel's (256, 512) blocks refuse
// shapes that do not divide; this one does not.
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
// into six pool leaves), which XLA fuses; as eager ops around the flat
// quantize kernel above it was a chain of ~16 launches per layer and call
// (stack, casts, mean, deviation, clamp, the kernel, int4 packing, six
// index writes).  Per (row, head, K or V), with x the hd values in f32:
//   mu = bf16(mean(x)),  sigma = bf16(max(sqrt(mean((x - mean)^2)), 1e-8))
//   code = quant_elem(x, mu, sigma)  -> int8 (kv8) or nibbles (kv4)
// What bounds it: nothing of the card at the engine's shapes -- 100 KB
// moved at decode (16 rows, 8 heads, hd 128, bf16), 0.03 us of bytes; one
// launch is ~3 us -- but the host.  What the design does about it: one
// launch, no allocation, no host sync.  A group of hd / VPL lanes (VPL = 4
// values, 8 at hd = 256) holds one (row, head, K or V) with one wide load
// per lane, reduces the mean and the deviation in f32 by shuffles inside
// the group, rounds both to bf16 and codes against the rounded values (so
// codes and stored statistics agree, as in quantize_kv), packs its lane's
// codes (kv4: low nibble first, as core/packing.py) and stores them with
// one coalesced row store; the group's first lane stores the two
// statistics.  The statistics are reduced in another order than torch.mean
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
constexpr int VEC = 4;
constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 4096;
constexpr int MAX_K = 256;

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float bf16_bits_to_f(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ uint32_t f_to_bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
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
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  uint2 o;
  o.x = f_to_bf16_bits(v[0]) | (f_to_bf16_bits(v[1]) << 16);
  o.y = f_to_bf16_bits(v[2]) | (f_to_bf16_bits(v[3]) << 16);
  *reinterpret_cast<uint2*>(p) = o;
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Position of a flat element: its group g, its offset in the group, its
// column; advanced one element at a time.
struct Pos {
  int64_t g, rem;
  int col;
  __device__ __forceinline__ Pos(int64_t i, int64_t rc, int c) {
    g = i / rc;
    rem = i - g * rc;
    col = (int)(rem % c);
  }
  __device__ __forceinline__ void next(int64_t rc, int c) {
    if (++col == c) col = 0;
    if (++rem == rc) {
      rem = 0;
      ++g;
    }
  }
  __device__ __forceinline__ int64_t stat(int per_col, int c) const {
    return per_col ? g * c + col : g;
  }
};

__device__ __forceinline__ int quant_elem(float w, float mu, float sigma,
                                          float kf, float kmax, int offset) {
  const float z = __fdiv_rn(__fsub_rn(w, mu), sigma);
  const float u = clampf(
      __fmul_rn(0.5f, __fadd_rn(1.0f, erff(__fmul_rn(z, RSQRT2)))), EPS,
      ONE_MINUS_EPS);
  return (int)clampf(floorf(__fmul_rn(u, kf)), 0.0f, kmax) - offset;
}

template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS)
quant_kernel(const T* __restrict__ w, const float* __restrict__ mu,
             const float* __restrict__ sigma, int8_t* __restrict__ out,
             int64_t n, int64_t rc, int c, int per_col, int k) {
  const float kf = (float)k;
  const float kmax = (float)(k - 1);
  const int offset = k == 256 ? 128 : 0;
  const int64_t n_runs = (n + VEC - 1) / VEC;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t run = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       run < n_runs; run += stride) {
    const int64_t i0 = run * VEC;
    const bool full = VECTOR && i0 + VEC <= n;
    float wv[VEC];
    int cv[VEC];
    if (full) {
      load4(w + i0, wv);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        wv[j] = i0 + j < n ? to_f(w[i0 + j]) : 0.0f;
    }
    Pos pos(i0, rc, c);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      cv[j] = 0;
      if (i0 + j < n) {
        const int64_t s = pos.stat(per_col, c);
        cv[j] = quant_elem(wv[j], __ldg(mu + s), __ldg(sigma + s), kf, kmax,
                           offset);
        pos.next(rc, c);
      }
    }
    if (full) {
      *reinterpret_cast<uint32_t*>(out + i0) =
          ((uint32_t)(uint8_t)cv[0]) | ((uint32_t)(uint8_t)cv[1] << 8) |
          ((uint32_t)(uint8_t)cv[2] << 16) | ((uint32_t)(uint8_t)cv[3] << 24);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        if (i0 + j < n) out[i0 + j] = (int8_t)cv[j];
    }
  }
}

// PACKED: two 4-bit codes per byte (element 2i in the low nibble of byte
// i); else one int8 code per byte carrying the k == 256 storage offset.
template <typename T, bool PACKED, bool VECTOR>
__global__ void __launch_bounds__(THREADS)
dequant_kernel(const uint8_t* __restrict__ codes,
               const float* __restrict__ mu, const float* __restrict__ sigma,
               const float* __restrict__ table, T* __restrict__ out,
               int64_t n, int64_t rc, int c, int per_col, int k) {
  __shared__ float s_table[MAX_K];
  for (int i = threadIdx.x; i < k; i += blockDim.x) s_table[i] = table[i];
  __syncthreads();
  const int offset = k == 256 ? 128 : 0;
  const int kmask = k - 1;                 // k is a power of two
  const int64_t n_runs = (n + VEC - 1) / VEC;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t run = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       run < n_runs; run += stride) {
    const int64_t i0 = run * VEC;
    const bool full = VECTOR && i0 + VEC <= n;
    int idx[VEC];
    if (PACKED) {
      uint32_t bits = 0;
      if (full) {
        bits = *reinterpret_cast<const uint16_t*>(codes + i0 / 2);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; j += 2)
          if (i0 + j < n) bits |= (uint32_t)codes[(i0 + j) / 2] << (4 * j);
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) idx[j] = (bits >> (4 * j)) & 0xF;
    } else {
      uint32_t bits = 0;
      if (full) {
        bits = *reinterpret_cast<const uint32_t*>(codes + i0);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          if (i0 + j < n) bits |= (uint32_t)codes[i0 + j] << (8 * j);
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        idx[j] = (int)(int8_t)((bits >> (8 * j)) & 0xFF) + offset;
    }
    float ov[VEC];
    Pos pos(i0, rc, c);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      ov[j] = 0.0f;
      if (i0 + j < n) {
        const int64_t s = pos.stat(per_col, c);
        // separate multiply and add: the plain version's rounding
        ov[j] = __fadd_rn(__ldg(mu + s),
                          __fmul_rn(__ldg(sigma + s), s_table[idx[j] & kmask]));
        pos.next(rc, c);
      }
    }
    if (full) {
      store4(out + i0, ov);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        if (i0 + j < n) store1(out + i0 + j, ov[j]);
    }
  }
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

unsigned grid_for(int64_t n) {
  const int64_t runs = (n + VEC - 1) / VEC;
  const int64_t blocks = (runs + THREADS - 1) / THREADS;
  return (unsigned)(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
}

template <typename T>
int quant(const void* w, const float* mu, const float* sigma, int per_col,
          int8_t* out, int k, int64_t n, int64_t rc, int c,
          cudaStream_t stream) {
  const T* wp = static_cast<const T*>(w);
  const bool vec = aligned(w, VEC * sizeof(T)) && aligned(out, VEC);
  const unsigned blocks = grid_for(n);
  if (vec)
    quant_kernel<T, true><<<blocks, THREADS, 0, stream>>>(
        wp, mu, sigma, out, n, rc, c, per_col, k);
  else
    quant_kernel<T, false><<<blocks, THREADS, 0, stream>>>(
        wp, mu, sigma, out, n, rc, c, per_col, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool PACKED>
int dequant(const uint8_t* codes, const float* mu, const float* sigma,
            int per_col, const float* table, void* out, int k, int64_t n,
            int64_t rc, int c, cudaStream_t stream) {
  T* op = static_cast<T*>(out);
  const bool vec = aligned(out, VEC * sizeof(T)) &&
                   aligned(codes, PACKED ? VEC / 2 : VEC);
  const unsigned blocks = grid_for(n);
  if (vec)
    dequant_kernel<T, PACKED, true><<<blocks, THREADS, 0, stream>>>(
        codes, mu, sigma, table, op, n, rc, c, per_col, k);
  else
    dequant_kernel<T, PACKED, false><<<blocks, THREADS, 0, stream>>>(
        codes, mu, sigma, table, op, n, rc, c, per_col, k);
  return static_cast<int>(cudaGetLastError());
}

// ---- the fused KV append ------------------------------------------------

constexpr int APPEND_THREADS = 256;

// VPL consecutive values of one lane: one or two 16-byte loads (f32), one
// 8- or 16-byte load (bf16)
template <int VPL>
__device__ __forceinline__ void load_lane(const float* p, float* o) {
  static_assert(VPL == 4 || VPL == 8, "VPL is 4 or 8");
#pragma unroll
  for (int j = 0; j < VPL; j += 4) load4(p + j, o + j);
}
template <int VPL>
__device__ __forceinline__ void load_lane(const __nv_bfloat16* p, float* o) {
  static_assert(VPL == 4 || VPL == 8, "VPL is 4 or 8");
  if constexpr (VPL == 8) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[2 * j] = bf16_bits_to_f(w[j] & 0xFFFFu);
      o[2 * j + 1] = bf16_bits_to_f(w[j] >> 16);
    }
  } else {
    load4(p, o);
  }
}

// sum over the LANES lanes of an aligned group of a warp; `mask` names
// exactly the group's lanes (a warp's other groups may have exited)
template <int LANES>
__device__ __forceinline__ float group_sum(float x, unsigned mask) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(mask, x, off));
  return x;
}

// One group of LANES lanes per (row, head, K or V); a warp holds 32 / LANES
// of them.  hd = LANES * VPL.  Codes: KV4 two per byte, else int8 with the
// k = 256 offset.  Statistics are stored as bf16 bits.
template <typename T, int VPL, int LANES, bool KV4>
__global__ void __launch_bounds__(APPEND_THREADS)
kv_append_kernel(const T* __restrict__ k, const T* __restrict__ v,
                 const int64_t* __restrict__ pages,
                 const int64_t* __restrict__ rows,
                 uint8_t* __restrict__ k_codes,
                 uint8_t* __restrict__ v_codes, uint16_t* __restrict__ k_mu,
                 uint16_t* __restrict__ k_sigma, uint16_t* __restrict__ v_mu,
                 uint16_t* __restrict__ v_sigma, int n_groups, int kv_heads,
                 long long n_pages, int page_size) {
  constexpr int HD = LANES * VPL;
  constexpr int CODE_BYTES = KV4 ? VPL / 2 : VPL;  // per lane
  const int t = blockIdx.x * APPEND_THREADS + threadIdx.x;
  const int group = t / LANES;
  const int lane = t % LANES;
  // a group never straddles a warp, and its lanes exit or stay together
  if (group >= n_groups) return;
  unsigned mask = 0xFFFFFFFFu;
  if constexpr (LANES < 32)
    mask = ((1u << LANES) - 1u) << ((threadIdx.x & 31) & ~(LANES - 1));
  const int which = group & 1;  // 0: K, 1: V
  const int rh = group >> 1;    // row * kv_heads + head
  const int n = rh / kv_heads;
  const int h = rh - n * kv_heads;
  float x[VPL];
  load_lane<VPL>((which ? v : k) + (int64_t)rh * HD + lane * VPL, x);

  float s = x[0];
#pragma unroll
  for (int j = 1; j < VPL; ++j) s = __fadd_rn(s, x[j]);
  const float mean = __fdiv_rn(group_sum<LANES>(s, mask), (float)HD);
  float q = 0.0f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const float d = __fsub_rn(x[j], mean);
    q = __fadd_rn(q, __fmul_rn(d, d));
  }
  float sd = __fsqrt_rn(__fdiv_rn(group_sum<LANES>(q, mask), (float)HD));
  sd = sd < 1e-8f ? 1e-8f : sd;  // torch.clamp(min=): NaN stays NaN
  const uint32_t mu_b = f_to_bf16_bits(mean);
  const uint32_t sd_b = f_to_bf16_bits(sd);
  const float mu_r = bf16_bits_to_f(mu_b);
  const float sd_r = bf16_bits_to_f(sd_b);

  const long long page = pages[n];
  const long long row = rows[n];
  if (page < 0 || page >= n_pages || row < 0 || row >= page_size) __trap();
  const int64_t slot = ((int64_t)page * page_size + row) * kv_heads + h;

  constexpr int K = KV4 ? 16 : 256;
  uint32_t packed[2] = {0u, 0u};  // CODE_BYTES <= 8
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = quant_elem(x[j], mu_r, sd_r, (float)K, (float)(K - 1),
                             KV4 ? 0 : 128);
    if (KV4) {
      const int bit = 4 * j;  // element j: nibble j of the lane's bytes
      packed[bit / 32] |= (uint32_t)(c & 0xF) << (bit % 32);
    } else {
      const int bit = 8 * j;
      packed[bit / 32] |= (uint32_t)(uint8_t)c << (bit % 32);
    }
  }
  uint8_t* dst = (which ? v_codes : k_codes) + slot * (KV4 ? HD / 2 : HD) +
                 lane * CODE_BYTES;
  if constexpr (CODE_BYTES == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
  } else if constexpr (CODE_BYTES == 4) {
    *reinterpret_cast<uint32_t*>(dst) = packed[0];
  } else {
    static_assert(CODE_BYTES == 2, "2, 4 or 8 code bytes a lane");
    *reinterpret_cast<uint16_t*>(dst) = (uint16_t)packed[0];
  }
  if (lane == 0) {
    (which ? v_mu : k_mu)[slot] = (uint16_t)mu_b;
    (which ? v_sigma : k_sigma)[slot] = (uint16_t)sd_b;
  }
}

template <typename T, int VPL, int LANES>
int append(const void* k, const void* v, const int64_t* pages,
           const int64_t* rows, void* const* leaves, int kv4, int n_rows,
           int kv_heads, long long n_pages, int page_size,
           cudaStream_t stream) {
  const int n_groups = 2 * n_rows * kv_heads;
  const long long threads = (long long)n_groups * LANES;
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
  if (kv4)
    kv_append_kernel<T, VPL, LANES, true><<<blocks, APPEND_THREADS, 0,
                                           stream>>>(
        kp, vp, pages, rows, kc, vc, km, ks, vm, vs, n_groups, kv_heads,
        n_pages, page_size);
  else
    kv_append_kernel<T, VPL, LANES, false><<<blocks, APPEND_THREADS, 0,
                                            stream>>>(
        kp, vp, pages, rows, kc, vc, km, ks, vm, vs, n_groups, kv_heads,
        n_pages, page_size);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int append_hd(int hd, const void* k, const void* v, const int64_t* pages,
              const int64_t* rows, void* const* leaves, int kv4, int n_rows,
              int kv_heads, long long n_pages, int page_size,
              cudaStream_t stream) {
  switch (hd) {
    case 16:
      return append<T, 4, 4>(k, v, pages, rows, leaves, kv4, n_rows,
                             kv_heads, n_pages, page_size, stream);
    case 32:
      return append<T, 4, 8>(k, v, pages, rows, leaves, kv4, n_rows,
                             kv_heads, n_pages, page_size, stream);
    case 64:
      return append<T, 4, 16>(k, v, pages, rows, leaves, kv4, n_rows,
                              kv_heads, n_pages, page_size, stream);
    case 128:
      return append<T, 4, 32>(k, v, pages, rows, leaves, kv4, n_rows,
                              kv_heads, n_pages, page_size, stream);
    case 256:
      return append<T, 8, 32>(k, v, pages, rows, leaves, kv4, n_rows,
                              kv_heads, n_pages, page_size, stream);
    default:
      return -6;
  }
}

int check_args(long long G, long long R, long long C, int k) {
  if (G <= 0 || R <= 0 || C <= 0) return -2;
  if (C > 0x7FFFFFFF) return -3;
  if (k < 2 || k > MAX_K || (k & (k - 1))) return -4;
  return 0;
}

}  // namespace

// Returns 0 on success, a cudaError_t value if the launch was refused, or a
// negative value for an argument the kernel does not take.
extern "C" int kquantile_quantize_launch(const void* w, int w_bf16,
                                         const float* mu, const float* sigma,
                                         int per_col, void* out, int k,
                                         long long G, long long R,
                                         long long C, void* stream_ptr) {
  const int rc_ok = check_args(G, R, C, k);
  if (rc_ok != 0) return rc_ok;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t n = (int64_t)G * R * C;
  const int64_t rc = (int64_t)R * C;
  int8_t* o = static_cast<int8_t*>(out);
  return w_bf16 ? quant<__nv_bfloat16>(w, mu, sigma, per_col, o, k, n, rc,
                                       (int)C, stream)
                : quant<float>(w, mu, sigma, per_col, o, k, n, rc, (int)C,
                               stream);
}

// `packed`: codes are (G, R, C/2) uint8, two 4-bit codes per byte (k <= 16,
// C even); else (G, R, C) int8.
extern "C" int kquantile_dequantize_launch(const void* codes, int packed,
                                           const float* mu,
                                           const float* sigma, int per_col,
                                           const float* table, void* out,
                                           int out_bf16, int k, long long G,
                                           long long R, long long C,
                                           void* stream_ptr) {
  const int rc_ok = check_args(G, R, C, k);
  if (rc_ok != 0) return rc_ok;
  if (packed && (k > 16 || (C % 2))) return -5;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t n = (int64_t)G * R * C;
  const int64_t rc = (int64_t)R * C;
  const uint8_t* cp = static_cast<const uint8_t*>(codes);
  if (packed)
    return out_bf16 ? dequant<__nv_bfloat16, true>(cp, mu, sigma, per_col,
                                                   table, out, k, n, rc,
                                                   (int)C, stream)
                    : dequant<float, true>(cp, mu, sigma, per_col, table, out,
                                           k, n, rc, (int)C, stream);
  return out_bf16 ? dequant<__nv_bfloat16, false>(cp, mu, sigma, per_col,
                                                  table, out, k, n, rc,
                                                  (int)C, stream)
                  : dequant<float, false>(cp, mu, sigma, per_col, table, out,
                                          k, n, rc, (int)C, stream);
}

// The fused KV append.  k, v: (n_rows, kv_heads, hd) contiguous, f32 or
// bf16 (`kv_bf16`); pages, rows: (n_rows,) int64 destinations; leaves: the
// six contiguous pool leaves of one layer in the order k_codes, k_mu,
// k_sigma, v_codes, v_mu, v_sigma -- codes (n_pages, page_size, kv_heads,
// hd) int8 (kv8) or (.., hd / 2) uint8 (kv4), statistics (n_pages,
// page_size, kv_heads) bf16.  hd is 16, 32, 64, 128 or 256.
extern "C" int kv_append_launch(const void* k, const void* v, int kv_bf16,
                                const void* pages, const void* rows,
                                void* k_codes, void* k_mu, void* k_sigma,
                                void* v_codes, void* v_mu, void* v_sigma,
                                int kv_bits, int n_rows, int kv_heads, int hd,
                                long long n_pages, int page_size,
                                void* stream_ptr) {
  if (n_rows <= 0 || kv_heads <= 0 || n_pages <= 0 || page_size <= 0)
    return -2;
  if (kv_bits != 4 && kv_bits != 8) return -4;
  if ((long long)n_rows * kv_heads * 2 * 32 > 0x7FFFFFFFLL) return -3;
  void* leaves[6] = {k_codes, k_mu, k_sigma, v_codes, v_mu, v_sigma};
  const int64_t* pp = static_cast<const int64_t*>(pages);
  const int64_t* rp = static_cast<const int64_t*>(rows);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int kv4 = kv_bits == 4;
  return kv_bf16 ? append_hd<__nv_bfloat16>(hd, k, v, pp, rp, leaves, kv4,
                                            n_rows, kv_heads, n_pages,
                                            page_size, stream)
                 : append_hd<float>(hd, k, v, pp, rp, leaves, kv4, n_rows,
                                    kv_heads, n_pages, page_size, stream);
}
