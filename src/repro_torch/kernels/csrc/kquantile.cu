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
