// UNIQ noise-injection / freeze transform and its gradient, for sm_90a.
//
// Forward, per element of w (G, R, C), with mode m = mode[g] of its group:
//   z = (w - mu) / sigma,   u = clip(Phi(z), eps, 1 - eps)
//   NOISE : w_hat = mu + sigma * sqrt2 * erfinv(2 clip(u + (e01 - 1/2)/k) - 1)
//   FROZEN: w_hat = mu + sigma * table[clip(floor(u k), 0, k - 1)]
//   CLEAN : w_hat = w
// Backward, from (g, w, w_hat) alone (the noise is not kept):
//   dw = g * { NOISE : exp(clip((zh^2 - z^2) / 2, -30, 30)), 0 where
//                      |zh| >= 4.75 (u + e sat on its clamp);
//              CLEAN : 1;   FROZEN : 0 }
// with zh = (w_hat - mu) / sigma and the factor rounded to g's type first.
//
// Replaces the TPU kernels `uniq_noise_fwd` and `uniq_noise_fwd_onchip` of
// src/repro/kernels/uniq_noise.py (`_kernel_host`, `_kernel_onchip`, `_body`)
// and the jnp backward `_uniq_bwd` of src/repro/kernels/ops.py.
//
// Noise: the forward takes e01 either as an operand (G, R, C) f32, or draws
// it inside the kernel (`uniq_noise_fwd_onchip_launch`) from a counter-based
// Philox4x32-10 keyed by the leaf's 64-bit key (two u32 words): element i of
// the leaf (flat index in storage order) is output lane i % 4 of counter
// (i / 4, 0) -- the 64-bit run index in the low two words, zero in the
// other two -- and e01 = (x >> 8) * 2^-24.  The bits depend on (key, i)
// only: not on the grid, the block size, the (G, R, C) grouping or the
// device, so the plain version (ref.philox4x32_10 / ref.onchip_e01)
// reproduces them.  The TPU kernel seeds its hardware PRNG per grid tile, so
// its bits depend on the tiling; that is not carried over.
//
// Statistics are (G, 1, C) (per column) or
// (G, 1, 1) (per group); `table` holds the k standardized levels
// Phi^-1((c + 1/2) / k), built once by the caller, so FROZEN runs no erfinv.
//
// What bounds it: bytes.  The forward reads w and e01 and writes w_hat (12 B
// per f32 element; 8 B with the draw on chip), the backward reads g, w, w_hat
// and writes dw (16 B); the per-element arithmetic (erff + erfinvf, or expf,
// and a dozen operations; Philox adds ten rounds of two 32-bit multiplies
// per run of 4, about 15 integer operations an element) stays under the
// memory time, if few instructions are spent around it.  What the flat body
// does about it: one grid-stride pass in which a thread takes runs of 4
// consecutive elements
// with 16-byte loads (8-byte for bf16 weights) and a scalar tail; the group
// and column of a run's first element are computed once and advanced element
// by element, so any C works -- the LM head's 49155 columns included -- and
// no padded copy is made.  The mode is read per element from the device
// array (an L1 hit; no host sync), the statistics by column or by group.
//
// Two bodies for the forward, picked by the caller's fixed rule on the shape
// (kernels/uniq_noise.py:onchip_route), never on a failure:
// - `uniq_fwd_group_kernel`, for per-group statistics with R C a multiple
//   of 4 below 2^31 (how both trainers call it): blockIdx.y is the group,
//   whose mode, mu and sigma are loaded once into registers; offsets inside
//   the group are 32-bit; the mode's branch is uniform across the block, so
//   CLEAN is a 16-byte copy, FROZEN the table path with no draw, and only
//   NOISE runs Philox.  The counter is still the global run index, so the
//   draw is the same bits as the flat body's and the plain version's.  The
//   flat body, issue-bound on its 64-bit walk (two 64-bit divisions a run,
//   64-bit steps and three statistics loads an element) and on Philox for
//   CLEAN and FROZEN runs too, takes 1.6x this body's time at (8, 4096,
//   12800) all NOISE on the H100 (PERF.md section 6).
// - `uniq_fwd_kernel`, the flat body below, for every other shape.
// A mode may also be given by value (`mode_value` >= 0, one mode for every
// group): nothing is read from, or copied to, the device for it.
//
// Bit-exactness: every step is one correctly rounded f32 operation
// (__fmul_rn / __fdiv_rn / __fadd_rn / __fsub_rn, which nvcc does not
// contract into FMAs) in the order of the plain version
// (ref.uniq_transform_ref / ref.uniq_grad_ref), so FROZEN outputs equal the
// plain version's wherever erff equals torch's erf, and NOISE differs only by
// erfinvf against torch's own erfinv.
//
// Plain C interface; the caller allocates every buffer and passes the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CLEAN = 0;
constexpr int NOISE = 1;
constexpr float EPS = 1e-6f;
constexpr float ONE_MINUS_EPS = 0.999999f;
constexpr float SQRT2 = 1.4142135623730951f;
constexpr float RSQRT2 = 0.7071067811865476f;
constexpr float RAIL_Z = 4.75f;
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

// value of a T as f32, and f32 rounded to T
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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

// Philox4x32-10 (Salmon et al., SC'11), written out: ten rounds of two
// 32 x 32 -> 64-bit multiplies, the key bumped by the Weyl constants between
// rounds.  Random123's known-answer vectors are pinned by the CPU tests
// against ref.philox4x32_10, which does the same arithmetic in int64.
constexpr uint32_t PHILOX_M0 = 0xD2511F53u;
constexpr uint32_t PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u;
constexpr uint32_t PHILOX_W1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += PHILOX_W0;
      k1 += PHILOX_W1;
    }
    const uint32_t hi0 = __umulhi(PHILOX_M0, c.x);
    const uint32_t lo0 = PHILOX_M0 * c.x;
    const uint32_t hi1 = __umulhi(PHILOX_M1, c.z);
    const uint32_t lo1 = PHILOX_M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// the top 24 bits as a float in [0, 1): exact (x >> 8 < 2^24)
__device__ __forceinline__ float bits_to_e01(uint32_t x) {
  return (float)(x >> 8) * 5.9604644775390625e-8f;  // 2^-24
}

// The forward's two noise sources.  run(r, ...) gives e01 of run r, elements
// 4r .. 4r + 3; lanes at or past n are never used.
struct NoiseOperand {  // e01 read from device memory
  const float* e01;
  __device__ __forceinline__ void run(int64_t r, int64_t n, bool full,
                                      float* ev) const {
    const int64_t i0 = r * VEC;
    if (full) {
      load4(e01 + i0, ev);
      return;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) ev[j] = i0 + j < n ? e01[i0 + j] : 0.5f;
  }
};

struct NoisePhilox {  // e01 drawn in the kernel, keyed by the leaf key
  uint32_t k0, k1;
  __device__ __forceinline__ void run(int64_t r, int64_t, bool,
                                      float* ev) const {
    const uint4 b = philox4x32_10(
        make_uint4((uint32_t)r, (uint32_t)((uint64_t)r >> 32), 0u, 0u), k0,
        k1);
    ev[0] = bits_to_e01(b.x);
    ev[1] = bits_to_e01(b.y);
    ev[2] = bits_to_e01(b.z);
    ev[3] = bits_to_e01(b.w);
  }
};

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

// u = clip(Phi((w - mu) / sigma), eps, 1 - eps)
__device__ __forceinline__ float u_of(float w, float mu, float sigma) {
  const float z = __fdiv_rn(__fsub_rn(w, mu), sigma);
  return clampf(__fmul_rn(0.5f, __fadd_rn(1.0f, erff(__fmul_rn(z, RSQRT2)))),
                EPS, ONE_MINUS_EPS);
}

__device__ __forceinline__ float noise_elem(float u, float mu, float sigma,
                                            float e01, float inv_k) {
  const float un = clampf(
      __fadd_rn(u, __fmul_rn(__fsub_rn(e01, 0.5f), inv_k)), EPS,
      ONE_MINUS_EPS);
  const float x = __fsub_rn(__fmul_rn(2.0f, un), 1.0f);
  return __fadd_rn(mu, __fmul_rn(sigma, __fmul_rn(SQRT2, erfinvf(x))));
}

__device__ __forceinline__ float frozen_elem(float u, float mu, float sigma,
                                             float kf, float kmax,
                                             const float* s_table) {
  const float c = clampf(floorf(__fmul_rn(u, kf)), 0.0f, kmax);
  return __fadd_rn(mu, __fmul_rn(sigma, s_table[(int)c]));
}

__device__ __forceinline__ float fwd_elem(float w, float mu, float sigma,
                                          float e01, int mode, float kf,
                                          float inv_k, float kmax,
                                          const float* s_table) {
  if (mode == CLEAN) return w;
  const float u = u_of(w, mu, sigma);
  if (mode == NOISE) return noise_elem(u, mu, sigma, e01, inv_k);
  return frozen_elem(u, mu, sigma, kf, kmax, s_table);
}

// the mode of group g: by value when given one, else from the device array
__device__ __forceinline__ int mode_of(const int* mode, int mode_value,
                                       int64_t g) {
  return mode_value >= 0 ? mode_value : __ldg(mode + g);
}

// One body for both noise sources, so CLEAN and FROZEN run the same
// instructions whichever source the caller picks.
template <typename T, bool VECTOR, typename Noise>
__global__ void __launch_bounds__(THREADS)
uniq_fwd_kernel(const T* __restrict__ w, const Noise noise,
                const float* __restrict__ mu, const float* __restrict__ sigma,
                const int* __restrict__ mode, int mode_value,
                const float* __restrict__ table, T* __restrict__ out,
                int64_t n, int64_t rc, int c, int per_col, int k) {
  __shared__ float s_table[MAX_K];
  for (int i = threadIdx.x; i < k; i += blockDim.x) s_table[i] = table[i];
  __syncthreads();
  const float kf = (float)k;
  const float inv_k = 1.0f / kf;  // exact: k is a power of two
  const float kmax = (float)(k - 1);
  const int64_t n_runs = (n + VEC - 1) / VEC;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t run = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       run < n_runs; run += stride) {
    const int64_t i0 = run * VEC;
    const bool full = VECTOR && i0 + VEC <= n;
    float wv[VEC], ev[VEC], ov[VEC];
    if (full) {
      load4(w + i0, wv);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        wv[j] = i0 + j < n ? to_f(w[i0 + j]) : 0.0f;
    }
    noise.run(run, n, full, ev);
    Pos pos(i0, rc, c);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (i0 + j < n) {
        const int64_t s = pos.stat(per_col, c);
        ov[j] = fwd_elem(wv[j], __ldg(mu + s), __ldg(sigma + s), ev[j],
                         mode_of(mode, mode_value, pos.g), kf, inv_k, kmax,
                         s_table);
        pos.next(rc, c);
      }
    }
    if (full) {
      store4(out + i0, ov);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        if (i0 + j < n) out[i0 + j] = from_f<T>(ov[j]);
    }
  }
}

// four raw elements (a CLEAN copy keeps every bit, NaN payloads included)
__device__ __forceinline__ void copy4(const float* src, float* dst) {
  *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
}
__device__ __forceinline__ void copy4(const __nv_bfloat16* src,
                                      __nv_bfloat16* dst) {
  *reinterpret_cast<uint2*>(dst) = __ldg(reinterpret_cast<const uint2*>(src));
}

// Per-group statistics, R C a multiple of 4 below 2^31: group blockIdx.y,
// runs of 4 within it by a 32-bit grid-stride loop over blockIdx.x.  The
// mode is uniform across the block, so are its branches (and the FROZEN
// branch's barrier).  VECTOR: w, out (and an e01 operand) 16-byte aligned
// (8-byte for bf16 w); else element loads and stores.
template <typename T, bool VECTOR, typename Noise>
__global__ void __launch_bounds__(THREADS)
uniq_fwd_group_kernel(const T* __restrict__ w, const Noise noise,
                      const float* __restrict__ mu,
                      const float* __restrict__ sigma,
                      const int* __restrict__ mode, int mode_value,
                      const float* __restrict__ table, T* __restrict__ out,
                      int64_t n, int rc, int k) {
  const int g = blockIdx.y;
  const int m = mode_of(mode, mode_value, g);
  const int64_t base = (int64_t)g * rc;
  const T* wg = w + base;
  T* og = out + base;
  const int64_t run0 = base / VEC;  // the group's first global run
  const int runs = rc / VEC;
  const int stride = gridDim.x * THREADS;
  const int first = blockIdx.x * THREADS + threadIdx.x;
  if (m == CLEAN) {
    for (int r = first; r < runs; r += stride) {
      if (VECTOR) {
        copy4(wg + r * VEC, og + r * VEC);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) og[r * VEC + j] = wg[r * VEC + j];
      }
    }
    return;
  }
  const float mu_g = __ldg(mu + g);
  const float sd_g = __ldg(sigma + g);
  const float kf = (float)k;
  const float inv_k = 1.0f / kf;  // exact: k is a power of two
  const float kmax = (float)(k - 1);
  float wv[VEC], ov[VEC];
  if (m == NOISE) {
    for (int r = first; r < runs; r += stride) {
      float ev[VEC];
      if (VECTOR) {
        load4(wg + r * VEC, wv);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) wv[j] = to_f(wg[r * VEC + j]);
      }
      noise.run(run0 + r, n, VECTOR, ev);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        ov[j] = noise_elem(u_of(wv[j], mu_g, sd_g), mu_g, sd_g, ev[j], inv_k);
      if (VECTOR) {
        store4(og + r * VEC, ov);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) og[r * VEC + j] = from_f<T>(ov[j]);
      }
    }
    return;
  }
  __shared__ float s_table[MAX_K];  // FROZEN
  for (int i = threadIdx.x; i < k; i += THREADS) s_table[i] = table[i];
  __syncthreads();
  for (int r = first; r < runs; r += stride) {
    if (VECTOR) {
      load4(wg + r * VEC, wv);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) wv[j] = to_f(wg[r * VEC + j]);
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      ov[j] = frozen_elem(u_of(wv[j], mu_g, sd_g), mu_g, sd_g, kf, kmax,
                          s_table);
    if (VECTOR) {
      store4(og + r * VEC, ov);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) og[r * VEC + j] = from_f<T>(ov[j]);
    }
  }
}

__device__ __forceinline__ float bwd_factor(float w, float wh, float mu,
                                            float sigma, int mode) {
  if (mode != NOISE) return mode == CLEAN ? 1.0f : 0.0f;
  const float z = __fdiv_rn(__fsub_rn(w, mu), sigma);
  const float zh = __fdiv_rn(__fsub_rn(wh, mu), sigma);
  const float d = clampf(
      __fmul_rn(0.5f, __fsub_rn(__fmul_rn(zh, zh), __fmul_rn(z, z))), -30.0f,
      30.0f);
  return fabsf(zh) >= RAIL_Z ? 0.0f : expf(d);
}

template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS)
uniq_bwd_kernel(const T* __restrict__ g, const T* __restrict__ w,
                const T* __restrict__ w_hat, const float* __restrict__ mu,
                const float* __restrict__ sigma, const int* __restrict__ mode,
                int mode_value, T* __restrict__ dw, int64_t n, int64_t rc,
                int c, int per_col) {
  const int64_t n_runs = (n + VEC - 1) / VEC;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t run = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       run < n_runs; run += stride) {
    const int64_t i0 = run * VEC;
    const bool full = VECTOR && i0 + VEC <= n;
    float gv[VEC], wv[VEC], hv[VEC], ov[VEC];
    if (full) {
      load4(g + i0, gv);
      load4(w + i0, wv);
      load4(w_hat + i0, hv);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const bool in = i0 + j < n;
        gv[j] = in ? to_f(g[i0 + j]) : 0.0f;
        wv[j] = in ? to_f(w[i0 + j]) : 0.0f;
        hv[j] = in ? to_f(w_hat[i0 + j]) : 0.0f;
      }
    }
    Pos pos(i0, rc, c);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (i0 + j < n) {
        const int64_t s = pos.stat(per_col, c);
        const float f = bwd_factor(wv[j], hv[j], __ldg(mu + s),
                                   __ldg(sigma + s),
                                   mode_of(mode, mode_value, pos.g));
        // the factor is rounded to g's type first, then the product
        ov[j] = __fmul_rn(gv[j], to_f(from_f<T>(f)));
        pos.next(rc, c);
      }
    }
    if (full) {
      store4(dw + i0, ov);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        if (i0 + j < n) dw[i0 + j] = from_f<T>(ov[j]);
    }
  }
}

int check_shape(long long G, long long R, long long C) {
  if (G <= 0 || R <= 0 || C <= 0) return -2;
  if (C > 0x7FFFFFFF) return -3;
  return 0;
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

unsigned grid_for(int64_t n) {
  const int64_t runs = (n + VEC - 1) / VEC;
  const int64_t blocks = (runs + THREADS - 1) / THREADS;
  return (unsigned)(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
}

bool noise_aligned(const NoiseOperand& s) {
  return aligned(s.e01, VEC * sizeof(float));
}
bool noise_aligned(const NoisePhilox&) { return true; }

// What a forward launch takes beside its operands: the body (`group`: the
// per-group body, else the flat one) and a mode by value (or -1).
struct FwdArgs {
  const float* mu;
  const float* sigma;
  int per_col;
  const int* mode;
  int mode_value;
  const float* table;
  int k;
  int group;
};

template <typename T, typename Noise>
int fwd(const void* w, Noise noise, const FwdArgs& a, void* out, int64_t G,
        int64_t n, int64_t rc, int c, cudaStream_t stream) {
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  const bool vec = aligned(w, VEC * sizeof(T)) && aligned(out, VEC * sizeof(T))
                   && noise_aligned(noise);
  if (a.group) {
    // the rule of onchip_route, checked again: per-group statistics, R C a
    // multiple of 4 below 2^31, G within the grid's y limit
    if (a.per_col || rc % VEC || rc > 0x7FFFFFFF || G > 65535) return -5;
    const int64_t per_group = (rc / VEC + THREADS - 1) / THREADS;
    const int64_t cap = MAX_BLOCKS / G > 0 ? MAX_BLOCKS / G : 1;
    const dim3 grid((unsigned)(per_group < cap ? per_group : cap),
                    (unsigned)G);
    if (vec)
      uniq_fwd_group_kernel<T, true, Noise><<<grid, THREADS, 0, stream>>>(
          wp, noise, a.mu, a.sigma, a.mode, a.mode_value, a.table, op, n,
          (int)rc, a.k);
    else
      uniq_fwd_group_kernel<T, false, Noise><<<grid, THREADS, 0, stream>>>(
          wp, noise, a.mu, a.sigma, a.mode, a.mode_value, a.table, op, n,
          (int)rc, a.k);
    return static_cast<int>(cudaGetLastError());
  }
  const unsigned blocks = grid_for(n);
  if (vec)
    uniq_fwd_kernel<T, true, Noise><<<blocks, THREADS, 0, stream>>>(
        wp, noise, a.mu, a.sigma, a.mode, a.mode_value, a.table, op, n, rc,
        c, a.per_col, a.k);
  else
    uniq_fwd_kernel<T, false, Noise><<<blocks, THREADS, 0, stream>>>(
        wp, noise, a.mu, a.sigma, a.mode, a.mode_value, a.table, op, n, rc,
        c, a.per_col, a.k);
  return static_cast<int>(cudaGetLastError());
}

template <typename Noise>
int fwd_any(const void* w, int w_bf16, Noise noise, const FwdArgs& a,
            void* out, long long G, long long R, long long C,
            void* stream_ptr) {
  const int rc_ok = check_shape(G, R, C);
  if (rc_ok != 0) return rc_ok;
  if (a.k < 2 || a.k > MAX_K || (a.k & (a.k - 1))) return -4;
  if (a.mode_value > 2 || (a.mode_value < 0 && a.mode == nullptr)) return -6;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t n = (int64_t)G * R * C;
  const int64_t rc = (int64_t)R * C;
  return w_bf16 ? fwd<__nv_bfloat16>(w, noise, a, out, G, n, rc, (int)C,
                                     stream)
                : fwd<float>(w, noise, a, out, G, n, rc, (int)C, stream);
}

// e01 of a key alone: the on-chip draw read back, for its bit-for-bit check
__global__ void __launch_bounds__(THREADS)
onchip_e01_kernel(const NoisePhilox noise, float* __restrict__ out,
                  int64_t n) {
  const int64_t n_runs = (n + VEC - 1) / VEC;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t run = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       run < n_runs; run += stride) {
    float ev[VEC];
    noise.run(run, n, true, ev);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if (run * VEC + j < n) out[run * VEC + j] = ev[j];
  }
}

template <typename T>
int bwd(const void* g, const void* w, const void* w_hat, const float* mu,
        const float* sigma, int per_col, const int* mode, int mode_value,
        void* dw, int64_t n, int64_t rc, int c, cudaStream_t stream) {
  const int a = VEC * sizeof(T);
  const bool vec = aligned(g, a) && aligned(w, a) && aligned(w_hat, a) &&
                   aligned(dw, a);
  const unsigned blocks = grid_for(n);
  if (vec)
    uniq_bwd_kernel<T, true><<<blocks, THREADS, 0, stream>>>(
        static_cast<const T*>(g), static_cast<const T*>(w),
        static_cast<const T*>(w_hat), mu, sigma, mode, mode_value,
        static_cast<T*>(dw), n, rc, c, per_col);
  else
    uniq_bwd_kernel<T, false><<<blocks, THREADS, 0, stream>>>(
        static_cast<const T*>(g), static_cast<const T*>(w),
        static_cast<const T*>(w_hat), mu, sigma, mode, mode_value,
        static_cast<T*>(dw), n, rc, c, per_col);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `group`: the per-group body (the caller's onchip_route); `mode_value`: one
// mode for every group by value, or -1 to read `mode` (G,) int32.
extern "C" int uniq_noise_fwd_launch(const void* w, int w_bf16,
                                     const float* e01, const float* mu,
                                     const float* sigma, int per_col,
                                     const int* mode, int mode_value,
                                     const float* table, void* out, int k,
                                     int group, long long G, long long R,
                                     long long C, void* stream_ptr) {
  const FwdArgs a{mu, sigma, per_col, mode, mode_value, table, k, group};
  return fwd_any(w, w_bf16, NoiseOperand{e01}, a, out, G, R, C, stream_ptr);
}

extern "C" int uniq_noise_fwd_onchip_launch(
    const void* w, int w_bf16, unsigned key_lo, unsigned key_hi,
    const float* mu, const float* sigma, int per_col, const int* mode,
    int mode_value, const float* table, void* out, int k, int group,
    long long G, long long R, long long C, void* stream_ptr) {
  const FwdArgs a{mu, sigma, per_col, mode, mode_value, table, k, group};
  return fwd_any(w, w_bf16, NoisePhilox{key_lo, key_hi}, a, out, G, R, C,
                 stream_ptr);
}

extern "C" int uniq_noise_onchip_e01_launch(float* out, long long n,
                                            unsigned key_lo, unsigned key_hi,
                                            void* stream_ptr) {
  if (n <= 0) return -2;
  onchip_e01_kernel<<<grid_for(n), THREADS, 0,
                      static_cast<cudaStream_t>(stream_ptr)>>>(
      NoisePhilox{key_lo, key_hi}, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int uniq_noise_bwd_launch(const void* g, const void* w,
                                     const void* w_hat, int bf16,
                                     const float* mu, const float* sigma,
                                     int per_col, const int* mode,
                                     int mode_value, void* dw, long long G,
                                     long long R, long long C,
                                     void* stream_ptr) {
  const int rc_ok = check_shape(G, R, C);
  if (rc_ok != 0) return rc_ok;
  if (mode_value > 2 || (mode_value < 0 && mode == nullptr)) return -6;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t n = (int64_t)G * R * C;
  const int64_t rc = (int64_t)R * C;
  return bf16 ? bwd<__nv_bfloat16>(g, w, w_hat, mu, sigma, per_col, mode,
                                   mode_value, dw, n, rc, (int)C, stream)
              : bwd<float>(g, w, w_hat, mu, sigma, per_col, mode, mode_value,
                           dw, n, rc, (int)C, stream);
}
