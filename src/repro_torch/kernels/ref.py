"""Plain PyTorch codec shared by every module of the port.

k-quantile codes, the k-entry level table and the analytic dequant: what the
CPU tests hold against the JAX reference, and what the kernels' plain
versions (each beside its kernel, in ``qmatmul.py``, ``paged_attn.py``,
``kquantile.py`` and ``uniq_noise.py``) are built from; the oracles of the
codebook and int8-activation matmuls; plus the oracle of the UNIQ training
transform and its gradient.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import packing

_SQRT2 = 1.4142135623730951
# z / sqrt2 is taken as z * (1 / sqrt2) by Phi and the UNIQ transform: a
# product rounds alike on every device and in the CUDA kernels, a division
# by a Python scalar need not (PyTorch's CUDA kernel may multiply by the
# reciprocal)
_RSQRT2 = 0.7071067811865476
_EPS = 1e-6

CLEAN, NOISE, FROZEN = 0, 1, 2

# |z_hat| at which u + e sits on the [eps, 1 - eps] clamp (Phi^-1(1e-6) is
# -4.753): the transform is flat there, so its gradient is zero
_RAIL_Z = 4.75


def phi(z: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF via erf (the KV-row / kernel formulation).

    An f32 ``z`` on the CPU is taken through the f64 ``erf`` and rounded
    once to f32: the codes then floor an exact CDF and cannot move with the
    f32 ``erf`` routine a CPU process happens to run (one was seen ~2e-5
    off, enough to flip a code 2e-4 of a bin from its edge).  On the card
    the plain version stays f32, the formula of the codec kernels, so they
    stay bit-equal to it."""
    if z.device.type == "cpu" and z.dtype == torch.float32:
        return (0.5 * (1.0 + torch.erf(z.double() * _RSQRT2))).float()
    return 0.5 * (1.0 + torch.erf(z * _RSQRT2))


def phi_inv(u: torch.Tensor) -> torch.Tensor:
    """Standard normal quantile via erfinv."""
    return _SQRT2 * torch.erfinv(2.0 * u - 1.0)


def code_offset(k: int) -> int:
    """int8-stored codes are offset by -128 iff k == 256 (range fit)."""
    return 128 if k == 256 else 0


def kquantile_codes_ref(w: torch.Tensor, mu: torch.Tensor,
                        sigma: torch.Tensor, k: int) -> torch.Tensor:
    """weights -> int8 codes in [0, k) - code_offset(k)."""
    z = (w.to(torch.float32) - mu) / sigma
    u = torch.clamp(phi(z), _EPS, 1.0 - _EPS)
    c = torch.clamp(torch.floor(u * k), 0, k - 1) - code_offset(k)
    return c.to(torch.int8)


@functools.lru_cache(maxsize=None)
def _level_table_cpu(k: int) -> torch.Tensor:
    centers = torch.clamp(
        (torch.arange(k, dtype=torch.float32) + 0.5) / k, _EPS, 1 - _EPS)
    return phi_inv(centers)


_TABLES = {}


def level_table(k: int, device=None) -> torch.Tensor:
    """The k standardized levels  Phi^{-1}((c + 1/2) / k), c in [0, k).

    Always computed on the CPU and copied, so every device sees the same
    f32 values; cached per (k, device).  Treat the result as read-only.
    """
    key = (k, device)
    t = _TABLES.get(key)
    if t is None:
        t = _level_table_cpu(k)
        if device is not None and torch.device(device).type != "cpu":
            t = t.to(device)
        _TABLES[key] = t
    return t


_SPLITS = {}


def level_split(k: int, device=None) -> torch.Tensor:
    """The level table as three bf16 parts, (3, k): ``h = bf16(T)``,
    ``d = bf16(T - h)``, ``l = bf16(T - h - d)``, so that ``h + d + l`` is
    ``T`` (each difference is exact in f32, and three 8-bit significands
    cover T's 24).  A bf16 part times an int8 code is exact in f32: the
    tensor-core ``qmatmul_a8`` multiplies the codes by each part.  Built on
    the CPU from ``level_table`` and cached per (k, device); read-only."""
    key = (k, device)
    t = _SPLITS.get(key)
    if t is None:
        rest = level_table(k)
        parts = []
        for _ in range(3):
            part = rest.to(torch.bfloat16)
            parts.append(part)
            rest = rest - part.to(torch.float32)
        t = torch.stack(parts)
        if device is not None and torch.device(device).type != "cpu":
            t = t.to(device)
        _SPLITS[key] = t
    return t


def kquantile_dequant_ref(codes: torch.Tensor, mu: torch.Tensor,
                          sigma: torch.Tensor, k: int,
                          dtype=torch.bfloat16) -> torch.Tensor:
    """int codes -> analytic k-quantile levels  mu + sigma * table[c].

    Applies the int8 storage offset for k == 256 (see code_offset)."""
    idx = codes.to(torch.int64) + code_offset(k)
    return (mu + sigma * level_table(k, codes.device)[idx]).to(dtype)


def qmatmul_lut_ref(a: torch.Tensor, w_packed: torch.Tensor,
                    lut: torch.Tensor, bits: int,
                    out_dtype=torch.float32) -> torch.Tensor:
    """Oracle of the codebook-LUT dequant matmul: ``w[r, c] = lut[code[r,
    c], c]`` (int8 codes carry the k = 256 storage offset), then an f32
    product.

    a        : (M, K) activations
    w_packed : (K, N//2) uint8 (bits=4) or (K, N) int8 (bits=8)
    lut      : (k, N) f32 per-column levels, or (k,) one codebook for every
               column (the reference broadcasts it to (k, N) first)
    """
    k = 2 ** bits
    codes = packing.unpack_int4(w_packed) if bits == 4 else w_packed
    c = codes.to(torch.int64) + code_offset(k)
    lut = lut.to(torch.float32)
    w = lut[c] if lut.ndim == 1 else torch.gather(lut, 0, c)
    return (a.to(torch.float32) @ w).to(out_dtype)


def qmatmul_a8_ref(a_codes: torch.Tensor, a_scale: torch.Tensor,
                   w_packed: torch.Tensor, mu: torch.Tensor,
                   sigma: torch.Tensor, bits: int,
                   out_dtype=torch.float32) -> torch.Tensor:
    """Oracle of the W4/W8 x A8 matmul: ``(a_codes * a_scale) @ dequant(w)``
    in f32.  ``a_scale`` is a scalar (the reference's kernel) or (M, 1) per
    row (the reference's engine, ``lm.mm_a``)."""
    k = 2 ** bits
    a = a_codes.to(torch.float32) * a_scale
    codes = packing.unpack_int4(w_packed) if bits == 4 else w_packed
    w = kquantile_dequant_ref(codes, mu, sigma, k, dtype=torch.float32)
    return (a @ w).to(out_dtype)


def uniq_transform_ref(w: torch.Tensor, mu: torch.Tensor,
                       sigma: torch.Tensor, e01: torch.Tensor,
                       mode: torch.Tensor, k: int) -> torch.Tensor:
    """Fused UNIQ 3-way transform (oracle of the ``uniq_noise`` kernel).

    w     : (G, R, C) f32 or bf16 weights
    mu    : (G, 1, C) or (G, 1, 1) f32;  sigma : same shape
    e01   : (G, R, C) f32 U[0, 1) noise
    mode  : (G,) int32 in {CLEAN, NOISE, FROZEN}, on w's device

    CLEAN gives ``w``; NOISE ``F^-1(clip(F(w) + (e01 - 1/2) / k))``; FROZEN
    the bin centre ``mu + sigma * level_table(k)[floor(F(w) k)]``.  Every
    step is one f32 operation in the order the kernel performs it, so the
    two agree to the bit wherever ``erf`` does (FROZEN) and differ only by
    ``erfinv``'s implementation (NOISE).  ``1/k`` is exact: k is a power of
    two.  Each intermediate is freed once read for the last time: on the
    card a leaf of 1.4 G elements is 5.4 GiB a copy.
    """
    z = (w.to(torch.float32) - mu) / sigma
    u = torch.clamp(0.5 * (1.0 + torch.erf(z * _RSQRT2)), _EPS, 1.0 - _EPS)
    del z
    u_noise = torch.clamp(u + (e01 - 0.5) * (1.0 / k), _EPS, 1.0 - _EPS)
    codes = torch.clamp(torch.floor(u * k), 0, k - 1).to(torch.int64)
    del u
    frozen = mu + sigma * level_table(k, w.device)[codes]
    del codes
    noisy = mu + sigma * (_SQRT2 * torch.erfinv(2.0 * u_noise - 1.0))
    del u_noise
    m = mode.reshape(-1, 1, 1)
    w_hat = torch.where(m == NOISE, noisy, frozen).to(w.dtype)
    del noisy, frozen
    return torch.where(m == CLEAN, w, w_hat)


def uniq_grad_ref(g: torch.Tensor, w: torch.Tensor, w_hat: torch.Tensor,
                  mu: torch.Tensor, sigma: torch.Tensor,
                  mode: torch.Tensor) -> torch.Tensor:
    """Gradient of ``uniq_transform_ref`` with respect to ``w``, from (w,
    w_hat) alone (the noise is not kept): ``g * dw`` with

        NOISE  : pdf(z) / pdf(z_hat) = exp(clip((z_hat^2 - z^2) / 2, +-30)),
                 zero where |z_hat| >= 4.75 (u + e sat on its clamp);
        CLEAN  : 1;
        FROZEN : 0 (hard-quantized, stop-gradient).

    ``dw`` is rounded to g's dtype before the product, as the reference's
    custom VJP does."""
    z = (w.to(torch.float32) - mu) / sigma
    zh = (w_hat.to(torch.float32) - mu) / sigma
    ratio = torch.exp(torch.clamp(0.5 * (zh * zh - z * z), -30.0, 30.0))
    del z
    ratio = torch.where(zh.abs() >= _RAIL_Z, 0.0, ratio)
    del zh
    m = mode.reshape(-1, 1, 1)
    dw = torch.where(m == NOISE, ratio, (m == CLEAN).to(torch.float32))
    return g * dw.to(g.dtype)


# --------------------------------------------------------------------------
# The on-chip draw: Philox4x32-10, as the uniq_noise kernel computes it
# --------------------------------------------------------------------------

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of the 64-bit product of u32 values ``a``
    (held in int64) and the constant ``m``.  The product itself can reach
    2^64, past int64, so ``m`` is split into 16-bit halves: each partial
    product stays below 2^48 and no operation overflows."""
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _U32


def philox4x32_10(counter, key):
    """Philox4x32-10 (Salmon et al., SC'11): ``counter`` four u32 words
    (int64 tensors of one shape, or ints), ``key`` two u32 words (ints).
    Returns the four output words as int64 tensors in [0, 2^32).  The
    arithmetic of ``csrc/uniq_noise.cu:philox4x32_10`` in int64 torch ops,
    so it runs on any device and gives the kernel's bits."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = int(key[0]) & _U32, int(key[1]) & _U32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def key_words(key: int):
    """A 64-bit leaf key as its (low, high) u32 words."""
    key = int(key)
    return key & _U32, (key >> 32) & _U32


def onchip_e01(key: int, n: int, device=None) -> torch.Tensor:
    """The kernel's on-chip draw for a leaf of ``n`` elements, (n,) f32 in
    [0, 1): element i is lane i % 4 of Philox4x32-10 at counter
    (i / 4 as two u32 words, 0, 0) under ``key``, mapped by
    ``(x >> 8) * 2^-24`` (the reference's mapping); exact in f32."""
    runs = (n + 3) // 4
    r = torch.arange(runs, dtype=torch.int64, device=device)
    zero = torch.zeros_like(r)
    words = philox4x32_10((r & _U32, r >> 32, zero, zero), key_words(key))
    bits = torch.stack(words, dim=1).reshape(-1)[:n]
    return (bits >> 8).to(torch.float32) * 2.0 ** -24
