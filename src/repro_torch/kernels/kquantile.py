"""Deterministic k-quantile quantize / dequantize: CUDA kernels + plain
PyTorch versions.

Replaces the TPU kernels ``kquantile_quantize`` and ``kquantile_dequantize``
of ``src/repro/kernels/kquantile.py``.  The source is ``csrc/kquantile.cu``
(see its header for what bounds it and what the design does about that).
Both wrappers launch their kernel for CUDA tensors and take the plain
version only for CPU tensors.

Layout, as the reference's: values ``(G, R, C)``, statistics ``(G, 1, C)``
(per column) or ``(G, 1, 1)`` (per group) f32.  Codes are int8 (with the
k = 256 storage offset of ``ref.code_offset``); ``kquantile_dequantize``
also takes 4-bit codes packed two per byte, ``(G, R, C // 2)`` uint8, and
unpacks them inside the kernel.  Any R and C: there is no divisibility
condition.

``kv_append`` is the serving engine's KV append fused into one kernel
(``kv_append_kernel``): fresh K and V rows ``(N, KV, hd)`` are coded per
(row, head) against their bf16-rounded mean and population deviation and
written, with those statistics, into one layer of the paged pool at
``(pages, rows)``.  Its plain version ``kv_append_plain`` is ``kv_codes``
(also ``models/kv_cache.py:quantize_kv``'s plain version) followed by the
six index writes.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import packing
from repro_torch.kernels import loader
from repro_torch.kernels import ref as kref

_DTYPES = (torch.float32, torch.bfloat16)


def kquantile_quantize_plain(w, mu, sigma, *, k: int) -> torch.Tensor:
    """Plain version of the quantize kernel (``ref.kquantile_codes_ref``)."""
    return kref.kquantile_codes_ref(w, mu, sigma, k)


def kquantile_dequantize_plain(codes, mu, sigma, *, k: int,
                               out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of the dequantize kernel: unpack packed codes, then
    ``ref.kquantile_dequant_ref``."""
    if codes.dtype == torch.uint8:
        codes = packing.unpack_int4(codes)
    return kref.kquantile_dequant_ref(codes, mu, sigma, k, dtype=out_dtype)


# the pool leaves of one layer that a coded KV append writes, in the
# kernel's argument order
KV_LEAVES = ("k_codes", "k_mu", "k_sigma", "v_codes", "v_mu", "v_sigma")
# head dims the fused append takes (hd / 4 lanes of 4 values, or 32 lanes of
# 8 at 256): the engine's configs have 128 and 256, the small ones 16
KV_APPEND_HEAD_DIMS = (16, 32, 64, 128, 256)


def kv_row_stats(x: torch.Tensor):
    """Per-row statistics of KV rows (..., hd) f32, as the pool stores them:
    the mean and the population deviation (clamped at 1e-8), rounded to
    bf16.  Rows are coded against these rounded values."""
    mu = torch.mean(x, dim=-1).to(torch.bfloat16)
    sigma = torch.clamp(torch.std(x, dim=-1, correction=0),
                        min=1e-8).to(torch.bfloat16)
    return mu, sigma


def kv_codes(x: torch.Tensor, kv_bits: int):
    """The plain k-quantile coding of KV rows x (..., hd): (codes, mu,
    sigma), codes against the ``kv_row_stats`` statistics as rounded, int8
    with the k = 256 offset at kv8, packed two per byte (uint8) at kv4."""
    if kv_bits not in (4, 8):
        raise ValueError(f"kv_bits must be 4 or 8, got {kv_bits}")
    xf = x.to(torch.float32)
    mu, sigma = kv_row_stats(xf)
    codes = kref.kquantile_codes_ref(
        xf, mu.to(torch.float32)[..., None],
        sigma.to(torch.float32)[..., None], 2 ** kv_bits)
    if kv_bits == 4:
        codes = packing.pack_int4(codes)
    return codes, mu, sigma


def kv_append_plain(pool, pages, rows, k, v, *, kv_bits: int) -> None:
    """Plain version of the fused KV append: ``kv_codes`` of the stacked K
    and V rows, then one index write per leaf.  Duplicate destinations
    overwrite each other in no set order.  A destination outside [0, P) x
    [0, page) is an error, as the kernel traps on one: a negative index is
    refused before any write (RuntimeError on the CPU, a device-side
    assertion on the card, with no host synchronisation) rather than
    wrapped to the pool's end; one past the end raises IndexError."""
    torch._assert_async(((pages >= 0) & (rows >= 0)).all(),
                        "kv_append: negative page or row destination")
    codes, mu, sigma = kv_codes(torch.stack([k, v]), kv_bits)
    vals = {"k_codes": codes[0], "k_mu": mu[0], "k_sigma": sigma[0],
            "v_codes": codes[1], "v_mu": mu[1], "v_sigma": sigma[1]}
    for name, val in vals.items():
        pool[name][pages, rows] = val.to(pool[name].dtype)


def _check_append(pool, pages, rows, k, v, kv_bits):
    """Raise on what ``kv_append`` does not take.  On the engine's hot path
    (once per layer and call), so each operand is looked at once."""
    if kv_bits not in (4, 8):
        raise ValueError(f"kv_bits must be 4 or 8, got {kv_bits}")
    if k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"k and v must be one (N, KV, hd) shape, got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if k.dtype not in _DTYPES or v.dtype != k.dtype:
        raise TypeError(f"k and v must be float32 or bfloat16 alike, got "
                        f"{k.dtype} / {v.dtype}")
    N, KV, hd = k.shape
    if kv_bits == 4 and hd % 2:
        raise ValueError(f"kv4 packs two codes a byte along head_dim; "
                         f"head_dim {hd} must be even")
    if len(pool) != len(KV_LEAVES) or any(n not in pool for n in KV_LEAVES):
        raise ValueError(f"the pool layer must hold exactly {KV_LEAVES}, "
                         f"got {sorted(pool)}")
    P, page = pool["k_codes"].shape[:2]
    code = (torch.uint8 if kv_bits == 4 else torch.int8,
            (P, page, KV, hd // 2 if kv_bits == 4 else hd))
    stat = (torch.bfloat16, (P, page, KV))
    dev = k.device
    for name, t, (dtype, shape) in (
            ("pages", pages, (torch.int64, (N,))),
            ("rows", rows, (torch.int64, (N,))),
            ("k_codes", pool["k_codes"], code), ("k_mu", pool["k_mu"], stat),
            ("k_sigma", pool["k_sigma"], stat),
            ("v_codes", pool["v_codes"], code), ("v_mu", pool["v_mu"], stat),
            ("v_sigma", pool["v_sigma"], stat)):
        if t.dtype != dtype or t.shape != shape:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != dev:
            raise ValueError("all operands must live on one device")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("k and v must be contiguous")
    if v.device != dev:
        raise ValueError("all operands must live on one device")
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"kv_append runs on cuda or cpu tensors, got "
                           f"{dev}")


def _check_k(k: int) -> None:
    if k < 2 or k > 256 or k & (k - 1):
        raise ValueError(f"k must be a power of two in [2, 256], got {k}")


def _check_stats(x, mu, sigma, C):
    if x.ndim != 3:
        raise ValueError(f"expected a (G, R, C) tensor, got {tuple(x.shape)}")
    G = x.shape[0]
    for name, s in (("mu", mu), ("sigma", sigma)):
        if s.dtype != torch.float32 or tuple(s.shape) not in (
                (G, 1, C), (G, 1, 1)):
            raise ValueError(f"{name} must be ({G}, 1, {C}) or ({G}, 1, 1) "
                             f"float32, got {tuple(s.shape)} {s.dtype}")
        if s.device != x.device:
            raise ValueError("all operands must live on one device")
    if mu.shape != sigma.shape:
        raise ValueError("mu and sigma must have one shape")
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"kquantile runs on cuda or cpu tensors, got "
                           f"{x.device}")


def _require_contiguous(**tensors):
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


_FNS = {}


def _bind(name: str):
    """A C entry point of ``csrc/kquantile.cu``, built and bound at first
    use."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(loader.load("kquantile"), name)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = {
            "kquantile_quantize_launch": [p, i, p, p, i, p, i, ll, ll, ll, p],
            "kquantile_dequantize_launch":
                [p, i, p, p, i, p, p, i, i, ll, ll, ll, p],
            "kv_append_launch":
                [p, p, i, p, p, p, p, p, p, p, p, i, i, i, i, ll, i, p]}[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def kquantile_quantize(w: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor,
                       *, k: int) -> torch.Tensor:
    """(G, R, C) f32 / bf16 values -> (G, R, C) int8 codes.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version.  ``kquantile_quantize.launches`` counts kernel launches.
    """
    _check_k(k)
    if w.dtype not in _DTYPES:
        raise TypeError(f"w must be float32 or bfloat16, got {w.dtype}")
    _check_stats(w, mu, sigma, w.shape[-1] if w.ndim == 3 else 0)
    if w.device.type == "cpu":
        return kquantile_quantize_plain(w, mu, sigma, k=k)
    _require_contiguous(w=w, mu=mu, sigma=sigma)
    G, R, C = w.shape
    if w.numel() == 0:
        return torch.empty(w.shape, dtype=torch.int8, device=w.device)
    fn = _bind("kquantile_quantize_launch")
    with loader.on_device(w.device):
        out = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = fn(w.data_ptr(), int(w.dtype == torch.bfloat16), mu.data_ptr(),
                sigma.data_ptr(), int(mu.shape[-1] != 1), out.data_ptr(), k,
                G, R, C, stream)
    if rc != 0:
        raise RuntimeError(f"kquantile_quantize kernel launch failed with "
                           f"code {rc} (G={G}, R={R}, C={C}, k={k})")
    kquantile_quantize.launches += 1
    return out


def kquantile_dequantize(codes: torch.Tensor, mu: torch.Tensor,
                         sigma: torch.Tensor, *, k: int,
                         out_dtype=torch.bfloat16) -> torch.Tensor:
    """(G, R, C) int8 codes, or (G, R, C // 2) uint8 packed 4-bit codes
    (k <= 16), -> (G, R, C) ``out_dtype`` levels ``mu + sigma * table[c]``.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version.  ``kquantile_dequantize.launches`` counts kernel launches.
    """
    _check_k(k)
    packed = codes.dtype == torch.uint8
    if codes.dtype not in (torch.int8, torch.uint8):
        raise TypeError(f"codes must be int8 or packed uint8, got "
                        f"{codes.dtype}")
    if packed and k > 16:
        raise ValueError(f"packed 4-bit codes hold k <= 16 levels, got k={k}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    C = codes.shape[-1] * (2 if packed else 1) if codes.ndim == 3 else 0
    _check_stats(codes, mu, sigma, C)
    if codes.device.type == "cpu":
        return kquantile_dequantize_plain(codes, mu, sigma, k=k,
                                          out_dtype=out_dtype)
    _require_contiguous(codes=codes, mu=mu, sigma=sigma)
    G, R = codes.shape[:2]
    if codes.numel() == 0:
        return torch.empty((G, R, C), dtype=out_dtype, device=codes.device)
    fn = _bind("kquantile_dequantize_launch")
    table = kref.level_table(k, codes.device)
    with loader.on_device(codes.device):
        out = torch.empty((G, R, C), dtype=out_dtype, device=codes.device)
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        rc = fn(codes.data_ptr(), int(packed), mu.data_ptr(),
                sigma.data_ptr(), int(mu.shape[-1] != 1), table.data_ptr(),
                out.data_ptr(), int(out_dtype == torch.bfloat16), k, G, R, C,
                stream)
    if rc != 0:
        raise RuntimeError(f"kquantile_dequantize kernel launch failed with "
                           f"code {rc} (G={G}, R={R}, C={C}, k={k}, "
                           f"packed={packed})")
    kquantile_dequantize.launches += 1
    return out


def kv_append(pool, pages: torch.Tensor, rows: torch.Tensor,
              k: torch.Tensor, v: torch.Tensor, *, kv_bits: int) -> None:
    """Code K and V rows (N, KV, hd) and write them, with their bf16
    statistics, into one layer of the coded paged pool at (pages[i],
    rows[i]), in place.

    ``pool`` maps ``KV_LEAVES`` to that layer's contiguous leaves: codes
    (P, page, KV, hd) int8 (kv8) or (P, page, KV, hd // 2) uint8 (kv4),
    statistics (P, page, KV) bf16.  ``pages`` / ``rows`` are (N,) int64
    in [0, P) and [0, page): the plain version refuses any other
    destination (see ``kv_append_plain``) and the kernel traps on it (which
    ends the CUDA context).
    CUDA tensors launch ``kv_append_kernel`` once (or raise); CPU tensors
    take the plain version.  ``kv_append.launches`` counts kernel launches.
    """
    _check_append(pool, pages, rows, k, v, kv_bits)
    if k.device.type == "cpu":
        kv_append_plain(pool, pages, rows, k, v, kv_bits=kv_bits)
        return
    N, KV, hd = k.shape
    if hd not in KV_APPEND_HEAD_DIMS:
        raise ValueError(f"the fused KV append takes head_dim in "
                         f"{KV_APPEND_HEAD_DIMS}, got {hd}")
    if N == 0:
        return
    for name, t, a in (("k", k, 16), ("v", v, 16),
                       ("k_codes", pool["k_codes"], 8),
                       ("v_codes", pool["v_codes"], 8)):
        if t.data_ptr() % a:
            raise ValueError(f"{name} must start on a {a}-byte boundary")
    fn = _bind("kv_append_launch")
    P, page = pool["k_codes"].shape[:2]
    with loader.on_device(k.device):
        stream = torch.cuda.current_stream(k.device).cuda_stream
        rc = fn(k.data_ptr(), v.data_ptr(), int(k.dtype == torch.bfloat16),
                pages.data_ptr(), rows.data_ptr(),
                *(pool[n].data_ptr() for n in KV_LEAVES), kv_bits, N, KV, hd,
                P, page, stream)
    if rc != 0:
        raise RuntimeError(f"kv_append kernel launch failed with code {rc} "
                           f"(N={N}, KV={KV}, hd={hd}, kv_bits={kv_bits})")
    kv_append.launches += 1


kquantile_quantize.launches = 0
kquantile_dequantize.launches = 0
kv_append.launches = 0
