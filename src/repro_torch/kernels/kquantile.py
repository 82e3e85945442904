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
condition; a group (R * C) of 2^31 elements or more is refused on the card.

Each call takes one of two bodies of the same kernel, by ``codec_route``: a
fixed rule on the shape, the dtypes and the pointers' alignment (16-byte
chunks where rows or groups are whole chunks and the pointers allow it, a
scalar chunk otherwise).  ``kquantile_quantize(..., packed=True)`` writes
4-bit codes two per byte (``core/packing.py``'s layout) from the kernel.

``kquantile_dequantize_paged`` is the prefill pool read in one launch:
the block-table gather of one layer's coded pool (codes and bf16
statistics) and the dequantize, as ``models/attention.py`` did it with
three gathers, two casts and the dense dequantize.  Its plain version
``kquantile_dequantize_paged_plain`` is that chain.

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


VECTOR, SCALAR = "vector", "scalar"
QUANTIZE, DEQUANTIZE = "quantize", "dequantize"
# a group of this many elements or more is refused: the bodies' offsets
# inside a group are 32-bit
MAX_GROUP = 1 << 31


def codec_route(op: str, shape, per_col: bool, dtype: torch.dtype,
                packed: bool, ptrs=(0, 0)) -> str:
    """Which body of ``csrc/kquantile.cu`` takes a call: ``VECTOR`` (16-byte
    chunks) or ``SCALAR`` (one element a chunk, two when packed).  A fixed
    rule on the shape, the dtypes and the pointers, never on whether a
    launch succeeded.

    ``op`` is ``QUANTIZE`` or ``DEQUANTIZE``; ``shape`` the (G, R, C) of the
    values; ``dtype`` theirs (the quantize input, the dequantize output);
    ``packed`` whether the codes are two a byte; ``ptrs`` the data pointers
    of (values, codes) and, optionally, of the statistics (mu, sigma).  A
    chunk is 16 / itemsize values to quantize and 16 codes to dequantize.
    ``VECTOR`` needs every row (per-column statistics) or every group
    (per-group statistics) to be whole chunks, the values and the
    statistics on a 16-byte boundary and the codes on a chunk's bytes.
    Raises ValueError for a group of ``MAX_GROUP`` elements or more.
    """
    G, R, C = shape
    if R * C >= MAX_GROUP:
        raise ValueError(f"a group of R * C = {R * C} elements: the codec "
                         f"kernels take groups below 2^31")
    vals_ptr, codes_ptr, *stats_ptrs = ptrs
    if op == QUANTIZE:
        vec = 16 // dtype.itemsize
    elif op == DEQUANTIZE:
        vec = 16
    else:
        raise ValueError(f"op must be {QUANTIZE!r} or {DEQUANTIZE!r}, got "
                         f"{op!r}")
    code_bytes = vec // 2 if packed else vec
    run = C if per_col else R * C
    if run % vec or vals_ptr % 16 or codes_ptr % code_bytes \
            or any(p % 16 for p in stats_ptrs):
        return SCALAR
    return VECTOR


def kquantile_quantize_plain(w, mu, sigma, *, k: int,
                             packed: bool = False) -> torch.Tensor:
    """Plain version of the quantize kernel (``ref.kquantile_codes_ref``,
    then ``pack_int4`` when ``packed``)."""
    codes = kref.kquantile_codes_ref(w, mu, sigma, k)
    return packing.pack_int4(codes) if packed else codes


def kquantile_dequantize_plain(codes, mu, sigma, *, k: int,
                               out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of the dequantize kernel: unpack packed codes, then
    ``ref.kquantile_dequant_ref``."""
    if codes.dtype == torch.uint8:
        codes = packing.unpack_int4(codes)
    return kref.kquantile_dequant_ref(codes, mu, sigma, k, dtype=out_dtype)


def gather_pages(pool, block_tables):
    """(P, page, ...) pool + (B, n_pages) table -> (B, n_pages*page, ...):
    each sequence's block-table row of pages, gathered in order."""
    B, n_pages = block_tables.shape
    g = pool[block_tables.to(torch.long)]
    return g.reshape(B, n_pages * pool.shape[1], *pool.shape[2:])


def kquantile_dequantize_paged_plain(codes, mu, sigma, block_tables, *,
                                     kv_bits: int,
                                     out_dtype=torch.bfloat16):
    """Plain version of the paged dequantize: the block-table gather of
    codes and statistics, the statistics cast to f32 (exact), then
    ``ref.kquantile_dequant_ref`` (after unpacking kv4 nibbles).  A page id
    outside [0, P) raises IndexError (negative ones are refused too, as the
    kernel traps on them, rather than wrapped to the pool's end)."""
    torch._assert_async((block_tables >= 0).all(),
                        "kquantile_dequantize_paged: negative page id")
    c = gather_pages(codes, block_tables)
    if kv_bits == 4:
        c = packing.unpack_int4(c)
    m = gather_pages(mu, block_tables).to(torch.float32)[..., None]
    s = gather_pages(sigma, block_tables).to(torch.float32)[..., None]
    return kref.kquantile_dequant_ref(c, m, s, 2 ** kv_bits, dtype=out_dtype)


# the pool leaves of one layer that a coded KV append writes, in the
# kernel's argument order
KV_LEAVES = ("k_codes", "k_mu", "k_sigma", "v_codes", "v_mu", "v_sigma")
# the largest head_dim the fused append takes (any one up to it: odd ones
# at kv8 only, as the reference's check_kv_bits)
KV_APPEND_MAX_HD = 256


def append_layout(hd: int):
    """The fused KV append's layout for head_dim ``hd``: (VPL, LANES), a
    (row, head) of hd values taken as hd / VPL chunks of VPL consecutive
    values by a group of LANES lanes.  A fixed rule on hd: for an even hd,
    VPL is the first of 4, 8, 2 that divides hd into at most 32 chunks
    (else 4 where it divides hd, else 2, and a lane takes up to 4 chunks);
    for an odd hd (kv8 only: kv4 packs two codes a byte) VPL is 1 and a lane
    takes up to 8 chunks, which ``append_route`` sends to the scalar loads
    and stores.  LANES is the power of two at or above the chunk count, at
    most 32.  Lanes past the last chunk load nothing.  Raises ValueError for
    hd below 1 or above ``KV_APPEND_MAX_HD``."""
    if hd < 1 or hd > KV_APPEND_MAX_HD:
        raise ValueError(f"the fused KV append takes a head_dim from 1 to "
                         f"{KV_APPEND_MAX_HD}, got {hd}")
    if hd % 2:
        vpl = 1
    else:
        fits = [v for v in (4, 8, 2) if hd % v == 0 and hd // v <= 32]
        vpl = fits[0] if fits else (4 if hd % 4 == 0 else 2)
    lanes = 1
    while lanes < min(hd // vpl, 32):
        lanes *= 2
    return vpl, lanes


def append_route(hd: int, itemsize: int, kv_bits: int, val_ptrs=(0, 0),
                 code_ptrs=(0, 0)):
    """Whether the fused KV append loads K / V a chunk at a time and stores
    codes a chunk at a time: (load route, store route), each ``VECTOR`` or
    ``SCALAR`` (one element, one byte a time).  A fixed rule: ``VECTOR``
    where the rows (hd * itemsize bytes of values, hd or hd / 2 bytes of
    codes) are whole 16-byte units and the pointers on a 16-byte
    boundary."""
    row_codes = hd // 2 if kv_bits == 4 else hd
    load = VECTOR if (hd * itemsize) % 16 == 0 \
        and not any(p % 16 for p in val_ptrs) else SCALAR
    store = VECTOR if row_codes % 16 == 0 \
        and not any(p % 16 for p in code_ptrs) else SCALAR
    return load, store


def kv_row_stats(x: torch.Tensor):
    """Per-row statistics of KV rows (..., hd) f32, as the pool stores them:
    the mean and the population deviation (clamped at 1e-8), rounded to
    bf16.  Rows are coded against these rounded values.  The mean is the
    sum divided by hd, correctly rounded, as the reference's ``jnp.mean``
    and the CPU's ``torch.mean`` give it.  On the card ``torch.mean``, and a
    division by a Python number, multiply by a rounded 1 / hd instead, which
    moves the bf16 mean of ~0.7 % of the rows at hd 7 (a sum that hd
    divides can sit exactly on a bf16 tie), so the divisor is a tensor on
    the rows' device."""
    s = torch.sum(x, dim=-1)
    mu = (s / s.new_full((), x.shape[-1])).to(torch.bfloat16)
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
            "kquantile_quantize_launch":
                [p, i, p, p, i, p, i, i, i, ll, ll, ll, p],
            "kquantile_dequantize_launch":
                [p, i, p, p, i, p, p, i, i, i, ll, ll, ll, p],
            "kquantile_dequantize_paged_launch":
                [p, i, p, p, p, i, p, p, i, i, ll, i, i, i, i, i, p],
            "kv_append_launch":
                [p, p, i, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, ll,
                 i, p]}[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def kquantile_quantize(w: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor,
                       *, k: int, packed: bool = False) -> torch.Tensor:
    """(G, R, C) f32 / bf16 values -> (G, R, C) int8 codes, or with
    ``packed`` (k <= 16, C even) (G, R, C // 2) uint8, two codes a byte,
    low nibble first.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version.  ``kquantile_quantize.launches`` counts kernel launches.
    """
    _check_k(k)
    if w.dtype not in _DTYPES:
        raise TypeError(f"w must be float32 or bfloat16, got {w.dtype}")
    _check_stats(w, mu, sigma, w.shape[-1] if w.ndim == 3 else 0)
    G, R, C = w.shape
    if packed and (k > 16 or C % 2):
        raise ValueError(f"packed codes hold k <= 16 levels two a byte along "
                         f"an even C, got k={k}, C={C}")
    if w.device.type == "cpu":
        return kquantile_quantize_plain(w, mu, sigma, k=k, packed=packed)
    _require_contiguous(w=w, mu=mu, sigma=sigma)
    shape = (G, R, C // 2) if packed else (G, R, C)
    dtype = torch.uint8 if packed else torch.int8
    if w.numel() == 0:
        return torch.empty(shape, dtype=dtype, device=w.device)
    per_col = mu.shape[-1] != 1
    fn = _bind("kquantile_quantize_launch")
    with loader.on_device(w.device):
        out = loader.empty(shape, dtype, w.device)
        route = codec_route(QUANTIZE, (G, R, C), per_col, w.dtype, packed,
                            (w.data_ptr(), out.data_ptr(), mu.data_ptr(),
                             sigma.data_ptr()))
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = fn(w.data_ptr(), int(w.dtype == torch.bfloat16), mu.data_ptr(),
                sigma.data_ptr(), int(per_col), out.data_ptr(), int(packed),
                int(route == VECTOR), k, G, R, C, stream)
    if rc != 0:
        raise RuntimeError(f"kquantile_quantize kernel launch failed with "
                           f"code {rc} (G={G}, R={R}, C={C}, k={k}, "
                           f"packed={packed}, {route})")
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
    per_col = mu.shape[-1] != 1
    fn = _bind("kquantile_dequantize_launch")
    table = kref.level_table(k, codes.device)
    with loader.on_device(codes.device):
        out = loader.empty((G, R, C), out_dtype, codes.device)
        route = codec_route(DEQUANTIZE, (G, R, C), per_col, out_dtype, packed,
                            (out.data_ptr(), codes.data_ptr(), mu.data_ptr(),
                             sigma.data_ptr()))
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        rc = fn(codes.data_ptr(), int(packed), mu.data_ptr(),
                sigma.data_ptr(), int(per_col), table.data_ptr(),
                out.data_ptr(), int(out_dtype == torch.bfloat16),
                int(route == VECTOR), k, G, R, C, stream)
    if rc != 0:
        raise RuntimeError(f"kquantile_dequantize kernel launch failed with "
                           f"code {rc} (G={G}, R={R}, C={C}, k={k}, "
                           f"packed={packed}, {route})")
    kquantile_dequantize.launches += 1
    return out


def _check_paged(codes, mu, sigma, block_tables, kv_bits, out_dtype):
    """Raise on what ``kquantile_dequantize_paged`` does not take."""
    if kv_bits not in (4, 8):
        raise ValueError(f"kv_bits must be 4 or 8, got {kv_bits}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    want = torch.uint8 if kv_bits == 4 else torch.int8
    if codes.ndim != 4 or codes.dtype != want:
        raise ValueError(f"codes must be (P, page, KV, hd') {want} at "
                         f"kv{kv_bits}, got {tuple(codes.shape)} "
                         f"{codes.dtype}")
    for name, t in (("mu", mu), ("sigma", sigma)):
        if t.dtype != torch.bfloat16 or t.shape != codes.shape[:3]:
            raise ValueError(f"{name} must be {tuple(codes.shape[:3])} "
                             f"bfloat16, got {tuple(t.shape)} {t.dtype}")
    if block_tables.ndim != 2 or block_tables.dtype not in (torch.int32,
                                                            torch.int64):
        raise ValueError(f"block_tables must be (B, n_pages) int32 or int64, "
                         f"got {tuple(block_tables.shape)} "
                         f"{block_tables.dtype}")
    dev = codes.device
    if any(t.device != dev for t in (mu, sigma, block_tables)):
        raise ValueError("all operands must live on one device")
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"kquantile runs on cuda or cpu tensors, got "
                           f"{dev}")


def kquantile_dequantize_paged(codes: torch.Tensor, mu: torch.Tensor,
                               sigma: torch.Tensor,
                               block_tables: torch.Tensor, *, kv_bits: int,
                               out_dtype=torch.bfloat16) -> torch.Tensor:
    """The prefill pool read: one layer's coded pool gathered by block
    table and dequantized, (B, n_pages * page, KV, hd) ``out_dtype``.

    ``codes`` (P, page, KV, hd) int8 (kv8) or (P, page, KV, hd // 2) uint8
    (kv4), ``mu`` / ``sigma`` (P, page, KV) bf16, ``block_tables``
    (B, n_pages) int32 or int64 page ids in [0, P) (the plain version
    refuses any other; the kernel traps on one, which ends the CUDA
    context).  Every row is written, the sink page's rows too.
    CUDA tensors launch ``dequant_paged_kernel`` once (or raise): no host
    sync, no allocation but the output; CPU tensors take the plain version.
    ``kquantile_dequantize_paged.launches`` counts kernel launches.
    """
    _check_paged(codes, mu, sigma, block_tables, kv_bits, out_dtype)
    if codes.device.type == "cpu":
        return kquantile_dequantize_paged_plain(
            codes, mu, sigma, block_tables, kv_bits=kv_bits,
            out_dtype=out_dtype)
    _require_contiguous(codes=codes, mu=mu, sigma=sigma,
                        block_tables=block_tables)
    P, page, KV, hdc = codes.shape
    hd = hdc * 2 if kv_bits == 4 else hdc
    B, n_pages = block_tables.shape
    if page * KV * hd >= MAX_GROUP or B * n_pages >= MAX_GROUP:
        raise ValueError(f"a page of {page * KV * hd} values or a table of "
                         f"{B * n_pages} entries: the kernel takes fewer "
                         f"than 2^31")
    if B * n_pages * page * KV * hd == 0:
        return torch.empty((B, n_pages * page, KV, hd), dtype=out_dtype,
                           device=codes.device)
    out = loader.empty((B, n_pages * page, KV, hd), out_dtype, codes.device)
    # a (row, head) of hd values is the group of the per-group body
    route = codec_route(DEQUANTIZE, (B * n_pages * page * KV, 1, hd), False,
                        out_dtype, kv_bits == 4,
                        (out.data_ptr(), codes.data_ptr()))
    fn = _bind("kquantile_dequantize_paged_launch")
    table = kref.level_table(2 ** kv_bits, codes.device)
    with loader.on_device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        rc = fn(codes.data_ptr(), kv_bits, mu.data_ptr(), sigma.data_ptr(),
                block_tables.data_ptr(),
                int(block_tables.dtype == torch.int64), table.data_ptr(),
                out.data_ptr(), int(out_dtype == torch.bfloat16),
                int(route == VECTOR), P, page, KV, hd, B, n_pages, stream)
    if rc != 0:
        raise RuntimeError(f"kquantile_dequantize_paged kernel launch failed "
                           f"with code {rc} (P={P}, page={page}, KV={KV}, "
                           f"hd={hd}, B={B}, n_pages={n_pages}, "
                           f"kv{kv_bits}, {route})")
    kquantile_dequantize_paged.launches += 1
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
    vpl, lanes = append_layout(hd)
    if N == 0:
        return
    load, store = append_route(
        hd, k.element_size(), kv_bits, (k.data_ptr(), v.data_ptr()),
        (pool["k_codes"].data_ptr(), pool["v_codes"].data_ptr()))
    fn = _bind("kv_append_launch")
    P, page = pool["k_codes"].shape[:2]
    with loader.on_device(k.device):
        stream = torch.cuda.current_stream(k.device).cuda_stream
        rc = fn(k.data_ptr(), v.data_ptr(), int(k.dtype == torch.bfloat16),
                pages.data_ptr(), rows.data_ptr(),
                *(pool[n].data_ptr() for n in KV_LEAVES), kv_bits, N, KV, hd,
                vpl, lanes.bit_length() - 1, int(load == VECTOR),
                int(store == VECTOR), P, page, stream)
    if rc != 0:
        raise RuntimeError(f"kv_append kernel launch failed with code {rc} "
                           f"(N={N}, KV={KV}, hd={hd}, kv_bits={kv_bits}, "
                           f"layout {vpl} x {lanes}, {load} / {store})")
    kv_append.launches += 1


kquantile_quantize.launches = 0
kquantile_dequantize.launches = 0
kquantile_dequantize_paged.launches = 0
kv_append.launches = 0
