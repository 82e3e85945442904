"""Dequant-fused matmuls over k-quantile-coded weights: CUDA kernels + plain
PyTorch versions.

Replaces the TPU kernels ``qmatmul``, ``qmatmul_lut`` (codebook levels, the
serving path of ``dist="empirical"`` checkpoints) and ``qmatmul_a8`` (int8
activation codes) of ``src/repro/kernels/qmatmul.py``.  ``qmatmul_experts``
/ ``qmatmul_lut_experts`` multiply a stack of E experts in one launch (the
MoE expert matmuls, which the reference computes as a ``materialize`` of
the whole stack and an einsum): bf16 activations at W4, the serving path,
take a persistent body of their own (``qmatmul_experts_wg_kernel``, planned
by ``expert_plan``); W8 and f32 activations run the bodies of ``qmatmul``
with the expert on the grid.  The kernel source
is ``csrc/qmatmul.cu`` (see its header for what bounds it on Hopper and what
the design does about that).  Each wrapper launches its kernel for CUDA
tensors and takes the plain version only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from repro_torch.core import packing
from repro_torch.kernels import loader
from repro_torch.kernels import ref as kref


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """One point on the block-shape tuning axis: ``bm`` rows per block
    select the kernel instantiation.  bf16 activations (the warpgroup body
    of ``qmatmul`` / ``qmatmul_lut``): 16, 32, 64 or 128 rows, the wgmma's
    N, with 8 taking the 16-row tile; from 64 rows on a block sums every
    split of K itself.  f32 activations (the CUDA-core body): 8, 16, 32 or
    64, which also serves 128.  ``qmatmul_a8``: 16, 32 or 64, with 8 taking
    16.  A block's tile is always 128 columns wide; a stage is 64 rows of K
    on the tensor cores and 32 on the CUDA cores."""
    bm: int


TUNED_BLOCKS = {
    "decode8": BlockConfig(bm=8),
    "decode16": BlockConfig(bm=16),
    "decode": BlockConfig(bm=32),
    "prefill64": BlockConfig(bm=64),      # and every qmatmul_a8 prefill
    "prefill": BlockConfig(bm=128),
}
_TILES = {"qmatmul_launch": (8, 16, 32, 64, 128),
          "qmatmul_lut_launch": (8, 16, 32, 64, 128),
          "qmatmul_a8_launch": (8, 16, 32, 64)}

_DECODE_M_MAX = 32
_MAX_SPLITK = 16
_TARGET_BLOCKS = 1056         # eight blocks per SM of a 132-SM card: a block
                              # walks its K range serially, so it is the
                              # number of resident blocks that hides latency


def default_blocks(M: int, a8: bool = False) -> BlockConfig:
    """Pick the block config for a call of M rows (``a8``: for
    ``qmatmul_a8``, whose widest tile is 64 rows)."""
    if M <= 8:
        return TUNED_BLOCKS["decode8"]
    if M <= 16:
        return TUNED_BLOCKS["decode16"]
    if M <= _DECODE_M_MAX:
        return TUNED_BLOCKS["decode"]
    if a8 or M <= 64:
        return TUNED_BLOCKS["prefill64"]
    return TUNED_BLOCKS["prefill"]


def default_splitk(K: int, N: int, E: int = 1) -> int:
    """Split count over K: a power of two that brings the grid near
    ``_TARGET_BLOCKS`` blocks (over the E experts of an expert call), each
    split at least 256 rows of K deep.  A function of (K, N, E) only —
    never of M — so a row's summation order, and with it its bits, do not
    depend on which rows share the call."""
    n_blocks = -(-N // 128) * E
    want = max(1, min(_MAX_SPLITK, _TARGET_BLOCKS // n_blocks, K // 256))
    return 1 << (want.bit_length() - 1)


# The expert body (bf16 activations, W4): its tile rows, the smallest that
# holds C (8 at a decode step, so no activation row of a stage is zero
# fill), and the blocks an SM holds at each (``xp_blocks_per_sm`` in
# csrc/qmatmul.cu; the launch checks that the card holds them)
EXPERT_TILES = (8, 16, 32, 64)
EXPERT_BLOCKS_PER_SM = {8: 5, 16: 4, 32: 3, 64: 2}


def expert_tile(C: int) -> int:
    """Rows of the expert body's tile for a capacity of C rows."""
    return next((t for t in EXPERT_TILES if t >= C), EXPERT_TILES[-1])


def expert_plan(E: int, C: int, K: int, N: int, sms: int) -> dict:
    """How the expert body takes an (E, C, K) x (E, K, N) call on a card
    of ``sms`` SMs: the tile rows ``bm``, the row blocks of an expert, the
    persistent grid (``sms`` times the blocks an SM holds at that tile) and
    the split count over K (1: a tile walks all of K in one block).  A
    function of these arguments only -- never of ``rows``, which stays on
    the device -- so an expert's summation order, and its bits, do not
    depend on the other experts of the call."""
    bm = expert_tile(C)
    return dict(bm=bm, row_blocks=-(-C // bm),
                grid=sms * EXPERT_BLOCKS_PER_SM[bm], splits=1)


def expert_tiles(rows, C: int, N: int, bm: int, grid: int):
    """The expert body's walk, in Python: for each block of the persistent
    grid, the (expert, first row, first column) of the tiles it takes, in
    order.  The tiles are (expert in use, row block, column block of 128)
    numbered expert-major over the experts in use in ascending order; tile
    t goes to block t mod ``grid``; a row block with no row in use is
    skipped (the kernel zeroes its rows).  Mirrors
    ``qmatmul_experts_wg_kernel`` (``csrc/qmatmul.cu``)."""
    rows = [min(C, max(0, int(r))) for r in rows]
    used = [e for e, r in enumerate(rows) if r > 0]
    n_mb, ncb = -(-C // bm), -(-N // 128)
    out = [[] for _ in range(grid)]
    for t in range(len(used) * n_mb * ncb):
        u, r = divmod(t, n_mb * ncb)
        e, m0, n0 = used[u], (r // ncb) * bm, (r % ncb) * 128
        if m0 < rows[e]:
            out[t % grid].append((e, m0, n0))
    return out


def qmatmul_plain(a: torch.Tensor, w_packed: torch.Tensor, mu: torch.Tensor,
                  sigma: torch.Tensor, *, bits: int,
                  out_dtype=torch.float32) -> torch.Tensor:
    """Plain version: unpack, level-table gather, ``a.float() @ w``.

    The dequantized weight is rounded to ``a``'s dtype first (a no-op for
    f32 activations), as the reference's serving matmul and its TPU kernel
    do; the product itself accumulates in f32."""
    k = 2 ** bits
    codes = packing.unpack_int4(w_packed) if bits == 4 else w_packed
    w = kref.kquantile_dequant_ref(codes, mu, sigma, k, dtype=a.dtype)
    return (a.to(torch.float32) @ w.to(torch.float32)).to(out_dtype)


def qmatmul_lut_plain(a: torch.Tensor, w_packed: torch.Tensor,
                      lut: torch.Tensor, *, bits: int,
                      out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of the codebook matmul: unpack, ``lut[code, col]`` (or
    ``lut[code]`` for a (k,) codebook), the levels rounded to ``a``'s dtype
    (as ``qmatmul_plain`` rounds Gaussian levels and the reference's
    ``materialize(w, x.dtype)`` does), then ``a.float() @ w``."""
    k = 2 ** bits
    codes = packing.unpack_int4(w_packed) if bits == 4 else w_packed
    c = codes.to(torch.int64) + kref.code_offset(k)
    w = lut[c] if lut.ndim == 1 else torch.gather(lut, 0, c)
    return (a.to(torch.float32) @ w.to(a.dtype).to(torch.float32)) \
        .to(out_dtype)


def qmatmul_a8_plain(a_codes: torch.Tensor, a_scale: torch.Tensor,
                     w_packed: torch.Tensor, mu: torch.Tensor,
                     sigma: torch.Tensor, *, bits: int,
                     out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of the int8-activation matmul: ``ref.qmatmul_a8_ref``
    (f32 ``code * scale`` against f32 levels, as the reference's engine
    computes ``lm.mm_a``)."""
    return kref.qmatmul_a8_ref(a_codes, a_scale, w_packed, mu, sigma, bits,
                               out_dtype)


def _expert_rows_mask(a: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(E, C, K) activations with the rows at or past ``rows[e]`` of expert
    e set to zero (by ``where``, so a NaN there is not read), as the expert
    kernels read them."""
    used = torch.arange(a.shape[1], device=a.device)[None, :] \
        < rows.to(device=a.device, dtype=torch.int64)[:, None]
    return torch.where(used[..., None], a, torch.zeros((), dtype=a.dtype,
                                                       device=a.device))


def qmatmul_experts_plain(a: torch.Tensor, w_packed: torch.Tensor,
                          mu: torch.Tensor, sigma: torch.Tensor,
                          rows: torch.Tensor, *, bits: int,
                          out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of the expert matmul: the unused rows zeroed, then
    ``qmatmul_plain`` expert by expert (one expert's weight dequantized at
    a time; the stack never is)."""
    a = _expert_rows_mask(a, rows)
    return torch.stack([qmatmul_plain(a[e], w_packed[e], mu, sigma,
                                      bits=bits, out_dtype=out_dtype)
                        for e in range(a.shape[0])])


def qmatmul_lut_experts_plain(a: torch.Tensor, w_packed: torch.Tensor,
                              lut: torch.Tensor, rows: torch.Tensor, *,
                              bits: int,
                              out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of the codebook expert matmul: the unused rows zeroed,
    then ``qmatmul_lut_plain`` expert by expert."""
    a = _expert_rows_mask(a, rows)
    return torch.stack([qmatmul_lut_plain(a[e], w_packed[e], lut, bits=bits,
                                          out_dtype=out_dtype)
                        for e in range(a.shape[0])])


def _check_w(w_packed, bits, K):
    """Checks the coded weight against K; returns N."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if w_packed.ndim != 2:
        raise ValueError(f"w must be 2-D, got {tuple(w_packed.shape)}")
    want = packing.storage_dtype(bits)
    if w_packed.dtype != want:
        raise TypeError(f"w must be {want} at bits={bits}, got "
                        f"{w_packed.dtype}")
    if w_packed.shape[0] != K:
        raise ValueError(f"K mismatch: a has K={K}, w is "
                         f"{tuple(w_packed.shape)}")
    return w_packed.shape[1] * 2 if bits == 4 else w_packed.shape[1]


def _check_stats(mu, sigma, N):
    for name, s in (("mu", mu), ("sigma", sigma)):
        if tuple(s.shape) != (1, N) or s.dtype != torch.float32:
            raise ValueError(f"{name} must be (1, {N}) float32, got "
                             f"{tuple(s.shape)} {s.dtype}")


def _check_float_a(a):
    """Checks a float activation; returns (M, K)."""
    if a.ndim != 2:
        raise ValueError(f"a must be 2-D, got {tuple(a.shape)}")
    if a.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"a must be bfloat16 or float32, got {a.dtype}")
    return a.shape


def _check_out_and_devices(out_dtype, a, *others):
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bfloat16 or float32, got "
                        f"{out_dtype}")
    for t in others:
        if t.device != a.device:
            raise ValueError("all operands must live on one device")
    if a.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"qmatmul runs on cuda or cpu tensors, got "
                           f"{a.device}")


_TAIL = "ppiiiiiip"     # part, out, out_bf16, M, K, N, bm, splitk, stream
_ARGTYPES = {
    # each C entry point's arguments: p = pointer, i = int.  The matmuls'
    # operands come before the shared tail; qmatmul_launch and
    # qmatmul_lut_launch take the expert rows and count E (null and 1 for a
    # plain call)
    "qmatmul_launch": "pipippppi" + _TAIL,
    "qmatmul_lut_launch": "pipipipi" + _TAIL,
    "qmatmul_a8_launch": "ppipippp" + _TAIL,
    "qmatmul_scratch_splits": "iii",
    # a, w, wm, mu, sigma, table, lut, rows, E, out, out_bf16, C, K, N, bm,
    # grid, stream
    "qmatmul_experts_launch": "ppipppppipiiiiiip",
}
_FNS = {}


def _bind(name: str):
    """A C entry point of ``csrc/qmatmul.cu``, built and bound at first
    use."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(loader.load("qmatmul"), name)
        c = {"p": ctypes.c_void_p, "i": ctypes.c_int}
        fn.argtypes = [c[t] for t in _ARGTYPES[name]]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


_MAX_GRID_Z = 65535


def _launch(name, operands, tensors, M, K, N, out_dtype, blocks, splitk,
            what, E=1):
    """Checks that ``tensors`` (name -> tensor) are contiguous, allocates the
    split-K scratch and the (E * M, N) output on their device and runs entry
    point ``name`` with ``operands`` followed by the shared tail."""
    for tname, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{tname} must be contiguous")
    cfg = blocks if blocks is not None else default_blocks(
        M, a8=name == "qmatmul_a8_launch")
    if cfg.bm not in _TILES[name]:
        raise ValueError(f"no kernel instantiation for {cfg} in {name}")
    nsplit = splitk if splitk is not None else default_splitk(K, N, E)
    if nsplit * E > _MAX_GRID_Z:
        raise ValueError(f"{name}: {E} experts x {nsplit} splits exceed the "
                         f"grid's {_MAX_GRID_Z} blocks along z")
    fn = _bind(name)
    # the warpgroup body (bf16 activations) may write the output itself:
    # the kernel source says when, and so how much scratch the call needs
    wg = name != "qmatmul_a8_launch" and tensors["a"].dtype == torch.bfloat16
    n_part = _bind("qmatmul_scratch_splits")(int(wg), cfg.bm, nsplit)
    dev = next(iter(tensors.values())).device
    with loader.on_device(dev):
        part = torch.empty((n_part, E * M, N), dtype=torch.float32,
                           device=dev)
        out = torch.empty((E * M, N), dtype=out_dtype, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*operands, part.data_ptr(), out.data_ptr(),
                int(out_dtype == torch.bfloat16), M, K, N, cfg.bm, nsplit,
                stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed with code {rc} (M={M}, K={K}, "
                           f"N={N}, {what}, {cfg}, splitk={nsplit})")
    return out


def qmatmul(a: torch.Tensor, w_packed: torch.Tensor, mu: torch.Tensor,
            sigma: torch.Tensor, *, bits: int, out_dtype=torch.float32,
            blocks: Optional[BlockConfig] = None,
            splitk: Optional[int] = None) -> torch.Tensor:
    """a (M, K) @ dequant(w_packed) (K, N) -> (M, N) ``out_dtype``.

    w_packed : (K, N//2) uint8 if bits==4 else (K, N) int8.
    mu/sigma : (1, N) f32 per-out-channel statistics.
    blocks/splitk : tuning axes; None picks the defaults for the shape.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version.  ``qmatmul.launches`` counts kernel launches.
    """
    M, K = _check_float_a(a)
    N = _check_w(w_packed, bits, K)
    _check_stats(mu, sigma, N)
    _check_out_and_devices(out_dtype, a, w_packed, mu, sigma)
    if a.device.type == "cpu":
        return qmatmul_plain(a, w_packed, mu, sigma, bits=bits,
                             out_dtype=out_dtype)
    if M == 0:
        return torch.empty((0, N), dtype=out_dtype, device=a.device)
    table = kref.level_table(2 ** bits, a.device)
    out = _launch("qmatmul_launch",
                  (a.data_ptr(), int(a.dtype == torch.bfloat16),
                   w_packed.data_ptr(), bits, mu.data_ptr(), sigma.data_ptr(),
                   table.data_ptr(), None, 1),
                  {"a": a, "w": w_packed, "mu": mu, "sigma": sigma},
                  M, K, N, out_dtype, blocks, splitk, f"bits={bits}")
    qmatmul.launches += 1
    return out


def qmatmul_lut(a: torch.Tensor, w_packed: torch.Tensor, lut: torch.Tensor,
                *, bits: int, out_dtype=torch.float32,
                blocks: Optional[BlockConfig] = None,
                splitk: Optional[int] = None) -> torch.Tensor:
    """a (M, K) @ lut-dequant(w_packed) (K, N) -> (M, N) ``out_dtype``.

    w_packed : (K, N//2) uint8 if bits==4 else (K, N) int8 (k=256 offset).
    lut      : (k, N) f32 per-column levels, or (k,) f32 one codebook for
               every column (the engine's per-tensor ``q_lut``; taken with
               a column stride of 0, never expanded).
    bf16 activations meet levels rounded to bf16 on the tensor cores (the
    body ``qmatmul`` runs); f32 activations f32 levels on the CUDA cores.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version.  ``qmatmul_lut.launches`` counts kernel launches.
    """
    M, K = _check_float_a(a)
    N = _check_w(w_packed, bits, K)
    k = 2 ** bits
    if lut.dtype != torch.float32 or tuple(lut.shape) not in ((k,), (k, N)):
        raise ValueError(f"lut must be ({k},) or ({k}, {N}) float32, got "
                         f"{tuple(lut.shape)} {lut.dtype}")
    _check_out_and_devices(out_dtype, a, w_packed, lut)
    if a.device.type == "cpu":
        return qmatmul_lut_plain(a, w_packed, lut, bits=bits,
                                 out_dtype=out_dtype)
    if M == 0:
        return torch.empty((0, N), dtype=out_dtype, device=a.device)
    out = _launch("qmatmul_lut_launch",
                  (a.data_ptr(), int(a.dtype == torch.bfloat16),
                   w_packed.data_ptr(), bits, lut.data_ptr(),
                   int(lut.ndim == 2), None, 1),
                  {"a": a, "w": w_packed, "lut": lut},
                  M, K, N, out_dtype, blocks, splitk,
                  f"bits={bits}, lut {tuple(lut.shape)}")
    qmatmul_lut.launches += 1
    return out


def qmatmul_a8(a_codes: torch.Tensor, a_scale: torch.Tensor,
               w_packed: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor,
               *, bits: int, out_dtype=torch.float32,
               blocks: Optional[BlockConfig] = None,
               splitk: Optional[int] = None) -> torch.Tensor:
    """(a_codes * a_scale) (M, K) @ dequant(w_packed) (K, N) -> (M, N).

    a_codes : (M, K) int8 activation codes.
    a_scale : f32, one value (the reference's kernel) or (M, 1) per row
              (the reference's engine: per-token absmax scales).
    w_packed, mu, sigma : as ``qmatmul``.
    The product is f32 ``code * scale`` against f32 levels (the reference
    engine's numerics; its TPU kernel rounds both operands to bf16
    instead), computed exactly on the tensor cores: ``s * (mu * sum(code)
    + sigma * sum(code * T))`` with T split into three bf16 parts
    (``ref.level_split``).

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version.  ``qmatmul_a8.launches`` counts kernel launches.
    """
    if a_codes.ndim != 2 or a_codes.dtype != torch.int8:
        raise ValueError(f"a_codes must be (M, K) int8, got "
                         f"{tuple(a_codes.shape)} {a_codes.dtype}")
    M, K = a_codes.shape
    N = _check_w(w_packed, bits, K)
    if a_scale.dtype != torch.float32 or (
            a_scale.numel() != 1 and tuple(a_scale.shape) != (M, 1)):
        raise ValueError(f"a_scale must be one float32 value or ({M}, 1) "
                         f"float32, got {tuple(a_scale.shape)} "
                         f"{a_scale.dtype}")
    _check_stats(mu, sigma, N)
    _check_out_and_devices(out_dtype, a_codes, a_scale, w_packed, mu, sigma)
    if a_codes.device.type == "cpu":
        return qmatmul_a8_plain(a_codes, a_scale, w_packed, mu, sigma,
                                bits=bits, out_dtype=out_dtype)
    if M == 0:
        return torch.empty((0, N), dtype=out_dtype, device=a_codes.device)
    split = kref.level_split(2 ** bits, a_codes.device)
    out = _launch("qmatmul_a8_launch",
                  (a_codes.data_ptr(), a_scale.data_ptr(),
                   int(a_scale.numel() != 1), w_packed.data_ptr(), bits,
                   mu.data_ptr(), sigma.data_ptr(), split.data_ptr()),
                  {"a_codes": a_codes, "a_scale": a_scale, "w": w_packed,
                   "mu": mu, "sigma": sigma},
                  M, K, N, out_dtype, blocks, splitk, f"bits={bits}")
    qmatmul_a8.launches += 1
    return out


_W_GAUSS, _W_LUT_SHARED, _W_LUT_COL = 0, 1, 2     # csrc/qmatmul.cu's WM


def _launch_experts(a, w_packed, rows, wm, mu, sigma, table, lut, out_dtype,
                    blocks, splitk, what):
    """Runs the expert body (bf16 activations, W4) on checked operands:
    one launch of ``expert_plan``'s persistent grid; returns (E, C, N)."""
    E, C, K = a.shape
    N = w_packed.shape[2] * 2
    for name, t in (("a", a), ("w", w_packed), ("rows", rows), ("mu", mu),
                    ("sigma", sigma), ("lut", lut)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if splitk not in (None, 1):
        raise ValueError(f"the expert body sums all of K in one block: "
                         f"splitk must be None or 1, got {splitk}")
    plan = expert_plan(E, C, K, N, loader.sm_count(a.device))
    bm = plan["bm"] if blocks is None else blocks.bm
    if bm not in EXPERT_TILES:
        raise ValueError(f"no expert tile of {bm} rows (have "
                         f"{EXPERT_TILES})")
    grid = plan["grid"] if blocks is None \
        else loader.sm_count(a.device) * EXPERT_BLOCKS_PER_SM[bm]
    fn = _bind("qmatmul_experts_launch")

    def ptr(t):
        return None if t is None else t.data_ptr()
    with loader.on_device(a.device):
        out = torch.empty((E, C, N), dtype=out_dtype, device=a.device)
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), w_packed.data_ptr(), wm, ptr(mu), ptr(sigma),
                ptr(table), ptr(lut), rows.data_ptr(), E, out.data_ptr(),
                int(out_dtype == torch.bfloat16), C, K, N, bm, grid, stream)
    if rc != 0:
        raise RuntimeError(f"qmatmul_experts_launch failed with code {rc} "
                           f"(E={E}, C={C}, K={K}, N={N}, {what}, bm={bm}, "
                           f"grid={grid})")
    return out


def _check_experts(a, w_packed, rows, bits):
    """Checks an expert call; returns (E, C, K, N)."""
    if a.ndim != 3:
        raise ValueError(f"a must be (E, C, K), got {tuple(a.shape)}")
    if a.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"a must be bfloat16 or float32, got {a.dtype}")
    E, C, K = a.shape
    if w_packed.ndim != 3 or w_packed.shape[0] != E:
        raise ValueError(f"w must be ({E}, K, N) codes, got "
                         f"{tuple(w_packed.shape)}")
    N = _check_w(w_packed[0], bits, K)
    if rows.dtype != torch.int32 or tuple(rows.shape) != (E,):
        raise ValueError(f"rows must be ({E},) int32, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    return E, C, K, N


def qmatmul_experts(a: torch.Tensor, w_packed: torch.Tensor,
                    mu: torch.Tensor, sigma: torch.Tensor,
                    rows: torch.Tensor, *, bits: int,
                    out_dtype=torch.float32,
                    blocks: Optional[BlockConfig] = None,
                    splitk: Optional[int] = None) -> torch.Tensor:
    """E products in one launch: out[e] = a[e] (C, K) @ dequant(w[e]) (K, N),
    the rows of a[e] at or past ``rows[e]`` taken as zeros.

    a        : (E, C, K) bf16 or f32.
    w_packed : (E, K, N//2) uint8 if bits==4 else (E, K, N) int8.
    mu/sigma : (1, N) f32, shared by the experts (per-column statistics of
               the layer's whole stack).
    rows     : (E,) int32 on a's device, never read on the host.
    blocks / splitk : bf16 activations at W4 take the expert body, whose
               tile rows ``blocks.bm`` may be any of ``EXPERT_TILES`` (None:
               ``expert_plan``'s) and whose split count is 1; W8 and f32
               activations take ``qmatmul``'s bodies and their axes.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version.  ``qmatmul_experts.launches`` counts kernel launches.
    """
    E, C, K, N = _check_experts(a, w_packed, rows, bits)
    _check_stats(mu, sigma, N)
    _check_out_and_devices(out_dtype, a, w_packed, mu, sigma, rows)
    if a.device.type == "cpu":
        return qmatmul_experts_plain(a, w_packed, mu, sigma, rows,
                                     bits=bits, out_dtype=out_dtype)
    if C == 0:
        return torch.empty((E, 0, N), dtype=out_dtype, device=a.device)
    table = kref.level_table(2 ** bits, a.device)
    if bits == 4 and a.dtype == torch.bfloat16:
        res = _launch_experts(a, w_packed, rows, _W_GAUSS, mu, sigma, table,
                              None, out_dtype, blocks, splitk,
                              f"bits={bits}")
        qmatmul_experts.launches += 1
        return res
    res = _launch("qmatmul_launch",
                  (a.data_ptr(), int(a.dtype == torch.bfloat16),
                   w_packed.data_ptr(), bits, mu.data_ptr(), sigma.data_ptr(),
                   table.data_ptr(), rows.data_ptr(), E),
                  {"a": a, "w": w_packed, "mu": mu, "sigma": sigma,
                   "rows": rows},
                  C, K, N, out_dtype, blocks, splitk, f"bits={bits}, E={E}",
                  E=E)
    qmatmul_experts.launches += 1
    return res.reshape(E, C, N)


def qmatmul_lut_experts(a: torch.Tensor, w_packed: torch.Tensor,
                        lut: torch.Tensor, rows: torch.Tensor, *, bits: int,
                        out_dtype=torch.float32,
                        blocks: Optional[BlockConfig] = None,
                        splitk: Optional[int] = None) -> torch.Tensor:
    """``qmatmul_experts`` with codebook levels: ``lut`` (k,) (the layer's
    one codebook, the engine's ``q_lut`` slice) or (k, N) f32, shared by
    the experts.  ``qmatmul_lut_experts.launches`` counts kernel launches.
    """
    E, C, K, N = _check_experts(a, w_packed, rows, bits)
    k = 2 ** bits
    if lut.dtype != torch.float32 or tuple(lut.shape) not in ((k,), (k, N)):
        raise ValueError(f"lut must be ({k},) or ({k}, {N}) float32, got "
                         f"{tuple(lut.shape)} {lut.dtype}")
    _check_out_and_devices(out_dtype, a, w_packed, lut, rows)
    if a.device.type == "cpu":
        return qmatmul_lut_experts_plain(a, w_packed, lut, rows, bits=bits,
                                         out_dtype=out_dtype)
    if C == 0:
        return torch.empty((E, 0, N), dtype=out_dtype, device=a.device)
    if bits == 4 and a.dtype == torch.bfloat16:
        res = _launch_experts(a, w_packed, rows, _W_LUT_COL if lut.ndim == 2
                              else _W_LUT_SHARED, None, None, None, lut,
                              out_dtype, blocks, splitk,
                              f"bits={bits}, lut {tuple(lut.shape)}")
        qmatmul_lut_experts.launches += 1
        return res
    res = _launch("qmatmul_lut_launch",
                  (a.data_ptr(), int(a.dtype == torch.bfloat16),
                   w_packed.data_ptr(), bits, lut.data_ptr(),
                   int(lut.ndim == 2), rows.data_ptr(), E),
                  {"a": a, "w": w_packed, "lut": lut, "rows": rows},
                  C, K, N, out_dtype, blocks, splitk,
                  f"bits={bits}, lut {tuple(lut.shape)}, E={E}", E=E)
    qmatmul_lut_experts.launches += 1
    return res.reshape(E, C, N)


qmatmul.launches = 0
qmatmul_lut.launches = 0
qmatmul_a8.launches = 0
qmatmul_experts.launches = 0
qmatmul_lut_experts.launches = 0
