"""Kernel audit of the port's hand-written CUDA: coverage, out-of-bounds
writes, shared memory and occupancy, and launches, for every kernel of
``kernels/csrc``.

The JAX package's audit (its ``analysis/kernel_audit.py``) reads Pallas
BlockSpecs statically.  A CUDA launch has no BlockSpec to read, so this
audit runs each case on the card and looks at what the launch did:

  (a) **coverage** — every output and split-K scratch buffer a wrapper
      allocates (``kernels/loader.py:empty``) is filled first: NaN for a
      float buffer, a sentinel byte for codes.  No fill value may remain
      where the kernel must write (integer outputs are run twice, with two
      sentinels, so a code equal to the first sentinel is not taken for a
      hole), none may be overwritten where it must not (the pool bytes
      around a KV append's rows), and the result must equal the plain
      version within that kernel's tolerance (``TOL_*`` below, which
      ``chip_smoke.py`` phase 3 uses too).  The matmul kernels run at both
      result dtypes the main path writes: f32 and bf16.  A split partial left unwritten and read by the reduce
      reaches the result as NaN.
  (b) **out-of-bounds writes** — each such buffer is a view inside a larger
      allocation whose guard bands (``GUARD_BYTES`` before and after: more
      than any block's tile, 128 x 128 f32 = 64 KiB) hold a byte pattern;
      the pattern must be unchanged after the launch.  Inputs sit between
      NaN guard bands (sentinel bytes for codes, 0 for indices), so an
      out-of-bounds *read* that reaches the result shows as NaN or as a
      disagreement with the plain version.  This is a partial check of
      reads: a read past an input whose value the kernel discards, or an
      index read that lands on a valid page, is not seen.
  (c) **shared memory and occupancy** — each library records, while the
      audit runs, the kernel instantiations it launches (``csrc/
      launch_audit.cuh``); for each, ``cudaFuncGetAttributes``' static
      shared bytes, registers and local bytes, the dynamic shared bytes the
      launcher requested, and ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
      at that launch.  Static + dynamic above ``SMEM_LIMIT`` (227 KB, a
      Hopper block's most) or an occupancy of 0 is a finding.
  (d) **a launch** — a case whose kernel the launch counters
      (``kernels/ops.py:launch_counts``) did not see is ``KERNEL-NOCALL``.

A case that raises is ``KERNEL-ERROR``.  ``run_kernel_audit`` needs the
card and raises without one; ``audit_callable`` takes any callable on any
device (the tests hold the checks against deliberately broken callables
on the CPU).  Findings use logical paths like ``kernels/paged_attn[kv4]``
so the baseline is stable across source edits.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.findings import Finding

GUARD_BYTES = 256 * 1024
SMEM_LIMIT = 232448                 # 227 KB: a block's most on Hopper
SENTINELS = (0x5A, 0xA5)            # the fill bytes of integer outputs
_INPUT_CODE_FILL = 0x77             # guard bytes around code inputs (a
                                    # value of both int8 and uint8)

# Tolerances of each kernel against its plain version, with their reasons;
# ``chip_smoke.py`` phase 3 holds the kernels to the same ones.
# qmatmul, f32 result: both sides multiply the same level values (f32 for
#   f32 activations; rounded to bf16 on both sides for bf16 activations,
#   whose products are then exact in f32) and accumulate in f32; only the
#   summation order over K differs.  With |a| ~ 1 and |w| ~ 0.02 the result
#   is O(1) and order effects are O(1e-5).
TOL_QMM_F32 = 5e-4
# qmatmul, bf16 result: the f32 sums are rounded to bf16 on both sides, so
#   a sum that straddles a rounding boundary lands one bf16 ulp apart:
#   2^-8 relative to the largest result.
TOL_QMM_BF16_REL = 2.0 ** -7
# attention, f32 queries: everything is f32 on both sides; the softmax is
#   accumulated online in another order and expf/tanhf differ from torch's
#   by ulps.  Outputs are O(1).
TOL_ATT_F32 = 2e-4
# attention, bf16 queries, absolute: the plain version rounds the
#   dequantized K/V and the softmax weights to bf16 before its products;
#   the CUDA-core body keeps all three in f32, the tensor-core body takes
#   the plain version's own bf16 K/V and rounds P relative to the running
#   max; both round the result to bf16.  A few 2^-8 relative steps on
#   values below 2.
TOL_ATT_BF16 = 4e-2
# uniq_noise NOISE: u and u + e are identical on both sides; Phi^-1 is
#   erfinvf in the kernel and torch's own erfinv in the plain version.
#   Stated in units of the group's sigma (bf16: beyond one rounding step).
TOL_UNIQ_NOISE_SIGMA = 1e-3
# uniq_noise backward: the same operations on the same (w, w_hat); expf
#   against torch's exp, a few ulps relative (bf16: beyond one step).
TOL_UNIQ_BWD_REL = 1e-5
# qmatmul_a8, f32 result: the plain version sums f32 code * scale times
#   f32 levels (cuBLAS in f32); the kernel sums exact products of the codes
#   and three bf16 parts of each level on the tensor cores and applies
#   scale, mu and sigma after the sum.  Only the order of the sum and where
#   those three are applied differ.  Results are O(1-10).
TOL_QMM_A8 = 5e-4
# qmatmul_lut: as qmatmul (bf16 activations meet levels rounded to bf16 on
#   both sides, f32 activations f32 levels), f32 result.
TOL_QMM_LUT = 5e-4


# -- guarded allocations ----------------------------------------------------

def _pattern(n: int, device) -> torch.Tensor:
    return ((torch.arange(n, device=device, dtype=torch.int64) * 37 + 11)
            % 256).to(torch.uint8)


@dataclasses.dataclass
class _Slab:
    role: str                   # "out" | "scratch" | "in"
    back: torch.Tensor          # the whole allocation, uint8
    lo: int                     # byte offset of the view
    nbytes: int                 # bytes of the view
    pattern: Optional[torch.Tensor]  # what the guard bands hold (out/scratch)


class Guarded:
    """Allocations of one audit run: outputs and scratch between patterned
    guard bands, filled with NaN or ``sentinel``; inputs between NaN (or
    sentinel-byte / zero) guard bands.  ``alloc`` is the allocator
    ``loader.set_allocator`` takes."""

    def __init__(self, device, guard_bytes: int = GUARD_BYTES,
                 sentinel: int = SENTINELS[0]):
        self.device = torch.device(device)
        self.guard = -(-guard_bytes // 256) * 256
        self.sentinel = sentinel
        self.slabs: List[_Slab] = []

    def _fill(self, view: torch.Tensor) -> None:
        if view.dtype.is_floating_point:
            view.fill_(float("nan"))
        else:
            view.view(torch.uint8).fill_(self.sentinel)

    def alloc(self, shape, dtype: torch.dtype, device=None,
              role: str = "out") -> torch.Tensor:
        """A ``shape`` / ``dtype`` view inside a guarded allocation, filled
        as its role says."""
        item = torch.empty((), dtype=dtype).element_size()
        nbytes = math.prod(shape) * item
        body = -(-nbytes // 256) * 256
        pat = _pattern(2 * self.guard + body, self.device)
        back = pat.clone()
        view = back[self.guard:self.guard + nbytes].view(dtype).view(shape)
        self._fill(view)
        self.slabs.append(_Slab(role, back, self.guard, nbytes, pat))
        return view

    def output(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """An output a case allocates itself (a pool a kernel writes in
        place), guarded and filled as a wrapper's output."""
        return self.alloc(tuple(shape), dtype, self.device, "out")

    def input(self, t: torch.Tensor) -> torch.Tensor:
        """A contiguous copy of ``t`` between guard bands: NaN for float,
        ``_INPUT_CODE_FILL`` bytes for codes, 0 for wider integers
        (indices: a read past them lands on the sink page, not a trap)."""
        item = t.element_size()
        ge = self.guard // item
        if t.dtype.is_floating_point:
            fill = float("nan")
        else:
            fill = _INPUT_CODE_FILL if item == 1 else 0
        back = torch.full((2 * ge + t.numel(),), fill, dtype=t.dtype,
                          device=self.device)
        back[ge:ge + t.numel()] = t.reshape(-1).to(self.device)
        self.slabs.append(_Slab("in", back, ge * item, t.numel() * item,
                                None))
        return back[ge:ge + t.numel()].view(t.shape)

    def guard_breaches(self) -> List[Tuple[int, str, int]]:
        """(slab index, role, bytes changed) of every output / scratch
        allocation whose guard bands no longer hold their pattern."""
        out = []
        for i, s in enumerate(self.slabs):
            if s.pattern is None:
                continue
            hi = s.lo + s.nbytes
            changed = int((s.back[:s.lo] != s.pattern[:s.lo]).sum()) + int(
                (s.back[hi:] != s.pattern[hi:]).sum())
            if changed:
                out.append((i, s.role, changed))
        return out


@dataclasses.dataclass
class Check:
    """One kernel result of a case, against its plain version.

    ``must_write``: bool mask of the elements the kernel must write (None:
    all of them; elsewhere the fill must survive).  The agreement is taken
    where ``must_write`` and ``agree`` hold: integers equal, floats with
    ``max(|got - want| / scale) <= limit`` (``scale`` broadcasts; 1 if
    None), or ``err_fn(got, want) <= limit`` when given."""
    name: str
    got: torch.Tensor
    want: torch.Tensor
    limit: float = 0.0
    scale: Any = None
    must_write: Optional[torch.Tensor] = None
    agree: Optional[torch.Tensor] = None
    err_fn: Optional[Callable] = None


@dataclasses.dataclass(frozen=True)
class KernelCase:
    """A case: ``fn(g: Guarded) -> List[Check]`` launches the kernel named
    by ``counter`` (a key of ``ops.launch_counts``) on inputs from ``g``."""
    fn: Callable
    counter: Optional[str]


def _unwritten(check: Check, sentinel: int) -> torch.Tensor:
    """Elements of a result that still hold their fill."""
    g = check.got
    if g.dtype.is_floating_point:
        return torch.isnan(g)
    return g.view(torch.uint8).reshape(g.shape + (g.element_size(),)) \
        .eq(sentinel).all(-1)


def _disagreement(check: Check, where: torch.Tensor) -> float:
    got, want = check.got, check.want.to(check.got.device)
    if check.err_fn is not None:
        return float(check.err_fn(got[where], want[where])) \
            if bool(where.any()) else 0.0
    if not bool(where.any()):
        return 0.0
    if not got.dtype.is_floating_point:
        return float((got[where] != want[where]).sum())
    diff = (got.float() - want.float()).abs()
    if check.scale is not None:
        diff = diff / torch.as_tensor(check.scale, device=diff.device)
    d = diff[where]
    if bool(torch.isnan(d).any()):
        return float("inf")
    return float(d.max())


# -- launch records of the CUDA libraries ------------------------------------

_LIB_FNS: Dict[str, tuple] = {}


def _lib_fns():
    """(record, count, entry) of each CUDA library's audit entry points."""
    if not _LIB_FNS:
        from repro_torch.kernels import loader
        for name in loader.SOURCES:
            lib = loader.load(name)
            rec = getattr(lib, f"{name}_audit_record")
            rec.argtypes, rec.restype = [ctypes.c_int], None
            cnt = getattr(lib, f"{name}_audit_count")
            cnt.argtypes, cnt.restype = [], ctypes.c_int
            ent = getattr(lib, f"{name}_audit_entry")
            ent.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
                            ctypes.POINTER(ctypes.c_int)]
            ent.restype = ctypes.c_int
            _LIB_FNS[name] = (rec, cnt, ent)
    return _LIB_FNS


_ATTR_KEYS = ("static_smem", "dynamic_smem", "regs", "local_bytes",
              "threads", "blocks_per_sm", "max_threads", "binary_version")


@contextlib.contextmanager
def launch_records(device):
    """While active, every CUDA library records the instantiations it
    launches; yields a list filled on exit with one dict per instantiation
    (``library``, ``name`` and ``_ATTR_KEYS``).  Records nothing on the
    CPU."""
    out: List[Dict[str, Any]] = []
    if torch.device(device).type != "cuda":
        yield out
        return
    fns = _lib_fns()
    for rec, _, _ in fns.values():
        rec(1)
    try:
        yield out
        torch.cuda.synchronize(device)
    finally:
        for rec, _, _ in fns.values():
            rec(0)
    for lib, (_, cnt, ent) in fns.items():
        n = cnt()
        if n < 0:
            raise RuntimeError(f"{lib}: more kernel instantiations in one "
                               "case than the launch table holds")
        for i in range(n):
            name = ctypes.create_string_buffer(128)
            vals = (ctypes.c_int * len(_ATTR_KEYS))()
            rc = ent(i, name, 128, vals)
            if rc != 0:
                raise RuntimeError(f"{lib}: reading launch record {i} "
                                   f"failed with code {rc}")
            out.append({"library": lib, "name": name.value.decode(),
                        **dict(zip(_ATTR_KEYS, vals))})


def check_attributes(entries: Sequence[Dict[str, Any]],
                     name: str) -> List[Finding]:
    """Shared memory and occupancy of recorded instantiations."""
    findings = []
    for e in entries:
        smem = e["static_smem"] + e["dynamic_smem"]
        if smem > SMEM_LIMIT:
            findings.append(Finding(
                rule="KERNEL-SMEM", path=f"kernels/{name}",
                detail=f"{e['name']}:smem",
                message=f"{e['name']}: {e['static_smem']} B static + "
                        f"{e['dynamic_smem']} B dynamic shared memory "
                        f"exceeds the {SMEM_LIMIT} B a block may hold"))
        if e["blocks_per_sm"] <= 0:
            findings.append(Finding(
                rule="KERNEL-OCCUPANCY", path=f"kernels/{name}",
                detail=f"{e['name']}:occupancy",
                message=f"{e['name']}: no block of {e['threads']} threads "
                        f"and {smem} B shared memory fits an SM "
                        f"({e['regs']} registers a thread)"))
    return findings


# -- the audit of one case ----------------------------------------------------

def _check_runs(runs, name: str) -> List[Finding]:
    """Coverage, stray writes and agreement over one or two runs of a
    case (``runs``: [(Guarded, [Check])])."""
    findings = []
    path = f"kernels/{name}"
    g0, checks0 = runs[0]
    for ci, c in enumerate(checks0):
        must = c.must_write if c.must_write is not None else \
            torch.ones(c.got.shape, dtype=torch.bool, device=c.got.device)
        holes = _unwritten(c, g0.sentinel)
        for g, checks in runs[1:]:
            holes = holes & _unwritten(checks[ci], g.sentinel)
        n_holes = int((holes & must).sum())
        if n_holes:
            findings.append(Finding(
                rule="KERNEL-COVERAGE", path=path, detail=f"{c.name}:holes",
                message=f"{c.name}: {n_holes} of {int(must.sum())} elements "
                        "the kernel must write still hold the fill value"))
        n_stray = int((~holes & ~must).sum())
        if n_stray:
            findings.append(Finding(
                rule="KERNEL-STRAY", path=path, detail=f"{c.name}:stray",
                message=f"{c.name}: {n_stray} elements outside the "
                        "kernel's destinations were overwritten"))
        where = must & ~holes
        if c.agree is not None:
            where = where & c.agree
        err = _disagreement(c, where)
        if not err <= c.limit:
            findings.append(Finding(
                rule="KERNEL-MISMATCH", path=path, detail=f"{c.name}:plain",
                message=f"{c.name}: disagrees with its plain version by "
                        f"{err:.3e} > {c.limit:.3e}"))
    for g, _ in runs:
        for i, role, changed in g.guard_breaches():
            findings.append(Finding(
                rule="KERNEL-OOB", path=path, detail=f"{role}{i}:guard",
                message=f"{role} allocation {i}: {changed} guard bytes "
                        "around it changed — the kernel wrote out of "
                        "bounds"))
    return findings


def audit_callable(case: KernelCase, name: str, device="cuda",
                   guard_bytes: int = GUARD_BYTES,
                   ) -> Tuple[List[Finding], Dict[str, Any]]:
    """Run one case under the guarded allocator (twice when a result is
    integer: once with each of ``SENTINELS``) and check coverage,
    out-of-bounds writes, shared memory / occupancy and the launch count.
    A case that raises is a ``KERNEL-ERROR`` finding."""
    from repro_torch.kernels import loader
    from repro_torch.kernels import ops as kops
    findings: List[Finding] = []
    runs = []
    entries: List[Dict[str, Any]] = []
    launched = 0
    try:
        for sentinel in SENTINELS:
            g = Guarded(device, guard_bytes, sentinel)
            before = kops.launch_counts().get(case.counter, 0)
            prev = loader.set_allocator(g.alloc)
            try:
                with launch_records(device) as recs:
                    checks = case.fn(g)
            finally:
                loader.set_allocator(prev)
            launched += kops.launch_counts().get(case.counter, 0) - before
            entries = entries or recs
            runs.append((g, checks))
            if all(c.got.dtype.is_floating_point for c in checks):
                break
        findings.extend(_check_runs(runs, name))
    except Exception as e:   # noqa: BLE001 - the audit reports, not dies
        findings.append(Finding(
            rule="KERNEL-ERROR", path=f"kernels/{name}",
            detail=f"error:{type(e).__name__}",
            message=f"kernel case raised {type(e).__name__}: {e}"))
        return findings, {"kernel": name, "counter": case.counter,
                          "error": f"{type(e).__name__}: {e}"}
    if case.counter is not None and launched <= 0:
        findings.append(Finding(
            rule="KERNEL-NOCALL", path=f"kernels/{name}", detail="nocall",
            message=f"kernel case launched no {case.counter} — audit "
                    "coverage silently lost"))
    findings.extend(check_attributes(entries, name))
    return findings, {"kernel": name, "counter": case.counter,
                      "launches": launched, "runs": len(runs),
                      "instantiations": entries}


# -- the cases ----------------------------------------------------------------

def _gen(device, seed: int = 0) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


# the result dtypes of the matmul kernels: f32, and the bf16 the main path
# writes (``models/lm.py``, ``models/moe.py``: out_dtype of the activations)
_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _qmm_check(name: str, out, want, f32_tol: float) -> Check:
    """A matmul result against its plain version: an f32 result within
    ``f32_tol``, a bf16 one within ``TOL_QMM_BF16_REL`` of the largest
    plain result."""
    if out.dtype == torch.float32:
        return Check(f"{name}:f32", out, want, f32_tol)
    return Check(f"{name}:bf16", out, want, TOL_QMM_BF16_REL,
                 scale=want.float().abs().max().clamp_min(1e-30))


def _qmm_inputs(g: Guarded, gen, M, K, N, bits, a_dtype):
    from repro_torch.core import packing
    dev = g.device
    a = torch.randn((M, K), generator=gen, device=dev).to(a_dtype)
    if bits == 4:
        w = packing.pack_int4(torch.randint(0, 16, (K, N), generator=gen,
                                            device=dev))
    else:
        w = torch.randint(-128, 128, (K, N), generator=gen,
                          device=dev).to(torch.int8)
    mu = torch.randn((1, N), generator=gen, device=dev) * 0.002
    sigma = 0.02 * (0.5 + torch.rand((1, N), generator=gen, device=dev))
    return tuple(g.input(t) for t in (a, w, mu, sigma))


def _case_qmatmul(shapes, g: Guarded) -> List[Check]:
    """``shapes``: (M, K, N, bits, a_dtype) calls of ``qmatmul``."""
    from repro_torch.kernels import qmatmul as qm
    gen = _gen(g.device)
    checks = []
    for i, (M, K, N, bits, a_dtype) in enumerate(shapes):
        a, w, mu, sigma = _qmm_inputs(g, gen, M, K, N, bits, a_dtype)
        for od in _OUT_DTYPES:
            out = qm.qmatmul(a, w, mu, sigma, bits=bits, out_dtype=od)
            want = qm.qmatmul_plain(a, w, mu, sigma, bits=bits,
                                    out_dtype=od)
            checks.append(_qmm_check(f"out{i}", out, want, TOL_QMM_F32))
    return checks


def _lut(gen, dev, N, bits, per_col):
    k = 2 ** bits
    shape = (k, N) if per_col else (k,)
    return torch.sort(torch.randn(shape, generator=gen, device=dev) * 0.02,
                      dim=0).values


def _case_qmatmul_lut(shapes, g: Guarded) -> List[Check]:
    """``shapes``: (M, K, N, bits, a_dtype, per_col) calls of
    ``qmatmul_lut``."""
    from repro_torch.kernels import qmatmul as qm
    gen = _gen(g.device)
    checks = []
    for i, (M, K, N, bits, a_dtype, per_col) in enumerate(shapes):
        a, w, _, _ = _qmm_inputs(g, gen, M, K, N, bits, a_dtype)
        lut = g.input(_lut(gen, g.device, N, bits, per_col))
        for od in _OUT_DTYPES:
            out = qm.qmatmul_lut(a, w, lut, bits=bits, out_dtype=od)
            want = qm.qmatmul_lut_plain(a, w, lut, bits=bits, out_dtype=od)
            checks.append(_qmm_check(f"out{i}", out, want, TOL_QMM_LUT))
    return checks


def _case_qmatmul_a8(shapes, g: Guarded) -> List[Check]:
    """``shapes``: (M, K, N, bits, per_row_scale) calls of
    ``qmatmul_a8``."""
    from repro_torch.kernels import qmatmul as qm
    gen = _gen(g.device)
    checks = []
    for i, (M, K, N, bits, per_row) in enumerate(shapes):
        _, w, mu, sigma = _qmm_inputs(g, gen, M, K, N, bits, torch.float32)
        codes = g.input(torch.randint(-127, 128, (M, K), generator=gen,
                                      device=g.device).to(torch.int8))
        scale = g.input(0.01 + 0.01 * torch.rand(
            (M, 1) if per_row else (1,), generator=gen, device=g.device))
        for od in _OUT_DTYPES:
            out = qm.qmatmul_a8(codes, scale, w, mu, sigma, bits=bits,
                                out_dtype=od)
            want = qm.qmatmul_a8_plain(codes, scale, w, mu, sigma, bits=bits,
                                       out_dtype=od)
            checks.append(_qmm_check(f"out{i}", out, want, TOL_QMM_A8))
    return checks


def _expert_inputs(g: Guarded, gen, E, C, K, N, bits, rows):
    from repro_torch.core import packing
    dev = g.device
    a = torch.randn((E, C, K), generator=gen, device=dev).to(torch.bfloat16)
    used = torch.arange(C, device=dev)[None, :] < torch.tensor(
        rows, device=dev)[:, None]
    a = torch.where(used[..., None], a, torch.full_like(a, float("nan")))
    if bits == 4:
        w = packing.pack_int4(torch.randint(0, 16, (E, K, N), generator=gen,
                                            device=dev))
    else:
        w = torch.randint(-128, 128, (E, K, N), generator=gen,
                          device=dev).to(torch.int8)
    mu = torch.randn((1, N), generator=gen, device=dev) * 0.002
    sigma = 0.02 * (0.5 + torch.rand((1, N), generator=gen, device=dev))
    r = torch.tensor(rows, dtype=torch.int32, device=dev)
    return tuple(g.input(t) for t in (a, w, mu, sigma, r))


def _case_qmatmul_experts(shapes, g: Guarded) -> List[Check]:
    """``shapes``: (E, C, K, N, bits, rows) calls of ``qmatmul_experts``
    with bf16 activations (the unused rows NaN on the way in)."""
    from repro_torch.kernels import qmatmul as qm
    gen = _gen(g.device)
    checks = []
    for i, (E, C, K, N, bits, rows) in enumerate(shapes):
        a, w, mu, sigma, r = _expert_inputs(g, gen, E, C, K, N, bits, rows)
        for od in _OUT_DTYPES:
            out = qm.qmatmul_experts(a, w, mu, sigma, r, bits=bits,
                                     out_dtype=od)
            want = qm.qmatmul_experts_plain(a, w, mu, sigma, r, bits=bits,
                                            out_dtype=od)
            checks.append(_qmm_check(f"out{i}", out, want, TOL_QMM_F32))
    return checks


def _case_qmatmul_lut_experts(shapes, g: Guarded) -> List[Check]:
    """``shapes``: (E, C, K, N, bits, rows, per_col) calls of
    ``qmatmul_lut_experts``."""
    from repro_torch.kernels import qmatmul as qm
    gen = _gen(g.device)
    checks = []
    for i, (E, C, K, N, bits, rows, per_col) in enumerate(shapes):
        a, w, _, _, r = _expert_inputs(g, gen, E, C, K, N, bits, rows)
        lut = g.input(_lut(gen, g.device, N, bits, per_col))
        for od in _OUT_DTYPES:
            out = qm.qmatmul_lut_experts(a, w, lut, r, bits=bits,
                                         out_dtype=od)
            want = qm.qmatmul_lut_experts_plain(a, w, lut, r, bits=bits,
                                                out_dtype=od)
            checks.append(_qmm_check(f"out{i}", out, want, TOL_QMM_LUT))
    return checks


def _codec_stats(gen, dev, G, C, per_col):
    shape = (G, 1, C) if per_col else (G, 1, 1)
    mu = torch.randn(shape, generator=gen, device=dev) * 0.01
    sigma = 0.02 * (0.5 + torch.rand(shape, generator=gen, device=dev))
    return mu, sigma


def _case_kquantile(which, shapes, g: Guarded) -> List[Check]:
    """``shapes``: (G, R, C, k, per_col, dtype) calls of the quantize or
    dequantize kernel (``dtype``: the values' / the output's); both routes
    of ``codec_route`` are among them."""
    from repro_torch.kernels import kquantile as kq
    gen = _gen(g.device)
    checks = []
    for i, (G, R, C, k, per_col, dtype) in enumerate(shapes):
        packed = k <= 16 and C % 2 == 0
        mu, sigma = (g.input(t) for t in _codec_stats(gen, g.device, G, C,
                                                      per_col))
        w = (torch.randn((G, R, C), generator=gen, device=g.device) * 0.02
             ).to(dtype)
        if which == "quantize":
            w = g.input(w)
            out = kq.kquantile_quantize(w, mu, sigma, k=k, packed=packed)
            want = kq.kquantile_quantize_plain(w, mu, sigma, k=k,
                                               packed=packed)
        else:
            codes = g.input(kq.kquantile_quantize_plain(
                w.float(), mu, sigma, k=k, packed=packed))
            out = kq.kquantile_dequantize(codes, mu, sigma, k=k,
                                          out_dtype=dtype)
            want = kq.kquantile_dequantize_plain(codes, mu, sigma, k=k,
                                                 out_dtype=dtype)
        checks.append(Check(f"out{i}", out, want, 0.0))
    return checks


def _paged_pool(g: Guarded, gen, B, H, KV, D, page, n_pages, kv_bits,
                q_dtype):
    """A coded pool of ``1 + B * n_pages`` pages (page 0 the sink), block
    tables, ragged positions and queries, all guarded."""
    dev = g.device
    P = 1 + B * n_pages
    Dc = D // 2 if kv_bits == 4 else D

    def codes():
        c = torch.randint(0, 256, (P, page, KV, Dc), generator=gen,
                          device=dev)
        c = c.to(torch.uint8) if kv_bits == 4 else (c - 128).to(torch.int8)
        c[0] = 0
        return c

    def stats(scale, offset):
        s = (offset + scale * torch.randn((P, page, KV), generator=gen,
                                          device=dev)).to(torch.bfloat16)
        s[0] = 0
        return s.abs() if offset else s
    t = dict(k_codes=codes(), v_codes=codes(), k_mu=stats(0.1, 0.0),
             v_mu=stats(0.1, 0.0), k_sigma=stats(0.1, 1.0),
             v_sigma=stats(0.1, 0.5))
    bt = (torch.randperm(P - 1, generator=gen, device=dev) + 1).reshape(
        B, n_pages).to(torch.int32)
    S = n_pages * page
    qp = torch.randint(0, S, (B,), generator=gen, device=dev)
    qp[0], qp[-1] = 0, S - 1
    t["block_tables"] = bt
    t["q_pos"] = qp.to(torch.int32)
    t["q"] = torch.randn((B, 1, H, D), generator=gen, device=dev).to(q_dtype)
    return {n: g.input(v) for n, v in t.items()}


_ATTN_ARGS = ("q", "k_codes", "k_mu", "k_sigma", "v_codes", "v_mu",
              "v_sigma", "block_tables", "q_pos")


def _case_paged_attn(geoms, g: Guarded) -> List[Check]:
    """``geoms``: (B, H, KV, D, page, n_pages, kv_bits, q_dtype, splits)
    calls of ``paged_quant_attention``; which body (``attn_route``) each
    takes follows from the query dtype and the page."""
    from repro_torch.kernels import paged_attn as pa
    gen = _gen(g.device)
    checks = []
    for i, (B, H, KV, D, page, n_pages, kv_bits, q_dtype, splits) in \
            enumerate(geoms):
        t = _paged_pool(g, gen, B, H, KV, D, page, n_pages, kv_bits,
                        q_dtype)
        args = [t[n] for n in _ATTN_ARGS]
        out = pa.paged_quant_attention(*args, kv_bits=kv_bits, splits=splits)
        want = pa.paged_quant_attention_plain(*args, kv_bits=kv_bits)
        tol = TOL_ATT_F32 if q_dtype == torch.float32 else TOL_ATT_BF16
        checks.append(Check(f"out{i}", out, want, tol))
    return checks


def _case_paged_dequant(geoms, g: Guarded) -> List[Check]:
    """``geoms``: (B, page, KV, hd, n_pages, kv_bits, out_dtype) calls of
    ``kquantile_dequantize_paged`` (both routes of ``codec_route``)."""
    from repro_torch.kernels import kquantile as kq
    gen = _gen(g.device)
    checks = []
    for i, (B, page, KV, hd, n_pages, kv_bits, out_dtype) in enumerate(geoms):
        t = _paged_pool(g, gen, B, KV, KV, hd, page, n_pages, kv_bits,
                        torch.float32)
        out = kq.kquantile_dequantize_paged(
            t["k_codes"], t["k_mu"], t["k_sigma"], t["block_tables"],
            kv_bits=kv_bits, out_dtype=out_dtype)
        want = kq.kquantile_dequantize_paged_plain(
            t["k_codes"], t["k_mu"], t["k_sigma"], t["block_tables"],
            kv_bits=kv_bits, out_dtype=out_dtype)
        checks.append(Check(f"out{i}", out, want, 0.0))
    return checks


def _ulps_bf16(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest distance of two bf16 tensors in units in the last place."""
    def ordered(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)
    if a.numel() == 0:
        return 0.0
    return float((ordered(a) - ordered(b)).abs().max())


def _case_kv_append(shapes, g: Guarded) -> List[Check]:
    """``shapes``: (N, KV, hd, kv_bits, dtype, page) calls of ``kv_append``
    into a guarded pool layer filled with the sentinel: the rows written
    at distinct (page, row) slots of pages >= 1, every other pool byte
    untouched; statistics at most one bf16 ulp from the plain version's,
    codes equal where they agree (``chip_smoke.py`` phase 3's rule)."""
    from repro_torch.kernels import kquantile as kq
    gen = _gen(g.device)
    dev = g.device
    checks = []
    for i, (N, KV, hd, kv_bits, dtype, page) in enumerate(shapes):
        P = 2 + -(-N // page)
        slots = torch.randperm((P - 1) * page, generator=gen,
                               device=dev)[:N] + page
        pages = g.input(slots // page)
        rows = g.input(slots % page)
        k, v = (g.input(torch.randn((N, KV, hd), generator=gen, device=dev)
                        .to(dtype)) for _ in range(2))
        hdc = hd // 2 if kv_bits == 4 else hd
        cdt = torch.uint8 if kv_bits == 4 else torch.int8
        pool = {}
        for name in kq.KV_LEAVES:
            shape = (P, page, KV, hdc) if name.endswith("codes") \
                else (P, page, KV)
            pool[name] = g.output(shape, cdt if name.endswith("codes")
                                  else torch.bfloat16)
        want = {n: t.clone() for n, t in pool.items()}
        kq.kv_append(pool, pages, rows, k, v, kv_bits=kv_bits)
        kq.kv_append_plain(want, pages, rows, k, v, kv_bits=kv_bits)
        target = torch.zeros((P, page), dtype=torch.bool, device=dev)
        target[pages.long(), rows.long()] = True
        for side in ("k", "v"):
            agree = (pool[f"{side}_mu"] == want[f"{side}_mu"]) & \
                (pool[f"{side}_sigma"] == want[f"{side}_sigma"])
            for f in ("mu", "sigma"):
                checks.append(Check(f"{side}_{f}{i}", pool[f"{side}_{f}"],
                                    want[f"{side}_{f}"], 1.0,
                                    must_write=target[..., None].expand(
                                        P, page, KV),
                                    err_fn=_ulps_bf16))
            checks.append(Check(f"{side}_codes{i}", pool[f"{side}_codes"],
                                want[f"{side}_codes"], 0.0,
                                must_write=target[..., None, None].expand(
                                    P, page, KV, hdc),
                                agree=agree[..., None].expand(
                                    P, page, KV, hdc)))
    return checks


def _uniq_inputs(g: Guarded, gen, G, R, C, per_col, modes):
    dev = g.device
    scale = 0.01 + 0.04 * torch.rand((G, 1, 1), generator=gen, device=dev)
    w = torch.randn((G, R, C), generator=gen, device=dev) * scale \
        + 0.1 * scale
    dims = (1,) if per_col else (1, 2)
    mu = w.mean(dim=dims, keepdim=True).expand(G, 1, -1).contiguous()
    sigma = w.std(dim=dims, correction=0, keepdim=True).clamp_min(
        1e-8).expand(G, 1, -1).contiguous()
    e01 = torch.rand((G, R, C), generator=gen, device=dev)
    mode = torch.tensor(modes, dtype=torch.int32, device=dev)
    return tuple(g.input(t) for t in (w, mu, sigma, mode, e01))


# CLEAN and NOISE groups: CLEAN equal to the weight, NOISE within
# TOL_UNIQ_NOISE_SIGMA of the group's sigma (a FROZEN code may flip where
# CUDA's erff and torch's erf differ by an ulp next to a bin edge, which
# phase 3 counts over large tensors; this audit's small cases leave it out)
_UNIQ_MODES = (0, 1, 1)


def _case_uniq(which, shapes, g: Guarded) -> List[Check]:
    """``shapes``: (G, R, C, per_col) calls of the forward (``host``: e01
    from memory; ``onchip``: drawn in the kernel) or the backward on the
    plain forward's output; per-group statistics with R * C a multiple of 4
    take the GROUP body, per-column ones the FLAT body."""
    from repro_torch.kernels import uniq_noise as un
    gen = _gen(g.device)
    checks = []
    for i, (G, R, C, per_col) in enumerate(shapes):
        modes = (_UNIQ_MODES * G)[:G]
        w, mu, sigma, mode, e01 = _uniq_inputs(g, gen, G, R, C, per_col,
                                               modes)
        if which == "host":
            out = un.uniq_noise_fwd(w, mu, sigma, mode, e01, k=16)
            want = un.uniq_noise_fwd_plain(w, mu, sigma, mode, e01, k=16)
            checks.append(Check(f"out{i}", out, want, TOL_UNIQ_NOISE_SIGMA,
                                scale=sigma))
        elif which == "onchip":
            out = un.uniq_noise_fwd_onchip(w, mu, sigma, mode, 7 + i, k=16)
            want = un.uniq_noise_fwd_onchip_plain(w, mu, sigma, mode, 7 + i,
                                                  k=16)
            checks.append(Check(f"out{i}", out, want, TOL_UNIQ_NOISE_SIGMA,
                                scale=sigma))
        else:
            w_hat = g.input(un.uniq_noise_fwd_plain(w, mu, sigma, mode, e01,
                                                    k=16))
            grad = g.input(torch.randn((G, R, C), generator=gen,
                                       device=g.device))
            out = un.uniq_noise_bwd(grad, w, w_hat, mu, sigma, mode)
            want = un.uniq_noise_bwd_plain(grad, w, w_hat, mu, sigma, mode)
            checks.append(Check(f"out{i}", out, want, TOL_UNIQ_BWD_REL,
                                scale=want.abs().clamp_min(1e-30)))
    return checks


def _case(fn, counter, *args) -> KernelCase:
    return KernelCase(functools.partial(fn, *args), counter)


_BF, _F32 = torch.bfloat16, torch.float32

# the JAX package's case names where the kernel exists, then the port's
# own kernels; small shapes with ragged N and M, both bodies of each
# route rule, and the production geometries of the reference's cases
KERNEL_CASES: Dict[str, KernelCase] = {
    "qmatmul[w8]": _case(_case_qmatmul, "qmatmul", (
        (5, 200, 130, 8, _BF), (5, 200, 130, 8, _F32),
        (1, 64, 2, 8, _BF))),
    "qmatmul[w4]": _case(_case_qmatmul, "qmatmul", (
        (33, 520, 96, 4, _BF), (33, 520, 96, 4, _F32),
        (70, 77, 258, 4, _BF))),
    "qmatmul[prod_blocks]": _case(_case_qmatmul, "qmatmul", (
        (256, 1024, 512, 8, _BF), (128, 1024, 512, 4, _BF),
        (64, 1024, 512, 4, _F32))),
    "qmatmul[prod_decode_blocks]": _case(_case_qmatmul, "qmatmul", (
        (32, 2048, 2048, 4, _BF), (16, 2048, 2048, 4, _BF),
        (8, 2048, 2048, 4, _F32))),
    "qmatmul_lut[w4]": _case(_case_qmatmul_lut, "qmatmul_lut", (
        (8, 256, 130, 4, _BF, True), (8, 256, 130, 4, _F32, False),
        (5, 200, 130, 8, _BF, False))),
    "qmatmul_lut[prod_blocks]": _case(_case_qmatmul_lut, "qmatmul_lut", (
        (256, 1024, 512, 4, _BF, False), (16, 1024, 512, 4, _BF, True))),
    "qmatmul_a8[w8a8]": _case(_case_qmatmul_a8, "qmatmul_a8", (
        (16, 512, 130, 8, True), (33, 520, 96, 4, False),
        (64, 1024, 512, 8, True))),
    "qmatmul_experts": _case(_case_qmatmul_experts, "qmatmul_experts", (
        (4, 8, 256, 256, 4, (8, 3, 0, 5)),
        (3, 16, 256, 130, 4, (16, 1, 9)),
        (2, 8, 128, 96, 8, (2, 8)))),
    "qmatmul_lut_experts": _case(_case_qmatmul_lut_experts,
                                 "qmatmul_lut_experts", (
        (4, 8, 256, 256, 4, (8, 3, 0, 5), False),
        (3, 32, 256, 130, 4, (32, 1, 9), True))),
    "kquantile[quantize]": _case(_case_kquantile, "kquantile_quantize",
                                 "quantize", (
        (2, 64, 128, 16, True, _F32), (2, 33, 130, 16, True, _F32),
        (3, 8, 64, 16, False, _BF), (2, 7, 13, 256, False, _F32))),
    "kquantile[dequantize]": _case(_case_kquantile, "kquantile_dequantize",
                                   "dequantize", (
        (2, 64, 128, 16, True, _BF), (2, 33, 130, 16, True, _F32),
        (3, 8, 64, 256, False, _BF), (2, 7, 13, 256, False, _F32))),
    "kquantile_dequantize_paged": _case(
        _case_paged_dequant, "kquantile_dequantize_paged", (
            (2, 4, 2, 128, 3, 8, _BF), (2, 4, 2, 128, 3, 4, _BF),
            (3, 64, 8, 128, 2, 8, _BF), (2, 4, 2, 7, 3, 8, _F32))),
    "kv_append": _case(_case_kv_append, "kv_append", (
        (16, 8, 128, 8, _BF, 4), (16, 8, 128, 4, _BF, 4),
        (5, 2, 7, 8, _F32, 64), (40, 4, 160, 4, _F32, 16))),
    "uniq_noise[host]": _case(_case_uniq, "uniq_noise_fwd", "host", (
        (3, 64, 96, False), (2, 33, 130, True), (3, 5, 7, False))),
    "uniq_noise[onchip]": _case(_case_uniq, "uniq_noise_fwd_onchip",
                                "onchip", (
        (3, 64, 96, False), (2, 33, 130, True))),
    "uniq_noise_bwd": _case(_case_uniq, "uniq_noise_bwd", "bwd", (
        (3, 64, 96, False), (2, 33, 130, True))),
    # (B, H, KV, D, page, n_pages, kv_bits, q_dtype, splits): bf16 at page
    # 4 takes the CUDA-core body, as the engine replays of phase 4M do
    "paged_attn[kv8]": _case(_case_paged_attn, "paged_quant_attention", (
        (2, 4, 2, 8, 4, 2, 8, _F32, None), (2, 8, 2, 128, 4, 3, 8, _BF, None),
        (2, 8, 2, 128, 16, 3, 8, _BF, None))),
    "paged_attn[kv4]": _case(_case_paged_attn, "paged_quant_attention", (
        (2, 4, 2, 8, 4, 2, 4, _F32, None), (2, 8, 2, 128, 4, 3, 4, _BF, None),
        (2, 8, 2, 128, 16, 3, 4, _BF, None))),
    "paged_attn[prod_geometry]": _case(
        _case_paged_attn, "paged_quant_attention", (
            (2, 8, 4, 128, 64, 4, 8, _BF, None),
            (2, 8, 4, 128, 64, 4, 8, _F32, None))),
    "paged_attn[kv4_splitk]": _case(
        _case_paged_attn, "paged_quant_attention", (
            (2, 4, 2, 8, 4, 5, 4, _F32, 4), (2, 8, 2, 64, 8, 5, 4, _BF, 4))),
    "paged_attn[kv8_splitk]": _case(
        _case_paged_attn, "paged_quant_attention", (
            (2, 4, 2, 8, 4, 5, 8, _F32, 4), (2, 8, 2, 64, 8, 5, 8, _BF, 4))),
    "paged_attn[prod_splitk]": _case(
        _case_paged_attn, "paged_quant_attention", (
            (2, 8, 4, 128, 64, 8, 8, _BF, 4),
            (2, 8, 4, 128, 64, 8, 8, _F32, 4))),
}


def run_kernel_audit(cases: Optional[Sequence[str]] = None, device="cuda",
                     ) -> Tuple[List[Finding], Dict[str, Any]]:
    """Every case of ``KERNEL_CASES`` (or those named) on the card.
    Raises where there is no card: the audit reads launches, and the CPU
    has none."""
    from repro_torch.devices import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the kernel audit launches the CUDA kernels: it "
                           f"needs a CUDA device, got {dev}")
    findings: List[Finding] = []
    info: Dict[str, Any] = {"kernels": []}
    for name, case in KERNEL_CASES.items():
        if cases is not None and name not in cases:
            continue
        fs, i = audit_callable(case, name, dev)
        findings.extend(fs)
        info["kernels"].append(i)
    return findings, info


def kernel_table(info: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Per launch counter (the kernel's wrapper), over the audit's cases:
    the largest static / dynamic shared memory, registers and local bytes
    of its instantiations, the fewest blocks an SM holds, and their
    names."""
    table: Dict[str, Dict[str, Any]] = {}
    for k in info.get("kernels", []):
        row = table.setdefault(k["counter"], {
            "cases": [], "instantiations": [], "static_smem": 0,
            "dynamic_smem": 0, "regs": 0, "local_bytes": 0,
            "blocks_per_sm": None})
        row["cases"].append(k["kernel"])
        for e in k.get("instantiations", []):
            if e["name"] not in row["instantiations"]:
                row["instantiations"].append(e["name"])
            for key in ("static_smem", "dynamic_smem", "regs",
                        "local_bytes"):
                row[key] = max(row[key], e[key])
            occ = row["blocks_per_sm"]
            row["blocks_per_sm"] = e["blocks_per_sm"] if occ is None \
                else min(occ, e["blocks_per_sm"])
    return table
