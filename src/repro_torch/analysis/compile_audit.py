"""Compile audit of the port: the two contracts of the JAX package's audit
that mean something without a tracer.

  * **byte accounting** — for every engine family x kv_bits x page_size,
    the pool ``models/model.py:init_paged_cache`` actually allocates must
    cost exactly ``total_pages * kv_cache.page_kv_bytes(cfg, page,
    kv_bits)``: that formula is the scheduler's admission currency, and a
    codec layout drifting from it silently breaks byte-budget admission
    (``pool_bytes``).  The smoke configs always; with ``full=True`` also
    the published widths of granite_3_8b and kimi_k2 (a real allocation:
    on the card).
  * **step-shape budget** — the port runs eagerly, so there is no jit
    cache to count; what would make a compiled step recompile is a new
    (shape, dtype) signature of the tensors the engine hands the model.
    The audit wraps ``model.decode`` and ``model.prefill`` (inside the
    audit only, never in the engine), serves the JAX package's two-bucket
    workload on a smoke engine per kv_bits and holds the distinct
    signatures to its budget: exactly 1 decode signature and 1 prefill
    signature per prompt bucket (growth moves block tables and positions,
    never shapes).

The JAX audit's sharding coverage, ``eval_shape`` entry points and config
hashability read XLA or jit and are not ported (ROADMAP.md, "Not ported,
by design").
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.findings import Finding

KV_BITS_MATRIX = (16, 8, 4)
PAGE_SIZE_MATRIX = (8, 16)
# the engine families (the paged-cache ones), at their smoke sizes
ENGINE_ARCHS = ("granite_3_8b", "kimi_k2_1t_a32b")
# the published widths the audit also allocates on the card
FULL_ARCHS = ("granite_3_8b", "kimi_k2_1t_a32b")
# the step-shape budget of the two-bucket workload
DECODE_BUDGET = 1
PREFILL_BUCKETS = 2


def _leaf_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_leaf_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


# -- byte accounting --------------------------------------------------------

def check_byte_accounting(archs: Sequence[str] = ENGINE_ARCHS,
                          kv_bits_list: Sequence[int] = KV_BITS_MATRIX,
                          page_sizes: Sequence[int] = PAGE_SIZE_MATRIX,
                          device="cpu", full: bool = False,
                          ) -> Tuple[List[Finding], Dict[str, Any]]:
    """Allocate each cell's pool on ``device`` and hold its bytes to the
    admission formula; ``full`` adds ``FULL_ARCHS`` at published widths
    (cells named ``<arch>:full/...``)."""
    from repro_torch.configs import base as cb
    from repro_torch.models import kv_cache, model
    findings: List[Finding] = []
    cells = []
    total_pages = 7   # any page count works; bytes must scale exactly
    configs = [(arch, cb.get_smoke(arch)) for arch in archs]
    if full:
        configs += [(f"{arch}:full", cb.get(arch)) for arch in FULL_ARCHS]
    for name, cfg in configs:
        for kv_bits in kv_bits_list:
            for page in page_sizes:
                pool = model.init_paged_cache(cfg, total_pages, page,
                                              torch.bfloat16,
                                              kv_bits=kv_bits, device=device)
                got = _leaf_bytes(pool)
                del pool
                want = total_pages * kv_cache.page_kv_bytes(
                    cfg, page, kv_bits, dense_itemsize=2)
                cell = f"{name}/kv{kv_bits}/page{page}"
                cells.append({"cell": cell, "pool_bytes": got,
                              "page_bytes": want // total_pages})
                if got != want:
                    findings.append(Finding(
                        rule="AUDIT-BYTES", path="models/kv_cache.py",
                        detail=cell,
                        message=f"{cell}: init_paged_cache allocates "
                                f"{got} B but page_kv_bytes predicts "
                                f"{want} B — the scheduler admits in a "
                                "currency the pool no longer spends"))
    return findings, {"byte_cells": cells}


# -- step-shape budget ------------------------------------------------------

def _signature(value):
    """(shape, dtype) structure of a step argument: tensors by shape and
    dtype, dicts / sequences recursively, anything else (configs, options)
    left out."""
    if isinstance(value, torch.Tensor):
        return (tuple(value.shape), str(value.dtype))
    if isinstance(value, dict):
        return tuple((k, _signature(v)) for k, v in sorted(value.items()))
    if isinstance(value, (list, tuple)):
        return tuple(_signature(v) for v in value)
    if isinstance(value, np.ndarray):
        return (value.shape, str(value.dtype))
    return None


@contextlib.contextmanager
def record_step_shapes(names=("decode", "prefill")):
    """While active, ``models/model.py``'s ``names`` entry points record the
    signature of every call (all arguments but the parameters) into the
    yielded {name: set}; the originals are restored on exit."""
    from repro_torch.models import model
    seen: Dict[str, set] = {n: set() for n in names}
    originals = {n: getattr(model, n) for n in names}

    def wrap(name, fn):
        def recorded(params, *args, **kwargs):
            seen[name].add((_signature(args),
                            _signature(dict(kwargs))))
            return fn(params, *args, **kwargs)
        return recorded
    for n, fn in originals.items():
        setattr(model, n, wrap(n, fn))
    try:
        yield seen
    finally:
        for n, fn in originals.items():
            setattr(model, n, fn)


def two_bucket_requests(vocab: int, seed: int = 0):
    """The JAX audit's workload: six prompts of 4..6 (bucket 8) and 10..12
    (bucket 16) tokens, 12 new tokens each (enough to grow pages)."""
    from repro_torch.serve.scheduler import Request, SamplingParams
    rng = np.random.default_rng(seed)
    return [Request(uid=i,
                    prompt=rng.integers(
                        0, vocab,
                        int(4 + (i % 3) + (i % 2) * 6)).astype(np.int32),
                    sampling=SamplingParams(max_new_tokens=12))
            for i in range(6)]


def check_step_shapes(kv_bits_list: Sequence[int] = KV_BITS_MATRIX,
                      arch: str = "granite_3_8b", device="cpu",
                      ) -> Tuple[List[Finding], Dict[str, Any]]:
    """Serve the two-bucket mix on a smoke engine per kv_bits (f32, max 4
    slots, pages of 8); the distinct decode / prefill signatures must be
    exactly ``DECODE_BUDGET`` and ``PREFILL_BUCKETS``."""
    from repro_torch.configs import base as cb
    from repro_torch.models import model
    from repro_torch.models.lm import ModelOpts
    from repro_torch.serve.engine import Engine, EngineConfig
    findings: List[Finding] = []
    info: Dict[str, Any] = {"step_shapes": []}
    cfg = cb.get_smoke(arch)
    opts = ModelOpts(compute_dtype=torch.float32, remat=False,
                     attn_chunked_min_len=1 << 30)
    params = model.init(0, cfg, device=device)
    for kv_bits in kv_bits_list:
        ec = EngineConfig(max_slots=4, max_len=64, prefill_batch=2,
                          min_bucket=8, cache_mode="paged", page_size=8,
                          kv_bits=kv_bits)
        eng = Engine(params, cfg, opts, ec, device=device)
        with record_step_shapes() as seen:
            eng.generate(two_bucket_requests(cfg.vocab))
        n_decode, n_prefill = len(seen["decode"]), len(seen["prefill"])
        info["step_shapes"].append({
            "kv_bits": kv_bits, "decode_signatures": n_decode,
            "prefill_signatures": n_prefill, "buckets": PREFILL_BUCKETS})
        if n_decode != DECODE_BUDGET:
            findings.append(Finding(
                rule="AUDIT-STEPSHAPE", path="serve/engine.py",
                detail=f"kv{kv_bits}:decode",
                message=f"kv{kv_bits}: the engine handed decode {n_decode} "
                        "distinct (shape, dtype) signatures over a "
                        f"steady-state run; the budget is {DECODE_BUDGET} — "
                        "some shape/dtype is varying per step"))
        if n_prefill != PREFILL_BUCKETS:
            findings.append(Finding(
                rule="AUDIT-STEPSHAPE", path="serve/engine.py",
                detail=f"kv{kv_bits}:prefill",
                message=f"kv{kv_bits}: prefill saw {n_prefill} signatures "
                        f"for a {PREFILL_BUCKETS}-bucket workload; the "
                        "budget is 1 per bucket"))
        del eng
    return findings, info


# -- driver -----------------------------------------------------------------

def run_compile_audit(kv_bits_list: Sequence[int] = KV_BITS_MATRIX,
                      with_engine: bool = True, device="cpu",
                      full: bool = False,
                      ) -> Tuple[List[Finding], Dict[str, Any]]:
    findings, info = check_byte_accounting(device=device, full=full)
    if with_engine:
        fs, i = check_step_shapes(kv_bits_list, device=device)
        findings.extend(fs)
        info.update(i)
    return findings, info


__all__ = ["check_byte_accounting", "check_step_shapes",
           "record_step_shapes", "run_compile_audit",
           "two_bucket_requests"]
