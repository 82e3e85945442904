"""Builds the CUDA sources under ``csrc/`` and binds them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library, compiled by ``nvcc`` for ``sm_90a`` at first use: all stale sources
are compiled together, one ``nvcc`` process each, started at the same time.
Libraries are cached by a hash of the source, the headers beside it
(``csrc/*.cuh``) and the command line in the build directory
(``build/repro_torch_kernels`` at the root of the checkout, or
``$REPRO_TORCH_BUILD_DIR``).  A build failure raises; nothing falls back.

``empty`` allocates the kernel wrappers' outputs and scratch: ``torch.empty``
unless the kernel audit (``analysis/kernel_audit.py``) has installed its
guarded allocator.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"qmatmul": "qmatmul.cu", "paged_attn": "paged_attn.cu",
           "uniq_noise": "uniq_noise.cu", "kquantile": "kquantile.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / \
        "repro_torch_kernels"


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built from source at first use and need the CUDA "
                       "toolkit")


def _lib_path(name: str, extra_flags: Iterable[str]) -> Path:
    src = CSRC / SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + tuple(extra_flags)).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None,
              extra_flags: Iterable[str] = (),
              verbose: bool = False) -> Dict[str, float]:
    """Compile every stale library in parallel; returns seconds per name
    (0.0 for a cache hit).  Raises RuntimeError with nvcc's output on a
    failure."""
    names = list(names) if names is not None else list(SOURCES)
    extra_flags = tuple(extra_flags)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    took = {n: 0.0 for n in names}
    for n in names:
        target = _lib_path(n, extra_flags)
        if target.exists():
            continue
        nvcc = find_nvcc()
        tmp = target.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
               str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, target, time.perf_counter(), cmd)
    failures = []
    for n, (proc, tmp, target, t0, cmd) in procs.items():
        log, _ = proc.communicate()
        took[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)}\n{log}")
            continue
        if verbose and log:
            print(log)
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return took


def load(name: str) -> ctypes.CDLL:
    """The bound library for ``csrc/<name>.cu``; builds all sources on the
    first call so their compiles overlap."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_lib_path(name, ())))
        _LIBS[name] = lib
    return lib


# the allocator of the wrappers' outputs and scratch: None is torch.empty;
# the kernel audit installs one (``set_allocator``) for the span of a case
_ALLOCATOR: Optional[Callable] = None


def empty(shape, dtype: torch.dtype, device, role: str = "out"
          ) -> torch.Tensor:
    """An uninitialised tensor a kernel writes: ``role`` is ``"out"`` (the
    result) or ``"scratch"`` (split partials the kernel reads back)."""
    if _ALLOCATOR is None:
        return torch.empty(shape, dtype=dtype, device=device)
    return _ALLOCATOR(tuple(shape), dtype, torch.device(device), role)


def set_allocator(alloc: Optional[Callable]) -> Optional[Callable]:
    """Install ``alloc(shape, dtype, device, role)`` for ``empty`` (None:
    back to ``torch.empty``); returns the one it replaces."""
    global _ALLOCATOR
    prev, _ALLOCATOR = _ALLOCATOR, alloc
    return prev


_SMS: Dict[Optional[int], int] = {}


def sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device (the kernels' grids are
    sized from it, never from data on the device)."""
    n = _SMS.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _SMS[device.index] = n
    return n


_NO_SWITCH = contextlib.nullcontext()


def on_device(device: torch.device):
    """Context in which ``device`` is the current CUDA device: a raw launch
    goes to the thread's current device.  Free when it already is."""
    if device.index is None or device.index == torch.cuda.current_device():
        return _NO_SWITCH
    return torch.cuda.device(device)
