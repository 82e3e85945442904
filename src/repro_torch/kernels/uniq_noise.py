"""Fused UNIQ noise-injection / freeze transform and its gradient: CUDA
kernels + plain PyTorch versions.

Replaces the TPU kernels ``uniq_noise_fwd`` and ``uniq_noise_fwd_onchip``
of ``src/repro/kernels/uniq_noise.py`` and the backward ``_uniq_bwd`` of
``src/repro/kernels/ops.py`` (jnp there; a kernel here, because as a dozen
eager ops it would pass over every quantized weight element of the model on
every training step).  The source is ``csrc/uniq_noise.cu`` (see its header
for what bounds it and what the design does about that).  Every wrapper
launches its kernel for CUDA tensors and takes the plain version only for
CPU tensors.

``uniq_noise_fwd`` reads its noise ``e01`` as an operand;
``uniq_noise_fwd_onchip`` draws it inside the kernel from Philox4x32-10
keyed by the leaf's 64-bit key (``ref.onchip_e01`` gives the same bits as
torch integer ops, on any device).

Layout, as the reference's: weights ``(G, R, C)`` (G = stacked layers, 1
for a plain tensor), statistics ``(G, 1, C)`` or ``(G, 1, 1)`` f32, mode
``(G,)`` int32 on the weights' device, or one Python int for every group
(handed to the kernel by value: nothing is copied to the device), noise
``e01`` ``(G, R, C)`` f32 in [0, 1).  Any R and C: there is no
divisibility condition.

Two CUDA bodies take the forwards, picked by the fixed rule
``onchip_route``: the per-group body (a block row per group, its mode and
statistics in registers, Philox only for NOISE groups) for per-group
statistics, the flat body for the rest.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import loader
from repro_torch.kernels import ref as kref

_DTYPES = (torch.float32, torch.bfloat16)


GROUP = "group"
FLAT = "flat"


def onchip_route(G: int, R: int, C: int, per_col: bool) -> str:
    """Which CUDA body takes a forward (on-chip or host noise): ``GROUP``
    for per-group statistics with R * C a multiple of 4 below 2^31 and G
    within the grid's y limit (65535), ``FLAT`` for every other shape.  A
    fixed rule on the shapes, never on whether a launch succeeded.  The
    trainers' leaves are all ``GROUP``: per-group statistics (per layer of
    a stacked LM leaf, per kernel row of a CNN leaf)."""
    if per_col or (R * C) % 4 or R * C >= 1 << 31 or G > 65535:
        return FLAT
    return GROUP


def _mode_tensor(mode, G: int, device) -> torch.Tensor:
    """A mode given by value as the (G,) int32 tensor the plain versions
    take; a tensor as it is."""
    if isinstance(mode, torch.Tensor):
        return mode
    return torch.full((G,), mode, dtype=torch.int32, device=device)


def uniq_noise_fwd_plain(w, mu, sigma, mode, e01, *, k: int) -> torch.Tensor:
    """Plain version of the forward (``ref.uniq_transform_ref``)."""
    return kref.uniq_transform_ref(w, mu, sigma, e01,
                                   _mode_tensor(mode, w.shape[0], w.device), k)


def uniq_noise_fwd_onchip_plain(w, mu, sigma, mode, key: int, *,
                                k: int) -> torch.Tensor:
    """Plain version of the on-chip forward: the reference transform on
    the kernel's own draw, ``ref.onchip_e01(key, w.numel())``."""
    e01 = kref.onchip_e01(key, w.numel(), w.device).view(w.shape)
    return uniq_noise_fwd_plain(w, mu, sigma, mode, e01, k=k)


def uniq_noise_bwd_plain(g, w, w_hat, mu, sigma, mode) -> torch.Tensor:
    """Plain version of the backward (``ref.uniq_grad_ref``)."""
    return kref.uniq_grad_ref(g, w, w_hat, mu, sigma,
                              _mode_tensor(mode, w.shape[0], w.device))


def _mode_arg(mode):
    """(pointer, value) of a mode for a launch: a (G,) tensor is read by the
    kernel (value -1), an int is passed by value (null pointer)."""
    if isinstance(mode, torch.Tensor):
        _require_contiguous(mode=mode)
        return mode.data_ptr(), -1
    return None, mode


def _check(w, mu, sigma, mode, others):
    if w.ndim != 3:
        raise ValueError(f"w must be (G, R, C), got {tuple(w.shape)}")
    if w.dtype not in _DTYPES:
        raise TypeError(f"w must be float32 or bfloat16, got {w.dtype}")
    G, R, C = w.shape
    for name, s in (("mu", mu), ("sigma", sigma)):
        if s.dtype != torch.float32 or tuple(s.shape) not in (
                (G, 1, C), (G, 1, 1)):
            raise ValueError(f"{name} must be ({G}, 1, {C}) or ({G}, 1, 1) "
                             f"float32, got {tuple(s.shape)} {s.dtype}")
    if mu.shape != sigma.shape:
        raise ValueError("mu and sigma must have one shape")
    tensors = [mu, sigma, *(o[1] for o in others)]
    if isinstance(mode, torch.Tensor):
        if tuple(mode.shape) != (G,) or mode.dtype != torch.int32:
            raise ValueError(f"mode must be ({G},) int32, got "
                             f"{tuple(mode.shape)} {mode.dtype}")
        tensors.append(mode)
    elif type(mode) is not int or mode not in (kref.CLEAN, kref.NOISE,
                                               kref.FROZEN):
        raise ValueError(f"mode must be a ({G},) int32 tensor or one of "
                         f"CLEAN, NOISE, FROZEN, got {mode!r}")
    for name, t, dtype in others:
        if tuple(t.shape) != (G, R, C) or t.dtype != dtype:
            raise ValueError(f"{name} must be ({G}, {R}, {C}) {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for t in tensors:
        if t.device != w.device:
            raise ValueError("all operands must live on one device")
    if w.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"uniq_noise runs on cuda or cpu tensors, got "
                           f"{w.device}")
    return G, R, C


def _require_contiguous(**tensors):
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_k(k: int):
    if k < 2 or k > 256 or k & (k - 1):
        raise ValueError(f"k must be a power of two in [2, 256], got {k}")


_FNS = {}


def _bind(name: str):
    """A C entry point of ``csrc/uniq_noise.cu``, built and bound at first
    use."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(loader.load("uniq_noise"), name)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        u = ctypes.c_uint
        fn.argtypes = {
            "uniq_noise_fwd_launch":
                [p, i, p, p, p, i, p, i, p, p, i, i, ll, ll, ll, p],
            "uniq_noise_fwd_onchip_launch":
                [p, i, u, u, p, p, i, p, i, p, p, i, i, ll, ll, ll, p],
            "uniq_noise_onchip_e01_launch": [p, ll, u, u, p],
            "uniq_noise_bwd_launch":
                [p, p, p, i, p, p, i, p, i, p, ll, ll, ll, p]}[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _launch_fwd(route: str, w, mu, sigma, mode, *, k: int, e01=None,
                key=None) -> torch.Tensor:
    """Launch one forward body (``GROUP`` or ``FLAT``) on checked CUDA
    operands: the host-noise forward with ``e01``, the on-chip one with
    ``key``.  Counts nothing; the wrappers pick ``onchip_route``'s body
    (a comparison may name the other one on a shape both take)."""
    G, R, C = w.shape
    table = kref.level_table(k, w.device)
    per_col = mu.shape[-1] != 1
    mode_ptr, mode_value = _mode_arg(mode)
    with loader.on_device(w.device):
        out = loader.empty(w.shape, w.dtype, w.device)
        stream = torch.cuda.current_stream(w.device).cuda_stream
        head = (w.data_ptr(), int(w.dtype == torch.bfloat16))
        tail = (mu.data_ptr(), sigma.data_ptr(), int(per_col), mode_ptr,
                mode_value, table.data_ptr(), out.data_ptr(), k,
                int(route == GROUP), G, R, C, stream)
        if key is None:
            name = "uniq_noise_fwd_launch"
            rc = _bind(name)(*head, e01.data_ptr(), *tail)
        else:
            name = "uniq_noise_fwd_onchip_launch"
            rc = _bind(name)(*head, *kref.key_words(key), *tail)
    if rc != 0:
        raise RuntimeError(f"{name} failed with code {rc} ({route} body, "
                           f"G={G}, R={R}, C={C}, k={k})")
    return out


def uniq_noise_fwd(w: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor,
                   mode, e01: torch.Tensor, *, k: int) -> torch.Tensor:
    """w_hat (G, R, C) in w's dtype: CLEAN / NOISE / FROZEN per group.

    ``mode``: (G,) int32 on w's device, or one int for every group.  CUDA
    tensors launch the body ``onchip_route`` picks (or raise); CPU tensors
    take the plain version.  ``uniq_noise_fwd.launches`` counts kernel
    launches.
    """
    _check_k(k)
    G, R, C = _check(w, mu, sigma, mode, [("e01", e01, torch.float32)])
    if w.device.type == "cpu":
        return uniq_noise_fwd_plain(w, mu, sigma, mode, e01, k=k)
    _require_contiguous(w=w, mu=mu, sigma=sigma, e01=e01)
    out = _launch_fwd(onchip_route(G, R, C, mu.shape[-1] != 1), w, mu,
                      sigma, mode, k=k, e01=e01)
    uniq_noise_fwd.launches += 1
    return out


def uniq_noise_fwd_onchip(w: torch.Tensor, mu: torch.Tensor,
                          sigma: torch.Tensor, mode, key: int,
                          *, k: int) -> torch.Tensor:
    """w_hat (G, R, C) in w's dtype, as ``uniq_noise_fwd`` with ``e01``
    drawn inside the kernel from Philox4x32-10 under the 64-bit ``key``
    (element i of w in storage order takes lane i % 4 of counter i / 4).

    ``mode``: (G,) int32 on w's device, or one int for every group.  CUDA
    tensors launch the body ``onchip_route`` picks (or raise); CPU tensors
    take the plain version.  ``uniq_noise_fwd_onchip.launches`` counts
    kernel launches.
    """
    _check_k(k)
    key = int(key)
    if not 0 <= key < 1 << 64:
        raise ValueError(f"key must be a 64-bit unsigned value, got {key}")
    G, R, C = _check(w, mu, sigma, mode, [])
    if w.device.type == "cpu":
        return uniq_noise_fwd_onchip_plain(w, mu, sigma, mode, key, k=k)
    _require_contiguous(w=w, mu=mu, sigma=sigma)
    out = _launch_fwd(onchip_route(G, R, C, mu.shape[-1] != 1), w, mu,
                      sigma, mode, k=k, key=key)
    uniq_noise_fwd_onchip.launches += 1
    return out


def onchip_e01(key: int, n: int, device) -> torch.Tensor:
    """The on-chip draw itself, (n,) f32, written by the kernel's own
    generator on a CUDA device (a debug entry point: it is what the
    forward draws, read back for a bit-for-bit check) or by the plain
    version on the CPU.  Not counted: the main path never calls it."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return kref.onchip_e01(key, n, dev)
    if dev.type != "cuda":
        raise RuntimeError(f"onchip_e01 runs on cuda or cpu, got {dev}")
    fn = _bind("uniq_noise_onchip_e01_launch")
    lo, hi = kref.key_words(key)
    with loader.on_device(dev):
        out = torch.empty((n,), dtype=torch.float32, device=dev)
        rc = fn(out.data_ptr(), n, lo, hi,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"onchip_e01 kernel launch failed with code {rc} "
                           f"(n={n})")
    return out


def uniq_noise_bwd(g: torch.Tensor, w: torch.Tensor, w_hat: torch.Tensor,
                   mu: torch.Tensor, sigma: torch.Tensor,
                   mode) -> torch.Tensor:
    """dL/dw (G, R, C) from dL/dw_hat ``g``: the NOISE pdf ratio, 1 for
    CLEAN, 0 for FROZEN (see ``ref.uniq_grad_ref``).  Needs no noise.
    ``mode``: (G,) int32 on w's device, or one int for every group.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version.  ``uniq_noise_bwd.launches`` counts kernel launches.
    """
    G, R, C = _check(w, mu, sigma, mode, [("g", g, w.dtype),
                                          ("w_hat", w_hat, w.dtype)])
    if w.device.type == "cpu":
        return uniq_noise_bwd_plain(g, w, w_hat, mu, sigma, mode)
    _require_contiguous(g=g, w=w, w_hat=w_hat, mu=mu, sigma=sigma)
    fn = _bind("uniq_noise_bwd_launch")
    mode_ptr, mode_value = _mode_arg(mode)
    with loader.on_device(w.device):
        dw = loader.empty(w.shape, w.dtype, w.device)
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = fn(g.data_ptr(), w.data_ptr(), w_hat.data_ptr(),
                int(w.dtype == torch.bfloat16), mu.data_ptr(),
                sigma.data_ptr(), int(mu.shape[-1] != 1), mode_ptr,
                mode_value, dw.data_ptr(), G, R, C, stream)
    if rc != 0:
        raise RuntimeError(f"uniq_noise_bwd kernel launch failed with code "
                           f"{rc} (G={G}, R={R}, C={C})")
    uniq_noise_bwd.launches += 1
    return dw


uniq_noise_fwd.launches = 0
uniq_noise_fwd_onchip.launches = 0
uniq_noise_bwd.launches = 0
