"""Optimizers: SGD(+momentum) and AdamW, with per-layer freeze masks (UNIQ
gradual schedule), gradient clipping, LR schedules, and optional bf16 /
int8-coded momentum.

The paper fine-tunes with SGD, lr 1e-4, momentum 0.9, weight decay 1e-4,
reducing the LR as noise is injected — ``cosine_schedule`` /
``stage_scaled_lr`` implement that.

State is a plain tree (nested dicts) so checkpoints carry it leaf by leaf:
``{"mu": {<param path>: {"m": codes[, "ms": scale]}}, ["nu": ...,]
"count": 0-d int32}``.  ``count`` and the learning rate are host values
(CPU tensors).  Where the reference's jit donates the state, the port
updates in place: ``apply_updates`` writes each new parameter and moment
into the tensors it was given, so a step holds one leaf's temporaries
beyond the state, not a second copy of it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.parallel import collectives as coll


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    kind: str = "sgd"                 # sgd | adamw
    lr: float = 1e-4                  # paper Sec. 4 fine-tune default
    momentum: float = 0.9
    weight_decay: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0            # 0 = off
    momentum_dtype: str = "float32"   # float32 | bfloat16 | int8


# --------------------------------------------------------------------------
# Momentum codec: f32, bf16, or int8 with a per-leading-slice absmax scale
# --------------------------------------------------------------------------

def _encode_m(m: torch.Tensor, dtype: str, groups=()):
    """``groups``: m is a rank's block whose reduced dims are split over
    them; the int8 absmax is the whole slice's (a max all-reduce)."""
    if dtype == "float32":
        return m.to(torch.float32), None
    if dtype == "bfloat16":
        return m.to(torch.bfloat16), None
    if dtype != "int8":
        raise ValueError(f"momentum_dtype must be float32|bfloat16|int8, "
                         f"got {dtype!r}")
    if m.ndim >= 2:    # per leading slice: per layer for stacked params
        amax = torch.amax(m.abs(), dim=tuple(range(1, m.ndim)), keepdim=True)
    else:
        amax = torch.amax(m.abs())
    if groups:
        amax = coll.all_reduce_max(amax, groups)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    codes = torch.clamp(torch.round(m / scale), -127, 127).to(torch.int8)
    return codes, scale.to(torch.float32)


def _decode_m(codes: torch.Tensor, scale, dtype: str) -> torch.Tensor:
    if dtype in ("float32", "bfloat16"):
        return codes.to(torch.float32)
    return codes.to(torch.float32) * scale


def init_state(params: Any, cfg: OptimConfig) -> Any:
    def zero_m(p):
        codes, scale = _encode_m(torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device),
                                 cfg.momentum_dtype)
        return {"m": codes} if scale is None else {"m": codes, "ms": scale}

    count = torch.zeros((), dtype=torch.int32)
    if cfg.kind == "sgd":
        return {"mu": tree_lib.map_tree(zero_m, params), "count": count}
    if cfg.kind == "adamw":
        return {"mu": tree_lib.map_tree(zero_m, params),
                "nu": tree_lib.map_tree(
                    lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params),
                "count": count}
    raise ValueError(f"optimizer kind must be sgd|adamw, got {cfg.kind!r}")


def global_norm(tree: Any, placement=None) -> torch.Tensor:
    """The L2 norm over every leaf.  With ``placement``
    (``sharding.Placement``) the leaves are a rank's blocks: the squares of
    the leaves split over the same axes are summed, each such sum
    all-reduced over those axes, so a replicated leaf counts once."""
    if placement is None:
        total = None
        for g in tree_lib.leaves(tree):
            s = torch.sum(torch.square(g.to(torch.float32)))
            total = s if total is None else total + s
        return torch.sqrt(total)
    by_axes: dict = {}
    for path, g in tree_lib.leaves_with_paths(tree):
        s = torch.sum(torch.square(g.to(torch.float32)))
        ax = placement.split_axes(path)
        by_axes[ax] = s if ax not in by_axes else by_axes[ax] + s
    total = None
    for ax in sorted(by_axes):
        s = by_axes[ax]
        if ax:
            s = coll.all_reduce(s, placement.groups(ax))
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads: Any, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_lib.map_tree(
        lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), norm


def _mask_of(mask, p: torch.Tensor):
    if mask is None:
        return 1.0
    m = torch.as_tensor(mask, device=p.device).to(torch.float32)
    return m.reshape(tuple(m.shape) + (1,) * (p.ndim - m.ndim))


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: Any, cfg: OptimConfig,
                  lr, freeze_mask: Optional[Any] = None, placement=None):
    """One optimizer step, in place.  ``freeze_mask``: tree (or None) of
    0/1 tensors broadcastable against each parameter from the left — 0
    freezes (UNIQ FROZEN blocks): the parameter and its momentum keep their
    values; AdamW's second moment decays as in the reference.

    Clipping is ``clip_by_global_norm``'s, applied leaf by leaf as each is
    updated, so no clipped copy of the whole gradient tree is made.

    ``placement`` (``sharding.Placement``): every tree holds a rank's
    blocks (the norm and the int8 moments' absmax are the whole leaves').

    Returns (params, state, metrics) — the same trees, updated.
    """
    gnorm = global_norm(grads, placement)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0) if cfg.grad_clip > 0 else None)
    count = state["count"] + 1
    lr = torch.as_tensor(lr, dtype=torch.float32)
    if cfg.kind == "adamw":
        c = count.to(torch.float32)
        bc1 = 1 - torch.tensor(cfg.beta1, dtype=torch.float32) ** c
        bc2 = 1 - torch.tensor(cfg.beta2, dtype=torch.float32) ** c

    def one(path, p, g, mu_d, *rest):
        mk = rest[-1] if freeze_mask is not None else None
        nu = rest[0] if cfg.kind == "adamw" else None
        if clip is not None:
            g = (g.to(torch.float32) * clip).to(g.dtype)
        g32 = g.to(torch.float32)
        del g
        p32 = p.to(torch.float32)
        m_prev = _decode_m(mu_d["m"], mu_d.get("ms"), cfg.momentum_dtype)
        mask = _mask_of(mk, p)
        # each leaf-sized temporary is dropped once read for the last time
        # (a leaf of 1.4 G elements is 5.4 GiB a copy)
        if cfg.kind == "sgd":
            m_new = cfg.momentum * m_prev + (g32 + cfg.weight_decay * p32)
            del g32
            upd = lr * m_new
        else:
            m_new = cfg.beta1 * m_prev + (1 - cfg.beta1) * g32
            nu.copy_(cfg.beta2 * nu + (1 - cfg.beta2) * g32 * g32)
            del g32
            # mhat / (sqrt(nhat) + eps), mhat = m / bc1, nhat = nu / bc2
            denom = torch.sqrt(nu / bc2) + cfg.eps
            upd = (m_new / bc1) / denom
            del denom
            upd = lr * (upd + cfg.weight_decay * p32)
        p_next = p32 - upd * mask
        del upd
        # frozen params also keep their previous momentum
        m_keep = m_prev * (1.0 - mask) + m_new * mask
        del m_new
        codes, scale = _encode_m(m_keep, cfg.momentum_dtype, () if
                                 placement is None else placement.groups(
                                     placement.split_axes(
                                         path, range(1, p.ndim)
                                         if p.ndim >= 2 else None)))
        mu_d["m"].copy_(codes)
        if scale is not None:
            mu_d["ms"].copy_(scale)
        p.copy_(p_next)
        return p

    rest = [state["nu"]] if cfg.kind == "adamw" else []
    if freeze_mask is not None:
        rest.append(freeze_mask)
    tree_lib.map_with_path(one, params, grads, state["mu"], *rest)
    state["count"] = count
    return params, state, {"grad_norm": gnorm}


# --------------------------------------------------------------------------
# LR schedules: step (host int) -> 0-d f32 tensor
# --------------------------------------------------------------------------

def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def cosine_schedule(base_lr: float, total_steps: int,
                    warmup: int = 0) -> Callable[[Any], torch.Tensor]:
    def lr_at(step):
        step = _f32(step)
        warm = torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                        0.0, 1.0)
        return base_lr * warm * 0.5 * (1.0 + torch.cos(math.pi * t))
    return lr_at


def constant_schedule(base_lr: float) -> Callable[[Any], torch.Tensor]:
    return lambda step: _f32(base_lr)


def stage_scaled_lr(base_lr: float, steps_per_stage: int,
                    decay: float = 0.5) -> Callable[[Any], torch.Tensor]:
    """Paper Sec. 3.2: reduce the LR as noise is injected — decay per
    gradual-quantization stage."""
    def lr_at(step):
        stage = torch.floor_divide(_f32(step), max(steps_per_stage, 1))
        return base_lr * (_f32(decay) ** torch.clamp(stage, max=8.0))
    return lr_at
