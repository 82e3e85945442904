"""Collectives over a mesh's process groups, and the UNIQ-compressed
cross-pod gradient synchronisation (the reference's
``src/repro/parallel/collectives.py``).

The ``pod`` mesh axis is pure data parallelism over the slowest link.
Instead of an f32 all-reduce of the gradients, ``compressed_pmean``

    1. codes each rank's local gradient leaf to int8 with a per-(leading
       slice) absmax scale (``_absmax_quant``, the optimizer's int8 codec),
    2. all-gathers codes + scales over the group (traffic ~ (n-1)/n * size
       * 1 B, ~4x less than f32),
    3. dequantizes and averages locally, summing the ranks in rank order.

Every rank computes the identical average from the same gathered bits, so
optimizer states stay in lockstep without a re-broadcast.

``all_reduce`` / ``all_gather`` are the port's collective wrappers: they
take one process group or several (a mesh axis each; several in turn, as
one collective over their product) and count their calls
(``collective_counts``), one a call whatever the groups' sizes, so a run
can show that it went through them.  A collective that fails raises: there
is no local fallback.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Union

import torch
import torch.distributed as dist

from repro_torch import tree as tree_lib

_CALLS = {"all_reduce": 0, "all_gather": 0}


def collective_counts() -> Dict[str, int]:
    """Wrapper calls since the last reset, by collective."""
    return dict(_CALLS)


def reset_collective_counts() -> None:
    for k in _CALLS:
        _CALLS[k] = 0


Groups = Union[dist.ProcessGroup, Sequence[dist.ProcessGroup]]


def _groups(groups: Groups):
    return list(groups) if isinstance(groups, (list, tuple)) else [groups]


def all_reduce(t: torch.Tensor, groups: Groups) -> torch.Tensor:
    """Sum ``t`` over the groups (in place; returned)."""
    _CALLS["all_reduce"] += 1
    for g in _groups(groups):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=g)
    return t


def all_gather(t: torch.Tensor, groups: Groups, dim: int = 0) -> torch.Tensor:
    """The groups' blocks of ``t`` concatenated along ``dim`` in rank
    order; over several groups the first is outermost (the block order
    of a dim sharded over those axes)."""
    _CALLS["all_gather"] += 1
    t = t.contiguous()
    for g in reversed(_groups(groups)):
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(g))]
        dist.all_gather(parts, t, group=g)
        t = torch.cat(parts, dim=dim)
    return t


def _stack_gather(t: torch.Tensor, group) -> torch.Tensor:
    """(n, *t.shape): every rank's ``t`` in rank order."""
    return all_gather(t[None], group, dim=0)


def _absmax_quant(g: torch.Tensor, bits: int = 8):
    """int8 codes of ``g`` and their f32 scale (one per leading slice; the
    whole leaf's for 1-D), kept with ``g``'s rank (the reference's)."""
    qmax = 2.0 ** (bits - 1) - 1.0
    dims = tuple(range(1, g.ndim)) if g.ndim >= 2 else (0,)
    amax = torch.amax(torch.abs(g), dim=dims, keepdim=True)
    scale = torch.clamp(amax.to(torch.float32), min=1e-30) / qmax
    codes = torch.clamp(torch.round(g.to(torch.float32) / scale), -qmax, qmax)
    return codes.to(torch.int8), scale


def _exact_mean(g: torch.Tensor, group) -> torch.Tensor:
    """Mean over the group, summed in rank order from every rank's gathered
    value (so each rank holds the same bits); a true division, as the
    reference's ``pmean``."""
    parts = _stack_gather(g, group)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total / parts.shape[0]


def compressed_pmean(tree: Any, group, bits: int = 8) -> Any:
    """Mean of a gradient tree (or a single tensor) across ``group`` via
    int8 all-gather.  Float leaves with ndim >= 2 and more than 128
    elements are coded; small, 1-D and integer leaves take the exact mean
    (< 0.01 % of the traffic)."""
    def one(g):
        if g.ndim <= 1 or g.numel() <= 128 or not g.is_floating_point():
            return _exact_mean(g, group)
        codes, scale = _absmax_quant(g, bits)
        codes_g = _stack_gather(codes, group)              # (n, ...)
        scale_g = _stack_gather(scale, group)
        total = codes_g[0].to(torch.float32) * scale_g[0]
        for i in range(1, codes_g.shape[0]):
            total = total + codes_g[i].to(torch.float32) * scale_g[i]
        return (total / codes_g.shape[0]).to(g.dtype)

    if isinstance(tree, torch.Tensor):
        return one(tree)
    return tree_lib.map_tree(one, tree)


def make_pod_compressed_grads(loss_and_grads_fn: Callable, mesh,
                              bits: int = 8) -> Callable:
    """Wrap ``loss_and_grads_fn(params, batch, *rest) -> (loss, grads)`` so
    each rank takes its ``pod`` block of the batch's rows, and the
    gradients sync by ``compressed_pmean`` over ``pod`` (the loss by the
    exact mean).  Unchanged when the mesh has no ``pod`` axis.  The batch
    every rank is handed is the whole one, as the reference's region is."""
    from repro_torch.parallel.sharding import axis_sizes, mesh_coords
    if mesh is None or "pod" not in axis_sizes(mesh):
        return loss_and_grads_fn
    group = mesh.get_group("pod")
    n = axis_sizes(mesh)["pod"]

    def wrapped(params, batch, *rest):
        i = mesh_coords(mesh)["pod"]

        def rows(x):
            if x.shape[0] % n:
                raise ValueError(f"batch of {x.shape[0]} rows does not "
                                 f"split over {n} pods")
            step = x.shape[0] // n
            return x[i * step:(i + 1) * step]
        loss, grads = loss_and_grads_fn(params, tree_lib.map_tree(rows,
                                                                  batch),
                                        *rest)
        grads = compressed_pmean(grads, group, bits)
        return _exact_mean(loss, group), grads

    return wrapped
