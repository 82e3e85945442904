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

``all_reduce`` / ``all_gather`` / ``reduce_scatter`` / ``all_reduce_max``
are the port's collective wrappers: they take one process group or several
(a mesh axis each; several in turn, as one collective over their product)
and count their calls (``collective_counts``), one a call whatever the
groups' sizes, so a run can show that it went through them.  Over a group
of one rank a collective is the identity and no backend call is made (a
one-rank NCCL all-gather copies its block through NCCL's copy kernel: at a
(1, 1) mesh, the weight bytes of every layer twice a call).  A collective
that fails raises: there is no local fallback.

The placed layers (``parallel/tensor_parallel.py``) go through their
autograd-aware forms, each a ``torch.autograd.Function`` whose forward and
backward are counted calls of the wrappers:

  ``sum_reduce``   forward all-reduce (sum), backward the identity (a
                   row-parallel product's partial sums);
  ``gather``       forward all-gather, backward reduce-scatter (an FSDP
                   block gathered in the layer: its gradient is summed over
                   the ranks that used the whole and cut back to the block);
  ``copy_to``      forward the identity, backward all-reduce (the input of
                   a column-parallel block: every rank's share of its
                   gradient summed).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Sequence, Union

import torch
import torch.distributed as dist

from repro_torch import tree as tree_lib

_CALLS = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0}


def collective_counts() -> Dict[str, int]:
    """Wrapper calls since the last reset, by collective."""
    return dict(_CALLS)


def reset_collective_counts() -> None:
    for k in _CALLS:
        _CALLS[k] = 0


Groups = Union[dist.ProcessGroup, Sequence[dist.ProcessGroup]]


def _groups(groups: Groups):
    """The groups of more than one rank (the others' collectives are the
    identity)."""
    groups = list(groups) if isinstance(groups, (list, tuple)) else [groups]
    return [g for g in groups if dist.get_world_size(g) > 1]


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


def _backend(g) -> str:
    return str(dist.get_backend(g)).lower()


def reduce_scatter(t: torch.Tensor, groups: Groups,
                   dim: int = 0) -> torch.Tensor:
    """The sum of ``t`` over the groups, cut along ``dim`` into the groups'
    blocks (the inverse layout of ``all_gather``: the first group
    outermost): this rank's block.  NCCL reduces and scatters in one
    collective; gloo has no reduce-scatter, so there it is an all-reduce
    and a slice (one counted call either way)."""
    _CALLS["reduce_scatter"] += 1
    for g in _groups(groups):
        n = dist.get_world_size(g)
        if t.shape[dim] % n:
            raise ValueError(f"reduce_scatter: dim {dim} of "
                             f"{tuple(t.shape)} does not split over {n} "
                             f"ranks")
        step = t.shape[dim] // n
        i = dist.get_rank(g)
        if _backend(g) == "nccl":
            src = t.movedim(dim, 0).contiguous()
            out = src.new_empty((step,) + tuple(src.shape[1:]))
            dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM,
                                       group=g)
            t = out.movedim(0, dim)
        else:
            t = t.contiguous()
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=g)
            t = t.narrow(dim, i * step, step)
    return t.contiguous()


def all_reduce_max(t: torch.Tensor, groups: Groups) -> torch.Tensor:
    """Elementwise max of ``t`` over the groups (in place; returned): the
    whole leaf's absmax from each rank's block.  Counted as an
    all-reduce."""
    _CALLS["all_reduce"] += 1
    for g in _groups(groups):
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=g)
    return t


class _SumReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups):
        return all_reduce(t.clone(), groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups, dim):
        ctx.groups, ctx.dim = groups, dim
        out = all_gather(t, groups, dim)
        return out.view_as(out) if out is t else out

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.groups, ctx.dim), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.groups), None


def sum_reduce(t: torch.Tensor, groups: Groups) -> torch.Tensor:
    """All-reduce (sum) of ``t`` over the groups into a new tensor; its
    backward is the identity."""
    return _SumReduce.apply(t, _groups(groups))


def gather(t: torch.Tensor, groups: Groups, dim: int = 0) -> torch.Tensor:
    """``all_gather`` whose backward is ``reduce_scatter``."""
    return _Gather.apply(t, _groups(groups), dim)


def copy_to(t: torch.Tensor, groups: Groups) -> torch.Tensor:
    """``t`` itself; its gradient is all-reduced over the groups."""
    return _CopyTo.apply(t, _groups(groups))


def _stack_gather(t: torch.Tensor, group) -> torch.Tensor:
    """(n, *t.shape): every rank's ``t`` in rank order."""
    return all_gather(t[None], group, dim=0)


def _absmax_quant(g: torch.Tensor, bits: int = 8, groups=()):
    """int8 codes of ``g`` and their f32 scale (one per leading slice; the
    whole leaf's for 1-D), kept with ``g``'s rank (the reference's).  On a
    rank's block whose reduced dims are split over ``groups`` the absmax is
    the whole leaf's (a max all-reduce), so the codes are the block of the
    whole leaf's codes."""
    qmax = 2.0 ** (bits - 1) - 1.0
    dims = tuple(range(1, g.ndim)) if g.ndim >= 2 else (0,)
    amax = torch.amax(torch.abs(g), dim=dims, keepdim=True)
    if groups:
        amax = all_reduce_max(amax, groups)
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


def compressed_pmean(tree: Any, group, bits: int = 8,
                     placement=None) -> Any:
    """Mean of a gradient tree (or a single tensor) across ``group`` via
    int8 all-gather.  Float leaves with ndim >= 2 and more than 128
    elements are coded; small, 1-D and integer leaves take the exact mean
    (< 0.01 % of the traffic).  With ``placement`` (``sharding.Placement``
    of a placed tree) each leaf is a rank's block: the size that decides is
    the whole leaf's, and each slice's absmax the whole slice's."""
    def one(path, g):
        n = g.numel() if placement is None \
            else math.prod(placement.whole_shape(path, g.shape))
        if g.ndim <= 1 or n <= 128 or not g.is_floating_point():
            return _exact_mean(g, group)
        groups = () if placement is None else placement.groups(
            placement.split_axes(path, range(1, g.ndim)))
        codes, scale = _absmax_quant(g, bits, groups)
        codes_g = _stack_gather(codes, group)              # (n, ...)
        scale_g = _stack_gather(scale, group)
        total = codes_g[0].to(torch.float32) * scale_g[0]
        for i in range(1, codes_g.shape[0]):
            total = total + codes_g[i].to(torch.float32) * scale_g[i]
        return (total / codes_g.shape[0]).to(g.dtype)

    if isinstance(tree, torch.Tensor):
        return one("", tree)
    return tree_lib.map_with_path(one, tree)


def make_pod_compressed_grads(loss_and_grads_fn: Callable, mesh,
                              bits: int = 8, placement=None) -> Callable:
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
        grads = compressed_pmean(grads, group, bits, placement)
        return _exact_mean(loss, group), grads

    return wrapped
