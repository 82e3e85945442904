"""Sharding rules: parameter / activation / cache partition specs, and each
rank's block of a tensor under them.

Axes (the reference's ``src/repro/parallel/sharding.py``):
  pod   — data parallelism across pods (multi-pod mesh only)
  data  — in-pod data parallelism + FSDP (parameters sharded over ``data``
          on a non-TP dim)
  model — tensor parallelism (attention heads / d_ff / vocab), expert
          parallelism (the MoE expert axis), and sequence sharding for
          caches.

The rules are the reference's, leaf for leaf: parameter-name based, any
axis that does not divide its mesh extent falls back to replicated
(validated per leaf), ``fsdp=False`` drops the ``data`` axis from
parameters.  What the reference hands GSPMD as a ``NamedSharding`` is here
a ``Sharding`` (a mesh and a ``PartitionSpec``) that gives each rank its
block: ``Sharding.place`` slices the rank's block out of a whole tensor,
``placements`` gives the ``torch.distributed.tensor`` placements of a spec
where they can express it.  ``place_tree`` gives each rank its blocks of a
whole tree (contiguous copies, never views), ``Sharding.whole`` gathers a
block back, and a ``Placement`` (the ``Sharding`` of every path of a placed
tree) is what the placed layers, the statistics, the optimizer and the
checkpoint read to know where each leaf lives.

A mesh is a live ``DeviceMesh`` (``launch/mesh.py``) or, for the rules
alone, a ``MeshShape`` (axis names and sizes, no world: the counterpart of
JAX's ``AbstractMesh``).

Block order of a dim sharded over several mesh axes: JAX orders the blocks
by the spec's axis tuple, major first (``("data", "pod")`` puts ``data``
outermost whatever the mesh's axis order); ``Sharding.place`` does the
same.  ``Shard`` placements on several mesh dims order them by mesh dim, so
``placements`` refuses a tuple that runs against the mesh's order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ArchConfig


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), an axis name, or a
    tuple of axis names (the dim split over all of them, the first
    outermost).  A tuple, so it compares equal to the tuple of its
    entries; as in JAX, a one-axis tuple is stored as the axis and an empty
    one as ``None``."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            (p[0] if len(p) == 1 else p or None)
            if isinstance(p, tuple) else p for p in parts))

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes of a mesh, without a world: what the rules read
    (``shape`` maps each axis name to its size, in mesh order)."""
    sizes: Tuple[Tuple[str, int], ...]

    @classmethod
    def of(cls, **sizes: int) -> "MeshShape":
        return cls(tuple(sizes.items()))

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.sizes)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.sizes)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size}, in mesh order, of a ``DeviceMesh`` or a
    ``MeshShape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def mesh_coords(mesh) -> Dict[str, int]:
    """This rank's coordinate on each axis of a live ``DeviceMesh``."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return dict(zip(mesh.mesh_dim_names, coord))


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def dp_axes(mesh) -> Tuple[str, ...]:
    """Data-parallel axes present in this mesh ('pod' optional)."""
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def _fit(spec: PartitionSpec, shape, mesh) -> PartitionSpec:
    """Drop sharding on dims that don't divide the mesh extent."""
    sizes = axis_sizes(mesh)
    out = []
    for i, axes in enumerate(spec):
        if axes is None or i >= len(shape):
            out.append(None)
            continue
        size = math.prod(sizes[a] for a in _axes(axes))
        out.append(axes if shape[i] % size == 0 else None)
    return P(*out)


# Parameter leaves that are *deliberately* replicated: norms, biases and
# per-head scalar vectors.  The compile audit's coverage pass
# (analysis/compile_audit.py) requires every leaf of every substrate to
# classify to either a named weight rule below or this list: "no rule" is a
# finding, not a default.
REPLICATED_PARAMS = frozenset({
    "attn_norm", "mlp_norm", "cross_norm", "post_attn_norm",
    "post_mlp_norm", "pre_norm", "final_norm", "enc_final_norm",
    "scale", "bias",                  # LayerNorm dict leaves
    "dt_bias", "A_log", "D",          # mamba per-head scalars
})


def param_rule_spec(path: str, shape, cfg: ArchConfig, fsdp, mesh,
                    expert_mode: str = "gather"):
    """Classify one parameter leaf: -> (rule_name, unfitted PartitionSpec).

    ``rule_name`` is the named rule that matched ("wq", "replicated",
    "q_lut", ...) or ``None`` when the leaf fell through to the implicit
    replicated fallback (a coverage finding for the compile audit).
    ``mesh`` may be None for classification-only callers (no pod check).
    A coded leaf takes its weight's rule: ``q_codes`` has the weight's
    shape (the last dim halved at W4, which ``_fit`` checks),
    ``q_mu`` / ``q_sigma`` are statistics whose size-1 dims fall
    replicated, and a codebook ``q_lut`` is always replicated (every rank
    needs all k levels)."""
    parts = path.split("/")
    if parts[-1] == "q_lut":
        return "q_lut", P()
    if parts[-1] in ("q_codes", "q_mu", "q_sigma") and len(parts) >= 2:
        path = "/".join(parts[:-1])
    if fsdp is True:
        d = "data"
    elif fsdp == "pod" and mesh is not None \
            and "pod" in axis_sizes(mesh):
        d = ("data", "pod")   # ZeRO-3 across pods too (1T-param cells)
    elif fsdp:
        d = "data"
    else:
        d = None
    stacked = path.startswith(("layers/", "enc_layers/", "dec_layers/"))
    lead = (None,) if stacked else ()
    name = path.split("/")[-1]

    if name == "embed":
        return name, P("model", d)
    if name == "lm_head":
        return name, P(d, "model")
    if name in ("wq", "wk", "wv", "cross_wq", "cross_wk", "cross_wv"):
        return name, P(*lead, d, "model")
    if name in ("wo", "cross_wo"):
        return name, P(*lead, "model", d)
    if name in ("w_gate", "w_up"):
        return name, P(*lead, d, "model")
    if name == "w_down":
        return name, P(*lead, "model", d)
    if name in ("eg", "eu"):          # (L, E, d, f): experts on model
        if expert_mode == "reduce":   # FSDP on f (partial-f compute)
            return name, P(*lead, "model", None, d)
        return name, P(*lead, "model", d, None)
    if name == "ed":                  # (L, E, f, d)
        if expert_mode == "reduce":
            return name, P(*lead, "model", d, None)
        return name, P(*lead, "model", None, d)
    if name == "router":
        return name, P(*lead, d, None)
    if name == "in_proj":             # (L, d, proj): d_inner on model
        return name, P(*lead, d, "model")
    if name == "out_proj":            # (L, d_inner, d)
        return name, P(*lead, "model", d)
    if name in ("conv_w",):           # (L, C, w)
        return name, P(*lead, "model", None)
    if name in ("conv_b", "norm_scale"):
        return name, P(*lead, "model")
    if name in REPLICATED_PARAMS:
        return "replicated", P()
    return None, P()                  # uncovered: audit finding


def _drop_tp(spec: PartitionSpec) -> PartitionSpec:
    """fsdp-only mode: no tensor parallelism — every 'model' placement is
    folded into the FSDP axis group instead (ZeRO-3 over the whole mesh).
    """
    out = []
    for e in spec:
        if e == "model":
            out.append(None)
        elif e == "data":
            out.append(("data", "model"))
        elif isinstance(e, tuple) and "data" in e:
            out.append(tuple(e) + ("model",))
        else:
            out.append(e)
    return P(*out)


@dataclasses.dataclass(frozen=True, eq=False)
class Sharding:
    """A mesh and a fitted spec: the counterpart of JAX's
    ``NamedSharding``."""
    mesh: Any
    spec: PartitionSpec

    def block(self, shape, coords: Optional[Dict[str, int]] = None):
        """The rank's block of a tensor of ``shape``: one ``slice`` per
        dim.  ``coords`` ({axis: index}) defaults to this rank's coordinate
        in the live mesh.  A dim over axes (a1, a2, ...) is cut into
        n1 * n2 * ... blocks, block c1 * n2 * ... + c2 * ... + ... (the
        first axis outermost, as JAX orders them)."""
        sizes = axis_sizes(self.mesh)
        if coords is None:
            coords = mesh_coords(self.mesh)
        out = []
        for i, n in enumerate(shape):
            idx, parts = 0, 1
            for a in _axes(self.spec[i] if i < len(self.spec) else None):
                idx = idx * sizes[a] + coords[a]
                parts *= sizes[a]
            if n % parts:
                raise ValueError(f"dim {i} of {tuple(shape)} does not "
                                 f"divide over {self.spec[i]} ({parts})")
            step = n // parts
            out.append(slice(idx * step, (idx + 1) * step))
        return tuple(out)

    def place(self, t: torch.Tensor, coords=None) -> torch.Tensor:
        """The rank's block of the whole tensor ``t`` (a view)."""
        return t[self.block(t.shape, coords)]

    def axes(self, dims=None) -> Tuple[str, ...]:
        """The mesh axes the dims ``dims`` (all, by default) are split
        over, in spec order."""
        dims = range(len(self.spec)) if dims is None else dims
        return tuple(a for i in dims if i < len(self.spec)
                     for a in _axes(self.spec[i]))

    def whole(self, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's block ``t`` (every rank
        calls it): each split dim all-gathered over its axes."""
        from repro_torch.parallel import collectives as coll
        for i, entry in enumerate(self.spec):
            if entry is not None:
                t = coll.all_gather(t, [self.mesh.get_group(a)
                                        for a in _axes(entry)], dim=i)
        return t


def place_tree(tree, shardings):
    """Each rank's blocks of a whole tree (a matching tree of
    ``Sharding``): every leaf's block as a contiguous tensor of its own
    (``Sharding.place`` gives a view, and a column block of a row-major
    tensor is strided: no kernel takes one), so the whole leaf can be
    freed; a replicated leaf is the leaf itself."""
    def one(t, shd):
        b = shd.place(t)
        return t if b.numel() == t.numel() \
            else b.clone(memory_format=torch.contiguous_format)
    return tree_lib.map_tree(one, tree, shardings)


def state_shardings(state, pshard, mesh):
    """The ``Sharding`` tree of a train state ``{"params", "opt", "step"}``
    whose parameters take ``pshard`` (the reference's ``dryrun.py``
    ``state_shardings`` rule): each moment follows its parameter, the
    optimizer's ``count`` and ``step`` are replicated.  An int8 moment's
    scale ``ms`` (one per leading slice) follows its parameter's leading
    dim, where the reference replicates it: a rank codes its block with its
    slices' scales."""
    repl = Sharding(mesh, P())

    def mu_tree(mu, ps):
        out = {}
        for k, v in mu.items():
            if "m" in v and not isinstance(v["m"], dict):
                out[k] = {"m": ps[k]}
                if "ms" in v:
                    lead = ps[k].spec[0] if v["ms"].ndim and ps[k].spec \
                        else None
                    out[k]["ms"] = Sharding(mesh, P(
                        lead, *(None,) * max(v["ms"].ndim - 1, 0))) \
                        if lead else repl
            else:
                out[k] = mu_tree(v, ps[k])
        return out

    opt = {"mu": mu_tree(state["opt"]["mu"], pshard), "count": repl}
    if "nu" in state["opt"]:
        opt["nu"] = pshard
    return {"params": pshard, "opt": opt, "step": repl}


@dataclasses.dataclass(frozen=True, eq=False)
class Placement:
    """Where every leaf of a placed parameter tree lives: its ``Sharding``
    by path (``ModelOpts.placement``).  ``manual_axes`` are axes the caller
    splits itself (the compressed sync's ``pod``): no leaf statistic, norm
    or gradient is reduced over them here."""
    mesh: Any
    specs: Dict[str, PartitionSpec]
    manual_axes: Tuple[str, ...] = ()

    @classmethod
    def of(cls, shardings, manual_axes=()) -> "Placement":
        flat = dict(tree_lib.leaves_with_paths(shardings))
        mesh = next(iter(flat.values())).mesh
        return cls(mesh, {p: s.spec for p, s in flat.items()},
                   tuple(manual_axes))

    def sharding(self, path: str) -> Sharding:
        if path not in self.specs:
            raise KeyError(f"{path!r} is not a leaf of the placed tree")
        return Sharding(self.mesh, self.specs[path])

    def split_axes(self, path: str, dims=None) -> Tuple[str, ...]:
        """The axes (not manual) that dims ``dims`` of the leaf are split
        over."""
        return tuple(a for a in self.sharding(path).axes(dims)
                     if a not in self.manual_axes)

    def groups(self, axes) -> list:
        return [self.mesh.get_group(a) for a in axes]

    def whole_shape(self, path: str, block_shape) -> Tuple[int, ...]:
        sizes = axis_sizes(self.mesh)
        spec = self.specs[path]
        return tuple(n * math.prod(sizes[a] for a in _axes(
            spec[i] if i < len(spec) else None))
            for i, n in enumerate(block_shape))


def placements(spec: PartitionSpec, mesh) -> list:
    """``torch.distributed.tensor`` placements (one per mesh dim) of a
    fitted spec: ``Shard(i)`` on every mesh axis of dim i, ``Replicate()``
    elsewhere.  A dim whose axes run against the mesh's order (the
    reference's ``("data", "pod")`` on a ``("pod", "data", ...)`` mesh)
    has no such placement: ``Shard`` on several mesh dims orders the
    blocks by mesh dim, so it raises; ``Sharding.place`` cuts it."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    out = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        axes = _axes(entry)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(
                f"dim {i} is split over {axes}, against the mesh's axis "
                f"order {tuple(names)}: no Shard placement orders its "
                f"blocks so")
        for p in pos:
            out[p] = Shard(i)
    return out


def _param_spec(path: str, shape, cfg: ArchConfig, fsdp, mesh,
                expert_mode: str = "gather", tp: bool = True):
    spec = param_rule_spec(path, shape, cfg, fsdp, mesh, expert_mode)[1]
    if not tp:
        spec = _drop_tp(spec)
    return _fit(spec, shape, mesh)


def param_shardings(params, cfg: ArchConfig, mesh, fsdp=True,
                    expert_mode: str = "gather", tp: bool = True):
    """``Sharding`` tree of a parameter tree (tensors, ``meta`` ones
    included).

    fsdp: True (shard over 'data'), "pod" (shard over data+pod — ZeRO-3
    across pods, for 1T-param cells), or False (pure DP replication).
    expert_mode: "gather" FSDPs experts on d (weights gathered per layer);
    "reduce" FSDPs on f for the partial-f output-reduce MoE.
    tp=False: fsdp-only (ZeRO-3 over data x model, no tensor
    parallelism)."""
    return tree_lib.map_with_path(
        lambda p, leaf: Sharding(mesh, _param_spec(
            p, tuple(leaf.shape), cfg, fsdp, mesh, expert_mode, tp)),
        params)


# --------------------------------------------------------------------------
# Input / cache rules
# --------------------------------------------------------------------------

def _batch_axes(mesh, batch: int, include_model: bool = False):
    sizes = axis_sizes(mesh)
    axes = list(dp_axes(mesh))
    if include_model and "model" in sizes:
        axes.append("model")
    while axes and batch % math.prod(sizes[a] for a in axes):
        axes.pop()  # drop the innermost until divisible (e.g. batch 1)
    return tuple(axes) if axes else None


def input_shardings(specs_tree, mesh, include_model: bool = False):
    """Batch (leading dim) over DP axes; everything else replicated."""
    def one(s):
        return Sharding(mesh, P(_batch_axes(mesh, s.shape[0], include_model),
                                *(None,) * (len(s.shape) - 1)))
    return tree_lib.map_tree(one, specs_tree)


def cache_shardings(cfg: ArchConfig, cache_tree, mesh):
    """KV/SSM cache shardings: batch over DP axes, seq/state over model.

      k/v (+cross)  (L, B, S, KV, hd) -> P(None, dp, 'model', None, None)
      conv          (L, B, w, C)      -> P(None, dp, None, 'model')
      ssm           (L, B, nh, hd, n) -> P(None, dp, 'model', None, None)
    Any non-divisible dim falls back to replicated.
    """
    tp = "model" if "model" in axis_sizes(mesh) else None

    def one(path, leaf):
        shape = tuple(leaf.shape)
        name = path.split("/")[-1]
        rest = [None] * (len(shape) - 2)
        if tp is not None and rest:
            cand = 0 if name in ("k", "v", "cross_k", "cross_v", "ssm") \
                else len(rest) - 1
            rest[cand] = tp
        spec = P(None, _batch_axes(mesh, shape[1]), *rest)
        return Sharding(mesh, _fit(spec, shape, mesh))
    return tree_lib.map_with_path(one, cache_tree)
