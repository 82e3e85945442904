"""Tensor and FSDP parallelism of the dense and vlm decoders on a mesh: the
placed layer operations, the port of what GSPMD derives in the reference
from ``param_shardings``, ``input_shardings`` and ``lm.shard_act``.

Every rank holds its blocks of the parameters (``place_params``: the
blocks ``param_shardings`` gives it, named by ``ModelOpts.placement``) and
its rows of the batch (``lm.shard_act``'s "dp"), and computes with them:

  column_mm    x @ W of wq / wk / wv / w_gate / w_up: W's K rows, split
               over "data" (FSDP), are all-gathered in the layer and freed
               after it; its columns over "model" stay the rank's: the
               rank's columns of the product;
  row_mm       x @ W of wo / w_down: W's columns over "data" gathered; the
               rank's rows of W times its columns of x, the partial sums
               all-reduced over "model";
  vocab_embed  the rank's vocabulary rows of the embedding (coded rows
               dequantized by ``kquantile_dequantize``), zero elsewhere,
               all-reduced over "model";
  head_weight  the head's blocks gathered over "data": the rank's
               vocabulary columns of the logits (gemma2's tied head is the
               embedding's block, transposed);
  vocab_ce     the cross-entropy of vocabulary-split logits: the
               logsumexp from each rank's max (one max all-reduce) and its
               sum of exponentials, the gold logit from the rank that holds
               it (one sum all-reduce of both), so the (B, S, V) logits are
               never gathered;
  head_plan    which heads a rank attends: its own where its column blocks
               of wq and of wk / wv are whole heads of the same GQA groups,
               else it gathers the columns and takes the heads it needs.

With ``dp_includes_model`` (``param_shardings(tp=False)``) "model" is one
more data-parallel axis: every weight is gathered whole over
("data", "model") and no product is split.  Any dim that ``_fit`` left
whole (granite's vocabulary of 49155, 8 KV heads on a model axis of 16)
is computed whole, as the reference does.

Gradients: the collectives are ``collectives.gather`` (backward a
reduce-scatter: an FSDP block's gradient summed over the ranks that used
the whole leaf), ``sum_reduce`` (backward the identity) and ``copy_to``
(backward an all-reduce: the input of a column-parallel block).  A leaf
that no product splits over a data-parallel axis has its gradient summed
over that axis by ``sync_grads``.  A weight block handed to a kernel that
is not contiguous raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding as shd

__all__ = ["place_params", "model_axis", "data_axes", "groups_of",
           "batch_axes", "take_rows", "gather_rows", "leaf_spec",
           "column_mm", "row_mm",
           "Heads", "head_plan", "q_heads", "kv_heads", "vocab_embed",
           "head_weight", "vocab_logits", "gather_vocab", "vocab_ce",
           "sync_grads", "whole_noise", "whole_layer_noise"]


def _is_q(w) -> bool:
    return isinstance(w, dict) and "q_codes" in w


def place_params(params, cfg, opts, fsdp=True):
    """(this rank's blocks of ``params``, ``opts`` naming them): the blocks
    of ``param_shardings(params, cfg, opts.mesh, fsdp, tp=not
    opts.dp_includes_model)``, each a contiguous tensor of its own."""
    shardings = shd.param_shardings(params, cfg, opts.mesh, fsdp=fsdp,
                                    tp=not opts.dp_includes_model)
    return (shd.place_tree(params, shardings),
            dataclasses.replace(opts, placement=shd.Placement.of(
                shardings, opts.manual_axes)))


# --------------------------------------------------------------------------
# Axes
# --------------------------------------------------------------------------

def model_axis(opts) -> Optional[str]:
    """"model" where it splits products (tensor parallelism), else None
    (no such axis, or ``dp_includes_model``)."""
    sizes = shd.axis_sizes(opts.mesh)
    if opts.dp_includes_model or "model" not in sizes \
            or "model" in opts.manual_axes:
        return None
    return "model"


def groups_of(opts, axes):
    """The mesh's process group of each of ``axes``."""
    return [opts.mesh.get_group(a) for a in axes]


def _coord(opts, axes) -> Tuple[int, int]:
    """(index, count) of this rank's block of a dim split over ``axes``."""
    sizes, coords = shd.axis_sizes(opts.mesh), shd.mesh_coords(opts.mesh)
    idx, n = 0, 1
    for a in axes:
        idx, n = idx * sizes[a] + coords[a], n * sizes[a]
    return idx, n


def _take(t: torch.Tensor, dim: int, axes, opts) -> torch.Tensor:
    """This rank's block of dim ``dim`` of a whole tensor (a view)."""
    idx, n = _coord(opts, axes)
    step = t.shape[dim] // n
    return t.narrow(dim, idx * step, step)


def batch_axes(opts, n_rows: int) -> Tuple[str, ...]:
    """The axes the batch's rows split over (``lm.shard_act``'s "dp")."""
    from repro_torch.models import lm
    return shd._axes(lm.shard_act((n_rows,), opts, "dp")[0])


def take_rows(t, opts, axes):
    """This rank's block of rows of a whole batch tensor (contiguous)."""
    return _take(t, 0, axes, opts).contiguous() if axes else t


def gather_rows(t, opts, axes):
    """Every rank's rows of ``t`` back, in order (no gradient)."""
    return coll.all_gather(t, groups_of(opts, axes), dim=0) if axes else t


def placed_dim(spec, dim: int):
    """The axes dim ``dim`` of a weight is split over: its spec's, or a
    coded weight's codes'."""
    return shd._axes((spec["q_codes"] if isinstance(spec, dict)
                      else spec)[dim])


def leaf_spec(opts, path: str):
    """The spec of a placed weight (a coded one's: a dict of its leaves')
    as its layer slice sees it: a stacked leaf's without the layer dim."""
    specs = opts.placement.specs
    cut = path.startswith("layers/")

    def one(s):
        return shd.P(*s[1:]) if cut else s
    if path in specs:
        return one(specs[path])
    sub = {p[len(path) + 1:]: one(s) for p, s in specs.items()
           if p.startswith(path + "/")}
    if not sub:
        raise KeyError(f"{path!r} is not a leaf of the placed tree")
    return sub


# --------------------------------------------------------------------------
# Weight blocks
# --------------------------------------------------------------------------

def _conform(t: torch.Tensor, have, want, opts) -> torch.Tensor:
    """One leaf from its layout ``have`` to ``want`` (a spec each): a dim
    split where it should be whole is gathered (``collectives.gather``); a
    dim whole where it should be split is cut (a statistic of size 1 stays
    as it is)."""
    for i in range(t.ndim):
        h = shd._axes(have[i] if i < len(have) else None)
        w = shd._axes(want[i] if i < len(want) else None)
        if h == w:
            continue
        if h:
            t = coll.gather(t, groups_of(opts, h), dim=i)
        if w and t.shape[i] > 1:
            t = _take(t, i, w, opts)
    return t


def _weight(w, spec, want, opts):
    """A layer weight (dense, or its coded dict) brought to ``want`` (for
    its main leaf; the statistics follow on the dims they have, and a
    codebook is whole).  Every leaf handed on must be contiguous."""
    def one(t, s):
        if t.ndim < 2:
            return t
        t = _conform(t, s, want, opts)
        if not t.is_contiguous():
            raise ValueError(f"a placed weight block of shape "
                             f"{tuple(t.shape)} is not contiguous")
        return t
    if _is_q(w):
        return {k: one(v, spec[k]) for k, v in w.items()}
    return one(w, spec)


def column_mm(x, w, spec, opts):
    """(x @ W's rank's columns, split): ``split`` where W's columns are
    split over "model" (the product is the rank's columns), else the whole
    product.  x is whole on every rank of the model axis."""
    from repro_torch.models import lm
    ax = model_axis(opts)
    split = ax is not None and ax in placed_dim(spec, 1)
    wl = _weight(w, spec, shd.P(None, ax if split else None), opts)
    if split:
        x = coll.copy_to(x, groups_of(opts, (ax,)))
    return lm.mm_a(x, wl, opts), split


def row_mm(x, x_split: bool, w, spec, opts):
    """x @ W for a row-parallel W: x is the rank's block of columns
    (``x_split``) or whole.  Where W's rows are split over "model" each
    rank multiplies its rows by its columns of x and the partial sums are
    all-reduced (at ``serve_a_bits`` < 32 the activation's per-token scale
    is the whole row's: a max all-reduce); else x is gathered whole.  The
    partial sums of more than one rank are f32 (each kernel's accumulator,
    not rounded to x's dtype before the sum), rounded once after it; a
    model axis of one rank has no partial sum and keeps x's dtype."""
    from repro_torch.models import lm
    ax = model_axis(opts)
    split = ax is not None and ax in placed_dim(spec, 0)
    wl = _weight(w, spec, shd.P(ax if split else None, None), opts)
    if not split:
        if x_split:
            x = coll.gather(x, groups_of(opts, (ax,)), dim=x.ndim - 1)
        return lm.mm_a(x, wl, opts)
    g = groups_of(opts, (ax,))
    if not x_split:
        x = _take(coll.copy_to(x, g), x.ndim - 1, (ax,), opts)
    wide = torch.float32 if shd.axis_sizes(opts.mesh)[ax] > 1 else None
    y = lm.mm_a(x, wl, opts, scale_groups=g, out_dtype=wide)
    return coll.sum_reduce(y, g).to(x.dtype)


# --------------------------------------------------------------------------
# Attention heads
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Heads:
    """The heads a rank attends: query heads [q_lo, q_lo + q_n), KV heads
    [kv_lo, kv_lo + kv_n); ``q_local`` / ``kv_local`` where they are the
    rank's own column blocks of wq / wk and wv (nothing gathered)."""
    q_lo: int
    q_n: int
    kv_lo: int
    kv_n: int
    q_local: bool
    kv_local: bool


def head_plan(cfg, opts) -> Heads:
    """The head rule.  A rank attends its own query heads where wq's
    columns are split over "model" into whole heads (``lm.shard_act``'s
    "tp" of the heads: H divisible by the axis), and the KV heads of their
    GQA groups; those come from its own wk / wv columns where they are
    whole heads too and the same groups, else from the gathered columns.
    Where a rank's query heads are not whole groups, nor within one group,
    every rank attends every head (its columns gathered)."""
    from repro_torch.models import lm
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    whole = Heads(0, H, 0, KV, False, False)
    ax = model_axis(opts)
    if ax is None or ax not in placed_dim(leaf_spec(opts, "layers/wq"), 1) \
            or lm.shard_act((1, 1, H, hd), opts, None, None, "tp",
                            None)[2] is None:
        return whole
    r, M = _coord(opts, (ax,))
    hl, g = H // M, H // KV
    if hl % g == 0:
        kv_lo, kv_n = r * hl // g, hl // g
    elif g % hl == 0:
        kv_lo, kv_n = r * hl // g, 1
    else:
        return whole
    kv_local = ax in placed_dim(leaf_spec(opts, "layers/wk"), 1) \
        and KV % M == 0 \
        and kv_lo == r * (KV // M)
    return Heads(r * hl, hl, kv_lo, kv_n, True, kv_local)


def kv_heads(t, split: bool, heads: Heads, hd: int, opts):
    """K or V columns (the rank's block where ``split``, else whole) ->
    the columns of the rank's KV heads."""
    if heads.kv_local:
        return t
    ax = model_axis(opts)
    if split:
        t = coll.gather(t, groups_of(opts, (ax,)), dim=t.ndim - 1)
    elif heads.q_local:
        t = coll.copy_to(t, groups_of(opts, (ax,)))
    if heads.kv_n * hd == t.shape[-1]:
        return t
    # a copy: the KV append writes from contiguous rows
    return t[..., heads.kv_lo * hd:(heads.kv_lo + heads.kv_n) * hd] \
        .contiguous()


def q_heads(t, split: bool, heads: Heads, opts):
    """Query columns -> the rank's heads' columns (gathered where the rank
    attends every head but holds a block)."""
    if split and not heads.q_local:
        t = coll.gather(t, groups_of(opts, (model_axis(opts),)),
                        dim=t.ndim - 1)
    return t


# --------------------------------------------------------------------------
# Embedding and head
# --------------------------------------------------------------------------

def vocab_embed(emb, spec, tok, dtype, opts):
    """The embedding rows of ``tok`` in ``dtype``: where the vocabulary is
    split over "model", the rank's rows (its block's, dequantized there),
    zero for tokens outside it, all-reduced; the d columns gathered over
    "data" first."""
    from repro_torch.models import lm
    ax = model_axis(opts)
    split = ax is not None and ax in placed_dim(spec, 0)
    e = _weight(emb, spec, shd.P(ax if split else None, None), opts)
    n = (e["q_codes"] if _is_q(e) else e).shape[0]
    idx, inside = tok, None
    if split:
        lo = _coord(opts, (ax,))[0] * n
        local = tok - lo
        inside = (local >= 0) & (local < n)
        idx = torch.clamp(local, 0, n - 1)
    if _is_q(e):
        x = lm.materialize(dict(e, q_codes=e["q_codes"][idx]), dtype,
                           opts.use_kernels)
    else:
        x = e[idx].to(dtype)
    if split:
        x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))
        x = coll.sum_reduce(x, groups_of(opts, (ax,)))
    return x


def head_weight(params, cfg, opts):
    """(the head (d, V_rank) as ``mm`` takes it, split): the rank's
    vocabulary columns (all of them where the vocabulary is not split),
    its d rows gathered over "data".  gemma2's tied head is the
    embedding's block (coded: dequantized through bf16), transposed."""
    from repro_torch.models import lm
    ax = model_axis(opts)
    if cfg.tie_embeddings:
        emb = params["embed"]
        spec = leaf_spec(opts, "embed")
        split = ax is not None and ax in placed_dim(spec, 0)
        e = _weight(emb, spec, shd.P(ax if split else None, None), opts)
        w = lm.materialize(e, torch.bfloat16, opts.use_kernels) \
            if _is_q(e) else e
        return w.T, split
    head = params["lm_head"]
    spec = leaf_spec(opts, "lm_head")
    split = ax is not None and ax in placed_dim(spec, 1)
    return _weight(head, spec, shd.P(None, ax if split else None),
                   opts), split


def vocab_logits(x, w, split: bool, opts):
    """f32 logits of the rank's vocabulary columns (x whole)."""
    from repro_torch.models import lm
    if split:
        x = coll.copy_to(x, groups_of(opts, (model_axis(opts),)))
    return lm.mm(x, w, opts.use_kernels, out_dtype=torch.float32)


def gather_vocab(logits, split: bool, opts):
    """Whole-vocabulary logits from the rank's columns (no gradient)."""
    if not split:
        return logits
    return coll.all_gather(logits, groups_of(opts, (model_axis(opts),)),
                           dim=logits.ndim - 1)


def vocab_ce(logits, targets, split: bool, opts):
    """Per-position ``logsumexp - gold`` of f32 logits that are the rank's
    vocabulary columns (``split``) or whole; targets clamped at 0."""
    tb = targets.clamp_min(0)
    if not split:
        lse = torch.logsumexp(logits, dim=-1)
        return lse - torch.gather(logits, -1, tb[..., None])[..., 0]
    g = groups_of(opts, (model_axis(opts),))
    n = logits.shape[-1]
    lo = _coord(opts, (model_axis(opts),))[0] * n
    m = coll.all_reduce_max(torch.amax(logits.detach(), dim=-1), g)
    se = torch.sum(torch.exp(logits - m[..., None]), dim=-1)
    local = tb - lo
    inside = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = torch.where(inside, gold, torch.zeros((), dtype=gold.dtype,
                                                  device=gold.device))
    se, gold = coll.sum_reduce(torch.stack([se, gold]), g).unbind(0)
    return m + torch.log(se) - gold


# --------------------------------------------------------------------------
# Gradients and the UNIQ noise of placed leaves
# --------------------------------------------------------------------------

def data_axes(opts) -> Tuple[str, ...]:
    """The data-parallel axes of the mesh that the caller does not split
    itself ("model" too with ``dp_includes_model``)."""
    names = ("pod", "data", "model") if opts.dp_includes_model \
        else ("pod", "data")
    sizes = shd.axis_sizes(opts.mesh)
    return tuple(a for a in names if a in sizes
                 and a not in opts.manual_axes)


def sync_grads(grads, opts):
    """Each leaf's gradient summed over the data-parallel axes it is not
    split on (its FSDP blocks were reduce-scattered in the backward of
    their gather), in place; returned."""
    pl = opts.placement
    axes = data_axes(opts)

    def one(path, g):
        over = [a for a in axes if a not in pl.split_axes(path)]
        return coll.all_reduce(g, groups_of(opts, over)) if over else g
    return tree_lib.map_with_path(one, grads)


def _shape_of(shape, leaf):
    """A tensor of ``shape`` on leaf's device and dtype that holds no
    memory: a noise source reads only its shape and device."""
    return torch.empty((), dtype=leaf.dtype,
                       device=leaf.device).expand(shape)


def whole_noise(noise, placement):
    """A ``NoiseFn`` over placed leaves from one over whole leaves: each
    leaf's whole draw, cut to the rank's block (a block's own draw is not
    the whole draw's slice).  Holds one leaf's f32 draw at a time."""
    def draw(path, leaf):
        e = noise(path, _shape_of(placement.whole_shape(path, leaf.shape),
                                  leaf))
        if isinstance(e, int):
            raise ValueError("the on-chip noise draws in the kernel on the "
                             "block's shape: a placed leaf takes a host "
                             "draw")
        return placement.sharding(path).place(e).contiguous()
    return draw


def whole_layer_noise(noise, placement):
    """``whole_noise`` of a ``LayerNoiseFn`` (one layer slice of the stack
    "layers/<key>")."""
    def draw(key, layer, leaf):
        path = f"layers/{key}"
        whole = placement.whole_shape(path, (1,) + tuple(leaf.shape))[1:]
        e = noise(key, layer, _shape_of(whole, leaf))
        spec = shd.P(*placement.specs[path][1:])
        return shd.Sharding(placement.mesh, spec).place(e).contiguous()
    return draw
