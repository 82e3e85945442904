"""Mixture-of-Experts FFN with expert parallelism.

The counterpart of ``src/repro/models/moe.py``.  On one device every
expert lives there (``n_shards=1``); under expert parallelism each shard of
the ``model`` axis holds E / n_shards of them and computes their
contribution alone (``moe_ffn_local(shard_idx=, n_shards=)``), summed over
the axis by ``moe_ffn(group=)``.  A
token's copies are routed by an f32 router (softmax, top-k, the top-k
weights renormalised to sum 1), packed by a stable sort into a fixed
``(E, C, d)`` capacity buffer, multiplied by the experts' SwiGLU and
scattered back to their tokens, each weighted by its gate.  A copy past
its expert's capacity ``C`` is dropped: it adds nothing, and the token
keeps its residual path.

The three expert matmuls take dense ``(E, d, f)`` / ``(E, f, d)`` stacks
or their k-quantile-coded dicts (``{"q_codes", "q_mu", "q_sigma"}`` with
statistics shared by the layer's experts, or ``{"q_codes", "q_lut"}`` with
one codebook per layer).  A coded stack is multiplied in one launch per
matrix by ``kernels/ops.py:qmatmul_experts`` / ``qmatmul_lut_experts`` (the
expert on the grid, the rows past each expert's kept count read as zeros
and never the weight bytes of an expert with none), so the stack is never
dequantized whole; their plain versions (CPU tensors, ``use_kernels=False``)
dequantize one expert at a time.  ``rows`` stays on the device: nothing on
this path reads a routing decision on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.parallel import collectives as coll


class MoEConfig(NamedTuple):
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    renorm_topk: bool = True       # normalize top-k router weights to sum 1


def router_topk(x: torch.Tensor, router_w: torch.Tensor, cfg: MoEConfig):
    """(T, d) -> (weights (T, k) f32, ids (T, k) int64).  Router math f32;
    ``torch.topk`` (sorted) orders as ``lax.top_k`` but at exact ties."""
    logits = x.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    if cfg.renorm_topk:
        w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    return w, ids


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    """Rows of each expert's buffer: the expected load times the capacity
    factor, plus one, rounded up to 8 and at least 8 (the reference's)."""
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max(8, -(-c // 8) * 8)


def route(x: torch.Tensor, router_w: torch.Tensor, cfg: MoEConfig,
          shard_idx: int = 0, n_local: int = 0):
    """The reference's drop rule: router, stable sort of the T*k copies by
    expert, each copy's position in its expert's group, kept while that
    position is below the capacity.  With ``n_local`` experts on this
    shard (0: all of them), the shard's experts are ``shard_idx *
    n_local`` onwards: copies routed to another shard sort last and are
    not kept (the reference's local-expert rule).

    Returns a dict of (T*k,) tensors in sorted order — ``order`` (the
    copies' flat (token, slot) index), ``stok`` (token), ``expert`` (the
    local expert; ``n_local`` for another shard's), ``sgate`` (f32 gate),
    ``keep`` (bool), ``buf_idx`` (row of the flattened (E_l*C) buffer;
    E_l*C for a copy not kept) — and ``rows`` (E_l,) int32, the copies
    each local expert keeps, plus the capacity ``C`` (of the global expert
    count, as the reference's)."""
    T = x.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    E_l = n_local or E
    C = capacity(T, cfg)
    gates, ids = router_topk(x, router_w, cfg)
    flat_ids = ids.reshape(-1)
    dev = x.device
    if E_l != E:
        local = flat_ids - shard_idx * E_l
        flat_ids = torch.where((local >= 0) & (local < E_l), local,
                               torch.full_like(local, E_l))
    order = torch.argsort(flat_ids, stable=True)
    se = flat_ids[order]
    starts = torch.searchsorted(se, torch.arange(E_l + 1, device=dev,
                                                 dtype=se.dtype))
    pos = torch.arange(T * k, device=dev) - starts[torch.clamp(se, max=E_l)]
    keep = (se < E_l) & (pos < C)
    buf_idx = torch.where(keep, se * C + pos, torch.full_like(se, E_l * C))
    rows = torch.clamp(starts[1:] - starts[:-1], max=C).to(torch.int32)
    return {"order": order, "stok": order // k, "expert": se,
            "sgate": gates.reshape(-1)[order], "keep": keep,
            "buf_idx": buf_idx, "rows": rows, "C": C}


def expert_matmul(buf: torch.Tensor, w, rows: torch.Tensor,
                  use_kernels: bool = True) -> torch.Tensor:
    """``einsum("ecd,edf->ecf", buf, w)`` in buf's dtype: a coded stack
    through ``qmatmul_experts`` / ``qmatmul_lut_experts`` (levels rounded to
    buf's dtype, f32 sums, the result cast back, as the reference's
    ``materialize(w, h.dtype)`` and einsum), a dense one through
    ``torch.bmm`` on its cast."""
    if isinstance(w, dict) and "q_codes" in w:
        bits = 4 if w["q_codes"].dtype == torch.uint8 else 8
        if "q_lut" in w:
            return kops.qmatmul_lut_experts(buf, w["q_codes"], w["q_lut"],
                                            rows, bits=bits,
                                            out_dtype=buf.dtype,
                                            use_kernel=use_kernels)
        return kops.qmatmul_experts(buf, w["q_codes"], w["q_mu"],
                                    w["q_sigma"], rows, bits=bits,
                                    out_dtype=buf.dtype,
                                    use_kernel=use_kernels)
    return torch.bmm(buf, w.to(buf.dtype))


def _n_experts(w) -> int:
    return (w["q_codes"] if isinstance(w, dict) else w).shape[0]


def moe_ffn_local(x: torch.Tensor, router_w: torch.Tensor, gate_w, up_w,
                  down_w, cfg: MoEConfig, act_fn=F.silu,
                  use_kernels: bool = True, shard_idx: int = 0,
                  n_shards: int = 1) -> torch.Tensor:
    """The contribution of this shard's experts to the MoE FFN of (T, d)
    tokens (all of it with ``n_shards`` 1; the caller sums the shards'
    otherwise).

    router_w : (d, E) f32, the full router
    gate/up  : (E_l, d, f) dense, or their coded dicts;  down : (E_l, f, d)
               — shard ``shard_idx``'s experts (E_l = E / n_shards)
    returns  : (T, d) in x's dtype.

    A token's k contributions are added in the order the reference's
    scatter-add takes them (the sorted order: ascending expert), each sum
    rounded to x's dtype, starting from zero.  A dropped copy reads the
    buffer's last row and is multiplied by 0, as in the reference: the
    kernels write zeros for the rows they skip, so that row is finite.
    """
    T, d = x.shape
    k = cfg.top_k
    E = _n_experts(gate_w)
    if E * n_shards != cfg.n_experts:
        raise ValueError(f"{E} experts on each of {n_shards} shards; the "
                         f"router has {cfg.n_experts}")
    r = route(x, router_w, cfg, shard_idx, E)
    C = r["C"]
    cd = x.dtype
    # pack: kept copies into their (expert, position) rows, dropped ones
    # into a sink row past the buffer, sliced off
    buf = torch.zeros((E * C + 1, d), dtype=cd, device=x.device)
    buf[r["buf_idx"]] = x[r["stok"]]
    buf = buf[:E * C].reshape(E, C, d)

    rows = r["rows"]
    g = expert_matmul(buf, gate_w, rows, use_kernels)
    u = expert_matmul(buf, up_w, rows, use_kernels)
    h = act_fn(g) * u
    y_flat = expert_matmul(h, down_w, rows, use_kernels).reshape(E * C, d)

    contrib = y_flat[torch.clamp(r["buf_idx"], max=E * C - 1)]
    contrib = contrib * (r["sgate"] * r["keep"]).to(cd)[:, None]
    # each token's k copies, in their sorted order
    inv = torch.empty_like(r["order"])
    inv[r["order"]] = torch.arange(T * k, device=x.device)
    slots = torch.sort(inv.reshape(T, k), dim=1).values
    parts = contrib[slots]                                   # (T, k, d)
    y = torch.zeros((T, d), dtype=cd, device=x.device)
    for j in range(k):
        y = y + parts[:, j]
    return y


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, gate_w, up_w, down_w,
            cfg: MoEConfig, act_fn=F.silu, use_kernels: bool = True,
            group=None) -> torch.Tensor:
    """MoE FFN on (B, S, d): every row of B*S is routed, padding rows
    included (they take capacity, as in the reference).  With ``group``
    (the ``model`` axis's process group) the weights are this rank's
    experts, rank r of n holding experts r * E/n onwards, and the shards'
    contributions are summed over the group."""
    B, S, d = x.shape
    idx, n = 0, 1
    if group is not None:
        idx, n = dist.get_rank(group), dist.get_world_size(group)
    y = moe_ffn_local(x.reshape(B * S, d), router_w, gate_w, up_w, down_w,
                      cfg, act_fn=act_fn, use_kernels=use_kernels,
                      shard_idx=idx, n_shards=n)
    if group is not None:
        y = coll.all_reduce(y, group)
    return y.reshape(B, S, d)


def aux_load_balance_loss(x: torch.Tensor, router_w: torch.Tensor,
                          cfg: MoEConfig) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (mean over tokens).  The
    reference defines it but never adds it to a loss: its MoE training loss
    is cross-entropy alone, and so is the port's (``lm.forward_train``)."""
    logits = x.reshape(-1, x.shape[-1]).to(torch.float32) \
        @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                    # (T, E)
    _, ids = torch.topk(probs, cfg.top_k, dim=-1)
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(ids[:, 0], cfg.n_experts).to(torch.float32),
                    dim=0)
    return cfg.n_experts * torch.sum(me * ce)
