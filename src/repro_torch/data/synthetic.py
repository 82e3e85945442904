"""Deterministic synthetic LM token stream.

Counter-based: batch ``i`` is a pure function of (seed, i), drawn with a
``torch.Generator`` keyed by that pair, so a restarted trainer replays the
exact stream from its checkpointed step with no data state in the
checkpoint.  The bits differ from the reference's ``jax.random`` stream; the
distribution is the same: order-1 Markov chains over a per-batch random
successor table (``branching`` successors per token), enough mutual
information between adjacent tokens that a model's loss falls below log(V).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import torch

from repro_torch.core.uniq import fold_in
from repro_torch.devices import resolve_device


@dataclasses.dataclass(frozen=True)
class LMStreamConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 4     # successors per token (lower = easier)


def lm_batch(cfg: LMStreamConfig, step: int,
             device="cuda") -> Dict[str, torch.Tensor]:
    """Batch ``step`` of the stream: {tokens, targets} (B, S) int32 on
    ``device``; drawn on the CPU, so every device sees the same bits."""
    dev = resolve_device(device)
    gen = torch.Generator()
    gen.manual_seed(fold_in(cfg.seed, step))
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab
    succ = torch.randint(0, V, (V, cfg.branching), generator=gen)
    start = torch.randint(0, V, (B,), generator=gen)
    choices = torch.randint(0, cfg.branching, (B, S), generator=gen)
    seq = [start]
    for t in range(S - 1):
        seq.append(succ[seq[-1], choices[:, t]])
    seq = torch.stack(seq, dim=1)                                  # (B, S)
    last = succ[seq[:, -1], choices[:, -1]]
    targets = torch.cat([seq[:, 1:], last[:, None]], dim=1)
    return {"tokens": seq.to(torch.int32).to(dev),
            "targets": targets.to(torch.int32).to(dev)}


def lm_stream(cfg: LMStreamConfig, start_step: int = 0,
              device="cuda") -> Iterator[Dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield lm_batch(cfg, step, device=device)
        step += 1
