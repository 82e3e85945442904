"""Deterministic synthetic data streams: LM tokens and CNN images.

Counter-based: batch ``i`` is a pure function of (seed, i), drawn with a
``torch.Generator`` keyed by that pair on the CPU, so a restarted trainer
replays the exact stream from its checkpointed step with no data state in
the checkpoint, and every device sees the same bits.  The bits differ from
the reference's ``jax.random`` streams; the distributions are the same.

LM stream: order-1 Markov chains over a per-batch random successor table
(``branching`` successors per token), enough mutual information between
adjacent tokens that a model's loss falls below log(V).

Image stream (the CNN trainer's CIFAR stand-in): 10 smooth class
prototypes plus Gaussian noise at 32x32x3, NHWC.  The prototypes are the
reference's own: the same numpy ``RandomState`` draw at 8x8, resized to
``hw`` bilinearly with half-pixel centres (``jax.image.resize``'s
"bilinear" when upsampling).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tree as tree_lib
from repro_torch.core.uniq import fold_in
from repro_torch.devices import resolve_device
from repro_torch.parallel.sharding import input_shardings


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


@dataclasses.dataclass(frozen=True)
class ImageStreamConfig:
    n_classes: int = 10
    hw: int = 32
    channels: int = 3
    batch: int = 128
    noise: float = 1.0
    seed: int = 0


def _prototypes(cfg: ImageStreamConfig) -> np.ndarray:
    """(n_classes, hw, hw, channels) f32: low-frequency random fields."""
    rng = np.random.RandomState(cfg.seed)
    base = rng.randn(cfg.n_classes, 8, 8, cfg.channels).astype(np.float32)
    x = torch.from_numpy(base).permute(0, 3, 1, 2)                # NCHW
    up = F.interpolate(x, size=(cfg.hw, cfg.hw), mode="bilinear",
                       align_corners=False)
    return up.permute(0, 2, 3, 1).contiguous().numpy()


_PROTO_CACHE: dict = {}


def image_batch(cfg: ImageStreamConfig, step: int,
                device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """(images (B, H, W, C) f32, labels (B,) int64) of batch ``step`` on
    ``device``; labels and noise are drawn on the CPU from a generator
    keyed by (seed, step)."""
    dev = resolve_device(device)
    ck = (cfg.n_classes, cfg.hw, cfg.channels, cfg.seed)
    if ck not in _PROTO_CACHE:
        _PROTO_CACHE[ck] = torch.from_numpy(_prototypes(cfg))
    protos = _PROTO_CACHE[ck]
    gen = torch.Generator()
    gen.manual_seed(fold_in(cfg.seed + 7919, step))
    labels = torch.randint(0, cfg.n_classes, (cfg.batch,), generator=gen)
    noise = torch.randn((cfg.batch, cfg.hw, cfg.hw, cfg.channels),
                        generator=gen) * cfg.noise
    return (protos[labels] + noise).to(dev), labels.to(dev)


def shard_batch(batch, mesh, specs=None):
    """This rank's block of a whole batch (every rank draws the same bits):
    the leading (batch) dim over the DP axes, by ``input_shardings``, or by
    ``specs`` (a matching tree of ``parallel.sharding.Sharding``)."""
    if specs is None:
        specs = input_shardings(batch, mesh)
    return tree_lib.map_tree(lambda x, s: s.place(x), batch, specs)
