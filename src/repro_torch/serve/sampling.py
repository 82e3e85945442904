"""Sampling keyed by (seed, absolute position).

The closed batch (``serve.generate``) and the continuous-batching engine
draw the same Gumbel noise for the same (seed, position): a draw never
depends on the slot, the batch or the bucket, so a resumed sequence's
stream continues where it stopped.  The draws are not comparable to
``jax.random.categorical``'s.
"""

from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1


def draw_seed(seed: int, position: int) -> int:
    """63-bit generator seed from (request seed, absolute position): a
    splitmix64 finalizer over the pair, so neighbouring positions get
    unrelated streams."""
    z = ((int(seed) & 0xFFFFFFFF) << 32 | (int(position) & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def gumbel(seed: int, position: int, vocab: int, device) -> torch.Tensor:
    """(V,) Gumbel noise on ``device``, a function of (seed, position) only:
    a fresh generator of that device seeded from the pair."""
    gen = torch.Generator(device=device)
    gen.manual_seed(draw_seed(seed, position))
    u = torch.rand(vocab, generator=gen, dtype=torch.float32, device=device)
    return -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))


def gumbel_max(logits: torch.Tensor, seeds, positions) -> torch.Tensor:
    """(B, V) f32 logits, already divided by the temperature (and
    filtered), -> (B,) int64 ``argmax(logits + noise)``, row b's noise
    ``gumbel(seeds[b], positions[b])``."""
    V = logits.shape[-1]
    noise = torch.stack([gumbel(int(s), int(p), V, logits.device)
                         for s, p in zip(seeds, positions)])
    return torch.argmax(logits + noise, dim=-1)
