"""Carry parameters and KV pools between the frameworks as numpy arrays.

``params_from_numpy`` turns the JAX reference's parameter tree, handed over
as numpy arrays (dense f32 leaves and ``{"q_codes","q_mu","q_sigma"}``
dicts), into the port's tree; with the codes carried across both engines
compute from identical weights.  ``cache_to_numpy`` turns a pool into
numpy for comparison, bf16 leaves as float32 values.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.devices import resolve_device


def params_from_numpy(tree, device="cuda", dtype=None) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``.

    Integer leaves (codes) keep their dtype (uint8 = 4-bit packed, int8 =
    8-bit); floating leaves are cast to ``dtype`` when given, except the
    ``q_mu`` / ``q_sigma`` statistics, which stay float32.
    """
    dev = resolve_device(device)

    def leaf(key, arr):
        t = torch.from_numpy(np.array(arr)).to(dev)
        if dtype is not None and t.is_floating_point() \
                and key not in ("q_mu", "q_sigma"):
            t = t.to(dtype)
        return t

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v)
                for k, v in node.items()}

    return walk(tree)


def cache_to_numpy(cache) -> Dict[str, np.ndarray]:
    """Pool dict -> numpy; bf16 leaves (stats, dense bf16 KV) are widened
    to float32 (exact), integer code leaves keep their dtype."""
    out = {}
    for name, leaf in cache.items():
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        out[name] = t.numpy()
    return out
