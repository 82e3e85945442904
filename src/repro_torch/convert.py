"""Carry parameters, training states and KV pools between the frameworks as
numpy arrays.

``params_from_numpy`` turns the JAX reference's parameter tree, handed over
as numpy arrays (dense f32 leaves, ``{"q_codes","q_mu","q_sigma"}`` and
``{"q_codes","q_lut"}`` dicts), into the port's tree; with the codes carried across both engines
compute from identical weights.  ``train_state_from_numpy`` /
``train_state_to_numpy`` do the same for a training state ``{"params",
"opt", "step"}``, so both frameworks can start a step from one state; the
CNN trainer's ``{"params", "opt"}`` goes the same way, in the trees' own
key order (``cnn.layer_names`` reads it).  ``cache_to_numpy`` turns a pool
into numpy for comparison, bf16 leaves as float32 values.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.devices import resolve_device

# leaves of a training state that the port keeps as host values (CPU)
_HOST_KEYS = ("step", "count")
# leaves that stay f32 whatever dtype the rest is cast to: a coded weight's
# statistics and codebook, and the MoE router (never coded; routing is f32)
_F32_KEYS = ("q_mu", "q_sigma", "q_lut", "router")


def tensor_from_numpy(arr) -> torch.Tensor:
    """numpy array -> CPU tensor.  A bfloat16 array (JAX hands its bf16 out
    as a 2-byte numpy type of its own, which an npz file reads back as raw
    2-byte records) is taken by its bits."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        bits = torch.from_numpy(arr.view(np.uint16).astype(np.int32))
        return (bits << 16).view(torch.float32).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy on the host; bf16 widened to float32 (exact)."""
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def params_from_numpy(tree, device="cuda", dtype=None) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``.

    Integer leaves (codes) keep their dtype (uint8 = 4-bit packed, int8 =
    8-bit); floating leaves are cast to ``dtype`` when given, except the
    ``q_mu`` / ``q_sigma`` statistics, the ``q_lut`` codebooks and the MoE
    ``router``, which stay float32.  An expert stack's code dicts keep
    their 4-D layout.
    """
    dev = resolve_device(device)

    def leaf(key, arr):
        t = tensor_from_numpy(arr).to(dev)
        if dtype is not None and t.is_floating_point() \
                and key not in _F32_KEYS:
            t = t.to(dtype)
        return t

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v)
                for k, v in node.items()}

    return walk(tree)


def train_state_from_numpy(state, device="cuda") -> Dict[str, Any]:
    """A training state ``{"params", "opt", "step"}`` of numpy arrays (the
    reference's, or ``train_state_to_numpy``'s) -> the port's.

    Parameters and the optimizer's moments (``mu`` with its ``m`` / ``ms``,
    ``nu``) go to ``device`` in their own dtype; ``step`` and the
    optimizer's ``count`` stay host (CPU) int32 scalars, as
    ``train.steps.init_state`` makes them."""
    dev = resolve_device(device)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else
                tensor_from_numpy(v).to("cpu" if k in _HOST_KEYS else dev)
                for k, v in node.items()}

    return walk(state)


def train_state_to_numpy(state) -> Dict[str, Any]:
    """The port's training state -> nested dict of numpy arrays (bf16
    leaves as float32 values)."""
    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else tensor_to_numpy(v)
                for k, v in node.items()}

    return walk(state)


def cache_to_numpy(cache) -> Dict[str, np.ndarray]:
    """Pool dict -> numpy; bf16 leaves (stats, dense bf16 KV) are widened
    to float32 (exact), integer code leaves keep their dtype."""
    return {name: tensor_to_numpy(leaf) for name, leaf in cache.items()}
