"""Fault-tolerant checkpointing: atomic sharded npz save / restore, in the
reference's on-disk layout, so a checkpoint crosses the frameworks both
ways.

Layout:  <dir>/step_<N>/  shard_000000.npz ... + manifest.json
         <dir>/LATEST     (atomic pointer file, written last)

Leaves are keyed by their ``/``-joined path (``params/layers/wq``,
``opt/mu/embed/m``, ``step``, ...); restore matches them by path into the
structure of a target tree and places each on the target leaf's device in
its dtype.  bf16 leaves are written widened to float32 (exact; numpy has no
bfloat16), and the reference's raw 2-byte bf16 arrays are read back by
their bits.

Atomicity: step dirs are written under a tmp name and renamed, then LATEST
is replaced by rename — a crash mid-save never corrupts the previous
checkpoint (restart picks up the old LATEST).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.convert import tensor_from_numpy, tensor_to_numpy

MAX_SHARD_BYTES = 1 << 30  # 1 GiB per npz shard


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None,
         shardings: Optional[Any] = None):
    """Write a checkpoint for ``step``; returns the step directory.

    ``shardings``: ``tree`` holds a rank's blocks, placed by this matching
    tree of ``parallel.sharding.Sharding`` (every rank calls it): each leaf
    is gathered whole (``Sharding.whole``) and rank 0 writes the whole
    leaves, the reference's on-disk form; every rank returns once it is
    written."""
    if shardings is not None:
        import torch.distributed as dist
        tree = tree_lib.map_tree(lambda t, shd: shd.whole(torch.as_tensor(t)),
                                 tree, shardings)
        if dist.get_rank() != 0:
            dist.barrier()
            return os.path.join(ckpt_dir, f"step_{step}")
        out = save(ckpt_dir, step, tree, extra)
        dist.barrier()
        return out
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    shard: dict = {}
    shard_bytes = 0
    shard_idx = 0

    def flush():
        nonlocal shard, shard_bytes, shard_idx
        if shard:
            np.savez(os.path.join(tmp, f"shard_{shard_idx:06d}.npz"),
                     **shard)
            shard, shard_bytes = {}, 0
            shard_idx += 1

    for i, (path, leaf) in enumerate(tree_lib.leaves_with_paths(tree)):
        t = torch.as_tensor(leaf)
        arr = tensor_to_numpy(t)
        key = f"leaf_{i:06d}"
        manifest["leaves"].append({
            "path": path, "key": key, "shard": shard_idx,
            "shape": list(arr.shape),
            "dtype": ("bfloat16" if t.dtype == torch.bfloat16
                      else str(arr.dtype))})
        shard[key] = arr
        shard_bytes += arr.nbytes
        if shard_bytes >= MAX_SHARD_BYTES:
            flush()
    flush()

    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    ptr_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(str(step))
    os.replace(ptr_tmp, os.path.join(ckpt_dir, "LATEST"))
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        return int(f.read().strip())


def restore(ckpt_dir: str, target: Any, step: Optional[int] = None,
            shardings: Optional[Any] = None):
    """Restore into the structure of ``target`` (a tree of tensors: each
    leaf gives the shape, dtype and device of what is restored there).
    ``shardings``: a matching tree of ``parallel.sharding.Sharding`` (the
    reference's ``NamedSharding`` tree): each leaf is checked against the
    whole target shape and placed by its sharding, so each rank holds its
    block (elastic restore onto another mesh than the one that saved).

    Returns (tree, step, extra).
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    by_shard: dict = {}
    for leaf in manifest["leaves"]:
        by_shard.setdefault(leaf["shard"], []).append(leaf)
    loaded = {}
    for sid, leaves in by_shard.items():
        with np.load(os.path.join(d, f"shard_{sid:06d}.npz")) as z:
            for leaf in leaves:
                loaded[leaf["path"]] = z[leaf["key"]]

    def one(path, tgt, shd=None):
        if path not in loaded:
            raise KeyError(f"checkpoint missing leaf {path!r}")
        arr = loaded[path]
        tgt = torch.as_tensor(tgt)
        if tuple(arr.shape) != tuple(tgt.shape):
            raise ValueError(f"shape mismatch for {path}: ckpt {arr.shape} "
                             f"vs target {tuple(tgt.shape)}")
        t = tensor_from_numpy(arr)
        if shd is not None:
            t = shd.place(t).clone()        # the block alone, not a view
        return t.to(device=tgt.device, dtype=tgt.dtype)

    rest = () if shardings is None else (shardings,)
    return (tree_lib.map_with_path(one, target, *rest), step,
            manifest["extra"])


def prune_old(ckpt_dir: str, keep: int = 3):
    """Delete all but the newest ``keep`` step dirs (never LATEST's)."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
                   if n.startswith("step_"))
    cur = latest_step(ckpt_dir)
    for s in steps[:-keep]:
        if s != cur:
            shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                          ignore_errors=True)
