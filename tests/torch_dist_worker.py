"""One rank of the gloo worlds of ``tests/test_torch_distributed.py``.

``run(rank, world, where)`` (or ``python tests/torch_dist_worker.py RANK
WORLD DIR``) joins a world of ``world`` ranks over a ``FileStore`` in
``where``, runs every case the test wrote into ``where/cases.json`` (arrays
in ``where/in.npz``) and writes its results to ``where/out_<rank>.npz`` (a
failure's traceback to ``where/log_<rank>.txt``).  The test forks each rank
from a forkserver that has imported this module alone: a rank holds torch
and the port, never JAX; the reference's side is computed by the test
process, which compares.  Not a test module (pytest collects
``test_*.py`` only).
"""

import dataclasses
import functools
import json
import os
import sys
import traceback

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch import convert, tree as tree_lib            # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt         # noqa: E402
from repro_torch.configs import base as cb                    # noqa: E402
from repro_torch.core.uniq import UniqConfig                  # noqa: E402
from repro_torch.data import synthetic                        # noqa: E402
from repro_torch.kernels import ops as kops                   # noqa: E402
from repro_torch.launch import mesh as mesh_lib               # noqa: E402
from repro_torch.models import model                          # noqa: E402
from repro_torch.models.lm import ModelOpts                   # noqa: E402
from repro_torch.optim.optim import OptimConfig               # noqa: E402
from repro_torch.parallel import collectives as coll          # noqa: E402
from repro_torch.parallel import sharding as shd              # noqa: E402
from repro_torch.train import steps as tsteps                 # noqa: E402


def subtree(arrays, prefix):
    """The nested dict of numpy arrays stored under ``prefix/``."""
    out = {}
    for key, val in arrays.items():
        if key.startswith(prefix + "/"):
            node = out
            parts = key[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = val
    return out


def flat(tree, prefix):
    return {f"{prefix}/{p}": convert.tensor_to_numpy(torch.as_tensor(v))
            for p, v in tree_lib.leaves_with_paths(tree)}


def case_pmean(c, arrays, rank, world, out):
    mesh = mesh_lib.make_mesh((world,), ("pod",), "cpu")
    grads = convert.params_from_numpy(
        subtree(arrays, f"pmean/{c['name']}/r{rank}"), device="cpu")
    res = coll.compressed_pmean(grads, mesh.get_group("pod"), c["bits"])
    out.update(flat(res, f"pmean/{c['name']}"))


@dataclasses.dataclass
class ExpertCalls:
    """Counts the port's expert-matmul wrapper calls and their experts (on
    the CPU a wrapper runs its plain version and counts no launch)."""
    calls: int = 0
    experts: tuple = ()

    def wrap(self, fn):
        def counted(a, *args, **kw):
            self.calls += 1
            self.experts += (a.shape[0],)
            return fn(a, *args, **kw)
        return counted


@functools.lru_cache(maxsize=None)
def smoke_params(arch, w_bits=16, w_dist="gaussian"):
    return model.init(0, cb.get_smoke(arch), device="cpu", w_bits=w_bits,
                      w_dist=w_dist)


def case_ep(c, arrays, rank, world, out):
    cfg = cb.get_smoke("kimi_k2_1t_a32b")
    params = smoke_params("kimi_k2_1t_a32b", 4, c["dist"])
    mesh = mesh_lib.make_host_mesh(*c["mesh"], device="cpu")
    opts = ModelOpts(compute_dtype=torch.float32, remat=False,
                     attn_chunked_min_len=1 << 30, ce_chunk=8,
                     moe_axis="model", mesh=mesh, moe_mode=c["mode"])
    batch = {k: torch.from_numpy(arrays[f"ep/{k}"])
             for k in ("tokens", "targets")}
    rec = ExpertCalls()
    name = "qmatmul_lut_experts" if c["dist"] == "empirical" \
        else "qmatmul_experts"
    orig = getattr(kops, name)
    setattr(kops, name, rec.wrap(orig))
    coll.reset_collective_counts()
    try:
        loss = model.loss_fn(params, cfg, opts, batch)
    finally:
        setattr(kops, name, orig)
    counts = coll.collective_counts()
    tag = c["tag"]
    out[f"ep/{tag}/loss"] = loss.detach().numpy()
    out[f"ep/{tag}/experts"] = np.array(rec.experts, np.int64)
    out[f"ep/{tag}/collectives"] = np.array(
        [counts["all_reduce"], counts["all_gather"]], np.int64)


def case_step(c, arrays, rank, world, out):
    """One SGD step with the compressed sync, the UNIQ transform off (the
    test's ``_step_tc``)."""
    cfg = cb.get_smoke("granite_3_8b")
    mesh = mesh_lib.make_mesh((world,), ("pod",), "cpu")
    tc = tsteps.TrainConfig(uniq=UniqConfig(w_bits=4, enabled=False),
                            optim=OptimConfig(kind=c["optim"], lr=1e-3),
                            total_steps=8, dp_compress_bits=8)
    opts = ModelOpts(compute_dtype=torch.float32, remat=False, ce_chunk=8,
                     mesh=mesh)
    state = convert.train_state_from_numpy(subtree(arrays, "step/state"),
                                           device="cpu")
    step_fn, _ = tsteps.make_train_step(cfg, opts, tc)
    batch = {k: torch.from_numpy(arrays[f"step/{k}"])
             for k in ("tokens", "targets")}
    state, m = step_fn(state, batch, seed=0)
    out.update(flat(state, "step/state"))
    out["step/loss"] = m["loss"].numpy()
    out["step/grad_norm"] = np.asarray(float(m["grad_norm"]))


def case_blocks(c, arrays, rank, world, out):
    """shard_batch of the stream's batch and restore(shardings=) of a
    checkpoint, on one mesh."""
    mesh = mesh_lib.make_mesh(tuple(c["mesh"]), tuple(c["axes"]), "cpu")
    tag = c["tag"]
    batch = synthetic.lm_batch(synthetic.LMStreamConfig(
        vocab=64, seq_len=6, global_batch=c["batch"], seed=3), 0,
        device="cpu")
    out.update(flat(synthetic.shard_batch(batch, mesh), f"blocks/{tag}/batch"))
    cfg = cb.get_smoke(c["arch"])
    target = smoke_params(c["arch"], c["w_bits"])
    shardings = shd.param_shardings(target, cfg, mesh, fsdp=c["fsdp"],
                                    expert_mode=c["expert_mode"])
    restored, step, _ = ckpt.restore(c["ckpt"], target, shardings=shardings)
    out.update(flat(restored, f"blocks/{tag}/params"))
    out[f"blocks/{tag}/step"] = np.asarray(step)


def case_dense_raises(c, arrays, rank, world, out):
    cfg = cb.get_smoke(c["arch"])
    mesh = mesh_lib.make_host_mesh(*c["mesh"], device="cpu")
    params = smoke_params(c["arch"])
    opts = ModelOpts(compute_dtype=torch.float32, remat=False,
                     attn_chunked_min_len=1 << 30, mesh=mesh)
    toks = torch.zeros((2, 8), dtype=torch.int32)
    try:
        model.loss_fn(params, cfg, opts, {"tokens": toks, "targets": toks})
        msg = ""
    except NotImplementedError as e:
        msg = str(e)
    out[f"raises/{c['arch']}"] = np.frombuffer(msg.encode(), np.uint8)


CASES = {"pmean": case_pmean, "ep": case_ep, "step": case_step,
         "blocks": case_blocks, "dense_raises": case_dense_raises}


def run(rank: int, world: int, where: str) -> None:
    try:
        torch.set_num_threads(1)
        with open(os.path.join(where, "cases.json")) as f:
            cases = json.load(f)
        with np.load(os.path.join(where, "in.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        mesh_lib.init_world("cpu", store_path=os.path.join(where, "store"),
                            rank=rank, world_size=world)
        out = {}
        try:
            for c in cases:
                CASES[c["kind"]](c, arrays, rank, world, out)
        finally:
            mesh_lib.destroy_world()
        np.savez(os.path.join(where, f"out_{rank}.npz"), **out)
    except BaseException:
        with open(os.path.join(where, f"log_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


if __name__ == "__main__":
    run(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
