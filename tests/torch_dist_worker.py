"""One rank of the gloo worlds of ``tests/test_torch_distributed.py`` and
``tests/test_torch_tensor_parallel.py``.

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
from repro_torch.parallel import tensor_parallel as tpar      # noqa: E402
from repro_torch.serve import serve as tserve                 # noqa: E402
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
    """A dense model's loss on a mesh through its placed parameters; a
    state-space or audio model's NotImplementedError text."""
    cfg = cb.get_smoke(c["arch"])
    mesh = mesh_lib.make_host_mesh(*c["mesh"], device="cpu")
    params = smoke_params(c["arch"])
    opts = ModelOpts(compute_dtype=torch.float32, remat=False,
                     attn_chunked_min_len=1 << 30, mesh=mesh)
    if cfg.family == "dense":
        params, opts = tpar.place_params(params, cfg, opts)
    toks = torch.zeros((2, 8), dtype=torch.int32)
    try:
        loss = model.loss_fn(params, cfg, opts, {"tokens": toks,
                                                 "targets": toks})
        msg = ""
        out[f"raises/{c['arch']}/loss"] = loss.detach().numpy()
    except NotImplementedError as e:
        msg = str(e)
    out[f"raises/{c['arch']}"] = np.frombuffer(msg.encode(), np.uint8)


# --------------------------------------------------------------------------
# Tensor and FSDP parallelism of the dense and vlm decoders
# --------------------------------------------------------------------------

def _tp_mesh(c):
    return mesh_lib.make_mesh(tuple(c["mesh"]), tuple(c["axes"]), "cpu")


def _tp_opts(c, mesh, **kw):
    return ModelOpts(compute_dtype=torch.float32,
                     attn_chunked_min_len=1 << 30, ce_chunk=8, mesh=mesh,
                     dp_includes_model=not c["tp"], **kw)


def _whole(tree, shardings):
    return tree_lib.map_tree(lambda t, s: s.whole(t), tree, shardings)


def _batch(arrays, prefix):
    return {k: torch.from_numpy(v) for k, v in subtree(arrays,
                                                       prefix).items()}


def case_tp_loss(c, arrays, rank, world, out):
    """The f32 loss and gradients (gathered whole) of the placed model;
    the collective wrapper's calls."""
    cfg = cb.get_smoke(c["arch"])
    mesh = _tp_mesh(c)
    params = smoke_params(c["arch"])
    placed, opts = tpar.place_params(params, cfg, _tp_opts(c, mesh,
                                                           remat=False),
                                     fsdp=c["fsdp"])
    tc = tsteps.TrainConfig(uniq=UniqConfig(w_bits=4, enabled=False))
    coll.reset_collective_counts()
    loss, grads = tsteps.loss_and_grads(
        placed, _batch(arrays, f"tp/{c['arch']}/batch"),
        torch.zeros(cfg.n_layers, dtype=torch.int32), None, cfg, opts, tc)
    counts = coll.collective_counts()
    whole = _whole(grads, shd.param_shardings(params, cfg, mesh,
                                              fsdp=c["fsdp"], tp=c["tp"]))
    tag = c["tag"]
    out[f"tp/{tag}/loss"] = loss.numpy()
    out[f"tp/{tag}/contiguous"] = np.asarray(all(
        t.is_contiguous() for t in tree_lib.leaves(placed)))
    out[f"tp/{tag}/collectives"] = np.array(
        [counts[k] for k in ("all_reduce", "all_gather", "reduce_scatter")])
    if rank == 0:
        out.update(flat(whole, f"tp/{tag}/grad"))


def _noise_of(arrays, prefix):
    def noise(path, leaf):
        e = torch.from_numpy(arrays[f"{prefix}/{path}"])
        if tuple(e.shape) != tuple(leaf.shape):
            raise ValueError(f"{path}: a draw of {tuple(leaf.shape)}, the "
                             f"whole leaf is {tuple(e.shape)}")
        return e
    return noise


def case_tp_step(c, arrays, rank, world, out):
    """One train step on the placed state (AdamW + UNIQ with the
    reference's noise, or the compressed pod sync), the state gathered
    whole on every rank."""
    cfg = cb.get_smoke("granite_3_8b")
    mesh = _tp_mesh(c)
    tag = c["tag"]
    whole = convert.train_state_from_numpy(
        subtree(arrays, f"{c['prefix']}/state"), device="cpu")
    if c["compress"]:
        tc = tsteps.TrainConfig(uniq=UniqConfig(w_bits=4, enabled=False),
                                optim=OptimConfig(kind="sgd", lr=1e-3),
                                total_steps=8, dp_compress_bits=8)
        noise = None
    else:
        tc = tsteps.TrainConfig(uniq=UniqConfig(w_bits=4),
                                optim=OptimConfig(kind="adamw", lr=1e-3),
                                total_steps=8, n_blocks=0)
        noise = _noise_of(arrays, f"{c['prefix']}/noise")
    pshard = shd.param_shardings(whole["params"], cfg, mesh, fsdp=c["fsdp"],
                                 tp=c["tp"])
    st_sh = shd.state_shardings(whole, pshard, mesh)
    state, opts = tsteps.place_state(whole, cfg, _tp_opts(c, mesh),
                                     fsdp=c["fsdp"])
    step_fn, _ = tsteps.make_train_step(cfg, opts, tc)
    state, m = step_fn(state, _batch(arrays, f"{c['prefix']}/batch"),
                       seed=0, noise=noise)
    out.update(flat(_whole(state, st_sh), f"tpstep/{tag}/state"))
    out[f"tpstep/{tag}/loss"] = m["loss"].numpy()
    out[f"tpstep/{tag}/grad_norm"] = np.asarray(float(m["grad_norm"]))
    out[f"tpstep/{tag}/lr"] = np.asarray(float(m["lr"]))


@dataclasses.dataclass
class CodeShapes:
    """The (K, N) of the weight codes each ``qmatmul`` / ``qmatmul_a8``
    wrapper call is handed, in call order (on the CPU a wrapper runs its
    plain version and counts no launch)."""
    shapes: list = dataclasses.field(default_factory=list)

    def wrap(self, fn, at):
        def recorded(*args, **kw):
            self.shapes.append(tuple(args[at].shape))
            return fn(*args, **kw)
        return recorded


def case_tp_serve(c, arrays, rank, world, out):
    """W4 prefill logits at each serving mode, the cache's block, the
    codes each matmul was handed, and greedy tokens of ``generate``."""
    cfg = cb.get_smoke(c["arch"])
    mesh = _tp_mesh(c)
    params = smoke_params(c["arch"], 4)
    tag = c["tag"]
    batch = _batch(arrays, f"serve/{c['arch']}/batch")
    prompt = torch.from_numpy(arrays[f"serve/{c['arch']}/prompt"])
    for mode in c["modes"]:
        kv_bits, a_bits = {"kv16": (16, 32), "kv8": (8, 32),
                           "a8": (16, 8)}[mode]
        placed, opts = tpar.place_params(
            params, cfg, _tp_opts(c, mesh, remat=False, kv_bits=kv_bits,
                                  serve_a_bits=a_bits), fsdp=c["fsdp"])
        rec = CodeShapes()
        orig = (kops.qmatmul, kops.qmatmul_a8)
        kops.qmatmul = rec.wrap(orig[0], 1)
        kops.qmatmul_a8 = rec.wrap(orig[1], 2)
        try:
            logits, cache = model.prefill(placed, cfg, opts, batch)
        finally:
            kops.qmatmul, kops.qmatmul_a8 = orig
        out[f"serve/{tag}/{mode}/logits"] = logits.numpy()
        leaf = next(iter(cache.values()))
        out[f"serve/{tag}/{mode}/cache"] = np.array(leaf.shape)
        out[f"serve/{tag}/{mode}/codes"] = np.array(rec.shapes)
        if mode != "kv8":
            toks = tserve.generate(placed, cfg, opts, tserve.ServeConfig(),
                                   prompt, c["n_new"])
            out[f"serve/{tag}/{mode}/tokens"] = toks.numpy()


def _paged_calls(params, cfg, opts, toks, page=4):
    """``model.prefill_chunk`` of the whole prompt into a paged pool
    (``init_paged_cache``: on a mesh the rank's KV heads), then one paged
    ``model.decode`` step: (the chunk's logits, the step's)."""
    B, S = toks.shape
    n_pages = S // page + 1
    pool = model.init_paged_cache(cfg, 1 + B * n_pages, page, torch.float32,
                                  kv_bits=opts.kv_bits, device="cpu",
                                  opts=opts if opts.placement else None)
    tables = torch.arange(1, 1 + B * n_pages).reshape(B, n_pages)
    pos = torch.arange(S)[None].expand(B, S)
    logits, pool = model.prefill_chunk(
        params, cfg, opts, pool, toks, pos, torch.gather(tables, 1,
                                                         pos // page),
        pos % page, tables, torch.full((B,), S - 1))
    step, _ = model.decode(params, cfg, opts, pool,
                           logits.argmax(-1)[:, None],
                           torch.full((B,), S), block_tables=tables)
    return logits, step


def case_tp_paged(c, arrays, rank, world, out):
    """The engine's model calls on a mesh: ``prefill_chunk`` and a paged
    decode step of the placed W4 model against the same calls unplaced
    (every rank runs every sequence of the shared pool, its KV heads)."""
    cfg = cb.get_smoke(c["arch"])
    mesh = _tp_mesh(c)
    params = smoke_params(c["arch"], 4)
    toks = torch.from_numpy(arrays[f"serve/{c['arch']}/batch/tokens"])
    for kv_bits in (16, 8):
        base = ModelOpts(compute_dtype=torch.float32, kv_bits=kv_bits,
                         attn_chunked_min_len=1 << 30)
        want = _paged_calls(params, cfg, base, toks)
        placed, opts = tpar.place_params(
            params, cfg, dataclasses.replace(base, mesh=mesh))
        got = _paged_calls(placed, cfg, opts, toks)
        out[f"paged/{c['tag']}/kv{kv_bits}/err"] = np.array(
            [float((g - w).abs().max()) for g, w in zip(got, want)])


def case_tp_stats(c, arrays, rank, world, out):
    """Each quantized leaf's placed statistics (``fit_placed``) and, as a
    control, its block's own."""
    from repro_torch.core import uniq as tuniq
    cfg = cb.get_smoke("granite_3_8b")
    mesh = _tp_mesh(c)
    params = smoke_params("granite_3_8b")
    placed, opts = tpar.place_params(params, cfg, _tp_opts(c, mesh),
                                     fsdp=c["fsdp"])
    ucfg = UniqConfig(w_bits=4)
    tag = c["tag"]
    for path, leaf in tree_lib.leaves_with_paths(placed):
        if not tuniq.default_quant_filter(path, leaf):
            continue
        stacked = path.startswith("layers/")
        got = tuniq.fit_placed(leaf, ucfg, stacked, path, opts.placement)
        own = tuniq._fit_dist(leaf, ucfg, stacked)
        for name, m in (("placed", got), ("own", own)):
            out[f"stats/{tag}/{name}/{path}/mu"] = m.mu.numpy()
            out[f"stats/{tag}/{name}/{path}/sigma"] = m.sigma.numpy()


def case_tp_ckpt(c, arrays, rank, world, out):
    """A placed W4 tree saved (gathered whole, rank 0 writes) and restored
    onto the same mesh: each block bit-equal to the one saved."""
    cfg = cb.get_smoke(c["arch"])
    mesh = _tp_mesh(c)
    params = smoke_params(c["arch"], 4)
    shardings = shd.param_shardings(params, cfg, mesh, fsdp=c["fsdp"],
                                    tp=c["tp"])
    placed = shd.place_tree(params, shardings)
    ckpt.save(c["ckpt"], 3, placed, shardings=shardings)
    restored, step, _ = ckpt.restore(c["ckpt"], params, shardings=shardings)
    out[f"ckpt/{c['tag']}/equal"] = np.asarray(
        step == 3 and all(torch.equal(a, b) for a, b in zip(
            tree_lib.leaves(placed), tree_lib.leaves(restored))))


CASES = {"pmean": case_pmean, "ep": case_ep, "step": case_step,
         "blocks": case_blocks, "dense_raises": case_dense_raises,
         "tp_loss": case_tp_loss, "tp_step": case_tp_step,
         "tp_serve": case_tp_serve, "tp_paged": case_tp_paged,
         "tp_stats": case_tp_stats,
         "tp_ckpt": case_tp_ckpt}


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
