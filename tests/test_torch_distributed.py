"""PyTorch port vs JAX reference: the multi-device layer on gloo worlds of
1, 2 and 4 ranks on the CPU.

Each world is spawned once for this module (``tests/torch_dist_worker.py``
ranks over a ``FileStore`` in a temporary directory); its ranks import the
port alone and run every case of the world, and this process, which
computes the reference's side, compares:

* ``compressed_pmean``: at world 1 equal to the reference's run on its
  one-device ``pod`` mesh; at 2 and 4 equal to the reference's
  ``_absmax_quant`` of each rank's gradient, dequantized, summed in rank
  order and divided by n; every rank's result bit-identical;
* the expert-parallel MoE (kimi_k2 smoke, W4 Gaussian on meshes (1, 2),
  (1, 4) and (2, 2), W4 empirical on (1, 2)) in both ``moe_mode``s, within
  ``TOL_F32`` of the
  reference's local ``model.loss_fn``, every rank's expert products through
  ``qmatmul_experts`` / ``qmatmul_lut_experts`` on its E / n experts;
* one ``dp_compress_bits=8`` train step: at world 1 against the reference's
  ``make_train_step`` on ``Mesh(devices[:1], ("pod",))``; at world 2
  against the reference's step over two pods written out on one device
  (each pod's half of the batch through its loss and gradient, its codec
  and mean, its optimizer), and the parameters bit-identical across
  ranks;
* ``shard_batch`` and ``restore(shardings=)``: each rank's block is the
  one JAX's ``NamedSharding`` of the reference's spec gives that device;
* a dense model on a mesh runs on its placed parameters (the loss within
  ``TOL_F32`` of the reference's); a state-space or audio model on a mesh
  of more than one rank raises a ``NotImplementedError`` naming it.
"""

import concurrent.futures
import dataclasses
import functools
import json
import multiprocessing
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
from jax.sharding import AbstractMesh, Mesh
from jax.sharding import PartitionSpec as JP

from repro.configs import base as jcb
from repro.core import uniq as juniq
from repro.models import model as jmodel
from repro.optim import optim as joptim
from repro.parallel import collectives as jcoll
from repro.parallel import sharding as jshd
from repro.train import steps as jsteps

from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import base as tcb
from repro_torch.data import synthetic as tdata
from repro_torch.models import model as tmodel
from repro_torch.train import steps as tsteps

import test_torch_train as ttrain
import torch_dist_worker


WORLDS = (1, 2, 4)
# the MoE loss at f32 (tests/test_torch_moe.py's TOL_F32): the same
# function, summed over the model axis's shards in another order
TOL_F32 = 2e-4
# one train step's loss: tests/test_torch_train.py's bound
TOL_LOSS_REL = ttrain.TOL_LOSS_REL
EP_ARCH = "kimi_k2_1t_a32b"
EP_MESHES = {1: [], 2: [(1, 2)], 4: [(1, 4), (2, 2)]}
# batch rows and positions of the EP loss, every target valid
EP_B, EP_S = 4, 8


# --------------------------------------------------------------------------
# The reference's side
# --------------------------------------------------------------------------

def _np(tree):
    return {p: convert.tensor_to_numpy(v)
            for p, v in tree_lib.leaves_with_paths(tree)}


def _nest(flat):
    out = {}
    for key, val in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def _pmean_grads(rank, seed=0):
    """Rank ``rank``'s gradient tree: coded leaves (2-D f32, 3-D f32, bf16)
    and exact ones (1-D, 32 elements, int32)."""
    rng = np.random.default_rng(seed + 101 * rank)
    return {"w": (rng.standard_normal((64, 32)) * 0.01).astype(np.float32),
            "e": rng.standard_normal((3, 4, 16)).astype(np.float32),
            "h": rng.standard_normal((16, 16)).astype(ml_dtypes.bfloat16),
            "b": rng.standard_normal((16,)).astype(np.float32),
            "s": rng.standard_normal((4, 8)).astype(np.float32),
            "n": rng.integers(-5, 5, (3,)).astype(np.int32)}


# the reference's codec, compiled once a shape (eager dispatch compiles each
# operation anew for each shape); ``bits`` traced, so that XLA does not
# turn the division by the constant 127 into a product with its rounded
# reciprocal: the codes and scales are eager dispatch's, bit for bit
_ref_quant = jax.jit(jcoll._absmax_quant)


def _ref_mean(gs, bits=8):
    """The reference's ``compressed_pmean`` of one leaf over the ranks'
    values ``gs`` (numpy, rank order), written out: the exact mean of a
    small, 1-D or integer leaf, else each rank's ``_absmax_quant`` codes
    times scales, summed in rank order, divided by n and cast back to the
    leaf's dtype; widened to f32."""
    g0, n = gs[0], len(gs)
    if g0.ndim <= 1 or g0.size <= 128 or g0.dtype.kind in "iu":
        total = gs[0]
        for g in gs[1:]:
            total = total + g
        return np.asarray(total / n).astype(np.float32)
    total = None
    for g in gs:
        codes, scale = _ref_quant(jnp.asarray(g), jnp.int32(bits))
        deq = np.asarray(codes).astype(np.float32) * np.asarray(scale)
        total = deq if total is None else total + deq
    return (total / np.float32(n)).astype(g0.dtype).astype(np.float32)


def _pmean_want(n):
    """The reference's mean over n ranks' gradients, widened to f32."""
    grads = [_pmean_grads(r) for r in range(n)]
    if n == 1:
        # the region compiled whole, ``bits`` traced as in _ref_quant
        mesh = Mesh(np.array(jax.devices()[:1]), ("pod",))
        out = jax.jit(jcoll.pod_shard_map(
            lambda t, bits: jcoll.compressed_pmean(t, "pod", bits), mesh,
            in_specs=(JP(), JP()), out_specs=JP()))(
            jax.tree.map(jnp.asarray, grads[0]), jnp.int32(8))
        return {k: np.asarray(v).astype(np.float32) for k, v in out.items()}
    return {k: _ref_mean([g[k] for g in grads]) for k in grads[0]}


def _ep_batch():
    rng = np.random.default_rng(5)
    cfg = tcb.get_smoke(EP_ARCH)
    toks = rng.integers(0, cfg.vocab, (EP_B, EP_S)).astype(np.int32)
    tgts = rng.integers(0, cfg.vocab, (EP_B, EP_S)).astype(np.int32)
    return {"tokens": toks, "targets": tgts}


@functools.lru_cache(maxsize=None)
def _ref_loss_fn():
    cfg = jcb.get_smoke(EP_ARCH)
    return jax.jit(lambda p, b: jmodel.loss_fn(p, cfg, ttrain._jopts(), b))


@functools.lru_cache(maxsize=None)
def _ep_params(dist):
    """The port's kimi_k2 smoke W4 parameters (the ranks draw the same from
    the same seed), as the reference's tree."""
    pt = tmodel.init(0, tcb.get_smoke(EP_ARCH), device="cpu", w_bits=4,
                     w_dist=dist)
    return jax.tree.map(jnp.asarray, _nest(_np(pt)))


@functools.lru_cache(maxsize=None)
def _ep_want(dist, blocks):
    """The reference's local loss of the EP batch; with ``blocks`` > 1 the
    mean of the local losses of its ``blocks`` row blocks (every target
    valid, blocks of equal size): in gather mode with data > 1 each data
    block of rows routes alone (its own capacity), as the reference's
    region splits them."""
    batch = _ep_batch()
    rows = EP_B // blocks
    return float(np.mean([_ref_loss_fn()(_ep_params(dist), {
        k: jnp.asarray(v[i * rows:(i + 1) * rows])
        for k, v in batch.items()}) for i in range(blocks)]))


def _step_tc():
    """The step's train configs (reference, port): SGD, the compressed sync,
    the UNIQ transform off — the transform's step is held against the
    reference by tests/test_torch_train.py, and the sync acts on whatever
    gradient comes out of it (one compile of the reference's step, 4 s
    here, against 16 with the transform)."""
    jt, tt = ttrain._tc("sgd", dp_compress_bits=8)
    return (dataclasses.replace(jt, uniq=dataclasses.replace(
                jt.uniq, enabled=False)),
            dataclasses.replace(tt, uniq=dataclasses.replace(
                tt.uniq, enabled=False)))


@functools.lru_cache(maxsize=None)
def _step_inputs():
    """State, batch and key of the step case: the port's fresh state as the
    reference's tree (the same structure, shapes and dtypes), four rows to
    split over every world's pods.  The halves hold different counts of
    valid targets (21 and 13), so the mean of the two pods' mean losses is
    not the whole batch's mean: a rank that trained on the whole batch, or
    on another pod's rows, shows."""
    cfg_t = tcb.get_smoke("granite_3_8b")
    sj0 = jax.tree.map(jnp.asarray, convert.train_state_to_numpy(
        tsteps.init_state(0, cfg_t, _step_tc()[1], device="cpu")))
    batch = {k: np.concatenate([ttrain._tokens(cfg_t, seed=1)[k],
                                ttrain._tokens(cfg_t, seed=2)[k]])
             for k in ("tokens", "targets")}
    batch["targets"][2:, :4] = -1
    assert [int((batch["targets"][i:i + 2] >= 0).sum())
            for i in (0, 2)] == [21, 13]
    return sj0, batch, jax.random.PRNGKey(42)


def _ref_step(sj0, batch, key):
    cfg = jcb.get_smoke("granite_3_8b")
    mesh = Mesh(np.array(jax.devices()[:1]), ("pod",))
    fn, sched = jsteps.make_train_step(
        cfg, dataclasses.replace(ttrain._jopts(), mesh=mesh), _step_tc()[0])
    sj1, mj = jax.jit(fn)(sj0, jax.tree.map(jnp.asarray, batch), key)
    return sj1, mj, sched.modes_at(0)


@functools.lru_cache(maxsize=None)
def _ref_grad_fn():
    cfg = jcb.get_smoke("granite_3_8b")
    return jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, cfg, ttrain._jopts(), b)))


@functools.lru_cache(maxsize=None)
def _ref_update_fn():
    oc = _step_tc()[0].optim
    return jax.jit(lambda p, g, o, lr: joptim.apply_updates(p, g, o, oc, lr))


def _ref_pod_step(sj0, batch, n):
    """The reference's ``dp_compress_bits`` step over ``n`` pods
    (``make_pod_compressed_grads`` inside ``make_train_step``), written out
    on one device: pod i's block of rows (``P("pod")``: rows i * B/n
    onwards) through the reference's loss and gradient (the UNIQ transform
    off: the loss of the parameters), the gradients through the reference's
    codec and mean (``_ref_mean``), the loss's exact mean, then the
    reference's optimizer at its learning rate.  Returns (state, metrics,
    each pod's gradient {name: numpy})."""
    jt = _step_tc()[0]
    cfg = jcb.get_smoke("granite_3_8b")
    rows = len(batch["tokens"]) // n
    pods = [_ref_grad_fn()(sj0["params"], {
        k: jnp.asarray(v[i * rows:(i + 1) * rows]) for k, v in batch.items()})
        for i in range(n)]
    loss = pods[0][0]
    for lp, _ in pods[1:]:
        loss = loss + lp
    loss = loss / n
    flat = [ttrain._flat_np(g) for _, g in pods]
    grads = jax.tree_util.tree_map_with_path(
        lambda kp, v: jnp.asarray(_ref_mean(
            [f[juniq.path_str(kp)] for f in flat])).astype(v.dtype),
        pods[0][1])
    lr = jsteps.make_lr_fn(jt, jsteps.make_schedule(cfg, jt))(
        int(sj0["step"]))
    params, opt, om = _ref_update_fn()(sj0["params"], grads, sj0["opt"], lr)
    return ({"params": params, "opt": opt, "step": sj0["step"] + 1},
            {"loss": loss, "lr": lr, **om}, flat)


# block cases: (mesh shape, axes, arch, W bits, fsdp, expert_mode, batch)
BLOCK_CASES = {
    1: [((1, 1), ("data", "model"), "granite_3_8b", 16, True, "gather", 4)],
    2: [((2, 1), ("data", "model"), "granite_3_8b", 4, True, "gather", 4),
        ((1, 2), ("data", "model"), EP_ARCH, 4, True, "reduce", 3)],
    4: [((2, 2), ("data", "model"), EP_ARCH, 4, True, "gather", 4),
        ((2, 2, 1), ("pod", "data", "model"), EP_ARCH, 4, "pod", "reduce",
         4)],
}


def jax_block(sharding, shape, device: int):
    """The block of a ``shape`` array that JAX's ``sharding`` (on an
    abstract mesh) gives the device at flat mesh index ``device``: one
    slice per dim, read from its HLO tile assignment."""
    hlo = sharding._to_xla_hlo_sharding(len(shape))
    if hlo.is_replicated():
        return tuple(slice(0, n) for n in shape)
    dims = hlo.tile_assignment_dimensions()
    tiles = np.asarray(hlo.tile_assignment_devices()).reshape(dims)
    where = np.argwhere(tiles == device)[0]
    out = []
    for i, n in enumerate(shape):
        step = n // dims[i]
        out.append(slice(where[i] * step, (where[i] + 1) * step))
    return tuple(out)


def _block_batch(b):
    return _np(tdata.lm_batch(tdata.LMStreamConfig(
        vocab=64, seq_len=6, global_batch=b, seed=3), 0, device="cpu"))


def _block_params(arch, bits):
    return _np(tmodel.init(0, tcb.get_smoke(arch), device="cpu",
                           w_bits=bits))


def _block_want(case, n):
    """Every rank's expected batch and parameter blocks of a block case,
    by the reference's specs on an abstract mesh of the case's shape."""
    shape, axes, arch, bits, fsdp, mode, b = case
    amesh = AbstractMesh(shape, axes)
    batch = _block_batch(b)
    bsh = jshd.input_shardings(
        {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
         for k, v in batch.items()}, amesh)
    flat = _block_params(arch, bits)
    psh = jshd.param_shardings(
        _nest({p: jax.ShapeDtypeStruct(v.shape, v.dtype)
               for p, v in flat.items()}), jcb.get_smoke(arch), amesh,
        fsdp=fsdp, expert_mode=mode)
    psh = dict(zip([p for p, _ in tree_lib.leaves_with_paths(_nest(flat))],
                   jax.tree_util.tree_leaves(psh)))
    want = []
    for r in range(n):
        w = {f"batch/{k}": v[jax_block(bsh[k], v.shape, r)]
             for k, v in batch.items()}
        w.update({f"params/{p}": v[jax_block(psh[p], v.shape, r)]
                  for p, v in flat.items()})
        want.append(w)
    return want


# --------------------------------------------------------------------------
# The worlds
# --------------------------------------------------------------------------

@dataclasses.dataclass
class World:
    n: int
    out: list          # each rank's results {key: numpy}
    want: dict


def _ep_cases(n):
    """(w_dist, mesh, moe_mode) of world ``n``'s EP cases: Gaussian codes
    (``qmatmul_experts``) on every mesh, codebooks
    (``qmatmul_lut_experts``) on (1, 2)."""
    return [(dist, mesh, mode) for dist in ("gaussian", "empirical")
            for mesh in EP_MESHES[n]
            if dist == "gaussian" or mesh == (1, 2)
            for mode in ("gather", "reduce")]


def _ep_tag(dist, mesh, mode):
    return f"{dist}/{mesh[0]}x{mesh[1]}/{mode}"


def _inputs(n, where):
    """The cases of world ``n`` and their arrays (the checkpoints of the
    block cases written under ``where``)."""
    cases, arrays = [], {}
    cases.append({"kind": "pmean", "name": "g", "bits": 8})
    for r in range(n):
        for k, v in _pmean_grads(r).items():
            arrays[f"pmean/g/r{r}/{k}"] = v
    arrays.update({f"ep/{k}": v for k, v in _ep_batch().items()})
    for dist, mesh, mode in _ep_cases(n):
        cases.append({"kind": "ep", "dist": dist, "mesh": mesh, "mode": mode,
                      "tag": _ep_tag(dist, mesh, mode)})
    if n <= 2:
        sj0, sbatch, _ = _step_inputs()
        cases.append({"kind": "step", "optim": "sgd"})
        arrays.update({f"step/state/{p}": v
                       for p, v in ttrain._flat_np(sj0).items()})
        arrays.update({f"step/{k}": v for k, v in sbatch.items()})
    for case in BLOCK_CASES[n]:
        shape, axes, arch, bits, fsdp, mode, b = case
        tag = "x".join(map(str, shape))
        ckpt_dir = os.path.join(where, f"ckpt_{tag}")
        tckpt.save(ckpt_dir, 7, _nest(_block_params(arch, bits)))
        cases.append({"kind": "blocks", "mesh": shape, "axes": axes,
                      "arch": arch, "w_bits": bits, "fsdp": fsdp,
                      "expert_mode": mode, "batch": b, "ckpt": ckpt_dir,
                      "tag": tag})
    mesh = (2, 2) if n == 4 else (1, n)
    for arch in RAISE_ARCHS[:2 if n == 1 else 3]:
        cases.append({"kind": "dense_raises", "arch": arch, "mesh": mesh})
    return cases, arrays


# the dense-raise cases: granite runs placed, the others raise past one
# rank (whisper only there: its loss wants frames)
RAISE_ARCHS = ("granite_3_8b", "mamba2_1_3b", "whisper_base")


@functools.lru_cache(maxsize=None)
def _dense_loss_want():
    """The reference's loss of the port's granite smoke parameters on the
    raise cases' batch (zero tokens and targets, 2 x 8)."""
    cfg = jcb.get_smoke("granite_3_8b")
    pj = jax.tree.map(jnp.asarray, _nest(_np(tmodel.init(
        0, tcb.get_smoke("granite_3_8b"), device="cpu"))))
    toks = jnp.zeros((2, 8), jnp.int32)
    return float(jax.jit(lambda p, b: jmodel.loss_fn(p, cfg, ttrain._jopts(),
                                                     b))(
        pj, {"tokens": toks, "targets": toks}))


def _wants(n):
    """The reference's side of world ``n``'s cases."""
    want = {"pmean": _pmean_want(n), "ep": {}, "raises": n > 1,
            "dense_loss": _dense_loss_want()}
    for dist, mesh, mode in _ep_cases(n):
        blocks = 1 if mode == "reduce" else mesh[0]
        want["ep"][_ep_tag(dist, mesh, mode)] = (mesh, _ep_want(dist, blocks))
    want["blocks"] = {"x".join(map(str, c[0])): _block_want(c, n)
                      for c in BLOCK_CASES[n]}
    return want


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Starts the three worlds' ranks at once, computes the reference's
    side while they run, then collects every rank's results: {n: World, or
    the failure's log}.  Each rank is a process forked from a forkserver
    that has imported ``torch_dist_worker`` (torch and the port, once, not
    once a rank: ~4 s of CPU each); it runs ``torch_dist_worker.run``."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["torch_dist_worker"])
    running = {}
    try:
        for n in WORLDS:
            where = str(tmp_path_factory.mktemp(f"world{n}"))
            cases, arrays = _inputs(n, where)
            with open(os.path.join(where, "cases.json"), "w") as f:
                json.dump(cases, f)
            np.savez(os.path.join(where, "in.npz"), **arrays)
            procs = [ctx.Process(target=torch_dist_worker.run,
                                 args=(r, n, where)) for r in range(n)]
            for p in procs:
                p.start()
            running[n] = (where, procs)
        # the reference's two train steps compile (the GIL released) in
        # threads while the rest of the reference's side is computed
        sj0, sbatch, key = _step_inputs()
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            step = pool.submit(_ref_step, sj0, sbatch, key)
            pod_step = pool.submit(_ref_pod_step, sj0, sbatch, 2)
            wants = {n: _wants(n) for n in WORLDS}
            sj2, mj2, pods = pod_step.result()
            sj1, mj1, modes = step.result()
            wants[1]["step"] = (sj0, key, sj1, mj1, modes, None)
            wants[2]["step"] = (sj0, key, sj2, mj2, modes, pods)
        for n, (where, procs) in running.items():
            for p in procs:
                p.join(timeout=300)
    finally:
        for _, procs in running.values():
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    out = {}
    for n, (where, procs) in running.items():
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            log = os.path.join(where, f"log_{failed[0]}.txt")
            text = f"exit code {procs[failed[0]].exitcode}"
            if os.path.exists(log):
                with open(log) as f:
                    text = f.read()
            out[n] = f"rank {failed[0]} of {n} failed:\n{text[-4000:]}"
            continue
        res = []
        for r in range(n):
            with np.load(os.path.join(where, f"out_{r}.npz")) as z:
                res.append({k: z[k] for k in z.files})
        out[n] = World(n, res, wants[n])
    return out


@pytest.fixture(params=WORLDS, ids=lambda n: f"world{n}")
def world(request, worlds):
    w = worlds[request.param]
    if isinstance(w, str):
        pytest.fail(w)
    return w


def _same_on_every_rank(world, key):
    for r in range(1, world.n):
        np.testing.assert_array_equal(world.out[r][key], world.out[0][key],
                                      err_msg=f"{key}: rank {r} vs rank 0")


# --------------------------------------------------------------------------
# The tests
# --------------------------------------------------------------------------

def test_compressed_pmean_equals_the_reference(world):
    """Bit-equal to the reference's codec, mean and dtype, on every rank."""
    for k, want in world.want["pmean"].items():
        key = f"pmean/g/{k}"
        _same_on_every_rank(world, key)
        got = world.out[0][key]
        assert got.dtype == np.float32, k
        np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("n", [2, 4], ids=lambda n: f"world{n}")
def test_expert_parallel_moe_matches_the_local_loss(n, worlds):
    """Loss within TOL_F32 of the reference's, equal on every rank; each
    loss call runs 3 expert products a layer, each on E / model experts,
    one all-reduce a layer at the collective wrapper, and in gather mode
    one all-gather a layer (the tokens' output over "data"; no weight
    moves), in reduce mode none."""
    world = worlds[n]
    if isinstance(world, str):
        pytest.fail(world)
    cfg = tcb.get_smoke(EP_ARCH)
    L = cfg.n_layers
    assert world.want["ep"]
    for tag, (mesh, want) in world.want["ep"].items():
        _same_on_every_rank(world, f"ep/{tag}/loss")
        got = float(world.out[0][f"ep/{tag}/loss"])
        assert abs(got - want) <= TOL_F32, (tag, got, want)
        for r in range(world.n):
            experts = world.out[r][f"ep/{tag}/experts"]
            assert experts.tolist() == [cfg.n_experts // mesh[1]] * 3 * L, \
                (tag, r, experts)
            n_reduce, n_gather = world.out[r][f"ep/{tag}/collectives"].tolist()
            assert n_reduce == L, (tag, r)
            assert n_gather == (L if tag.endswith("/gather") else 0), (tag, r)


def check_pod_step(got, loss, grad_norm, want):
    """A ``dp_compress_bits`` step's whole state ``got`` ({path: numpy},
    rank 0's), loss and gradient norm against the reference's ``want``
    ((sj0, key, sj1, metrics, modes, pods): ``_ref_step`` at one pod,
    ``_ref_pod_step`` at more).  Each rank's gradient is within
    tests/test_torch_train.py's bounds of the reference's for the same
    rows, so its int8 code may sit one step (its slice's scale) away where
    a rounding boundary lies inside that bound; the mean over the ranks
    carries the mean of their bounds."""
    sj0, key, sj1, mj, modes, pods = want
    want, prev = ttrain._flat_np(sj1), ttrain._flat_np(sj0)
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(loss, float(mj["loss"]), rtol=TOL_LOSS_REL)
    oc, lr = _step_tc()[1].optim, float(mj["lr"])
    # no UNIQ transform: the weights the loss sees are the parameters
    prev_params = {p[len("params/"):]: v for p, v in prev.items()
                   if p.startswith("params/")}
    names = [p[len("params/"):] for p in want if p.startswith("params/")]
    # SGD from zero momentum: m1 = clip * g_coded + wd * p0
    gj = {n: want[f"opt/mu/{n}/m"] - oc.weight_decay * prev["params/" + n]
          for n in names}
    gt = {n: got[f"opt/mu/{n}/m"] - oc.weight_decay * prev["params/" + n]
          for n in names}
    norm = float(mj["grad_norm"])
    clip = min(1.0, oc.grad_clip / norm) if oc.grad_clip > 0 else 1.0
    if pods is None:
        # one rank: its gradient is the applied one, read back unclipped
        pods = [{n: gj[n] / clip for n in names}]
    tol_c = {n: 0.0 for n in names}
    for g_rank in pods:
        tol_g = ttrain._grad_tol(sj0["params"], key, modes,
                                 {n: g_rank[n] for n in names},
                                 w_hat=prev_params)
        for n in names:
            g = g_rank[n]
            t = np.broadcast_to(tol_g[n], g.shape)
            if g.ndim >= 2 and g.size > 128:
                # the slice's scale moves with its largest element, and a
                # code may land one step away
                axes = tuple(range(1, g.ndim))
                t = t + t.max(axis=axes, keepdims=True) \
                    + np.abs(g).max(axis=axes, keepdims=True) / 127.0
            tol_c[n] = tol_c[n] + t / len(pods)
    tol_norm = float(np.sqrt(sum(np.sum(np.square(t))
                                 for t in tol_c.values())))
    assert abs(grad_norm - norm) <= tol_norm + 1e-6 * norm
    for n in names:
        # clipping scales by clip / norm, so the norm's error reaches every
        # element of the clipped gradient as well
        tgc = clip * tol_c[n] + (np.abs(gj[n]) * tol_norm / norm
                                 if clip < 1.0 else 0.0)
        np.testing.assert_array_less(
            np.abs(gt[n] - gj[n]), tgc + 2 * np.spacing(np.abs(gj[n]))
            + 1e-30, err_msg=n)
        p_prev = prev["params/" + n]
        ulp = 2 * np.spacing(np.abs(p_prev).astype(np.float32))
        np.testing.assert_array_less(
            np.abs(got["params/" + n] - want["params/" + n]),
            lr * tgc + ulp, err_msg=n)


@pytest.mark.parametrize("n", [1, 2], ids=lambda n: f"world{n}")
def test_dp_compress_step(n, worlds):
    """The step (SGD, the UNIQ transform off: ``_step_tc``) on every rank
    bit-identical, rank 0's loss, gradient norm, applied gradient and
    parameters against the reference's: at world 1 its ``make_train_step``
    on a one-device pod mesh, at world 2 ``_ref_pod_step``
    (``check_pod_step``)."""
    world = worlds[n]
    if isinstance(world, str):
        pytest.fail(world)
    params = [k for k in world.out[0] if k.startswith("step/state/")]
    assert params
    for k in params + ["step/loss", "step/grad_norm"]:
        _same_on_every_rank(world, k)
    got = {k[len("step/state/"):]: v for k, v in world.out[0].items()
           if k.startswith("step/state/")}
    check_pod_step(got, float(world.out[0]["step/loss"]),
                   float(world.out[0]["step/grad_norm"]), world.want["step"])


def test_shard_batch_and_restore_give_each_rank_its_block(world):
    for tag, wants in world.want["blocks"].items():
        for r, want in enumerate(wants):
            got = {k[len(f"blocks/{tag}/"):]: v
                   for k, v in world.out[r].items()
                   if k.startswith(f"blocks/{tag}/")
                   and not k.endswith("/step")}
            assert sorted(got) == sorted(want), (tag, r)
            for k, v in want.items():
                np.testing.assert_array_equal(
                    got[k], np.asarray(v).astype(got[k].dtype),
                    err_msg=f"{tag} rank {r}: {k}")
            assert int(world.out[r][f"blocks/{tag}/step"]) == 7


def test_dense_models_run_on_a_mesh_and_the_others_raise(world):
    """granite on a mesh runs on its placed parameters: its loss within
    TOL_F32 of the reference's, on every rank.  A state-space or audio
    model on a mesh of more than one rank raises NotImplementedError naming
    it (their tensor / FSDP parallelism is not ported); a one-rank mesh
    runs."""
    archs = [a for a in RAISE_ARCHS if f"raises/{a}" in world.out[0]]
    assert len(archs) == (3 if world.want["raises"] else 2)
    for arch in archs:
        msg = world.out[0][f"raises/{arch}"].tobytes().decode()
        if arch == "granite_3_8b" or not world.want["raises"]:
            assert msg == "", (arch, msg)
        else:
            assert tcb.get_smoke(arch).name in msg and "not ported" in msg
    _same_on_every_rank(world, "raises/granite_3_8b/loss")
    got = float(world.out[0]["raises/granite_3_8b/loss"])
    assert abs(got - world.want["dense_loss"]) <= TOL_F32
