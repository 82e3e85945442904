"""PyTorch port vs JAX reference: tensor and FSDP parallelism of the dense
and vlm decoders (``parallel/tensor_parallel.py``) on gloo worlds of 2 and
4 ranks on the CPU.

Each world is spawned once for this module, every rank forked from a
forkserver that preloads ``tests/torch_dist_worker.py`` (torch and the port
alone); this process computes the reference's single-device side on the
same numpy inputs meanwhile (remat off) and compares:

* the f32 loss and its gradients, gathered whole, of granite_3_8b on
  (1, 2), (2, 1), (2, 2), (1, 4), the fsdp-only layout (``tp=False``) and
  pure data parallelism (``fsdp=False``) at (2, 2), gemma2_9b (tied head,
  windows, caps) and pixtral_12b (patch embeddings) at (2, 2): within
  ``TOL_F32``;
* one AdamW + UNIQ train step on placed state at (1, 2) and (2, 2) with
  the reference's noise (each leaf's whole draw, cut to the block) within
  tests/test_torch_train.py's step bounds, and one ``dp_compress_bits=8``
  step on a (2, 1, 2) pod x data x model mesh within
  tests/test_torch_distributed.py's pod-step bounds; every rank's state
  bit-identical;
* the placed leaf statistics within 1e-6 of the whole leaf's, a control
  fitted on the rank's own block farther off;
* W4 prefill logits within 2e-4 at kv16, kv8 and ``serve_a_bits=8`` and
  greedy ``generate`` tokens equal (granite on (1, 2), (1, 4), (2, 2);
  gemma2 and pixtral, with patch embeddings, on (2, 2)), every coded
  matmul handed the rank's block of the codes, the cache the rank's rows
  and KV heads;
* a placed save (whole leaves on disk) and ``restore(shardings=)`` round
  trip, bit-equal.

Granite's smoke has 4 heads, 2 KV heads of 16: a model axis of 4 cuts wk
inside a head, so the ranks gather K / V and take the KV head of their
query head.
"""

import concurrent.futures
import dataclasses
import functools
import json
import multiprocessing
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.core import uniq as juniq
from repro.models import model as jmodel
from repro.models.lm import ModelOpts as JOpts
from repro.serve import serve as jserve
from repro.train import steps as jsteps

from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import base as tcb
from repro_torch.models import model as tmodel
from repro_torch.parallel import sharding as tshd
from repro_torch.parallel import tensor_parallel as tpar

import test_torch_distributed as tdist
import test_torch_train as ttrain
import torch_dist_worker

WORLDS = (2, 4)
# the f32 loss (tests/test_torch_distributed.py): the same function, its
# sums split over the ranks; gradients relative to the leaf's largest
TOL_F32 = tdist.TOL_F32
# W4 prefill logits of O(1) through two f32 layers (tests/
# test_torch_serve_modes.py's kv16 bound)
TOL_LOGITS = 2e-4
# a placed statistic against the whole leaf's: the same sums, in another
# order (f32)
TOL_STATS_REL = 1e-6
GRANITE = "granite_3_8b"
# batch of the loss cases: 4 rows (split over every data-parallel layout),
# 8 positions, the last 3 targets of rows 2-3 ignored
B, S = 4, 8
# the prompts of generate: 4 rows of 4 tokens, 4 new
GEN_S0, GEN_NEW = 4, 4
SERVE_MODES = {"kv16": (16, 32), "kv8": (8, 32), "a8": (16, 8)}
AXES2 = ("data", "model")

# (arch, mesh, tp, fsdp) of each world's loss cases
LOSS_CASES = {
    2: [(GRANITE, (1, 2), True, True), (GRANITE, (2, 1), True, True)],
    4: [(GRANITE, (2, 2), True, True), (GRANITE, (1, 4), True, True),
        (GRANITE, (2, 2), False, True), (GRANITE, (2, 2), True, False),
        ("gemma2_9b", (2, 2), True, True),
        ("pixtral_12b", (2, 2), True, True)],
}
# (arch, mesh, modes) of the serving cases
SERVE_CASES = {
    2: [(GRANITE, (1, 2), ("kv16", "kv8", "a8"))],
    4: [(GRANITE, (1, 4), ("kv16", "kv8", "a8")),
        (GRANITE, (2, 2), ("kv16", "kv8", "a8")),
        ("gemma2_9b", (2, 2), ("kv16",)), ("pixtral_12b", (2, 2), ("kv16",))],
}
# (mesh, axes, compress) of the train-step cases
STEP_CASES = {2: [((1, 2), AXES2, False)],
              4: [((2, 2), AXES2, False),
                  ((2, 1, 2), ("pod", "data", "model"), True)]}
STATS_MESHES = {2: [(1, 2)], 4: [(2, 2)]}
CKPT_MESHES = {2: [(1, 2)], 4: [(2, 2)]}


def _tag(arch, mesh, tp=True, fsdp=True):
    return f"{arch}/{'x'.join(map(str, mesh))}" + ("" if tp else "-notp") \
        + ("" if fsdp else "-nofsdp")


def _ids(cases):
    return [_tag(*c[:2], *c[2:4]) if len(c) == 4 else _tag(*c[:2])
            for c in cases]


ALL_LOSS = [(n, c) for n in WORLDS for c in LOSS_CASES[n]]
ALL_SERVE = [(n, c) for n in WORLDS for c in SERVE_CASES[n]]
ALL_STEP = [(n, c) for n in WORLDS for c in STEP_CASES[n]]


# --------------------------------------------------------------------------
# The reference's side
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _port_params(arch, w_bits=16):
    """The port's smoke parameters (the ranks draw the same from seed 0),
    as {path: numpy} and as the reference's tree."""
    flat = tdist._np(tmodel.init(0, tcb.get_smoke(arch), device="cpu",
                                 w_bits=w_bits))
    return flat, jax.tree.map(jnp.asarray, tdist._nest(flat))


def _loss_batch(arch):
    cfg = tcb.get_smoke(arch)
    rng = np.random.default_rng(11)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "targets": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    b["targets"][2:, -3:] = -1
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return b


def _serve_batch(arch):
    b = _loss_batch(arch)
    del b["targets"]
    return b


def _prompt(arch):
    return np.random.default_rng(12).integers(
        0, tcb.get_smoke(arch).vocab, (B, GEN_S0)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _ref_loss_grads(arch):
    """The reference's f32 loss and gradients {path: numpy}."""
    cfg = jcb.get_smoke(arch)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, cfg, ttrain._jopts(), b)))
    loss, g = fn(_port_params(arch)[1],
                 jax.tree.map(jnp.asarray, _loss_batch(arch)))
    return float(loss), ttrain._flat_np(g)


def _jopts(mode):
    kv, a = SERVE_MODES[mode]
    return JOpts(compute_dtype=jnp.float32, remat=False,
                 attn_chunked_min_len=1 << 30, kv_bits=kv, serve_a_bits=a)


@functools.lru_cache(maxsize=None)
def _ref_serve(arch, mode):
    """(W4 prefill logits, greedy tokens of ``generate``) of the
    reference on the port's W4 codes."""
    cfg = jcb.get_smoke(arch)
    pj = _port_params(arch, 4)[1]
    logits = jax.jit(lambda p, b: jmodel.prefill(p, cfg, _jopts(mode),
                                                 b)[0])(
        pj, jax.tree.map(jnp.asarray, _serve_batch(arch)))
    toks = None
    if mode != "kv8":
        toks = np.asarray(jserve.generate(
            pj, cfg, _jopts(mode), jserve.ServeConfig(),
            jnp.asarray(_prompt(arch)), GEN_NEW))
    return np.asarray(logits), toks


@functools.lru_cache(maxsize=None)
def _step_inputs():
    """The AdamW + UNIQ step's initial state, batch and key (as
    tests/test_torch_train.py's step test), and each quantized leaf's
    whole draw of the reference's noise under the key."""
    jt, _ = ttrain._tc("adamw")
    cfg = jcb.get_smoke(GRANITE)
    sj0 = jsteps.init_state(jax.random.PRNGKey(0), cfg, jt)
    batch = ttrain._tokens(tcb.get_smoke(GRANITE), seed=1)
    key = jax.random.PRNGKey(42)
    noise = {}
    for p, v in ttrain._flat_np(sj0["params"]).items():
        if juniq.default_quant_filter(p, v):
            noise[p] = np.asarray(ttrain._uniform(juniq._fold_path(key, p),
                                                  tuple(v.shape)))
    return sj0, batch, key, noise


def _ref_adamw_step():
    sj0, batch, key, _ = _step_inputs()
    sj1, mj = ttrain._jax_step("adamw")(
        sj0, jax.tree.map(jnp.asarray, batch), key)
    modes = jsteps.make_schedule(jcb.get_smoke(GRANITE),
                                 ttrain._tc("adamw")[0]).modes_at(0)
    return sj1, mj, np.asarray(modes)


def _ref_pod():
    sj0, sbatch, key = tdist._step_inputs()
    sj1, mj, pods = tdist._ref_pod_step(sj0, sbatch, 2)
    modes = jsteps.make_schedule(jcb.get_smoke(GRANITE),
                                 tdist._step_tc()[0]).modes_at(0)
    return (sj0, key, sj1, mj, np.asarray(modes), pods)


@functools.lru_cache(maxsize=None)
def _ref_stats():
    """Each quantized leaf's whole statistics, the reference's fit."""
    flat, _ = _port_params(GRANITE)
    cfg = juniq.UniqConfig(w_bits=4)
    out = {}
    for p, v in flat.items():
        if juniq.default_quant_filter(p, v):
            m = juniq._fit_dist(jnp.asarray(v), cfg, p.startswith("layers/"))
            out[p] = (np.asarray(m.mu), np.asarray(m.sigma))
    return out


# --------------------------------------------------------------------------
# The worlds
# --------------------------------------------------------------------------

def _inputs(n, where):
    cases, arrays = [], {}
    for arch in {c[0] for c in LOSS_CASES[n]}:
        arrays.update({f"tp/{arch}/batch/{k}": v
                       for k, v in _loss_batch(arch).items()})
    for arch, mesh, tp, fsdp in LOSS_CASES[n]:
        cases.append({"kind": "tp_loss", "arch": arch, "mesh": mesh,
                      "axes": AXES2, "tp": tp, "fsdp": fsdp,
                      "tag": _tag(arch, mesh, tp, fsdp)})
    for arch, mesh, modes in SERVE_CASES[n]:
        arrays.update({f"serve/{arch}/batch/{k}": v
                       for k, v in _serve_batch(arch).items()})
        arrays[f"serve/{arch}/prompt"] = _prompt(arch)
        cases.append({"kind": "tp_serve", "arch": arch, "mesh": mesh,
                      "axes": AXES2, "tp": True, "fsdp": True,
                      "modes": list(modes), "n_new": GEN_NEW,
                      "tag": _tag(arch, mesh)})
        if arch == GRANITE:
            cases.append({"kind": "tp_paged", "arch": arch, "mesh": mesh,
                          "axes": AXES2, "tp": True, "fsdp": True,
                          "tag": _tag(arch, mesh)})
    for mesh, axes, compress in STEP_CASES[n]:
        prefix = "tpstep_in/" + ("pod" if compress else "adamw")
        if compress:
            sj0, sbatch, _ = tdist._step_inputs()
        else:
            sj0, sbatch, _, noise = _step_inputs()
            arrays.update({f"{prefix}/noise/{p}": v
                           for p, v in noise.items()})
        arrays.update({f"{prefix}/state/{p}": v
                       for p, v in ttrain._flat_np(sj0).items()})
        arrays.update({f"{prefix}/batch/{k}": v for k, v in sbatch.items()})
        cases.append({"kind": "tp_step", "mesh": mesh, "axes": axes,
                      "tp": True, "fsdp": True, "compress": compress,
                      "prefix": prefix, "tag": _tag(GRANITE, mesh)})
    for mesh in STATS_MESHES[n]:
        cases.append({"kind": "tp_stats", "mesh": mesh, "axes": AXES2,
                      "tp": True, "fsdp": True, "tag": _tag(GRANITE, mesh)})
    for mesh in CKPT_MESHES[n]:
        cases.append({"kind": "tp_ckpt", "arch": GRANITE, "mesh": mesh,
                      "axes": AXES2, "tp": True, "fsdp": True,
                      "ckpt": os.path.join(where, "ckpt"),
                      "tag": _tag(GRANITE, mesh)})
    return cases, arrays


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Starts both worlds' ranks at once, computes the reference's side
    while they run (the two train steps compiling in threads), then
    collects every rank's results: {n: [each rank's {key: numpy}], or the
    failure's log}."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["torch_dist_worker"])
    running = {}
    want = {}
    try:
        for n in WORLDS:
            where = str(tmp_path_factory.mktemp(f"tpworld{n}"))
            cases, arrays = _inputs(n, where)
            with open(os.path.join(where, "cases.json"), "w") as f:
                json.dump(cases, f)
            np.savez(os.path.join(where, "in.npz"), **arrays)
            procs = [ctx.Process(target=torch_dist_worker.run,
                                 args=(r, n, where)) for r in range(n)]
            for p in procs:
                p.start()
            running[n] = (where, procs)
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            adamw = pool.submit(_ref_adamw_step)
            pod = pool.submit(_ref_pod)
            for arch in {c[1][0] for c in ALL_LOSS}:
                _ref_loss_grads(arch)
            for _, (arch, _, modes) in ALL_SERVE:
                for mode in modes:
                    _ref_serve(arch, mode)
            _ref_stats()
            want["adamw"] = adamw.result()
            want["pod"] = pod.result()
        for where, procs in running.values():
            for p in procs:
                p.join(timeout=300)
    finally:
        for _, procs in running.values():
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    out = {"want": want, "where": {n: w for n, (w, _) in running.items()}}
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
        out[n] = res
    return out


def _world(worlds, n):
    w = worlds[n]
    if isinstance(w, str):
        pytest.fail(w)
    return w


def _same_on_every_rank(out, key):
    for r in range(1, len(out)):
        np.testing.assert_array_equal(out[r][key], out[0][key],
                                      err_msg=f"{key}: rank {r} vs rank 0")


# --------------------------------------------------------------------------
# The tests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,case", ALL_LOSS,
                         ids=[_tag(*c) for _, c in ALL_LOSS])
def test_loss_and_gradients_match_the_reference(n, case, worlds):
    """The placed model's f32 loss, equal on every rank, within TOL_F32 of
    the reference's single-device loss; every gradient, gathered whole,
    within TOL_F32 of its leaf's largest; every placed block contiguous;
    the FSDP gathers' gradients reduce-scattered (neither without FSDP:
    granite's smoke splits its heads whole over a model axis of 2)."""
    out = _world(worlds, n)
    arch, mesh, tp, fsdp = case
    tag = _tag(*case)
    _same_on_every_rank(out, f"tp/{tag}/loss")
    want_loss, want_g = _ref_loss_grads(arch)
    assert abs(float(out[0][f"tp/{tag}/loss"]) - want_loss) <= TOL_F32
    got = {k[len(f"tp/{tag}/grad/"):]: v for k, v in out[0].items()
           if k.startswith(f"tp/{tag}/grad/")}
    assert sorted(got) == sorted(want_g)
    for p, g in want_g.items():
        assert got[p].shape == g.shape, p
        np.testing.assert_array_less(np.abs(got[p] - g),
                                     TOL_F32 * np.abs(g).max() + 1e-30,
                                     err_msg=f"{tag}: {p}")
    for r in range(n):
        assert bool(out[r][f"tp/{tag}/contiguous"])
        n_reduce, n_gather, n_scatter = out[r][f"tp/{tag}/collectives"]
        assert n_reduce > 0, (tag, r)
        assert (n_gather > 0) == (n_scatter > 0) == fsdp, (tag, r)


@pytest.mark.parametrize("n,case", ALL_STEP,
                         ids=[_tag(GRANITE, c[0]) for _, c in ALL_STEP])
def test_train_step_on_placed_state_matches_the_reference(n, case, worlds):
    """One step on the placed state, gathered whole: every rank
    bit-identical.  AdamW + UNIQ (the reference's noise, each leaf's whole
    draw cut to the rank's block): loss, norm, moments and parameters
    within tests/test_torch_train.py's step bounds.  The compressed pod
    sync on (2, 1, 2): within tests/test_torch_distributed.py's pod-step
    bounds of the reference's step over two pods."""
    out = _world(worlds, n)
    mesh, _, compress = case
    tag = _tag(GRANITE, mesh)
    pre = f"tpstep/{tag}/state/"
    keys = [k for k in out[0] if k.startswith(pre)]
    assert keys
    for k in keys + [f"tpstep/{tag}/loss", f"tpstep/{tag}/grad_norm"]:
        _same_on_every_rank(out, k)
    got = {k[len(pre):]: v for k, v in out[0].items() if k.startswith(pre)}
    loss = float(out[0][f"tpstep/{tag}/loss"])
    norm = float(out[0][f"tpstep/{tag}/grad_norm"])
    if compress:
        tdist.check_pod_step(got, loss, norm, worlds["want"]["pod"])
        return
    sj0, _, key, _ = _step_inputs()
    sj1, mj, modes = worlds["want"]["adamw"]
    np.testing.assert_allclose(loss, float(mj["loss"]),
                               rtol=ttrain.TOL_LOSS_REL)
    metrics = {"loss": loss, "grad_norm": norm,
               "lr": float(out[0][f"tpstep/{tag}/lr"])}
    ttrain._compare_step(tdist._nest(got), metrics, sj0, sj1, mj, key,
                         modes, "adamw", ttrain._tc("adamw")[1])


@pytest.mark.parametrize("n", WORLDS, ids=lambda n: f"world{n}")
def test_placed_statistics_are_the_whole_leaves(n, worlds):
    """``fit_placed`` on each rank's block gives the whole leaf's mean and
    deviation within TOL_STATS_REL (the reference's fit of the whole
    leaf); the block's own statistics, the control, miss by more."""
    out = _world(worlds, n)
    want = _ref_stats()
    for mesh in STATS_MESHES[n]:
        tag = _tag(GRANITE, mesh)
        for p, (mu, sigma) in want.items():
            for r in range(n):
                for name, w in (("mu", mu), ("sigma", sigma)):
                    got = out[r][f"stats/{tag}/placed/{p}/{name}"]
                    own = out[r][f"stats/{tag}/own/{p}/{name}"]
                    scale = np.abs(sigma).max()
                    err = np.abs(got - np.broadcast_to(w, got.shape)).max()
                    miss = np.abs(own.reshape(got.shape)
                                  - np.broadcast_to(w, got.shape)).max()
                    assert err <= TOL_STATS_REL * scale, (p, name, r, err)
                    assert miss > TOL_STATS_REL * scale, (p, name, r, miss)


def _code_blocks(arch, mesh):
    """The (K, N) of the codes each coded matmul of a prefill is handed on
    ``mesh``: the rank's "model" block of each projection (its FSDP dim
    gathered whole), then the head's, in call order."""
    cfg = tcb.get_smoke(arch)
    flat, _ = _port_params(arch, 4)
    specs = {p: s.spec for p, s in tree_lib_leaves(tshd.param_shardings(
        tdist._nest({p: torch.empty(v.shape, device="meta")
                     for p, v in flat.items()}), cfg,
        tshd.MeshShape.of(data=mesh[0], model=mesh[1])))}
    M = mesh[1]

    def block(path, split_dim):
        shape = list(flat[f"{path}/q_codes"].shape[-2:])
        spec = specs[f"{path}/q_codes"][-2:]
        if spec[split_dim] == "model":
            shape[split_dim] //= M
        return tuple(shape)
    layer = [block(f"layers/{k}", 1) for k in ("wq", "wk", "wv")] \
        + [block("layers/wo", 0)] \
        + [block(f"layers/{k}", 1) for k in ("w_gate", "w_up")] \
        + [block("layers/w_down", 0)]
    head = [] if cfg.tie_embeddings else [block("lm_head", 1)]
    return layer * cfg.n_layers + head


def tree_lib_leaves(tree):
    from repro_torch import tree as tree_lib
    return tree_lib.leaves_with_paths(tree)


@pytest.mark.parametrize("n,case", ALL_SERVE,
                         ids=[_tag(*c[:2]) for _, c in ALL_SERVE])
def test_prefill_and_generate_match_the_reference(n, case, worlds):
    """W4 prefill logits (whole, on every rank) within TOL_LOGITS of the
    reference's at each serving mode, greedy ``generate`` tokens equal and
    equal on every rank; each coded matmul took the rank's block of the
    codes; the cache holds the rank's rows and the KV heads it attends."""
    out = _world(worlds, n)
    arch, mesh, modes = case
    tag = _tag(arch, mesh)
    cfg = tcb.get_smoke(arch)
    M = mesh[1]
    rows = B // mesh[0]
    kv_heads = max(cfg.n_kv_heads // M, 1)
    seq = S + (cfg.n_patches if cfg.family == "vlm" else 0)
    for mode in modes:
        key = f"serve/{tag}/{mode}"
        want_l, want_t = _ref_serve(arch, mode)
        _same_on_every_rank(out, f"{key}/logits")
        np.testing.assert_allclose(out[0][f"{key}/logits"], want_l,
                                   atol=TOL_LOGITS, err_msg=key)
        if want_t is not None:
            _same_on_every_rank(out, f"{key}/tokens")
            np.testing.assert_array_equal(out[0][f"{key}/tokens"], want_t,
                                          err_msg=key)
        for r in range(n):
            assert [tuple(s) for s in out[r][f"{key}/codes"]] \
                == _code_blocks(arch, mesh), (key, r)
            assert tuple(out[r][f"{key}/cache"]) == (
                cfg.n_layers, rows, seq, kv_heads, cfg.head_dim), (key, r)


ALL_PAGED = [(n, c) for n, c in ALL_SERVE if c[0] == GRANITE]


@pytest.mark.parametrize("n,case", ALL_PAGED,
                         ids=[_tag(*c[:2]) for _, c in ALL_PAGED])
def test_paged_prefill_chunk_and_decode_on_a_mesh(n, case, worlds):
    """``prefill_chunk`` into a paged pool of the rank's KV heads and a
    paged decode step (kv16 and kv8), placed, within TOL_LOGITS of the
    same calls unplaced (which tests/test_torch_serve_modes.py holds to
    the reference), on every rank."""
    out = _world(worlds, n)
    tag = _tag(*case[:2])
    for kv in (16, 8):
        for r in range(n):
            err = out[r][f"paged/{tag}/kv{kv}/err"]
            assert err.shape == (2,) and (err <= TOL_LOGITS).all(), \
                (tag, kv, r, err)


@pytest.mark.parametrize("n", WORLDS, ids=lambda n: f"world{n}")
def test_placed_checkpoint_round_trip(n, worlds):
    """``save(shardings=)`` of a placed W4 tree writes the whole leaves
    (read back here whole, bit-equal to the port's parameters), and
    ``restore(shardings=)`` gives each rank its blocks bit-equal."""
    out = _world(worlds, n)
    for mesh in CKPT_MESHES[n]:
        tag = _tag(GRANITE, mesh)
        for r in range(n):
            assert bool(out[r][f"ckpt/{tag}/equal"]), (tag, r)
    params = tmodel.init(0, tcb.get_smoke(GRANITE), device="cpu", w_bits=4)
    got, step, _ = tckpt.restore(os.path.join(worlds["where"][n], "ckpt"),
                                 params)
    assert step == 3
    for (p, a), (_, b) in zip(tree_lib_leaves(got), tree_lib_leaves(params)):
        assert torch.equal(a, b), p


def test_a_strided_weight_block_raises():
    """A weight block handed on to a kernel must be contiguous: a column
    block cut as a view raises (``place_tree`` copies such a block)."""
    w = torch.zeros(8, 8)[:, :4]
    with pytest.raises(ValueError, match="not contiguous"):
        tpar._weight(w, tshd.P(None, None), tshd.P(None, None), None)
    whole = torch.arange(64.0).reshape(8, 8)
    blk = tshd.place_tree({"w": whole}, {"w": tshd.Sharding(
        _FakeMesh(2, rank=1), tshd.P(None, "model"))})["w"]
    assert blk.is_contiguous() and torch.equal(blk, whole[:, 4:])


def test_head_plan_gathers_where_a_block_cuts_a_head():
    """At a model axis of 4, granite's smoke (4 heads, 2 KV heads of 16)
    gives each rank its query head and the KV head of its group, gathered
    (wk's column block of 8 is half a head); at 2, both are the rank's own
    blocks."""
    cfg = tcb.get_smoke(GRANITE)
    flat, _ = _port_params(GRANITE)
    whole = tdist._nest({p: torch.empty(v.shape, device="meta")
                         for p, v in flat.items()})
    for M, want in ((2, [(0, 2, 0, 1, True, True), (2, 2, 1, 1, True, True)]),
                    (4, [(r, 1, r // 2, 1, True, False) for r in range(4)])):
        mesh = _FakeMesh(M)
        pl = tshd.Placement.of(tshd.param_shardings(
            whole, cfg, tshd.MeshShape.of(data=1, model=M)))
        got = []
        for r in range(M):
            mesh.rank = r
            opts = tmodel.ModelOpts(mesh=mesh, placement=dataclasses.replace(
                pl, mesh=mesh))
            h = tpar.head_plan(cfg, opts)
            got.append((h.q_lo, h.q_n, h.kv_lo, h.kv_n, h.q_local,
                        h.kv_local))
        assert got == want, M


@dataclasses.dataclass
class _FakeMesh:
    """A (1, M) ("data", "model") mesh seen from rank ``rank``: what the
    head rule reads (names, shape, this rank's coordinate)."""
    M: int
    rank: int = 0

    @property
    def mesh_dim_names(self):
        return AXES2

    @property
    def shape(self):
        return (1, self.M)

    def get_coordinate(self):
        return [0, self.rank]
