"""PyTorch port vs JAX reference: the UNIQ transform applied per layer
inside the layer loop (``TrainConfig(uniq_in_scan=True)``).

At the ``*_smoke`` sizes in f32 on the CPU, for granite_3_8b (dense),
kimi_k2_1t_a32b (moe) and pixtral_12b (vlm):

* one train step against the reference's
  ``make_train_step(TrainConfig(uniq_in_scan=True))``, the reference's
  own noise handed in: the embedding's and the head's per leaf, each
  layer's per (weight, layer), ``uniform(fold_in(_fold_path(rng, key),
  layer))`` as its ``_uniq_layer`` draws it;
* the port's in-scan loss and gradients against its whole-tree transform
  fed the same noise (each stacked leaf's draw the stack of its layers'),
  bit for bit;
* the per-layer draws: one layer slice's shape each, once per step
  without remat and again in the recompute with it, with the same
  gradients either way;
* the families outside the decoder (ssm here) take the whole-tree path, as
  the reference's ``in_scan`` condition decides.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.core import uniq as juniq
from repro.models import model as jmodel
from repro.optim import optim as joptim
from repro.train import steps as jsteps

from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.configs import base as tcb
from repro_torch.core import uniq as tuniq
from repro_torch.optim import optim as toptim
from repro_torch.train import steps as tsteps

from test_torch_train import (_compare_step, _flat_np, _jopts, _np_tree,
                              _ref_noise, _topts, _uniform)
from test_torch_train_families import (TOL_FAMILY_STEP_GRAD_REL,
                                       TOL_FAMILY_STEP_LOSS_REL, _batch)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread for this module, restored after it: at
    these sizes more threads only add their OpenMP spin-waits, which take
    the cores of the suite's other parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ("granite_3_8b", "kimi_k2_1t_a32b", "pixtral_12b")
FROZEN, NOISE = 2, 1
# 8 steps over 2 layers, two iterations: step 2 is stage 1, layer 0 (and
# the embedding) FROZEN, layer 1 (and the head) NOISE
TOTAL, STEP = 8, 2
MODES = [FROZEN, NOISE]
QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "eg",
              "eu", "ed")


def _tc(in_scan=True, kind="sgd"):
    common = dict(total_steps=TOTAL, n_blocks=0, uniq_in_scan=in_scan)
    jt = jsteps.TrainConfig(uniq=juniq.UniqConfig(w_bits=4),
                            optim=joptim.OptimConfig(kind=kind, lr=1e-3),
                            **common)
    tt = tsteps.TrainConfig(uniq=tuniq.UniqConfig(w_bits=4),
                            optim=toptim.OptimConfig(kind=kind, lr=1e-3),
                            **common)
    return jt, tt


def _ref_scan_noise(key, draws=None):
    """The reference's per-(weight, layer) noise inside the layer loop:
    ``_uniq_layer`` draws ``uniform_noise(fold_in(_fold_path(rng, key),
    layer))``, ``(e01 - 1/2) / k`` of these e01 bits."""
    def noise(name, layer, leaf):
        e = np.asarray(_uniform(
            jax.random.fold_in(juniq._fold_path(key, name), layer),
            tuple(leaf.shape)))
        if draws is not None:
            draws.append((name, layer, tuple(leaf.shape)))
        return torch.from_numpy(e).to(leaf.device)
    return noise


@functools.partial(jax.jit, static_argnums=2)
def _ref_w_hat_tree(params_j, key, modes):
    ucfg = juniq.UniqConfig(w_bits=4)
    out = juniq.transform_tree(
        params_j, key, juniq.lm_mode_fn(jnp.asarray(modes, jnp.int32)), ucfg,
        quant_filter=lambda p, l: (juniq.default_quant_filter(p, l)
                                   and not p.startswith("layers")))
    layers = dict(out["layers"])
    for name in QUANT_KEYS:
        if name in layers:
            w = params_j["layers"][name]
            layers[name] = jnp.stack([juniq.transform_param(
                w[l], jax.random.fold_in(juniq._fold_path(key, name), l),
                jnp.int32(modes[l]), ucfg, stacked=False)
                for l in range(w.shape[0])])
    return dict(out, layers=layers)


def _ref_w_hat(params_j, key, modes):
    """The reference's transformed weights of an in-scan step: the
    embedding and head at the tree level, each layer's weights by its
    ``_uniq_layer`` (one jitted function)."""
    return _flat_np(_ref_w_hat_tree(params_j, key,
                                    tuple(int(m) for m in modes)))


@functools.lru_cache(maxsize=None)
def _jax_step(arch):
    fn, _ = jsteps.make_train_step(jcb.get_smoke(arch), _jopts(), _tc()[0])
    return jax.jit(fn)


def _jb(batch):
    return jax.tree_util.tree_map(jnp.asarray, batch)


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_in_scan_step_matches_reference(arch):
    """Step 2 of 8 (layer 0 FROZEN, layer 1 NOISE), the port's remat on:
    loss, gradients and the SGD update within ``_compare_step``'s
    tolerances, derived from the reference's own in-scan weights.  The
    bounds are test_torch_train_families' (a FROZEN code on a bin edge, a
    NOISE weight clamped at the tails)."""
    cfg_j, cfg_t = jcb.get_smoke(arch), tcb.get_smoke(arch)
    jt, tt = _tc()
    sj0 = jsteps.init_state(jax.random.PRNGKey(2), cfg_j, jt)
    sj0["step"] = jnp.int32(STEP)
    batch = _batch(cfg_t, seed=4)
    key = jax.random.PRNGKey(9)
    sj1, mj = _jax_step(arch)(sj0, _jb(batch), key)
    step_t, sched = tsteps.make_train_step(cfg_t, _topts(remat=True), tt)
    modes = sched.modes_at(STEP)
    assert modes.tolist() == MODES
    st = convert.train_state_from_numpy(_np_tree(sj0), device="cpu")
    tree_draws, layer_draws = [], []
    st, mt = step_t(st, _tb(batch), seed=0,
                    noise=_ref_noise(key, tree_draws),
                    scan_noise=_ref_scan_noise(key, layer_draws))
    head = [] if cfg_t.tie_embeddings else ["lm_head"]
    assert sorted(tree_draws) == sorted(["embed"] + head)
    names = [n for n in QUANT_KEYS if n in sj0["params"]["layers"]]
    assert {(n, l) for n, l, _ in layer_draws} == {
        (n, l) for n in names for l in range(cfg_t.n_layers)}
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=TOL_FAMILY_STEP_LOSS_REL)
    _compare_step(st, mt, sj0, sj1, mj, key, modes, "sgd", tt,
                  grad_rel=TOL_FAMILY_STEP_GRAD_REL,
                  w_hat=_ref_w_hat(sj0["params"], key, np.asarray(modes)))


def _whole_tree_noise(key):
    """The whole-tree noise that equals the in-scan draws: a stacked
    leaf's draw is the stack of its layers' (weight, layer) draws, the
    embedding's and head's the reference's per-leaf draw."""
    tree = _ref_noise(key)
    scan = _ref_scan_noise(key)

    def noise(path, leaf):
        if path.startswith("layers/"):
            name = path.split("/", 1)[1]
            return torch.stack([scan(name, l, leaf[l])
                                for l in range(leaf.shape[0])])
        return tree(path, leaf)
    return noise


@pytest.mark.parametrize("arch", ARCHS)
def test_in_scan_matches_the_whole_tree_transform(arch):
    """The same noise through both of the port's paths gives the same loss
    and gradients, bit for bit: a layer's statistics are the same values
    (the in-scan path takes its layer's slice of the stack's, fitted as the
    whole tree fits them: ``fit_layers``), so are the transformed weights,
    and every operation after them is the same."""
    cfg = tcb.get_smoke(arch)
    pj = jmodel.init(jax.random.PRNGKey(3), jcb.get_smoke(arch))
    pt = convert.params_from_numpy(_np_tree(pj), device="cpu")
    batch = _tb(_batch(cfg, seed=5))
    modes = torch.tensor(MODES, dtype=torch.int32)
    key = jax.random.PRNGKey(11)
    got = {}
    for in_scan in (True, False):
        loss, g = tsteps.loss_and_grads(
            pt, batch, modes, _whole_tree_noise(key), cfg,
            _topts(remat=True), _tc(in_scan)[1],
            scan_noise=_ref_scan_noise(key))
        got[in_scan] = (float(loss), _flat_np(g))
    assert got[True][0] == got[False][0]
    assert sorted(got[True][1]) == sorted(got[False][1])
    for p, want in got[False][1].items():
        np.testing.assert_array_equal(got[True][1][p], want, err_msg=p)


def test_in_scan_draws_per_layer_and_again_in_the_recompute():
    """Each (weight, layer) draw has one layer slice's shape, is made once
    in a step without remat and a second time, the same bits, in the
    backward's recompute with it; the gradients are equal either way."""
    arch = "kimi_k2_1t_a32b"
    cfg = tcb.get_smoke(arch)
    pt = tsteps.init_state(0, cfg, _tc()[1], device="cpu")["params"]
    batch = _tb(_batch(cfg, seed=6))
    modes = torch.tensor([NOISE, NOISE], dtype=torch.int32)
    out = {}
    for remat in (False, True):
        draws = []
        base = tuniq.layer_noise(3, 1)

        def scan_noise(name, l, leaf, draws=draws, base=base):
            e = base(name, l, leaf)
            draws.append((name, l, tuple(leaf.shape), e.sum().item()))
            return e

        loss, g = tsteps.loss_and_grads(
            pt, batch, modes, tuniq.leaf_noise(3, 1), cfg,
            _topts(remat=remat), _tc()[1], scan_noise=scan_noise)
        out[remat] = (float(loss), _flat_np(g), draws)
    lay = pt["layers"]
    once = sorted((n, l, tuple(lay[n].shape[1:]))
                  for n in ("wq", "wk", "wv", "wo", "eg", "eu", "ed")
                  for l in range(cfg.n_layers))
    assert sorted(d[:3] for d in out[False][2]) == once
    assert sorted(d[:3] for d in out[True][2]) == sorted(once + once)
    sums = {}
    for n, l, _, s in out[True][2]:
        assert sums.setdefault((n, l), s) == s        # the same bits again
    assert out[True][0] == out[False][0]
    for p, want in out[False][1].items():
        np.testing.assert_array_equal(out[True][1][p], want, err_msg=p)


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_in_scan_transform_calls_per_layer_and_in_the_recompute(
        remat, monkeypatch):
    """The ``uniq_noise`` forward runs once per tree-level leaf and per
    (layer weight, layer), a second time per (weight, layer) in remat's
    recompute, and the backward once each; the whole tree runs one of each
    per leaf (the counts the card's launches are held to)."""
    from repro_torch.kernels import ops as kops
    calls = {"fwd": 0, "bwd": 0}
    for side in calls:
        orig = getattr(kops._un, f"uniq_noise_{side}")

        def counted(*a, side=side, orig=orig, **kw):
            calls[side] += 1
            return orig(*a, **kw)

        monkeypatch.setattr(kops._un, f"uniq_noise_{side}", counted)
    cfg = tcb.get_smoke("granite_3_8b")
    pt = tsteps.init_state(0, cfg, _tc()[1], device="cpu")["params"]
    quant = [p for p, t in tree_lib.leaves_with_paths(pt)
             if tuniq.default_quant_filter(p, t)]
    n_layer = sum(p.startswith("layers/") for p in quant)
    n_tree, L = len(quant) - n_layer, cfg.n_layers
    assert n_layer == 7 and n_tree >= 1
    batch = _tb(_batch(cfg, seed=8))
    modes = torch.tensor(MODES, dtype=torch.int32)
    want = {True: (n_tree + (2 if remat else 1) * L * n_layer,
                   n_tree + L * n_layer),
            False: (n_tree + n_layer, n_tree + n_layer)}
    for in_scan in (True, False):
        calls.update(fwd=0, bwd=0)
        tsteps.loss_and_grads(pt, batch, modes, tuniq.leaf_noise(1, 2), cfg,
                              _topts(remat=remat), _tc(in_scan)[1],
                              scan_noise=tuniq.layer_noise(1, 2))
        assert (calls["fwd"], calls["bwd"]) == want[in_scan], in_scan


def test_in_scan_is_the_whole_tree_step_outside_the_decoder_families():
    """mamba2 (ssm) under ``uniq_in_scan=True`` takes the whole-tree
    transform, as the reference's condition decides: the step equals the
    step without it, bit for bit; a ``uniq_scan`` handed to its loss
    raises."""
    arch = "mamba2_1_3b"
    cfg = tcb.get_smoke(arch)
    assert not tsteps.in_scan(cfg, _tc()[1])
    assert tsteps.in_scan(tcb.get_smoke("pixtral_12b"), _tc()[1])
    batch = _tb(_batch(cfg, seed=7))
    res = []
    for in_scan in (True, False):
        tt = _tc(in_scan)[1]
        state = tsteps.init_state(1, cfg, tt, device="cpu")
        step, _ = tsteps.make_train_step(
            cfg, dataclasses.replace(_topts(), ssd_chunk=4), tt)
        state, m = step(state, batch, seed=2)
        res.append((float(m["loss"]), _flat_np(state["params"])))
    assert res[0][0] == res[1][0]
    for p, v in res[1][1].items():
        np.testing.assert_array_equal(res[0][1][p], v, err_msg=p)
    from repro_torch.models import model as tmodel
    with pytest.raises(ValueError, match="uniq_scan"):
        tmodel.loss_fn(state["params"], cfg, _topts(), batch,
                       uniq_scan=(tuniq.UniqConfig(), torch.zeros(2),
                                  tuniq.layer_noise(0, 0)))
