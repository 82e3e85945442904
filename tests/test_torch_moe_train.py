"""PyTorch port vs JAX reference: UNIQ training of the MoE family (kimi_k2,
llama4).

At the ``*_smoke`` sizes in f32 on the CPU (kimi_k2: 8 experts, top-2;
llama4: 4 experts, top-1), the reference's init carried across by
``convert.params_from_numpy`` and the reference's own noise handed in:

* ``moe_ffn_local``'s gradient (input, router, the three expert stacks)
  against ``jax.grad`` of the reference's, with copies dropped;
* the loss and every leaf's gradient, router included, at the
  UNIQ-transformed parameters against ``jax.value_and_grad`` of the
  reference's transformed ``model.loss_fn`` (the port's remat on and off),
  after the routing ids of every layer were found equal;
* two train steps against the reference's ``make_train_step``: FROZEN
  slices of the (L, E, d, f) stacks bit-unchanged, masks equal;
* a train state saved by the port restores in the reference.

The loss is cross-entropy alone, as the reference's (which defines
``aux_load_balance_loss`` and never adds it).  The batch ``_batch`` puts
one token in every position of its first two rows: those 24 tokens reach
the first layer's router with the same hidden row, so all their copies go
to the same top-k experts and overflow their capacity (kimi_k2: 36 tokens,
C = 16, 24 copies an expert; llama4: C = 16, 24 copies), and the copies
past it are dropped in both frameworks.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import base as jcb
from repro.core import uniq as juniq
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.optim import optim as joptim
from repro.train import steps as jsteps

from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import base as tcb
from repro_torch.core import uniq as tuniq
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.optim import optim as toptim
from repro_torch.train import steps as tsteps

from test_torch_train import (TOL_GRAD_REL, TOL_LOSS_REL, _compare_step,
                              _flat_np, _grad_tol, _jopts, _np_tree,
                              _ref_noise, _topts)
# At the transformed parameters the two sides differ where a FROZEN code
# sits on a bin edge (kimi_k2's eu at these inputs: one of 65,536 codes
# takes the next level) and where a NOISE weight is clamped at the tails
# (the two erfinv / ndtri levels 2.7e-3 sigma apart): the loss up to
# 1.2e-5 relative and a gradient up to 1.5e-3 of its leaf's largest (the
# attention norm under all-FROZEN layers) here.  The bounds of
# test_torch_train_families' steps, for the same reasons; where the weights
# are equal the two agree to 1e-7 (loss) and 1e-6 (gradients).
from test_torch_train_families import (TOL_FAMILY_STEP_GRAD_REL,
                                       TOL_FAMILY_STEP_LOSS_REL)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread for this module, restored after it: at
    these sizes more threads only add their OpenMP spin-waits, which take
    the cores of the suite's other parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MOE_ARCHS = ("kimi_k2_1t_a32b", "llama4_maverick_400b_a17b")
FROZEN, NOISE = 2, 1
B, S = 3, 12
# the schedule of the step tests: 8 steps over 2 layers, two iterations:
# steps 2 and 3 are stage 1, layer 0 (and the embedding) FROZEN, layer 1
# (and the head) NOISE
TOTAL = 8
STEP = 2
MODES = [FROZEN, NOISE]


def _batch(cfg, seed=0):
    """tokens / targets (B, S): rows 0 and 1 one repeated token (their
    copies overflow an expert's capacity), row 2 drawn; ignored targets."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    toks[:2] = toks[0, 0]
    tgts = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    tgts[2, -3:] = -1
    return {"tokens": toks, "targets": tgts}


def _tc(arch, kind):
    common = dict(total_steps=TOTAL, n_blocks=0)
    jt = jsteps.TrainConfig(uniq=juniq.UniqConfig(w_bits=4),
                            optim=joptim.OptimConfig(kind=kind, lr=1e-3),
                            **common)
    tt = tsteps.TrainConfig(uniq=tuniq.UniqConfig(w_bits=4),
                            optim=toptim.OptimConfig(kind=kind, lr=1e-3),
                            **common)
    return jt, tt


# kimi_k2 steps under AdamW (the CLI's default), llama4 under SGD with
# momentum (the paper's fine-tuning optimizer).  llama4's router has no
# gradient but rounding (a renormalised top-1 gate is 1): AdamW divides
# that noise by its own root mean square into steps of about lr, another
# draw of noise in each framework, so its update is compared under SGD
KIND = {"kimi_k2_1t_a32b": "adamw", "llama4_maverick_400b_a17b": "sgd"}


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jmodel.init(jax.random.PRNGKey(0), jcb.get_smoke(arch))


@functools.lru_cache(maxsize=None)
def _jax_step(arch):
    fn, _ = jsteps.make_train_step(jcb.get_smoke(arch), _jopts(),
                                   _tc(arch, KIND[arch])[0])
    return jax.jit(fn)


def _jb(batch):
    return jax.tree_util.tree_map(jnp.asarray, batch)


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _dropped(ids, mcfg):
    """Copies past their expert's capacity in one layer's (T, k) ids, by
    the reference's rule (stable sort by expert, position < C)."""
    ids = np.asarray(ids)
    C = jmoe.capacity(ids.shape[0], mcfg)
    counts = np.bincount(ids.reshape(-1), minlength=mcfg.n_experts)
    return int(np.maximum(counts - C, 0).sum())


def _assert_rounding_only(got, want, other):
    """Both sides' gradient of an analytically zero leaf below 1e-5 of
    another leaf's largest gradient."""
    bound = 1e-5 * float(np.abs(other).max())
    assert np.abs(got).max() <= bound and np.abs(want).max() <= bound


def _mcfg(cfg):
    return jmoe.MoEConfig(cfg.n_experts, cfg.top_k, cfg.capacity_factor)


# --------------------------------------------------------------------------
# moe_ffn_local's gradient
# --------------------------------------------------------------------------

@pytest.mark.parametrize("E,k,T", [(8, 2, 24), (4, 1, 40), (6, 3, 9)])
def test_moe_ffn_gradients_match_reference(E, k, T):
    """The gradient of <y, probe> in x, the router and the three stacks.
    Half the tokens repeat one row, so copies drop: a dropped copy's pack
    into the sink row gives x no gradient (as ``.at[].set(mode="drop")``),
    the router's gradient flows through the kept gates alone, and each
    token's k contributions are summed in the sorted order."""
    d, f = 16, 24
    rng = np.random.default_rng(E * 100 + k * 10 + T)
    x = rng.standard_normal((T, d)).astype(np.float32)
    x[: T // 2] = x[0]
    rw = (rng.standard_normal((d, E)) * 0.5).astype(np.float32)
    eg, eu = ((rng.standard_normal((E, d, f)) * 0.2).astype(np.float32)
              for _ in range(2))
    ed = (rng.standard_normal((E, f, d)) * 0.2).astype(np.float32)
    probe = rng.standard_normal((T, d)).astype(np.float32)
    mcj = jmoe.MoEConfig(E, k, 1.25)
    mct = tmoe.MoEConfig(E, k, 1.25)
    _, ids = jmoe.router_topk(jnp.asarray(x), jnp.asarray(rw), mcj)
    assert _dropped(ids, mcj) > 0

    def jloss(*a):
        return jnp.sum(jmoe.moe_ffn_local(*a, mcj) * probe)

    gj = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(
        *(jnp.asarray(v) for v in (x, rw, eg, eu, ed)))
    ts = [torch.from_numpy(v).requires_grad_(True)
          for v in (x, rw, eg, eu, ed)]
    y = tmoe.moe_ffn_local(*ts, mct)
    gt = torch.autograd.grad(torch.sum(y * torch.from_numpy(probe)), ts)
    for name, a, b in zip(("x", "router", "eg", "eu", "ed"), gt, gj):
        b = np.asarray(b)
        if name == "router" and k == 1:
            # a renormalised top-1 gate is 1 whatever the router: its
            # gradient is zero but for rounding, on both sides
            _assert_rounding_only(a.numpy(), b, np.asarray(gj[0]))
            continue
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * float(np.abs(b).max()) + 1e-9,
                                   err_msg=name)
    r = tmoe.route(torch.from_numpy(x), torch.from_numpy(rw), mct)
    assert int((~r["keep"]).sum()) == _dropped(ids, mcj)


# --------------------------------------------------------------------------
# Loss and gradients at the transformed parameters
# --------------------------------------------------------------------------

def _record_port_ids(monkeypatch):
    """Record every port router call's (T, k) ids."""
    rec = []
    orig = tmoe.router_topk

    def topk(x, w, cfg):
        out = orig(x, w, cfg)
        rec.append(out[1].numpy().copy())
        return out

    monkeypatch.setattr(tmoe, "router_topk", topk)
    return rec


@functools.lru_cache(maxsize=None)
def _ref_loss_and_grads(arch):
    """The reference's loss at its transformed parameters (layer 0 FROZEN,
    layer 1 NOISE; noise keyed by ``KEY``) and its gradients in the
    parameters, the transformed parameters ``w_hat`` and the gradients in
    them, from one jitted function, and the expert ids of its router calls
    in call order."""
    cfg = jcb.get_smoke(arch)
    batch = _jb(_batch(tcb.get_smoke(arch)))
    modes = jnp.asarray(MODES, jnp.int32)
    ids = []
    orig = jmoe.router_topk

    def topk(x, w, mcfg):
        out = orig(x, w, mcfg)
        jax.debug.callback(lambda i: ids.append(np.asarray(i)), out[1])
        return out

    def both(p):
        w_hat, back = jax.vjp(lambda q: juniq.transform_tree(
            q, KEY, juniq.lm_mode_fn(modes), juniq.UniqConfig(w_bits=4)), p)
        loss, g_hat = jax.value_and_grad(
            lambda w: jmodel.loss_fn(w, cfg, _jopts(), batch))(w_hat)
        return loss, back(g_hat)[0], w_hat, g_hat

    jmoe.router_topk = topk
    try:
        loss_j, g_j, w_hat, g_hat = jax.jit(both)(_jax_params(arch))
        jax.effects_barrier()
    finally:
        jmoe.router_topk = orig
    return (float(loss_j), _flat_np(g_j), ids, _np_tree(w_hat),
            _flat_np(g_hat))


KEY = jax.random.PRNGKey(7)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loss_and_grads_at_transformed_params_match_reference(
        arch, remat, monkeypatch):
    """Layer 0 FROZEN (with the embedding), layer 1 NOISE (with the head):
    the reference's per-leaf noise is handed to the port.  The routing of
    every layer is compared first (the same ids, copies dropped), then the
    loss and the gradient of every leaf, the f32 router included."""
    cfg_t = tcb.get_smoke(arch)
    loss_j, want, ids_j, w_hat, _ = _ref_loss_and_grads(arch)
    want = dict(want)
    ids_t = _record_port_ids(monkeypatch)
    _, tt = _tc(arch, "adamw")
    pt = convert.params_from_numpy(_np_tree(_jax_params(arch)), device="cpu")
    loss_t, g_t = tsteps.loss_and_grads(
        pt, _tb(_batch(cfg_t)), torch.tensor(MODES, dtype=torch.int32),
        _ref_noise(KEY), cfg_t, _topts(remat=remat), tt)

    L = cfg_t.n_layers
    assert len(ids_j) == L and len(ids_t) >= L
    for l in range(L):
        np.testing.assert_array_equal(ids_t[l], ids_j[l], err_msg=f"{l}")
    assert _dropped(ids_j[0], _mcfg(cfg_t)) > 0

    np.testing.assert_allclose(float(loss_t), loss_j,
                               rtol=TOL_FAMILY_STEP_LOSS_REL)
    got = _flat_np(g_t)
    assert sorted(got) == sorted(want)
    if cfg_t.top_k == 1:
        # llama4: the renormalised top-1 gate is 1, so the router has no
        # gradient in either framework (and trains by weight decay alone)
        _assert_rounding_only(got["layers/router"], want["layers/router"],
                              want["layers/wq"])
        del want["layers/router"]
    else:
        assert float(np.abs(want["layers/router"]).max()) > 0
    tol = _grad_tol(_jax_params(arch), KEY, np.asarray(MODES), want,
                    TOL_FAMILY_STEP_GRAD_REL, w_hat=_flat_np(w_hat))
    for p in want:
        np.testing.assert_array_less(np.abs(got[p] - want[p]), tol[p] + 1e-9,
                                     err_msg=p)
    # FROZEN layer 0 of every 4-D stack: no gradient on either side
    for name in ("eg", "eu", "ed"):
        assert not got[f"layers/{name}"][0].any()
        assert got[f"layers/{name}"].ndim == 4


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loss_and_grads_at_the_references_weights_match_reference(
        arch, remat, monkeypatch):
    """Both frameworks at the same weights, the reference's transformed
    parameters (layer 0 FROZEN, layer 1 NOISE) handed to the port as they
    are: the routing ids equal (copies dropped), then the loss within
    ``TOL_LOSS_REL`` and the gradient of every leaf in these weights within
    ``TOL_GRAD_REL`` of its largest: the MoE forward and backward (the pack
    into the sink row, the router through the renormalised gates, the
    per-token sum in sorted order) at the bounds of the dense trainer,
    where no code on a bin edge or clamped tail separates the two sides."""
    cfg_t = tcb.get_smoke(arch)
    loss_j, _, ids_j, w_hat, want = _ref_loss_and_grads(arch)
    want = dict(want)
    ids_t = _record_port_ids(monkeypatch)
    pt = convert.params_from_numpy(w_hat, device="cpu")
    leaves = list(tree_lib.leaves_with_paths(pt))
    for _, t in leaves:
        t.requires_grad_(True)
    loss_t = tmodel.loss_fn(pt, cfg_t, _topts(remat=remat),
                            _tb(_batch(cfg_t)))
    grads = torch.autograd.grad(loss_t, [t for _, t in leaves])
    for l in range(cfg_t.n_layers):
        np.testing.assert_array_equal(ids_t[l], ids_j[l], err_msg=f"{l}")
    assert _dropped(ids_j[0], _mcfg(cfg_t)) > 0
    np.testing.assert_allclose(float(loss_t), loss_j, rtol=TOL_LOSS_REL)
    got = {p: g.numpy() for (p, _), g in zip(leaves, grads)}
    assert sorted(got) == sorted(want)
    if cfg_t.top_k == 1:
        _assert_rounding_only(got["layers/router"], want["layers/router"],
                              want["layers/wq"])
        del want["layers/router"]
    else:
        assert float(np.abs(want["layers/router"]).max()) > 0
    for p in want:
        np.testing.assert_allclose(
            got[p], want[p], rtol=0,
            atol=TOL_GRAD_REL * float(np.abs(want[p]).max()) + 1e-9,
            err_msg=p)


# --------------------------------------------------------------------------
# Train steps against the reference's make_train_step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_steps_match_reference(arch):
    """Steps 2 and 3 of 8 (layer 0 FROZEN, layer 1 NOISE), each from the
    reference's state converted afresh: loss, gradients and update within
    ``_compare_step``'s tolerances, the masks of the 4-D stacks equal to
    the reference's, the FROZEN layer's expert slices bit-unchanged and the
    router moved."""
    kind = KIND[arch]
    cfg_j, cfg_t = jcb.get_smoke(arch), tcb.get_smoke(arch)
    jt, tt = _tc(arch, kind)
    sj = jsteps.init_state(jax.random.PRNGKey(1), cfg_j, jt)
    sj["step"] = jnp.int32(STEP)
    step_t, sched = tsteps.make_train_step(cfg_t, _topts(), tt)
    for i in range(2):
        modes = sched.modes_at(STEP + i)
        assert modes.tolist() == MODES
        mask_j = _flat_np(jsteps.freeze_mask_tree(sj["params"],
                                                  jnp.asarray(modes)))
        mask_t = _flat_np(tsteps.freeze_mask_tree(
            convert.params_from_numpy(_np_tree(sj["params"]),
                                      device="cpu"), modes))
        assert sorted(mask_t) == sorted(mask_j)
        for p in mask_j:
            np.testing.assert_array_equal(mask_t[p], mask_j[p], err_msg=p)
        np.testing.assert_array_equal(mask_t["layers/eg"], [0.0, 1.0])
        batch = _batch(cfg_t, seed=10 + i)
        key = jax.random.PRNGKey(20 + i)
        sj1, mj = _jax_step(arch)(sj, _jb(batch), key)
        st = convert.train_state_from_numpy(_np_tree(sj), device="cpu")
        before = {p: v.copy() for p, v in _flat_np(st).items()}  # in place
        st, mt = step_t(st, _tb(batch), seed=0, noise=_ref_noise(key))
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                                   rtol=TOL_FAMILY_STEP_LOSS_REL)
        _compare_step(st, mt, sj, sj1, mj, key, modes, kind, tt,
                      grad_rel=TOL_FAMILY_STEP_GRAD_REL,
                      zero_grad=("layers/router",) if cfg_t.top_k == 1
                      else ())
        after = _flat_np(st)
        for name in ("eg", "eu", "ed"):
            p = f"params/layers/{name}"
            np.testing.assert_array_equal(after[p][0], before[p][0])
            assert not np.array_equal(after[p][1], before[p][1])
        assert not np.array_equal(after["params/layers/router"],
                                  before["params/layers/router"])
        sj = sj1


def test_moe_port_checkpoint_restores_in_the_reference(tmp_path):
    """Two port steps of kimi_k2 under SGD, saved by the port: the
    reference restores every leaf (4-D stacks, router, momentum) bit for
    bit into its own state."""
    arch = "kimi_k2_1t_a32b"
    cfg_t = tcb.get_smoke(arch)
    jt, tt = _tc(arch, "sgd")
    st = tsteps.init_state(0, cfg_t, tt, device="cpu")
    step_t, _ = tsteps.make_train_step(cfg_t, _topts(), tt)
    for s in range(2):
        st, _ = step_t(st, _tb(_batch(cfg_t, seed=30 + s)), seed=0)
    tckpt.save(str(tmp_path), 2, st, extra={"arch": arch})
    target = jsteps.init_state(jax.random.PRNGKey(5), jcb.get_smoke(arch), jt)
    sj, step, extra = jckpt.restore(str(tmp_path), target)
    assert step == 2 and extra == {"arch": arch}
    got, want = _flat_np(sj), _flat_np(st)
    assert sorted(got) == sorted(want)
    for p in want:
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)
    assert got["params/layers/eg"].ndim == 4
    assert int(sj["step"]) == 2


def test_moe_trainer_cli_runs_on_cpu(capsys):
    """``launch.train --arch kimi_k2_1t_a32b --smoke --device cpu --steps
    3`` trains (finite losses), and so does llama4 under SGD."""
    for arch, extra in (("kimi_k2_1t_a32b", []),
                        ("llama4_maverick_400b_a17b", ["--optim", "sgd"])):
        from repro_torch.launch import train as tlaunch
        state = tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--steps", "3", "--batch", "2", "--seq-len",
                              "16"] + extra)
        assert int(state["step"]) == 3
        out = capsys.readouterr().out
        assert "final loss" in out and "nan" not in out.lower()
