"""PyTorch port vs JAX reference: the UNIQ training path.

Schedule, freeze masks, optimizer and LR schedules; ``forward_train``'s
loss and gradients; one whole ``make_train_step`` from a JAX state carried
across (with the reference's own per-leaf noise handed to the port, and an
all-FROZEN step); checkpoints crossing the frameworks both ways; and replay
inside the port (data, noise, a resumed run).  Everything runs on the CPU
at the ``*_smoke`` sizes in f32, each comparison with its stated tolerance.
"""

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import base as jcb
from repro.core import uniq as juniq
from repro.models import model as jmodel
from repro.models.lm import ModelOpts as JOpts
from repro.optim import optim as joptim
from repro.train import steps as jsteps

from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import base as tcb
from repro_torch.core import uniq as tuniq
from repro_torch.data import synthetic as tdata
from repro_torch.launch import train as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.models import model as tmodel
from repro_torch.optim import optim as toptim
from repro_torch.train import steps as tsteps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread for this module, restored after it: at
    these sizes more threads only add their OpenMP spin-waits, which take
    the cores of the suite's other parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FROZEN = 2
B, S = 2, 12

# loss of O(log V) after two f32 layers: summation orders and
# transcendental implementations differ.
TOL_LOSS_REL = 1e-5
# gradients: the same, through the backward; stated relative to the
# leaf's largest gradient.
TOL_GRAD_REL = 1e-4
# one train step: the two forwards differ where NOISE outputs do (the far
# tails, see below), which moves every other leaf's gradient too: stated
# relative to the leaf's largest gradient.
TOL_STEP_GRAD_REL = 5e-4
# NOISE weights: the error of u allowed on either side of the transform
# (four ulps of u near 1), as in test_torch_uniq_noise.
TOL_NOISE_U = 4 * 2.0 ** -24


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat_np(tree):
    """{path: numpy} of a JAX tree or a port tree."""
    if isinstance(tree, dict) and any(isinstance(v, torch.Tensor)
                                      for _, v in tree_lib.leaves_with_paths(
                                          tree)):
        return {p: convert.tensor_to_numpy(v)
                for p, v in tree_lib.leaves_with_paths(tree)}
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {juniq.path_str(kp): np.asarray(v, np.float32)
            if np.asarray(v).dtype.kind == "V" else np.asarray(v)
            for kp, v in flat}


def _tokens(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    tgts = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    tgts[0, -3:] = -1                                 # ignored positions
    return {"tokens": toks, "targets": tgts}


def _jopts():
    return JOpts(compute_dtype=jnp.float32, remat=False,
                 attn_chunked_min_len=1 << 30, ce_chunk=8)


def _topts(**kw):
    return tlm.ModelOpts(compute_dtype=torch.float32, ce_chunk=8, **kw)


# --------------------------------------------------------------------------
# Schedule, masks, optimizer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_layers", [1, 3, 8])
def test_schedule_modes_match_reference(n_layers):
    for n_blocks in (1, 2, 3, 8, 10):
        for iterations in (1, 2):
            for total in (5, 40):
                js = juniq.GradualSchedule(n_layers, n_blocks, total,
                                           iterations)
                ts = tuniq.GradualSchedule(n_layers, n_blocks, total,
                                           iterations)
                assert ts.n_blocks == js.n_blocks
                assert ts.steps_per_stage == js.steps_per_stage
                for step in sorted({0, 1, 2, total // 2, total - 1, total,
                                    total + 2, js.steps_per_stage,
                                    3 * js.steps_per_stage - 1}):
                    want = np.asarray(js.modes_at(step))
                    got = ts.modes_at(step)
                    assert got.dtype == torch.int32
                    np.testing.assert_array_equal(got.numpy(), want)
                    np.testing.assert_array_equal(
                        ts.freeze_mask_at(step).numpy(),
                        np.asarray(js.freeze_mask_at(step)))


def test_freeze_mask_tree_matches_reference():
    cfg = jcb.get_smoke("granite_3_8b")
    params_j = jmodel.init(jax.random.PRNGKey(0), cfg)
    params_t = convert.params_from_numpy(_np_tree(params_j), device="cpu")
    sched = juniq.GradualSchedule(cfg.n_layers, cfg.n_layers, 8)
    for step in range(10):
        modes = sched.modes_at(step)
        want = _flat_np(jsteps.freeze_mask_tree(params_j, modes))
        got = tsteps.freeze_mask_tree(params_t,
                                      torch.from_numpy(np.asarray(modes)))
        got = {p: v.numpy() for p, v in tree_lib.leaves_with_paths(got)}
        assert sorted(got) == sorted(want)
        for p in want:
            np.testing.assert_array_equal(got[p], want[p], err_msg=p)


def _opt_inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = {"a": rng.standard_normal((3, 8, 16)).astype(np.float32),
              "b": rng.standard_normal((16,)).astype(np.float32),
              "c": {"d": rng.standard_normal((8, 4)).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * 0.5).astype(np.float32),
        params) for _ in range(3)]
    mask = {"a": np.array([1.0, 0.0, 1.0], np.float32),
            "b": np.float32(1.0), "c": {"d": np.float32(0.0)}}
    return params, grads, mask


def _t_tree(tree):
    return jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x)),
                                  tree)


@pytest.mark.parametrize("momentum_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("kind", ["sgd", "adamw"])
def test_apply_updates_matches_reference(kind, momentum_dtype):
    """Three steps with clipping (the gradients' norm is above 1) and a
    freeze mask that stops one layer of a stacked leaf and one whole leaf;
    both sides get the same gradients."""
    params, grads, mask = _opt_inputs()
    cfg_j = joptim.OptimConfig(kind=kind, lr=1e-2, weight_decay=1e-2,
                               momentum_dtype=momentum_dtype, grad_clip=1.0)
    cfg_t = toptim.OptimConfig(kind=kind, lr=1e-2, weight_decay=1e-2,
                               momentum_dtype=momentum_dtype, grad_clip=1.0)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    sj = joptim.init_state(pj, cfg_j)
    pt = _t_tree(params)
    st = toptim.init_state(pt, cfg_t)
    mt = _t_tree(mask)
    for step, g in enumerate(grads):
        lr = 1e-2 * (step + 1)
        pj, sj, mj = joptim.apply_updates(
            pj, jax.tree_util.tree_map(jnp.asarray, g), sj, cfg_j,
            jnp.float32(lr), freeze_mask=mask)
        pt2, st2, m_t = toptim.apply_updates(pt, _t_tree(g), st, cfg_t, lr,
                                             freeze_mask=mt)
        assert pt2 is pt and st2 is st                        # in place
        np.testing.assert_allclose(float(m_t["grad_norm"]),
                                   float(mj["grad_norm"]), rtol=1e-6)
    # the public clipping function: the same scale as the reference's
    ct, nt = toptim.clip_by_global_norm(_t_tree(grads[0]), 1.0)
    cj, nj = joptim.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, grads[0]), 1.0)
    np.testing.assert_allclose(float(nt), float(nj), rtol=1e-6)
    np.testing.assert_allclose(ct["a"].numpy(), np.asarray(cj["a"]),
                               rtol=1e-6)
    got, want = _flat_np(pt), _flat_np(pj)
    # frozen slices keep their values exactly, params and momentum alike
    np.testing.assert_array_equal(got["a"][1], params["a"][1])
    np.testing.assert_array_equal(got["c/d"], params["c"]["d"])
    np.testing.assert_array_equal(_flat_np(st)["mu/c/d/m"],
                                  np.zeros((8, 4), np.float32))
    # f32 state: ulps; bf16 momentum: one bf16 rounding (2^-8 relative) of
    # a moment that differs by ulps, carried through three steps; int8:
    # one code step of the absmax scale (1/127 of the largest moment).
    rtol = {"float32": 1e-5, "bfloat16": 2e-2, "int8": 2e-2}[momentum_dtype]
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=rtol, atol=1e-6,
                                   err_msg=p)
    so_t, so_j = _flat_np(st), _flat_np(sj)
    assert sorted(so_t) == sorted(so_j)
    assert int(so_t["count"]) == int(so_j["count"]) == 3
    for p in so_j:
        if p.endswith("/m") and momentum_dtype == "int8":
            # codes: at most one step apart, and rarely
            d = np.abs(so_t[p].astype(np.int32) - so_j[p].astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 0.05, p
        else:
            np.testing.assert_allclose(so_t[p], so_j[p], rtol=rtol,
                                       atol=1e-7, err_msg=p)


def test_lr_schedules_match_reference():
    steps = list(range(0, 70, 3))
    pairs = [
        (joptim.cosine_schedule(1e-3, 60), toptim.cosine_schedule(1e-3, 60)),
        (joptim.cosine_schedule(1e-3, 60, warmup=7),
         toptim.cosine_schedule(1e-3, 60, warmup=7)),
        (joptim.constant_schedule(3e-4), toptim.constant_schedule(3e-4)),
        (joptim.stage_scaled_lr(1e-3, 5, decay=0.8),
         toptim.stage_scaled_lr(1e-3, 5, decay=0.8)),
        (joptim.stage_scaled_lr(1e-3, 4), toptim.stage_scaled_lr(1e-3, 4)),
    ]
    for fj, ft in pairs:
        for s in steps:
            got = ft(s)
            assert got.dtype == torch.float32
            # f32 arithmetic on both sides: cos / pow differ by a few ulps,
            # and 1 + cos cancels near the end (an ulp of 1 x base lr)
            np.testing.assert_allclose(float(got), float(fj(s)), rtol=4e-6,
                                       atol=1e-9)
    tc = tsteps.TrainConfig(total_steps=40)
    sched = tsteps.make_schedule(tcb.get_smoke("granite_3_8b"), tc)
    for kind in ("stage", "cosine", "constant"):
        tcj = jsteps.TrainConfig(total_steps=40, lr_schedule=kind)
        fj = jsteps.make_lr_fn(tcj, jsteps.make_schedule(
            jcb.get_smoke("granite_3_8b"), tcj))
        ft = tsteps.make_lr_fn(dataclasses.replace(tc, lr_schedule=kind),
                               sched)
        for s in steps:
            np.testing.assert_allclose(float(ft(s)), float(fj(s)), rtol=4e-6,
                                       atol=1e-9)


# --------------------------------------------------------------------------
# forward_train and the bf16 head
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jmodel.init(jax.random.PRNGKey(0), jcb.get_smoke(arch))


def _close_grads(got, want):
    for p in want:
        scale = float(np.abs(want[p]).max())
        np.testing.assert_allclose(got[p], want[p],
                                   atol=TOL_GRAD_REL * scale + 1e-9,
                                   err_msg=p)


@pytest.mark.parametrize("arch", ["granite_3_8b", "gemma2_9b"])
def test_forward_train_loss_and_grads_match_reference(arch):
    """The loss and the gradient of every leaf, from the reference's init
    carried across; chunked cross-entropy (12 positions in chunks of 6),
    ignored targets, and the port's per-layer recompute (remat) on."""
    cfg_j, cfg_t = jcb.get_smoke(arch), tcb.get_smoke(arch)
    pj = _jax_params(arch)
    batch = _tokens(cfg_j)
    loss_j, g_j = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, cfg_j, _jopts(),
                                 jax.tree_util.tree_map(jnp.asarray, batch))
    )(pj)
    pt = convert.params_from_numpy(_np_tree(pj), device="cpu")
    leaves = list(tree_lib.leaves_with_paths(pt))
    for _, t in leaves:
        t.requires_grad_(True)
    bt = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss_t = tmodel.loss_fn(pt, cfg_t, _topts(remat=True), bt)
    grads = torch.autograd.grad(loss_t, [t for _, t in leaves])
    np.testing.assert_allclose(float(loss_t), float(loss_j),
                               rtol=TOL_LOSS_REL)
    _close_grads({p: g.numpy() for (p, _), g in zip(leaves, grads)},
                 _flat_np(g_j))


@pytest.mark.parametrize("arch", ["granite_3_8b", "gemma2_9b"])
def test_forward_train_at_a_bits_8_matches_reference(arch):
    """As above with every layer's output fake-quantized to int8
    (``_maybe_quant_act``: per-tensor absmax, straight-through gradient)
    on both sides, remat on in the port."""
    cfg_j, cfg_t = jcb.get_smoke(arch), tcb.get_smoke(arch)
    pj = _jax_params(arch)
    batch = _tokens(cfg_j, seed=2)
    jo = dataclasses.replace(_jopts(), a_bits=8)
    loss_j, g_j = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, cfg_j, jo,
                                 jax.tree_util.tree_map(jnp.asarray, batch))
    )(pj)
    pt = convert.params_from_numpy(_np_tree(pj), device="cpu")
    leaves = list(tree_lib.leaves_with_paths(pt))
    for _, t in leaves:
        t.requires_grad_(True)
    bt = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss_t = tmodel.loss_fn(pt, cfg_t, _topts(remat=True, a_bits=8), bt)
    grads = torch.autograd.grad(loss_t, [t for _, t in leaves])
    np.testing.assert_allclose(float(loss_t), float(loss_j),
                               rtol=TOL_LOSS_REL)
    _close_grads({p: g.numpy() for (p, _), g in zip(leaves, grads)},
                 _flat_np(g_j))


def test_bf16_head_accumulates_into_f32_like_the_reference():
    """bf16 activations @ a bf16 dense head with f32 logits: the port keeps
    the f32 sums (``jnp.dot(..., preferred_element_type=f32)``), not their
    bf16 rounding."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 300)) * 0.1).astype(np.float32)
    xj, wj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = np.asarray(jnp.dot(xj, wj, preferred_element_type=jnp.float32))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    got = tlm.mm(xt, wt, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    # products of bf16 values are exact in f32; only the order of the f32
    # sums over K = 64 differs
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    rounded = np.asarray(jnp.asarray(want, jnp.bfloat16), np.float32)
    assert np.abs(rounded - want).max() > 100 * np.abs(got.numpy()
                                                       - want).max()
    # and through the LM head of the serving path, the logits stay f32
    cfg = tcb.get_smoke("granite_3_8b")
    head = torch.from_numpy((rng.standard_normal((cfg.d_model, cfg.vocab))
                             * 0.1).astype(np.float32)).bfloat16()
    logits = tlm._logits(xt, {"lm_head": head}, cfg, _topts())
    want = np.asarray(jnp.dot(xj, jnp.asarray(head.float().numpy(),
                                              jnp.bfloat16),
                              preferred_element_type=jnp.float32))
    np.testing.assert_allclose(logits.numpy(), want, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# One whole train step, JAX state carried across
# --------------------------------------------------------------------------

def _tc(kind, **kw):
    common = dict(total_steps=8, n_blocks=0)
    common.update(kw)
    jt = jsteps.TrainConfig(uniq=juniq.UniqConfig(w_bits=4),
                            optim=joptim.OptimConfig(kind=kind, lr=1e-3),
                            **common)
    tt = tsteps.TrainConfig(uniq=tuniq.UniqConfig(w_bits=4),
                            optim=toptim.OptimConfig(kind=kind, lr=1e-3),
                            **common)
    return jt, tt


@functools.lru_cache(maxsize=None)
def _jax_step(kind, a_bits=32, uniq=True):
    cfg = jcb.get_smoke("granite_3_8b")
    jt, _ = _tc(kind)
    if not uniq:
        jt = dataclasses.replace(jt, uniq=dataclasses.replace(
            jt.uniq, enabled=False))
    fn, _ = jsteps.make_train_step(
        cfg, dataclasses.replace(_jopts(), a_bits=a_bits), jt)
    return jax.jit(fn)


# jitted: eager dispatch compiles each operation anew for each leaf shape,
# seconds a tree where one compile of the whole takes a fraction
_uniform = jax.jit(lambda k, shape: jax.random.uniform(k, shape,
                                                       dtype=jnp.float32),
                   static_argnums=1)


@jax.jit
def _ref_transform(params_j, key, modes):
    """The reference's whole-tree W4 transform under ``key`` and the
    per-layer ``modes``."""
    return juniq.transform_tree(params_j, key, juniq.lm_mode_fn(modes),
                                juniq.UniqConfig(w_bits=4))


def _ref_noise(key, draws=None):
    """The reference's own per-leaf noise: its ``transform_param`` draws
    ``uniform(_fold_path(key, path), minval=-1/2k, maxval=1/2k)``, which is
    ``(e01 - 1/2) / k`` of these e01 bits exactly."""
    def noise(path, leaf):
        e = np.asarray(_uniform(juniq._fold_path(key, path),
                                tuple(leaf.shape)))
        if draws is not None:
            draws.append(path)
        return torch.from_numpy(e).to(leaf.device)
    return noise


def _noise_tol_sigma(z_hat):
    """Tolerance on a NOISE output in units of sigma: an ulp-level
    difference of u between the two erf / ndtr implementations, magnified
    by 1 / pdf(z_hat) (see test_torch_uniq_noise)."""
    pdf = np.exp(-0.5 * np.square(z_hat)) / np.sqrt(2.0 * np.pi)
    return TOL_NOISE_U / pdf + 1e-5


def _grad_tol(params_j, key, modes, g, grad_rel=TOL_STEP_GRAD_REL,
              w_hat=None):
    """Per-element tolerance on the (unclipped) gradient of one train step.

    The gradient of a NOISE weight is g_hat * pdf(z) / pdf(z_hat); z_hat
    comes from each side's own forward, which differ as stated in
    ``_noise_tol_sigma``, so the factor's relative error is |z_hat| *
    dz_hat (twice that, for both sides' errors).  Every gradient also
    carries ``grad_rel`` (TOL_STEP_GRAD_REL) of its leaf's largest.
    ``w_hat`` ({path: numpy}) gives the reference's transformed weights
    where they are not the whole-tree transform under ``key`` (the
    per-layer transform inside the layer loop)."""
    if w_hat is None:
        w_hat = _flat_np(_ref_transform(params_j, key, jnp.asarray(modes)))
    w_all = _flat_np(params_j)
    tol = {}
    for p, gp in g.items():
        tol[p] = grad_rel * float(np.abs(gp).max()) + 1e-12
        w, wh = w_all[p], w_hat[p]
        if np.array_equal(w, wh):                     # CLEAN / not quantized
            continue
        axes = tuple(range(1, w.ndim)) if p.startswith("layers") else None
        mu = w.mean(axis=axes, keepdims=True, dtype=np.float64)
        sd = w.std(axis=axes, keepdims=True, dtype=np.float64)
        zh = np.abs((wh - mu) / sd)
        tol[p] = tol[p] + 2.0 * zh * _noise_tol_sigma(zh) * np.abs(gp)
    return tol


def _compare_step(st, mt, sj0, sj1, mj, key, modes, kind, tc,
                  grad_rel=TOL_STEP_GRAD_REL, w_hat=None, zero_grad=()):
    """Port state and metrics vs the reference's after the same step from
    the same state ``sj0``.  The reference's applied gradient is read back
    from its momentum; every tolerance is derived from ``_grad_tol``
    through clipping and the optimizer's update, element by element.  A
    leaf named in ``zero_grad`` has an analytically zero gradient, rounding
    noise on either side: its gradient may differ by 1e-5 of the step's
    largest."""
    oc = tc.optim
    got, want, prev = _flat_np(st), _flat_np(sj1), _flat_np(sj0)
    assert sorted(got) == sorted(want)
    assert int(got["step"]) == int(want["step"])
    assert int(got["opt/count"]) == int(want["opt/count"])
    np.testing.assert_allclose(float(mt["lr"]), float(mj["lr"]), rtol=1e-7)
    lr, count = float(mj["lr"]), int(want["opt/count"])
    names = [p[len("params/"):] for p in want if p.startswith("params/")]
    m0 = {n: prev[f"opt/mu/{n}/m"] for n in names}
    m1 = {n: want[f"opt/mu/{n}/m"] for n in names}
    if kind == "sgd":
        gc = {n: m1[n] - oc.momentum * m0[n] - oc.weight_decay
              * prev["params/" + n] for n in names}
    else:
        gc = {n: (m1[n] - oc.beta1 * m0[n]) / (1 - oc.beta1) for n in names}
    norm = float(mj["grad_norm"])
    scale = min(1.0, oc.grad_clip / norm) if oc.grad_clip > 0 else 1.0
    tol_g = _grad_tol(sj0["params"], key, modes,
                      {n: gc[n] / scale for n in names}, grad_rel, w_hat)
    largest = max(float(np.abs(gc[n]).max()) for n in names) / scale
    for n in zero_grad:
        tol_g[n] = tol_g[n] + 1e-5 * largest
    tol_norm = float(np.sqrt(sum(np.sum(np.square(
        np.broadcast_to(tol_g[n], gc[n].shape))) for n in names)))
    assert abs(float(mt["grad_norm"]) - norm) <= tol_norm + 1e-6 * norm
    for n in names:
        # clipping scales by clip / norm, so the norm's error reaches every
        # element of the clipped gradient as well
        tgc = scale * tol_g[n] + (np.abs(gc[n]) * tol_norm / norm
                                  if scale < 1.0 else 0.0)
        p_prev, p = prev["params/" + n], "params/" + n
        ulp = 2 * np.spacing(np.abs(p_prev).astype(np.float32))
        if kind == "sgd":
            tol_m = tgc
            tol_p = lr * tol_m + ulp
        else:
            tol_m = (1 - oc.beta1) * tgc
            nu = want[f"opt/nu/{n}"]
            tol_v = (1 - oc.beta2) * (2 * np.abs(gc[n]) + tgc) * tgc
            bc1, bc2 = 1 - oc.beta1 ** count, 1 - oc.beta2 ** count
            m_hat, v_hat = m1[n] / bc1, nu / bc2
            s = np.sqrt(v_hat)
            ds = (tol_v / bc2) / (s + np.sqrt(np.maximum(v_hat - tol_v / bc2,
                                                         0.0)) + 1e-30)
            lo = np.maximum(s - ds, 0.0) + oc.eps
            dr = (tol_m / bc1) / lo + np.abs(m_hat) * ds / ((s + oc.eps) * lo)
            r = np.abs(m_hat) / (s + oc.eps)
            tol_p = lr * 1.01 * np.minimum(dr, 2.0 * (r + 1.0)) + ulp
            np.testing.assert_array_less(
                np.abs(got[f"opt/nu/{n}"] - nu),
                tol_v + 2 * np.spacing(np.abs(nu)) + 1e-30, err_msg=n)
        np.testing.assert_array_less(
            np.abs(got[f"opt/mu/{n}/m"] - m1[n]),
            tol_m + 2 * np.spacing(np.abs(m1[n])) + 1e-30, err_msg=n)
        np.testing.assert_array_less(np.abs(got[p] - want[p]), tol_p,
                                     err_msg=p)


@pytest.mark.parametrize("kind", ["sgd", "adamw"])
def test_train_step_with_noise_matches_reference(kind):
    """Step 0 of 8 over two layers: layer 0 NOISE (with the embedding),
    layer 1 CLEAN (with the head).  The reference's per-leaf noise is
    handed to the port, so both compute the same function."""
    cfg_t = tcb.get_smoke("granite_3_8b")
    jt, tt = _tc(kind)
    sj0 = jsteps.init_state(jax.random.PRNGKey(0),
                            jcb.get_smoke("granite_3_8b"), jt)
    batch = _tokens(cfg_t, seed=1)
    key = jax.random.PRNGKey(42)
    sj1, mj = _jax_step(kind)(sj0, jax.tree_util.tree_map(jnp.asarray,
                                                          batch), key)
    step_t, sched = tsteps.make_train_step(cfg_t, _topts(), tt)
    assert sched.modes_at(0).tolist() == [1, 0]              # NOISE, CLEAN
    st = convert.train_state_from_numpy(_np_tree(sj0), device="cpu")
    draws = []
    st, mt = step_t(st, {k: torch.from_numpy(v) for k, v in batch.items()},
                    seed=0, noise=_ref_noise(key, draws))
    assert sorted(draws) == sorted(
        ["embed", "lm_head"] + [f"layers/{n}" for n in
                                ("w_down", "w_gate", "w_up", "wk", "wo",
                                 "wq", "wv")])
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=TOL_LOSS_REL)
    _compare_step(st, mt, sj0, sj1, mj, key, sched.modes_at(0), kind, tt)


def _check_a8_step(kind, frozen=False):
    """One train step with every layer's output fake-quantized to int8
    (``a_bits=8``); loss, gradients (through the straight-through
    estimator) and update within ``_compare_step``'s tolerances.

    Both sides must run the same weights: a NOISE weight one ulp apart
    would move an activation across a rounding edge of the int8 grid (one
    step of absmax / 127).  So either the UNIQ transform is off on both
    sides (every layer CLEAN), or ``frozen``: the step is past the
    schedule's end, every quantized leaf is FROZEN and the forward runs the
    transform's hard k-quantile weights, which no noise reaches."""
    cfg_t = tcb.get_smoke("granite_3_8b")
    jt, tt = _tc(kind)
    if not frozen:
        tt = dataclasses.replace(tt, uniq=dataclasses.replace(
            tt.uniq, enabled=False))
    sj0 = jsteps.init_state(jax.random.PRNGKey(0),
                            jcb.get_smoke("granite_3_8b"), jt)
    if frozen:
        sj0["step"] = jnp.int32(8)
    batch = _tokens(cfg_t, seed=1)
    key = jax.random.PRNGKey(42)
    sj1, mj = _jax_step(kind, 8, uniq=frozen)(
        sj0, jax.tree_util.tree_map(jnp.asarray, batch), key)
    step_t, sched = tsteps.make_train_step(cfg_t, _topts(a_bits=8), tt)
    modes = (sched.modes_at(8) if frozen
             else np.zeros(cfg_t.n_layers, np.int32))
    if frozen:
        assert modes.tolist() == [FROZEN] * cfg_t.n_layers
    st = convert.train_state_from_numpy(_np_tree(sj0), device="cpu")
    st, mt = step_t(st, {k: torch.from_numpy(v) for k, v in batch.items()},
                    seed=0)
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=TOL_LOSS_REL)
    _compare_step(st, mt, sj0, sj1, mj, key, modes, kind, tt)


def test_a8_train_step_through_frozen_uniq_matches_reference():
    """The trainer's a_bits=8 step with the UNIQ transform on: every layer
    FROZEN, so the int8 fake-quant runs on the transform's hard weights."""
    _check_a8_step("adamw", frozen=True)


def test_all_frozen_step_matches_reference():
    """Past the schedule's end every quantized leaf is FROZEN: hard
    k-quantile weights, no gradient, masked in the optimizer: only the
    norms move.  No noise is read."""
    cfg_t = tcb.get_smoke("granite_3_8b")
    jt, tt = _tc("adamw")
    sj0 = jsteps.init_state(jax.random.PRNGKey(3),
                            jcb.get_smoke("granite_3_8b"), jt)
    sj0["step"] = jnp.int32(8)
    batch = _tokens(cfg_t, seed=2)
    sj1, mj = _jax_step("adamw")(sj0, jax.tree_util.tree_map(jnp.asarray,
                                                             batch),
                                 jax.random.PRNGKey(0))
    step_t, sched = tsteps.make_train_step(cfg_t, _topts(), tt)
    assert sched.modes_at(8).tolist() == [FROZEN, FROZEN]
    st = convert.train_state_from_numpy(_np_tree(sj0), device="cpu")
    st, mt = step_t(st, {k: torch.from_numpy(v) for k, v in batch.items()},
                    seed=123)
    # the hard-quantized forward may take another bin where u * k sits on
    # an edge (see test_torch_uniq_noise); the loss is an average over
    # every position, so one flipped code moves it by far less than this
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-4)
    before = _flat_np(sj0)
    got = _flat_np(st)
    for p in before:
        if p.startswith("params/") and "norm" not in p:
            np.testing.assert_array_equal(got[p], before[p], err_msg=p)
    _compare_step(st, mt, sj0, sj1, mj, jax.random.PRNGKey(0),
                  sched.modes_at(8), "adamw", tt)


def test_eval_step_matches_reference():
    cfg_j, cfg_t = jcb.get_smoke("granite_3_8b"), tcb.get_smoke("granite_3_8b")
    pj = _jax_params("granite_3_8b")
    batch = _tokens(cfg_t, seed=5)
    want = jax.jit(jsteps.eval_step(cfg_j, _jopts()), static_argnums=2)(
        pj, jax.tree_util.tree_map(jnp.asarray, batch), 4)
    pt = convert.params_from_numpy(_np_tree(pj), device="cpu")
    got = tsteps.eval_step(cfg_t, _topts())(
        pt, {k: torch.from_numpy(v) for k, v in batch.items()}, 4)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


# --------------------------------------------------------------------------
# Checkpoints across the frameworks
# --------------------------------------------------------------------------

def test_reference_checkpoint_restores_in_the_port_and_steps_on(tmp_path):
    """A state saved by ``repro.checkpoint.save`` after one JAX step
    restores in the port leaf for leaf, and the port's next step (with the
    reference's noise) matches JAX's next step."""
    cfg_t = tcb.get_smoke("granite_3_8b")
    jt, tt = _tc("adamw")
    sj0 = jsteps.init_state(jax.random.PRNGKey(0),
                            jcb.get_smoke("granite_3_8b"), jt)
    b0, b1 = _tokens(cfg_t, seed=6), _tokens(cfg_t, seed=7)
    k0, k1 = jax.random.PRNGKey(10), jax.random.PRNGKey(11)
    step_j = _jax_step("adamw")
    sj1, _ = step_j(sj0, jax.tree_util.tree_map(jnp.asarray, b0), k0)
    jckpt.save(str(tmp_path), 1, sj1, extra={"arch": "granite_3_8b"})

    target = tsteps.init_state(9, cfg_t, tt, device="cpu")
    st, step, extra = tckpt.restore(str(tmp_path), target)
    assert step == 1 and extra == {"arch": "granite_3_8b"}
    got, want = _flat_np(st), _flat_np(sj1)
    assert sorted(got) == sorted(want)
    for p in want:
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)
    assert st["step"].device.type == "cpu" and int(st["step"]) == 1

    sj2, mj = step_j(sj1, jax.tree_util.tree_map(jnp.asarray, b1), k1)
    step_t, sched = tsteps.make_train_step(cfg_t, _topts(), tt)
    st, mt = step_t(st, {k: torch.from_numpy(v) for k, v in b1.items()},
                    seed=0, noise=_ref_noise(k1))
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=TOL_LOSS_REL)
    _compare_step(st, mt, sj1, sj2, mj, k1, sched.modes_at(1), "adamw", tt)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    cfg_t = tcb.get_smoke("granite_3_8b")
    jt, tt = _tc("adamw", total_steps=4)
    st = tsteps.init_state(0, cfg_t, tt, device="cpu")
    step_t, _ = tsteps.make_train_step(cfg_t, _topts(), tt)
    data = tdata.LMStreamConfig(vocab=cfg_t.vocab, seq_len=S, global_batch=B)
    for s in range(2):
        st, _ = step_t(st, tdata.lm_batch(data, s, device="cpu"), seed=0)
    tckpt.save(str(tmp_path), 2, st)
    assert tckpt.latest_step(str(tmp_path)) == 2
    target = jsteps.init_state(jax.random.PRNGKey(1),
                               jcb.get_smoke("granite_3_8b"), jt)
    sj, step, _ = jckpt.restore(str(tmp_path), target)
    assert step == 2
    got, want = _flat_np(sj), _flat_np(st)
    assert sorted(got) == sorted(want)
    for p in want:
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)
    assert sj["step"].dtype == jnp.int32 and int(sj["step"]) == 2
    assert sj["opt"]["count"].dtype == jnp.int32


def test_bf16_leaves_cross_both_ways(tmp_path):
    """bf16 momentum: the reference writes raw 2-byte bf16, the port
    widened f32; each reads the other's back to the same values."""
    tree_t = {"m": torch.tensor([1.5, -0.00390625, 3.0e5],
                                dtype=torch.bfloat16)}
    tckpt.save(str(tmp_path / "t"), 0, tree_t)
    back_j, _, _ = jckpt.restore(str(tmp_path / "t"),
                                 {"m": jnp.zeros(3, jnp.bfloat16)})
    assert back_j["m"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back_j["m"], np.float32),
                                  tree_t["m"].float().numpy())
    jckpt.save(str(tmp_path / "j"), 0, back_j)
    back_t, _, _ = tckpt.restore(str(tmp_path / "j"),
                                 {"m": torch.zeros(3, dtype=torch.bfloat16)})
    assert torch.equal(back_t["m"], tree_t["m"])
    st = convert.train_state_from_numpy(
        {"params": {"w": np.asarray(back_j["m"])}, "step": np.int32(3)},
        device="cpu")
    assert torch.equal(st["params"]["w"], tree_t["m"])


# --------------------------------------------------------------------------
# Replay inside the port, the CLI, and what is not ported
# --------------------------------------------------------------------------

def test_lm_batch_is_a_function_of_seed_and_step():
    cfg = tdata.LMStreamConfig(vocab=97, seq_len=16, global_batch=3, seed=5)
    a = tdata.lm_batch(cfg, 4, device="cpu")
    b = tdata.lm_batch(cfg, 4, device="cpu")
    c = tdata.lm_batch(cfg, 5, device="cpu")
    d = tdata.lm_batch(dataclasses.replace(cfg, seed=6), 4, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["targets"], b["targets"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert not torch.equal(a["tokens"], d["tokens"])
    assert a["tokens"].shape == (3, 16) and a["tokens"].dtype == torch.int32
    assert torch.equal(a["targets"][:, :-1], a["tokens"][:, 1:])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 97
    stream = tdata.lm_stream(cfg, start_step=4, device="cpu")
    assert torch.equal(next(stream)["tokens"], a["tokens"])
    assert torch.equal(next(stream)["tokens"], c["tokens"])


def _run(state, step_fn, data, start, end, seed=7):
    m = None
    for s in range(start, end):
        state, m = step_fn(state, tdata.lm_batch(data, s, device="cpu"),
                           seed=seed)
    return state, m


def test_resumed_run_equals_the_unbroken_run(tmp_path):
    """Four steps straight vs two steps, a checkpoint, a restore into a
    fresh state, two more steps: every leaf equal to the bit.  The
    schedule passes NOISE and CLEAN layers on the way."""
    cfg = tcb.get_smoke("granite_3_8b")
    _, tt = _tc("adamw", total_steps=4)
    data = tdata.LMStreamConfig(vocab=cfg.vocab, seq_len=S, global_batch=B)
    step_fn, _ = tsteps.make_train_step(cfg, _topts(), tt)
    full, m_full = _run(tsteps.init_state(0, cfg, tt, device="cpu"),
                        step_fn, data, 0, 4)
    half, _ = _run(tsteps.init_state(0, cfg, tt, device="cpu"), step_fn,
                   data, 0, 2)
    tckpt.save(str(tmp_path), 2, half)
    restored, step, _ = tckpt.restore(
        str(tmp_path), tsteps.init_state(1, cfg, tt, device="cpu"))
    assert step == 2
    resumed, m_res = _run(restored, step_fn, data, 2, 4)
    assert float(m_full["loss"]) == float(m_res["loss"])
    for (p, a), (_, b) in zip(tree_lib.leaves_with_paths(full),
                              tree_lib.leaves_with_paths(resumed)):
        assert torch.equal(a, b), p


def test_train_cli_runs_checkpoints_and_resumes(tmp_path, capsys):
    args = ["--arch", "granite_3_8b", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq-len", "8", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2", "--log-every", "1"]
    state = tlaunch.main(args + ["--steps", "3"])
    assert int(state["step"]) == 3
    assert tckpt.latest_step(str(tmp_path)) == 3
    out = capsys.readouterr().out
    assert "step     2 loss" in out and "final loss" in out
    state = tlaunch.main(args + ["--steps", "4"])
    assert int(state["step"]) == 4
    assert "resumed from step 3" in capsys.readouterr().out


def test_default_device_is_the_card():
    """The trainer's entry points take device='cuda' by default and raise,
    not fall back, where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tcb.get_smoke("granite_3_8b")
    with pytest.raises(RuntimeError, match="cuda"):
        tsteps.init_state(0, cfg, tsteps.TrainConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        tdata.lm_batch(tdata.LMStreamConfig(vocab=8, seq_len=4,
                                            global_batch=1), 0)
    with pytest.raises(RuntimeError, match="cuda"):
        tlaunch.main(["--arch", "granite_3_8b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        convert.train_state_from_numpy({"step": np.int32(0)})


def test_training_options_of_the_reference_are_ported(capsys):
    # the compressed cross-pod sync is a train config like any other (its
    # step against the reference's: test_torch_distributed.py)
    assert tsteps.TrainConfig(dp_compress_bits=8).dp_compress_bits == 8
    cfg = tcb.get_smoke("granite_3_8b")
    # the per-layer transform inside the layer loop is ported
    # (test_torch_uniq_scan.py)
    assert tsteps.in_scan(cfg, tsteps.TrainConfig(uniq_in_scan=True))
    pt = convert.params_from_numpy(_np_tree(_jax_params("granite_3_8b")),
                                   device="cpu")
    bt = {k: torch.from_numpy(v) for k, v in _tokens(cfg).items()}
    # activation fake-quant (a_bits < 32) is ported: a train step at
    # a_bits=8 agrees with the reference's (loss, gradients through the
    # straight-through estimator, and the update: _compare_step)
    _check_a8_step("adamw")
    # chunked attention is ported: the loss through it is the whole one's
    # (f32, another summation order: 1e-5 relative)
    got = tmodel.loss_fn(pt, cfg, _topts(attn_chunked_min_len=8,
                                         kv_chunk=4), bt)
    want = tmodel.loss_fn(pt, cfg, _topts(), bt)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    # --data-mesh is parsed and not read, as the reference's trainer does:
    # at 2 the CLI trains exactly as at 1 (the same lines but the times)
    runs = []
    for n in ("1", "2"):
        capsys.readouterr()
        tlaunch.main(["--arch", "granite_3_8b", "--smoke", "--device",
                      "cpu", "--steps", "1", "--data-mesh", n])
        runs.append(re.sub(r" [0-9.]+s$", "", capsys.readouterr().out,
                           flags=re.M))
    assert runs[0] == runs[1] and "final loss" in runs[0]
