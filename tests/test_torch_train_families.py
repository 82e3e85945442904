"""PyTorch port vs JAX reference: UNIQ training of the state-space (mamba2,
zamba2), audio (whisper_base) and vlm (pixtral_12b) families.

At the ``*_smoke`` sizes in f32 on the CPU, the reference's init carried
across by ``convert.params_from_numpy``: the loss and every leaf's gradient
against ``jax.value_and_grad(model.loss_fn)`` (the port's remat on and
off); one train step with the reference's own noise against the
reference's step; ``freeze_mask_tree``, each quantized leaf's mode and
statistics (zamba2's unstacked ``shared/*`` and whisper's ``enc_layers/*``
/ ``dec_layers/*`` take ``modes[-1]`` and one statistic over the whole
tensor, as in the reference); the all-FROZEN ``eval_step``; the trainer
CLI (runs, checkpoints, resumes to the unbroken run); and the chunked SSD
scan's gradient where a chunk's decay overflows, which the reference's is
not finite at.
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
from repro.models import ssm as jssm
from repro.optim import optim as joptim
from repro.train import steps as jsteps

from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import base as tcb
from repro_torch.core import uniq as tuniq
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.optim import optim as toptim
from repro_torch.train import steps as tsteps

from test_torch_train import (TOL_GRAD_REL, TOL_LOSS_REL, _close_grads,
                              _compare_step, _flat_np, _jopts, _np_tree,
                              _ref_noise, _tc, _topts)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread for this module, restored after it: at
    these sizes more threads only add their OpenMP spin-waits, which take
    the cores of the suite's other parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ("mamba2_1_3b", "zamba2_2_7b", "whisper_base", "pixtral_12b")
B, S = 2, 12
# encoder frames of the audio batch: another length than the tokens'
TE = 10
# the SSD chunk of both sides: 12 positions in three chunks, the state
# carried across them
SSD_CHUNK = 4
# one train step, the share of each leaf's largest gradient that every
# gradient may differ by (test_torch_train's TOL_STEP_GRAD_REL is 5e-4 for
# granite).  A NOISE weight whose u + e leaves [1e-6, 1 - 1e-6] is clamped
# there, and the port's level for the clamp (f32 erfinv of 2u - 1: z
# -4.7508) sits 2.7e-3 sigma from the reference's (ndtri: -4.7534; ROADMAP
# Queue 3, "near the clamp").  Those few per cent of the NOISE weights move
# the forward, and every other leaf's gradient with it: read up to 2.4e-3
# of the leaf's largest (zamba2's A_log), where the two models' gradients
# at the same transformed weights agree to 3e-6.
TOL_FAMILY_STEP_GRAD_REL = 5e-3
# the step's loss, for the same reason: read up to 2.2e-5 relative (zamba2,
# the first block NOISE), where the loss at the same transformed weights
# agrees to 1e-6; the bound of test_torch_train's all-FROZEN step
TOL_FAMILY_STEP_LOSS_REL = 1e-4


def _batch(cfg, seed=0):
    """tokens / targets (B, S) with ignored targets, and the family's extra
    input: patch embeddings (B, n_patches, d) or frames (B, TE, d), drawn
    (the trainer CLI feeds zeros)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(B, S)).astype(
        np.int32),
             "targets": rng.integers(0, cfg.vocab, size=(B, S)).astype(
        np.int32)}
    batch["targets"][0, -3:] = -1
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    elif cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (B, TE, cfg.d_model)).astype(np.float32)
    return batch


def _jo():
    return dataclasses.replace(_jopts(), ssd_chunk=SSD_CHUNK)


def _to(**kw):
    return _topts(ssd_chunk=SSD_CHUNK, **kw)


def _jbatch(batch):
    return jax.tree_util.tree_map(jnp.asarray, batch)


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jmodel.init(jax.random.PRNGKey(0), jcb.get_smoke(arch))


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch):
    cfg = jcb.get_smoke(arch)
    batch = _jbatch(_batch(cfg))
    loss, g = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, cfg, _jo(), batch)))(_jax_params(arch))
    return float(loss), _flat_np(g)


# --------------------------------------------------------------------------
# The loss and its gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, remat):
    """``model.loss_fn`` and the gradient of every leaf, the reference's
    init carried across: chunked cross-entropy over 12 positions in chunks
    of 8 with ignored targets, three SSD chunks (ssm / hybrid), the shared
    block after every second layer (zamba2), the encoder over 10 frames
    (whisper), 8 patches ahead of the tokens (pixtral)."""
    cfg = tcb.get_smoke(arch)
    loss_j, g_j = _jax_loss_and_grads(arch)
    pt = convert.params_from_numpy(_np_tree(_jax_params(arch)), device="cpu")
    leaves = list(tree_lib.leaves_with_paths(pt))
    for _, t in leaves:
        t.requires_grad_(True)
    loss_t = tmodel.loss_fn(pt, cfg, _to(remat=remat), _tbatch(_batch(cfg)))
    grads = torch.autograd.grad(loss_t, [t for _, t in leaves])
    np.testing.assert_allclose(float(loss_t), loss_j, rtol=TOL_LOSS_REL)
    got = {p: g.numpy() for (p, _), g in zip(leaves, grads)}
    assert sorted(got) == sorted(g_j)
    assert all(np.isfinite(g).all() for g in got.values())
    _close_grads(got, g_j)


# --------------------------------------------------------------------------
# One train step, the reference's state and noise carried across
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_step(arch):
    jt, _ = _tc("adamw")
    fn, _ = jsteps.make_train_step(jcb.get_smoke(arch), _jo(), jt)
    return jax.jit(fn)


def _last_block_noise_step(sched):
    """The first step whose NOISE block is the last one: the LM head (and
    zamba2's shared block, whisper's two stacks) get NOISE, every earlier
    layer (and the embedding) FROZEN."""
    return sched.steps_per_stage * (sched.n_blocks - 1)


def _quantized_paths(params):
    return sorted(p for p, t in tree_lib.leaves_with_paths(params)
                  if tuniq.default_quant_filter(p, t))


@pytest.mark.parametrize("when", ["first_block", "last_block"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_with_noise_matches_reference(arch, when):
    """One AdamW step of 8 at step 0 (the first block NOISE with the
    embedding, the rest CLEAN) or at the step where the last block is
    NOISE (everything before it FROZEN): the reference's per-leaf noise is
    handed to the port, which draws it for every quantized leaf; state,
    metrics and update within ``test_torch_train._compare_step``'s
    tolerances."""
    cfg_t = tcb.get_smoke(arch)
    jt, tt = _tc("adamw")
    step_t, sched = tsteps.make_train_step(cfg_t, _to(), tt)
    step = 0 if when == "first_block" else _last_block_noise_step(sched)
    modes = sched.modes_at(step)
    assert 1 in modes.tolist()
    sj0 = jsteps.init_state(jax.random.PRNGKey(0), jcb.get_smoke(arch), jt)
    sj0["step"] = jnp.int32(step)
    batch = _batch(cfg_t, seed=1)
    key = jax.random.PRNGKey(42)
    sj1, mj = _jax_step(arch)(sj0, _jbatch(batch), key)
    st = convert.train_state_from_numpy(_np_tree(sj0), device="cpu")
    draws = []
    st, mt = step_t(st, _tbatch(batch), seed=0, noise=_ref_noise(key, draws))
    assert sorted(draws) == _quantized_paths(st["params"])
    assert np.isfinite(float(mt["loss"]))
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=TOL_FAMILY_STEP_LOSS_REL)
    _compare_step(st, mt, sj0, sj1, mj, key, modes, "adamw", tt,
                  grad_rel=TOL_FAMILY_STEP_GRAD_REL)


# --------------------------------------------------------------------------
# Modes, statistics and masks of each leaf
# --------------------------------------------------------------------------

# the leaves the reference does not stack (no ``layers`` prefix): one mode
# (the last block's) and one statistic over the whole tensor each
UNSTACKED = {"zamba2_2_7b": "shared/", "whisper_base": ("enc_layers/",
                                                        "dec_layers/")}


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_modes_statistics_and_masks_match_reference(arch):
    """For every quantized leaf: its mode from ``lm_mode_fn`` and its
    Gaussian statistics as ``transform_tree`` fits them (stacked by the
    ``layers`` prefix) equal the reference's; ``freeze_mask_tree`` equal
    at every step of the schedule.  Pinned: ``layers/*`` take the (L,)
    vector and per-layer statistics; zamba2's ``shared/*`` and whisper's
    ``enc_layers/*`` / ``dec_layers/*`` take ``modes[-1]`` and one
    statistic over the whole tensor; the embedding ``modes[0]``."""
    cfg = tcb.get_smoke(arch)
    pj = _jax_params(arch)
    pt = convert.params_from_numpy(_np_tree(pj), device="cpu")
    flat_j = _flat_np(pj)
    sched = juniq.GradualSchedule(cfg.n_layers, cfg.n_layers, 8)
    ucfg_t, ucfg_j = tuniq.UniqConfig(w_bits=4), juniq.UniqConfig(w_bits=4)
    unstacked = UNSTACKED.get(arch, ())
    seen_unstacked = 0
    for step in range(10):
        modes = sched.modes_at(step)
        mt = torch.from_numpy(np.asarray(modes))
        mode_j, mode_t = juniq.lm_mode_fn(modes), tuniq.lm_mode_fn(mt)
        for p in _quantized_paths(pt):
            want = np.asarray(mode_j(p))
            np.testing.assert_array_equal(np.asarray(mode_t(p)), want, p)
            if p.startswith("layers"):
                assert want.shape == (cfg.n_layers,), p
            elif p.startswith("embed"):
                assert int(want) == int(modes[0]), p
            else:
                assert want.shape == () and int(want) == int(modes[-1]), p
        want = _flat_np(jsteps.freeze_mask_tree(pj, modes))
        got = {p: v.numpy() for p, v in tree_lib.leaves_with_paths(
            tsteps.freeze_mask_tree(pt, mt))}
        assert sorted(got) == sorted(want)
        for p in want:
            np.testing.assert_array_equal(got[p], want[p], err_msg=p)
    leaves = dict(tree_lib.leaves_with_paths(pt))
    for p in _quantized_paths(pt):
        w = leaves[p]
        stacked = p.startswith("layers")
        gt = tuniq._fit_dist(w, ucfg_t, stacked)
        gj = juniq._fit_dist(jnp.asarray(flat_j[p]), ucfg_j, stacked)
        for name in ("mu", "sigma"):
            a, b = getattr(gt, name).numpy(), np.asarray(getattr(gj, name))
            assert a.shape == b.shape, (p, name)
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{p} {name}")
        n_stats = gt.mu.numel()
        assert n_stats == (cfg.n_layers if stacked else 1), p
        if p.startswith(unstacked):
            seen_unstacked += 1
    assert seen_unstacked == {"zamba2_2_7b": 7, "whisper_base": 16}.get(
        arch, 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_eval_step_matches_reference(arch):
    """The all-FROZEN eval: every quantized weight hard-quantized, one
    loss; within the bound of ``test_torch_train``'s eval (a code that
    flips at a bin edge moves the loss by far less)."""
    cfg_j, cfg_t = jcb.get_smoke(arch), tcb.get_smoke(arch)
    batch = _batch(cfg_t, seed=5)
    want = jax.jit(jsteps.eval_step(cfg_j, _jo()), static_argnums=2)(
        _jax_params(arch), _jbatch(batch), 4)
    pt = convert.params_from_numpy(_np_tree(_jax_params(arch)), device="cpu")
    got = tsteps.eval_step(cfg_t, _to())(pt, _tbatch(batch), 4)
    assert np.isfinite(float(got))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


# --------------------------------------------------------------------------
# The trainer CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_checkpoints_and_resumes(arch, tmp_path, capsys):
    """The CLI on ``--device cpu --smoke``: four steps straight, and two
    steps, a checkpoint and a resumed run to four; the two end states equal
    to the bit, every loss finite."""
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--seq-len", "8", "--ckpt-every", "2", "--log-every", "1"]
    full = tlaunch.main(args + ["--ckpt-dir", str(tmp_path / "a"),
                                "--steps", "4"])
    out = capsys.readouterr().out
    assert "step     3 loss" in out and "final loss" in out
    assert "nan" not in out.lower()
    tlaunch.main(args + ["--ckpt-dir", str(tmp_path / "b"), "--steps", "2"])
    assert tckpt.latest_step(str(tmp_path / "b")) == 2
    resumed = tlaunch.main(args + ["--ckpt-dir", str(tmp_path / "b"),
                                   "--steps", "4"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert int(resumed["step"]) == int(full["step"]) == 4
    for (p, a), (_, b) in zip(tree_lib.leaves_with_paths(full),
                              tree_lib.leaves_with_paths(resumed)):
        assert torch.equal(a, b), p


def test_train_batch_feeds_the_reference_trainers_extra_inputs():
    """The CLI's batches: zero f32 patch embeddings (B, n_patches, d) at
    the vlm, zero f32 frames (B, S, d) at audio, tokens only elsewhere;
    and ``ssd_chunk`` 16, the reference trainer's."""
    from repro_torch.data.synthetic import LMStreamConfig
    for arch, extra in (("pixtral_12b", "patch_embeds"),
                        ("whisper_base", "frames"), ("mamba2_1_3b", None)):
        cfg = tcb.get_smoke(arch)
        dcfg = LMStreamConfig(vocab=cfg.vocab, seq_len=8, global_batch=3)
        batch = tlaunch.train_batch(cfg, dcfg, 0, "cpu")
        assert sorted(batch) == sorted(["tokens", "targets"]
                                       + ([extra] if extra else []))
        if extra:
            t = batch[extra]
            rows = cfg.n_patches if extra == "patch_embeds" else 8
            assert tuple(t.shape) == (3, rows, cfg.d_model)
            assert t.dtype == torch.float32 and not t.any()
    _, opts, _ = tlaunch.setup(tlaunch.parse_args(["--arch", "mamba2_1_3b"]))
    assert opts.ssd_chunk == 16 and opts.compute_dtype == torch.float32


def test_moe_training_still_raises():
    """MoE training is ported (test_torch_moe_train.py): ``loss_fn`` gives
    kimi_k2 a finite loss.  What still raises is ``lm.forward_train`` on a
    family it does not train, naming the family."""
    from repro_torch.models import lm as tlm
    cfg = tcb.get_smoke("kimi_k2_1t_a32b")
    pt = tmodel.init(0, cfg, device="cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.long),
             "targets": torch.zeros((1, 4), dtype=torch.long)}
    assert torch.isfinite(tmodel.loss_fn(pt, cfg, _to(), batch))
    with pytest.raises(NotImplementedError, match="'ssm'"):
        tlm.forward_train(pt, tcb.get_smoke("mamba2_1_3b"), _to(), batch)


def test_whisper_grad_norm_overflows_on_zero_frames_in_both_frameworks():
    """The trainer CLI's zero frames through whisper_base's encoder depth
    (6 layers, at the smoke width): every row the encoder normalizes is 0,
    and each LayerNorm scales the gradient by up to 1 / sqrt(eps), so its
    norm biases get gradients of ~1e31.  Every element is finite and the
    port's equal the reference's; the f32 global norm overflows to inf in
    both, so the trainer's clip zeroes the whole update in both."""
    enc_layers = jcb.get("whisper_base").enc_layers
    cfg_j = dataclasses.replace(jcb.get_smoke("whisper_base"),
                                enc_layers=enc_layers)
    cfg_t = dataclasses.replace(tcb.get_smoke("whisper_base"),
                                enc_layers=enc_layers)
    batch = _batch(cfg_t)
    batch["frames"] = np.zeros((B, S, cfg_t.d_model), np.float32)
    pj = jmodel.init(jax.random.PRNGKey(0), cfg_j)
    jb = _jbatch(batch)
    g_j = jax.jit(jax.grad(lambda p: jmodel.loss_fn(p, cfg_j, _jo(), jb)))(
        pj)
    norm_j = float(joptim.global_norm(g_j))
    pt = convert.params_from_numpy(_np_tree(pj), device="cpu")
    leaves = list(tree_lib.leaves_with_paths(pt))
    for _, t in leaves:
        t.requires_grad_(True)
    loss_t = tmodel.loss_fn(pt, cfg_t, _to(), _tbatch(batch))
    got = dict(zip((p for p, _ in leaves),
                   torch.autograd.grad(loss_t, [t for _, t in leaves])))
    norm_t = float(toptim.global_norm(got))
    want = _flat_np(g_j)
    assert all(np.isfinite(g).all() for g in want.values())
    assert all(bool(torch.isfinite(g).all()) for g in got.values())
    assert max(float(np.abs(g).max()) for g in want.values()) > 1e19
    assert norm_j == norm_t == float("inf")
    _close_grads({p: g.numpy() for p, g in got.items()}, want)


# --------------------------------------------------------------------------
# The SSD scan's gradient where a chunk's decay overflows
# --------------------------------------------------------------------------

# 64 heads with A = 1 ... 64 (mamba2_1_3b's), dt 0.1 at the top of the
# init's range, chunks of 16 (the trainer's): dt * A * 15 reaches 96, and
# exp(96) overflows f32 above the diagonal of the (Q, Q) decay
OVERFLOW_NH, OVERFLOW_HD, OVERFLOW_N, OVERFLOW_S = 64, 4, 8, 32
# the port's gradient at chunk 16 against the reference's of the same
# function at chunk 1 (no product above a diagonal): a different order of
# the f32 sums and products over 32 positions; relative to each input's
# largest gradient
TOL_SSD_GRAD_REL = 1e-4


def _overflow_inputs(seed=0):
    rng = np.random.default_rng(seed)
    shape = (1, OVERFLOW_S)
    return {"x": rng.standard_normal(shape + (OVERFLOW_NH, OVERFLOW_HD)
                                     ).astype(np.float32),
            "dt": np.full(shape + (OVERFLOW_NH,), 0.1, np.float32),
            "A_log": np.log(np.arange(1, OVERFLOW_NH + 1, dtype=np.float32)),
            "Bm": rng.standard_normal(shape + (OVERFLOW_N,)).astype(
                np.float32),
            "Cm": rng.standard_normal(shape + (OVERFLOW_N,)).astype(
                np.float32),
            "D": np.ones((OVERFLOW_NH,), np.float32)}


NAMES = ("x", "dt", "A_log", "Bm", "Cm", "D")


def _jax_ssd_grads(inputs, chunk):
    def f(*args):
        y, h = jssm.ssd_scan(*args, chunk=chunk)
        return jnp.sum(y * y) + jnp.sum(h)
    return jax.grad(f, argnums=tuple(range(6)))(
        *(jnp.asarray(inputs[n]) for n in NAMES))


def _ssd_scan_before_repair(x, dt, A_log, Bm, Cm, D, chunk):
    """``models/ssm.py:ssd_scan`` as it was before the exponent was masked:
    the (Q, Q) decay over the whole square, selected after the product."""
    Bsz, S, nh, hd = x.shape
    n = Bm.shape[-1]
    nc = S // chunk
    la = dt.float() * -torch.exp(A_log.float())
    xc = x.reshape(Bsz, nc, chunk, nh, hd)
    dtc = dt.float().reshape(Bsz, nc, chunk, nh)
    lac = la.reshape(Bsz, nc, chunk, nh)
    Bc = Bm.reshape(Bsz, nc, chunk, n).float()
    Cc = Cm.reshape(Bsz, nc, chunk, n).float()
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))[
        None, :, :, None]
    h = torch.zeros((Bsz, nh, hd, n))
    ys = []
    for c in range(nc):
        xb, dtb, Bb, Cb = xc[:, c].float(), dtc[:, c], Bc[:, c], Cc[:, c]
        cs = torch.cumsum(lac[:, c], dim=1)
        cb = torch.einsum("bin,bjn->bij", Cb, Bb)
        dec = torch.exp(cs[:, :, None] - cs[:, None, :])
        sc = torch.where(mask, cb[..., None] * dec * dtb[:, None],
                         torch.zeros(()))
        y_intra = torch.einsum("bijh,bjhd->bihd", sc, xb)
        y_inter = torch.einsum("bin,bhdn,bih->bihd", Cb, h, torch.exp(cs))
        tot = cs[:, -1]
        w = torch.exp(tot[:, None] - cs) * dtb
        dh = torch.einsum("bjh,bjn,bjhd->bhdn", w, Bb, xb)
        h = torch.exp(tot)[..., None, None] * h + dh
        ys.append((y_intra + y_inter).to(x.dtype))
    y = torch.stack(ys, dim=1).reshape(Bsz, S, nh, hd)
    return y + x * D.to(x.dtype)[None, None, :, None], h


def test_ssd_scan_gradient_is_finite_where_a_chunk_decay_overflows():
    """Chunks of 16, A up to 64, dt 0.1: the reference's gradient through
    ``ssd_scan`` is not finite (``0 * exp(inf)`` in the backward of its
    masked product: the record of its defect, ROADMAP Queue 3).  The port
    masks the exponent first: its gradient is finite and equals the
    reference's gradient of the same function at chunk 1, where no
    product lies above a diagonal; its forward is bit-equal to the scan
    before the repair."""
    inputs = _overflow_inputs()
    ref16 = _jax_ssd_grads(inputs, 16)
    assert not all(np.isfinite(np.asarray(g)).all() for g in ref16)
    ref1 = [np.asarray(g) for g in _jax_ssd_grads(inputs, 1)]
    assert all(np.isfinite(g).all() for g in ref1)
    args = [torch.from_numpy(inputs[n]).requires_grad_(True) for n in NAMES]
    y, h = tssm.ssd_scan(*args, chunk=16)
    with torch.no_grad():
        y0, h0 = _ssd_scan_before_repair(*args, chunk=16)
    assert torch.equal(y, y0) and torch.equal(h, h0)
    grads = torch.autograd.grad(torch.sum(y * y) + torch.sum(h), args)
    for name, g, want in zip(NAMES, grads, ref1):
        g = g.numpy()
        assert np.isfinite(g).all(), name
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(g, want,
                                   atol=TOL_SSD_GRAD_REL * scale + 1e-9,
                                   err_msg=name)
