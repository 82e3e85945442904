"""PyTorch port vs JAX reference: the paper's CNN trainer.

The reference's parameter trees (narrow ResNet-18, small MobileNet; flat
dicts, HWIO kernels) convert by numpy alone; the same images go through
both networks; one fp step and one QAT step run from one state, with the
reference's own per-leaf noise handed to the port (``NoiseFn``); the
all-FROZEN inference model; the image stream's prototypes; and replay of a
whole tiny ``run_experiment`` inside the port.  Everything runs on the CPU
in f32 at widths 4-8, batch <= 8, 16x16 images, each comparison with its
stated tolerance.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn import cnn as jcnn
from repro.cnn import train as jtrain
from repro.core import uniq as juniq
from repro.data import synthetic as jdata
from repro.optim import optim as joptim

from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.cnn import cnn as tcnn
from repro_torch.cnn import train as ttrain
from repro_torch.configs import mobilenet_cifar, resnet18_cifar
from repro_torch.data import synthetic as tdata
from repro_torch.kernels import ops as tops

CLEAN, NOISE, FROZEN = 0, 1, 2
B, HW = 4, 16

# conv outputs / logits, f32 on both sides: sums over (kh, kw, cin) in
# another order, through up to 20 conv + GroupNorm layers; relative to the
# largest output.
TOL_CONV_REL = 1e-5
TOL_LOGITS_REL = 1e-4
# prototypes: one bilinear upsampling of the same numpy draw, at the
# stream's sizes (8 -> 16, 8 -> 32: the interpolation weights are binary
# fractions, so only the sums' rounding order differs)
TOL_PROTO = 1e-6
# loss of a step (log-softmax of O(1) logits)
TOL_LOSS_REL = 1e-5
# gradients: relative to the tree's largest gradient, not each leaf's: a
# gradient is a sum whose rounding error is of the size of its terms, and
# the scale of a GroupNorm followed by another per-channel GroupNorm lies on
# a nearly scale-invariant direction, so its gradient cancels to ~1e-5 of
# its terms.  A QAT step's forward differs where NOISE outputs do (erf /
# erfinv against ndtr / ndtri, magnified in the tails), which moves every
# gradient a little (as the LM step test states it).
TOL_GRAD_REL = 1e-4
TOL_QAT_GRAD_REL = 5e-4
# NOISE outputs: four ulps of u either side, magnified by 1 / pdf(z_hat),
# plus the levels' tolerance (relative to sigma)
TOL_NOISE_U = 4 * 2.0 ** -24
TOL_LEVEL_SIGMA = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny convolutions run several times faster on one thread than on a
    pool of them (thread start-up per call); restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    """A reference tree as numpy, in its own key order."""
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _ref_params(model, width, seed=0):
    """The reference's init, jitted, in the reference's own key order (a
    jitted function returns its dict sorted: the order is restored).  JAX
    arrays are immutable, so one tree serves every test."""
    init = jcnn.init_resnet18 if model == "resnet18" else jcnn.init_mobilenet
    p = jax.jit(lambda k: init(k, width=width))(jax.random.PRNGKey(seed))
    return {k: p[k] for k in _insertion_order(model, width, list(p))}


def _insertion_order(model, width, keys):
    """The key order of the reference's init (its dict literal order)."""
    own = (tcnn.init_resnet18 if model == "resnet18"
           else tcnn.init_mobilenet)(0, width=width, device="cpu")
    assert sorted(own) == sorted(keys)
    return list(own)


def _port_params(pj):
    return convert.params_from_numpy(_np_tree(pj), device="cpu")


def _images(seed=0, batch=B, hw=HW):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, hw, hw, 3)).astype(np.float32),
            rng.integers(0, 10, size=(batch,)).astype(np.int32))


def _apply(model, width):
    if model == "resnet18":
        return (lambda p, x: jcnn.resnet18_apply(p, x, width=width),
                lambda p, x: tcnn.resnet18_apply(p, x, width=width))
    return (lambda p, x: jcnn.mobilenet_apply(p, x, width=width),
            lambda p, x: tcnn.mobilenet_apply(p, x, width=width))


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------

CONV_CASES = [((2, 32, 32, 8), (3, 3, 8, 16), 2, 1),     # stride-2 SAME
              ((2, 16, 16, 8), (3, 3, 8, 8), 1, 1),
              ((2, 16, 16, 8), (1, 1, 8, 16), 2, 1),     # downsample
              ((2, 7, 9, 4), (3, 3, 4, 6), 2, 1),        # odd sizes
              ((2, 16, 16, 8), (3, 3, 1, 8), 2, 8),      # depthwise
              ((2, 15, 15, 8), (3, 3, 1, 8), 1, 8)]


@pytest.mark.parametrize("case", CONV_CASES,
                         ids=[f"{c[0]}-{c[1]}-s{c[2]}-g{c[3]}"
                              for c in CONV_CASES])
def test_conv2d_same_padding_matches_reference(case):
    """JAX "SAME" pads (0, 1) at stride 2 on an even input: the port pads
    the same way (a symmetric padding=1 would be off by whole products)."""
    xs, ws, stride, groups = case
    rng = np.random.default_rng(1)
    x = rng.standard_normal(xs).astype(np.float32)
    w = rng.standard_normal(ws).astype(np.float32)
    want = np.asarray(jcnn.conv2d(jnp.asarray(x), jnp.asarray(w), stride,
                                  groups))
    got = tcnn.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride,
                      groups).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL_CONV_REL


@pytest.mark.parametrize("C", [3, 8, 12, 16, 20])
def test_group_norm_matches_reference(C):
    rng = np.random.default_rng(C)
    x = (rng.standard_normal((2, 6, 5, C)) * 3 + 1).astype(np.float32)
    s = rng.standard_normal(C).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    want = np.asarray(jcnn.group_norm(jnp.asarray(x), jnp.asarray(s),
                                      jnp.asarray(b)))
    got = tcnn.group_norm(torch.from_numpy(x), torch.from_numpy(s),
                          torch.from_numpy(b)).numpy()
    # f32 mean / variance in another order, normalised values O(1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("model,width", [("resnet18", 4), ("resnet18", 8),
                                         ("mobilenet", 8)])
def test_tree_and_logits_match_reference(model, width):
    """One reference tree, converted by numpy: the same paths, shapes and
    layer order, and the same logits on the same images."""
    pj = _ref_params(model, width)
    pt = _port_params(pj)
    assert list(pt) == list(pj)
    assert tcnn.layer_names(pt) == jcnn.layer_names(pj)
    for (pa, a), (pb, b) in zip(tree_lib.leaves_with_paths(pt),
                                jax.tree_util.tree_flatten_with_path(pj)[0]):
        assert pa == juniq.path_str(pb)
        assert tuple(a.shape) == b.shape
        assert tcnn.cnn_quant_filter(pa, a) == jcnn.cnn_quant_filter(pa, b)
    # the port's own init: the reference's tree structure
    init = tcnn.init_resnet18 if model == "resnet18" else tcnn.init_mobilenet
    own = init(0, width=width, device="cpu")
    assert list(own) == list(pt)
    assert all(tuple(a.shape) == tuple(b.shape) for a, b in zip(
        tree_lib.leaves(own), tree_lib.leaves(pt)))
    x, _ = _images(seed=width)
    fj, ft = _apply(model, width)
    want = np.asarray(jax.jit(fj)(pj, jnp.asarray(x)))
    got = ft(pt, torch.from_numpy(x)).numpy()
    assert got.shape == (B, 10)
    assert _rel(got, want) <= TOL_LOGITS_REL


def test_resnet18_at_published_width_counts():
    """Width 64 (the standard ResNet-18 of the chip run): 21 quantized
    leaves, 11,164,352 weights; the tree only, on the CPU."""
    p = tcnn.init_resnet18(0, width=64, device="cpu")
    assert len(tcnn.layer_names(p)) == 21
    assert tcnn.n_quantized(p) == 11_164_352
    pj = jax.eval_shape(lambda k: jcnn.init_resnet18(k, width=64),
                        jax.random.PRNGKey(0))
    assert sorted(p) == sorted(pj)
    for k in p:
        assert tuple(p[k].shape) == pj[k].shape if k in tcnn.layer_names(p) \
            else True


# --------------------------------------------------------------------------
# Data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed,hw", [(0, 32), (1, 32), (1, 16), (7, 16)])
def test_prototypes_match_reference(seed, hw):
    cj = jdata.ImageStreamConfig(seed=seed, hw=hw)
    ct = tdata.ImageStreamConfig(seed=seed, hw=hw)
    want = jdata._prototypes(cj)
    got = tdata._prototypes(ct)
    assert got.shape == want.shape == (10, hw, hw, 3)
    assert np.max(np.abs(got - want)) <= TOL_PROTO


def test_image_batch_is_a_function_of_seed_and_step():
    cfg = tdata.ImageStreamConfig(batch=6, hw=16, noise=1.5, seed=3)
    x1, y1 = tdata.image_batch(cfg, 5, device="cpu")
    x2, y2 = tdata.image_batch(cfg, 5, device="cpu")
    x3, _ = tdata.image_batch(cfg, 6, device="cpu")
    assert x1.shape == (6, 16, 16, 3) and x1.dtype == torch.float32
    assert y1.shape == (6,) and int(y1.min()) >= 0 and int(y1.max()) < 10
    assert torch.equal(x1, x2) and torch.equal(y1, y2)
    assert not torch.equal(x1, x3)
    # images are the labels' prototypes plus noise of the stated scale
    protos = torch.from_numpy(tdata._prototypes(cfg))
    resid = x1 - protos[y1]
    assert abs(float(resid.std()) - 1.5) < 0.1


# --------------------------------------------------------------------------
# Steps against the reference
# --------------------------------------------------------------------------

def _ref_draws(key, params):
    """The reference's own per-leaf draw: its ``transform_param`` takes
    ``uniform(_fold_path(key, path))``, (e01 - 1/2) / k of these bits."""
    return {p: jax.random.uniform(juniq._fold_path(key, p), tuple(v.shape),
                                  dtype=jnp.float32)
            for p, v in params.items() if not isinstance(v, dict)}


def _noise_fn(draws):
    """A ``NoiseFn`` handing the port those bits."""
    def noise(path, leaf):
        return torch.from_numpy(np.array(draws[path]))
    return noise


def _exp(model="resnet18", width=4, **kw):
    base = dict(model=model, width=width, batch=B, w_bits=4, a_bits=8,
                steps=8, device="cpu")
    base.update(kw)
    return ttrain.CNNExperiment(**base)


def _ref_step(exp, qat, layer_order):
    """The reference's fp / QAT step, as ``repro.cnn.train.run_experiment``
    builds it (its step functions are local to that function), jitted:
    ``step(params, opt_state, x, y, modes, key, lr)``.  ``layer_order`` is
    taken from the tree outside the jit, as the reference does (a traced
    dict comes in sorted-key order)."""
    apply_fn = jtrain._apply_fn(exp)
    ocfg = joptim.OptimConfig(kind="adamw", lr=exp.lr, weight_decay=1e-4,
                              grad_clip=1.0)
    ucfg = juniq.UniqConfig(w_bits=exp.w_bits, a_bits=exp.a_bits,
                            method=exp.method)

    def step(params, opt_state, x, y, modes, key, lr):
        mf = jtrain._mode_fn(layer_order, modes)

        def loss_fn(p):
            if not qat:
                return jtrain._loss(apply_fn, p, x, y, 32), p
            p_eff = juniq.transform_tree(
                p, key, mf, ucfg, quant_filter=jcnn.cnn_quant_filter,
                stacked_prefixes=())
            return jtrain._loss(apply_fn, p_eff, x, y, exp.a_bits), p_eff

        (loss, p_eff), grads = jax.value_and_grad(loss_fn,
                                                  has_aux=True)(params)
        mask = None
        if qat:
            mask = {k: (jax.tree_util.tree_map(
                        lambda _: jnp.ones((), jnp.float32), v)
                        if isinstance(v, dict)
                        or not jcnn.cnn_quant_filter(k, v)
                        else (mf(k) != FROZEN).astype(jnp.float32))
                    for k, v in params.items()}
        new, state, _ = joptim.apply_updates(params, grads, opt_state, ocfg,
                                             lr, freeze_mask=mask)
        return loss, grads, new, p_eff, _ref_draws(key, params)
    return jax.jit(step)


def _jref(exp):
    return jtrain.CNNExperiment(**{k: getattr(exp, k) for k in (
        "model", "width", "w_bits", "a_bits", "method", "steps", "batch",
        "lr", "noise", "n_stages", "iterations", "seed")})


def _grad_tol(g_max, qat):
    return (TOL_QAT_GRAD_REL if qat else TOL_GRAD_REL) * g_max + 1e-12


def _noise_tol(params_np, w_hat, g):
    """Extra per-element gradient tolerance of NOISE leaves (``w_hat``: the
    reference's transformed tree): the factor pdf(z) / pdf(z_hat) inherits
    the forward's z_hat error as |z_hat| * dz_hat relative (twice, one per
    side)."""
    tol = {}
    for name in jcnn.layer_names(params_np):
        w, wh = params_np[name], np.asarray(w_hat[name])
        if np.array_equal(w, wh):
            continue
        zh = np.abs((wh - w.mean(dtype=np.float64)) / w.std(dtype=np.float64))
        pdf = np.exp(-0.5 * zh * zh) / math.sqrt(2.0 * math.pi)
        tol[name] = 2.0 * zh * (TOL_NOISE_U / pdf + TOL_LEVEL_SIGMA) \
            * np.abs(g[name])
    return tol


@pytest.mark.parametrize("kind", ["fp", "qat"])
def test_step_matches_reference(kind):
    """One step from one state (the reference's init and AdamW state,
    converted): loss, gradients, and the updated parameters.  The QAT step
    is step 3 of 42 over ResNet-18's 21 layers (layers 0-2 FROZEN, 3 NOISE,
    the rest CLEAN) with the reference's per-leaf noise handed over; the fp
    step runs MobileNet (depthwise convs).  AdamW's first update is lr *
    sign(g) for |g| >> eps, so where a gradient is within its tolerance of
    zero the two updates may differ by 2 lr."""
    model = "resnet18" if kind == "qat" else "mobilenet"
    exp = _exp(model=model, lr=3e-3, steps=42)
    pj = _ref_params(model, exp.width, seed=2)
    pnp = _np_tree(pj)
    ocfg = joptim.OptimConfig(kind="adamw", lr=exp.lr, weight_decay=1e-4,
                              grad_clip=1.0)
    sj = jax.jit(lambda p: joptim.init_state(p, ocfg))(pj)
    x, y = _images(seed=3)
    key = jax.random.PRNGKey(11)
    trainer = ttrain.CNNTrainer(exp)
    step = 3
    modes = trainer.schedule.modes_at(step) if kind == "qat" else None
    assert modes is None or modes.tolist()[:5] == [2, 2, 2, 1, 0]
    n_layers = len(jcnn.layer_names(pj))
    lr = float(np.float32(exp.lr * 0.5 ** (step / exp.steps * 3)))
    modes_j = jnp.asarray(modes.numpy() if modes is not None else
                          np.zeros(n_layers, np.int32))
    lj, gj, pj1, w_hat, draws = _ref_step(_jref(exp), modes is not None,
                               jcnn.layer_names(pj))(
        pj, sj, jnp.asarray(x), jnp.asarray(y), modes_j, key,
        jnp.float32(lr))
    state = convert.train_state_from_numpy(
        {"params": pnp, "opt": _np_tree(sj)}, device="cpu")
    trainer.params, trainer.opt_state = state["params"], state["opt"]
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    noise = _noise_fn(draws)
    lt, gt = trainer.loss_and_grads(xt, yt, modes,
                                    noise if modes is not None else None)
    np.testing.assert_allclose(float(lt), float(lj), rtol=TOL_LOSS_REL)
    gj_np = {juniq.path_str(kp): np.asarray(v) for kp, v in
             jax.tree_util.tree_flatten_with_path(gj)[0]}
    extra = _noise_tol(pnp, w_hat, gj_np) if modes is not None else {}
    g_max = max(float(np.max(np.abs(g))) for g in gj_np.values())
    for p, g in tree_lib.leaves_with_paths(gt):
        tol = _grad_tol(g_max, modes is not None) + extra.get(p, 0.0)
        np.testing.assert_array_less(np.abs(g.numpy() - gj_np[p]),
                                     tol + 1e-30, err_msg=p)
    # the step itself
    lt2 = (trainer.qat_step(xt, yt, modes, noise, torch.tensor(lr))
           if modes is not None else trainer.fp_step(xt, yt,
                                                     torch.tensor(lr)))
    assert float(lt2) == float(lt)
    pj1 = {juniq.path_str(kp): np.asarray(v) for kp, v in
           jax.tree_util.tree_flatten_with_path(pj1)[0]}
    p0 = {p: v for p, v in [(juniq.path_str(kp), np.asarray(v)) for kp, v in
                            jax.tree_util.tree_flatten_with_path(pj)[0]]}
    for p, v in tree_lib.leaves_with_paths(trainer.params):
        tol = _grad_tol(g_max, modes is not None) + extra.get(p, 0.0)
        small = np.abs(gj_np[p]) <= 2 * tol
        bound = np.where(small, 2.02 * lr, 1e-3 * lr) \
            + 2 * np.spacing(np.abs(p0[p]))
        np.testing.assert_array_less(np.abs(v.numpy() - pj1[p]), bound,
                                     err_msg=p)
        if modes is not None and p in ("conv1", "s0b0_conv0", "s0b0_conv1"):
            np.testing.assert_array_equal(v.numpy(), p0[p])   # FROZEN


def test_frozen_inference_model_matches_reference():
    """The all-FROZEN model (every conv, depthwise ones included, and the
    fc hard-quantized by the k-quantile quantizer): the same weights up to
    the levels' tolerance (a code may flip at a bin edge), and the same
    logits.  The ablation quantizers' FROZEN branch is held to the
    reference in test_torch_quantizers."""
    method = "kquantile"
    exp = _exp(model="mobilenet", width=8, method=method)
    pj = _ref_params("mobilenet", 8, seed=4)
    ucfg = juniq.UniqConfig(w_bits=4, a_bits=8, method=method)
    qj = jax.jit(lambda p: juniq.transform_tree(
        p, jax.random.PRNGKey(0), jnp.int32(FROZEN), ucfg,
        quant_filter=jcnn.cnn_quant_filter, stacked_prefixes=()))(pj)
    trainer = ttrain.CNNTrainer(exp)
    trainer.params = _port_params(pj)
    before = tops.launch_counts()
    qt = trainer.quantized_params()
    assert tops.launch_counts() == before              # CPU: plain versions
    for name in tcnn.layer_names(trainer.params):
        w = np.asarray(pj[name])
        sig = float(w.std())
        diff = np.abs(qt[name].numpy() - np.asarray(qj[name]))
        off = diff > 2 * TOL_LEVEL_SIGMA * sig
        assert off.sum() <= 1, (name, off.sum())
        assert len(np.unique(qt[name].numpy())) <= 16
    x, _ = _images(seed=5)
    fj, ft = _apply("mobilenet", 8)
    want = np.asarray(jax.jit(fj)(qj, jnp.asarray(x)))
    got = ft(qt, torch.from_numpy(x)).numpy()
    assert _rel(got, want) <= TOL_LOGITS_REL


# --------------------------------------------------------------------------
# The port's own runs
# --------------------------------------------------------------------------

def test_run_experiment_replays_bit_for_bit():
    """A whole tiny run twice (fp pre-training, then QAT with the on-chip
    noise source's plain draw): the same losses, parameters, AdamW state and
    accuracy; and stepping a ``CNNTrainer`` by hand is the same run."""
    exp = _exp(width=4, steps=6, pretrain_steps=2, n_stages=3)
    a = ttrain.run_experiment(exp)
    b = ttrain.run_experiment(exp)
    assert a["final_loss"] == b["final_loss"]
    assert a["accuracy"] == b["accuracy"]
    for (p, x), (_, y) in zip(tree_lib.leaves_with_paths(a["params"]),
                              tree_lib.leaves_with_paths(b["params"])):
        assert torch.equal(x, y), p
    tr = ttrain.CNNTrainer(exp)
    losses = [float(tr.step(i)) for i in range(8)]
    assert losses[-1] == a["final_loss"]
    for (p, x), (_, y) in zip(tree_lib.leaves_with_paths(a["params"]),
                              tree_lib.leaves_with_paths(tr.params)):
        assert torch.equal(x, y), p
    for (p, x), (_, y) in zip(
            tree_lib.leaves_with_paths(a["params_quantized"]),
            tree_lib.leaves_with_paths(tr.quantized_params())):
        assert torch.equal(x, y), p
    # the schedule froze every quantized leaf by the end
    assert tr.schedule.modes_at(6).tolist() == [FROZEN] * 21


def test_qat_step_freezes_and_noises_the_right_leaves():
    """Step 1 of 42: conv1 FROZEN (and its AdamW moment kept), s0b0_conv0
    NOISE, the rest CLEAN; norms train throughout."""
    exp = _exp(width=4, steps=42)
    tr = ttrain.CNNTrainer(exp)
    for i in range(2):
        before = {p: t.clone() for p, t in
                  tree_lib.leaves_with_paths(tr.params)}
        m_before = tr.opt_state["mu"]["conv1"]["m"].clone()
        tr.step(i)
    assert torch.equal(tr.params["conv1"], before["conv1"])
    assert torch.equal(tr.opt_state["mu"]["conv1"]["m"], m_before)
    for p in ("s0b0_conv0", "s0b0_conv1", "fc", "norm1/scale"):
        assert not torch.equal(tr.params[p.split("/")[0]]
                               if "/" not in p else
                               tr.params["norm1"]["scale"], before[p]), p


def test_configs_give_the_papers_experiments():
    r = resnet18_cifar.experiment(steps=5, device="cpu")
    m = mobilenet_cifar.experiment()
    assert (r.model, r.width, r.batch, r.lr, r.noise, r.steps) == \
        ("resnet18", 16, 128, 3e-3, 1.2, 5)
    assert (m.model, m.width, m.device) == ("mobilenet", 16, "cuda")
    from repro.configs import mobilenet_cifar as jm
    from repro.configs import resnet18_cifar as jr
    for t, j in ((r, jr.experiment(steps=5)), (m, jm.experiment())):
        for f in ("model", "width", "w_bits", "a_bits", "method", "steps",
                  "batch", "lr", "noise", "n_stages", "iterations", "seed"):
            assert getattr(t, f) == getattr(j, f), f


@pytest.mark.parametrize("argv", [
    ["--model", "resnet18"],
    ["--model", "mobilenet", "--method", "uniform"],
    ["--model", "resnet18", "--method", "kmeans", "--a-bits", "32"]])
def test_cli_runs_on_the_cpu(argv, capsys):
    fp, q = ttrain.main(argv + ["--device", "cpu", "--steps", "4",
                                "--width", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("fp32 baseline     : acc=")
    assert out[1].startswith("UNIQ w4a")
    assert out[2].startswith("accuracy gap: ")
    assert 0.0 <= q["accuracy"] <= 1.0 and math.isfinite(q["final_loss"])


def test_default_device_is_the_card():
    """The CNN entry points take device='cuda' by default and raise, not
    fall back, where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.run_experiment(ttrain.CNNExperiment(width=4, steps=1))
    with pytest.raises(RuntimeError, match="cuda"):
        tcnn.init_resnet18(0, width=4)
    with pytest.raises(RuntimeError, match="cuda"):
        tdata.image_batch(tdata.ImageStreamConfig(batch=2), 0)
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(["--steps", "2", "--width", "4"])


def test_cnn_state_crosses_the_frameworks_both_ways():
    """The reference's params and AdamW state -> the port -> numpy: the
    same values and key order; the port's own state as numpy has the
    reference's tree structure."""
    pj = _ref_params("resnet18", 4, seed=2)
    ocfg = joptim.OptimConfig(kind="adamw", lr=1e-3)
    sj = jax.jit(lambda p: joptim.init_state(p, ocfg))(pj)
    state = convert.train_state_from_numpy(
        {"params": _np_tree(pj), "opt": _np_tree(sj)}, device="cpu")
    pt, st = state["params"], state["opt"]
    assert list(pt) == list(pj) and st["count"].device.type == "cpu"
    back = convert.train_state_to_numpy(state)
    back_p, back_s = back["params"], back["opt"]
    for a, b in ((back_p, _np_tree(pj)), (back_s, _np_tree(sj))):
        fa = jax.tree_util.tree_flatten_with_path(a)[0]
        fb = jax.tree_util.tree_flatten_with_path(b)[0]
        assert [juniq.path_str(k) for k, _ in fa] == \
            [juniq.path_str(k) for k, _ in fb]
        for (_, x), (_, y) in zip(fa, fb):
            np.testing.assert_array_equal(x, y)
    # the port's own state, as numpy, has the reference's structure
    tr = ttrain.CNNTrainer(_exp(width=4))
    own = convert.train_state_to_numpy({"params": tr.params,
                                        "opt": tr.opt_state})
    own_p, own_s = own["params"], own["opt"]
    assert jax.tree_util.tree_structure(own_s) == \
        jax.tree_util.tree_structure(_np_tree(sj))
    assert list(own_p) == list(pj)
