"""PyTorch port vs JAX reference: the UNIQ transform and its gradient.

The same numpy inputs go through the reference's Pallas kernel
``uniq_noise_fwd`` (interpret mode) and the port's ``uniq_noise_fwd`` (its
plain version, on CPU tensors); the gradient goes through ``jax.grad`` of
the reference's ``ops.uniq_transform`` (Pallas, interpret mode, custom VJP)
and torch autograd of the port's ``ops.uniq_transform`` (the backward's
plain version).  Then the training-path callers: ``transform_param`` /
``transform_tree`` with the reference's own noise handed over, and the
unfused ``core/noise`` formulation.

What may differ, and the tolerance each comparison states:

* FROZEN: the port uniformizes with ``erf`` (``z * 1/sqrt2``), the kernel
  of the reference with XLA's ``erf`` (``z / sqrt2``), its training path
  with ``ndtr``: a code flips where ``u * k`` sits within rounding of an
  integer.  Elsewhere the outputs are the same level, which the two compute
  with different ``erfinv`` / ``ndtri``: a few f32 ulps.
* NOISE: ``u`` differs by an ulp or so between the two ``erf``s (~6e-8
  absolute), and Phi^-1 magnifies that by 1 / pdf(z_hat): 5e-4 sigma at
  |z_hat| = 4, 1e-2 sigma at the 1e-6 clamp.  The tolerance is stated per
  element from that, plus the few ulps of the two ``erfinv``s.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import noise as jnoise
from repro.core import uniq as juniq
from repro.core.distributions import GaussianModel as JGaussian
from repro.kernels import ops as jops
from repro.kernels import uniq_noise as jun

from repro_torch.core import noise as tnoise
from repro_torch.core import uniq as tuniq
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import uniq_noise as tun


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread for this module, restored after it: at
    these sizes more threads only add their OpenMP spin-waits, which take
    the cores of the suite's other parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CLEAN, NOISE, FROZEN = 0, 1, 2
MODE_SETS = ([CLEAN] * 3, [NOISE] * 3, [FROZEN] * 3, [CLEAN, NOISE, FROZEN])

# FROZEN / CLEAN levels: the same level computed by two erfinv/ndtri
# implementations, f32: a few ulps of |w_hat| plus the mu + sigma * level
# rounding (stated relative to sigma).
TOL_LEVEL_SIGMA = 1e-5
# A FROZEN code may flip only where u * k is this close to an integer
# (u in f64 from the same f32 inputs); f32 u carries ~6e-8 absolute error.
EDGE = 1e-4
# NOISE: the error of u allowed on either side (four ulps of u near 1),
# carried to w_hat / sigma through 1 / pdf(z_hat); see the docstring.
TOL_NOISE_U = 4 * 2.0 ** -24
# bf16 outputs: both sides round their f32 value to bf16, so two values
# that straddle a rounding boundary land one bf16 ulp apart (8 significant
# bits); beyond that ulp the f32 tolerances above apply.
BF16_BITS = 8


def _bf16_ulp(a, b):
    mag = np.maximum(np.abs(a), np.abs(b))
    return np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.where(
        mag > 0, mag, 1.0))) - (BF16_BITS - 1)), 0.0)


def _inputs(shape, per_col, dtype, seed=0):
    """Gaussian weights with per-group scale and offset, their statistics
    (per column (G,1,C) or per group (G,1,1), f32) and U[0,1) noise."""
    rng = np.random.default_rng(seed)
    G, R, C = shape
    scale = rng.uniform(0.01, 0.05, size=(G, 1, 1)).astype(np.float32)
    w = (rng.standard_normal(shape).astype(np.float32) * scale
         + 0.1 * scale).astype(np.float32)
    if dtype == "bf16":
        w = np.asarray(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))
    axes = (1,) if per_col else (1, 2)
    mu = w.mean(axis=axes, keepdims=True, dtype=np.float64).astype(np.float32)
    sd = np.maximum(w.std(axis=axes, keepdims=True, dtype=np.float64),
                    1e-8).astype(np.float32)
    e01 = rng.random(shape, dtype=np.float32)
    return w, mu, sd, e01


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _to_dtype(w, dtype):
    return (jnp.asarray(w, jnp.bfloat16) if dtype == "bf16"
            else jnp.asarray(w), _t(w, torch.bfloat16 if dtype == "bf16"
                                    else torch.float32))


def _u64(w, mu, sd):
    """Phi((w - mu) / sd) in f64, from the f32 inputs."""
    z = (w.astype(np.float64) - mu) / sd
    return 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))


def _noise_tol_sigma(z_hat):
    """Per-element NOISE tolerance in units of sigma (see TOL_NOISE_U)."""
    pdf = np.exp(-0.5 * np.square(z_hat)) / math.sqrt(2.0 * math.pi)
    return TOL_NOISE_U / pdf + TOL_LEVEL_SIGMA


def _check_fwd(out_t, out_j, w, mu, sd, modes, k, dtype):
    """Compare the port's and the reference's transform output per mode,
    each with its stated tolerance.  Returns the FROZEN flip count."""
    out_t = np.asarray(out_t.to(torch.float32))
    out_j = np.asarray(jnp.asarray(out_j, jnp.float32))
    m = np.asarray(modes).reshape(-1, 1, 1) * np.ones_like(w, dtype=np.int64)
    sig = np.broadcast_to(sd, w.shape)
    diff = np.abs(out_t - out_j)
    step = _bf16_ulp(out_t, out_j) if dtype == "bf16" else 0.0
    excess = np.maximum(diff - step, 0.0) / sig

    clean = m == CLEAN
    np.testing.assert_array_equal(out_t[clean], out_j[clean])
    np.testing.assert_array_equal(out_t[clean], w[clean])

    frozen = m == FROZEN
    off = frozen & (excess > TOL_LEVEL_SIGMA)
    uk = _u64(w, mu, sd) * k
    edge_dist = np.abs(uk - np.round(uk))
    assert np.all(edge_dist[off] < EDGE), \
        f"FROZEN outputs differ away from a bin edge: {edge_dist[off]}"

    noisy = m == NOISE
    if noisy.any():
        zh = (out_j - np.broadcast_to(mu, w.shape)) / sig
        bad = noisy & (excess > _noise_tol_sigma(zh))
        assert not bad.any(), (excess[bad], zh[bad])
    return int(off.sum())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("per_col", [False, True])
@pytest.mark.parametrize("k", [4, 16, 256])
def test_fwd_matches_pallas_kernel(k, per_col, dtype):
    """Every mode alone and all three mixed across G, on a ragged (G, R, C)
    (R = 37, C = 131: no multiple of 8 or 128)."""
    shape = (3, 37, 131)
    w, mu, sd, e01 = _inputs(shape, per_col, dtype, seed=k)
    wj, wt = _to_dtype(w, dtype)
    flips = 0
    for modes in MODE_SETS:
        mode_j = jnp.asarray(modes, jnp.int32)
        out_j = jun.uniq_noise_fwd(wj, jnp.asarray(mu), jnp.asarray(sd),
                                   mode_j, jnp.asarray(e01), k=k,
                                   interpret=True)
        before = tops.launch_counts()
        out_t = tun.uniq_noise_fwd(wt, _t(mu), _t(sd),
                                   _t(np.asarray(modes), torch.int32),
                                   _t(e01), k=k)
        assert tops.launch_counts() == before      # CPU: the plain version
        assert out_t.dtype == wt.dtype and out_t.shape == wt.shape
        flips += _check_fwd(out_t, out_j, w, mu, sd, modes, k, dtype)
    # at most a handful of the 2 x 14537 FROZEN outputs sit on a bin edge
    assert flips <= 4


def test_fwd_larger_groups_match_pallas_kernel():
    """Tile-sized groups, as the reference's own kernel test takes them."""
    shape = (2, 256, 512)
    w, mu, sd, e01 = _inputs(shape, False, "f32", seed=5)
    modes = [NOISE, FROZEN]
    out_j = jun.uniq_noise_fwd(jnp.asarray(w), jnp.asarray(mu),
                               jnp.asarray(sd), jnp.asarray(modes, jnp.int32),
                               jnp.asarray(e01), k=16, interpret=True)
    out_t = tun.uniq_noise_fwd(_t(w), _t(mu), _t(sd),
                               _t(np.asarray(modes), torch.int32), _t(e01),
                               k=16)
    assert _check_fwd(out_t, out_j, w, mu, sd, modes, 16, "f32") <= 8


@pytest.mark.parametrize("per_col", [False, True])
@pytest.mark.parametrize("k", [4, 16, 256])
def test_gradient_matches_jax_custom_vjp(k, per_col):
    """jax.grad through the Pallas forward + custom VJP against torch
    autograd through the port's forward + backward, on the same e01 (drawn
    with jax.random in the test, as the reference's wrapper draws it)."""
    shape = (3, 37, 131)
    w, mu, sd, _ = _inputs(shape, per_col, "f32", seed=10 + k)
    key = jax.random.PRNGKey(k)
    e01 = np.asarray(jax.random.uniform(key, shape, dtype=jnp.float32))
    cot = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    modes = [CLEAN, NOISE, FROZEN]
    mode_j = jnp.asarray(modes, jnp.int32)
    mu_j, sd_j, cot_j = jnp.asarray(mu), jnp.asarray(sd), jnp.asarray(cot)

    def loss_j(wj):
        return jnp.sum(jops.uniq_transform(wj, mu_j, sd_j, mode_j, key, k=k,
                                           use_pallas=True,
                                           interpret=True) * cot_j)

    g_j = np.asarray(jax.grad(loss_j)(jnp.asarray(w)))
    w_hat_j = np.asarray(jops.uniq_transform(
        jnp.asarray(w), mu_j, sd_j, mode_j, key, k=k, use_pallas=True,
        interpret=True))

    wt = _t(w).requires_grad_(True)
    out = tops.uniq_transform(wt, _t(mu), _t(sd), torch.tensor(modes),
                              _t(e01), k=k)
    (out * _t(cot)).sum().backward()
    g_t = wt.grad.numpy()

    np.testing.assert_array_equal(g_t[0], cot[0])           # CLEAN: 1
    np.testing.assert_array_equal(g_t[2], np.zeros_like(cot[2]))  # FROZEN
    # NOISE: g * exp((zh^2 - z^2) / 2); zh comes from each side's own w_hat,
    # so the factor's relative error is |zh| * dzh, with dzh the forward's
    # stated NOISE tolerance.  Entries within dzh of the |zh| = 4.75 rail
    # may be zeroed on one side only.
    zh = np.abs((w_hat_j[1] - mu[1]) / sd[1])
    dzh = _noise_tol_sigma(zh)
    rel = np.abs(g_t[1] - g_j[1]) / np.maximum(np.abs(g_j[1]), 1e-30)
    ok = (rel <= 2 * zh * dzh + 1e-5) | (np.abs(zh - 4.75) <= dzh)
    assert ok.all(), (rel[~ok], zh[~ok])


def test_gradient_bf16_is_rounded_like_the_reference():
    """bf16 weights: the factor is rounded to bf16 before the product, as
    the reference's VJP does (``dw.astype(g.dtype)``)."""
    shape = (2, 8, 16)
    w, mu, sd, e01 = _inputs(shape, False, "bf16", seed=3)
    g = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    w_b, g_b = _t(w, torch.bfloat16), _t(g, torch.bfloat16)
    mode = torch.tensor([NOISE, CLEAN], dtype=torch.int32)
    w_hat = tun.uniq_noise_fwd(w_b, _t(mu), _t(sd), mode, _t(e01), k=16)
    dw = tun.uniq_noise_bwd(g_b, w_b, w_hat, _t(mu), _t(sd), mode)
    assert dw.dtype == torch.bfloat16
    z = (w_b.float() - _t(mu)) / _t(sd)
    zh = (w_hat.float() - _t(mu)) / _t(sd)
    ratio = torch.exp(torch.clamp(0.5 * (zh * zh - z * z), -30, 30))
    ratio = torch.where(zh.abs() >= 4.75, 0.0, ratio)
    want0 = g_b[0] * ratio[0].to(torch.bfloat16)
    assert torch.equal(dw[0], want0)
    assert torch.equal(dw[1], g_b[1])


def test_wrappers_validate_their_operands():
    w, mu, sd, e01 = (_t(x) for x in _inputs((2, 4, 6), False, "f32"))
    mode = torch.tensor([NOISE, FROZEN], dtype=torch.int32)
    with pytest.raises(ValueError):                          # k not 2^n
        tun.uniq_noise_fwd(w, mu, sd, mode, e01, k=12)
    with pytest.raises(ValueError):                          # 2-D weights
        tun.uniq_noise_fwd(w[0], mu, sd, mode, e01, k=16)
    with pytest.raises(ValueError):                          # mode shape
        tun.uniq_noise_fwd(w, mu, sd, mode[:1], e01, k=16)
    with pytest.raises(ValueError):                          # mode dtype
        tun.uniq_noise_fwd(w, mu, sd, mode.long(), e01, k=16)
    with pytest.raises(ValueError):                          # stats shape
        tun.uniq_noise_fwd(w, mu[:, :, :1].expand(2, 2, 1), sd, mode, e01,
                           k=16)
    with pytest.raises(ValueError):                          # noise dtype
        tun.uniq_noise_fwd(w, mu, sd, mode, e01.double(), k=16)
    with pytest.raises(TypeError):                           # weight dtype
        tun.uniq_noise_fwd(w.double(), mu, sd, mode, e01, k=16)
    with pytest.raises(ValueError):                          # g dtype
        tun.uniq_noise_bwd(e01.bfloat16(), w, w, mu, sd, mode)


def test_plain_versions_are_the_oracles():
    """The wrappers' CPU path is ``ref.uniq_transform_ref`` /
    ``ref.uniq_grad_ref``, bit for bit."""
    w, mu, sd, e01 = (_t(x) for x in _inputs((3, 5, 7), True, "f32"))
    mode = torch.tensor([CLEAN, NOISE, FROZEN], dtype=torch.int32)
    out = tun.uniq_noise_fwd(w, mu, sd, mode, e01, k=16)
    assert torch.equal(out, tref.uniq_transform_ref(w, mu, sd, e01, mode, 16))
    g = torch.randn(w.shape, generator=torch.Generator().manual_seed(0))
    assert torch.equal(tun.uniq_noise_bwd(g, w, out, mu, sd, mode),
                       tref.uniq_grad_ref(g, w, out, mu, sd, mode))


# --------------------------------------------------------------------------
# The training path's callers: transform_param / transform_tree / noise
# --------------------------------------------------------------------------

def _cmp_train_transform(out_t, out_j, w, mu, sd, mode_b, k):
    """``transform_param`` (port: the fused formulation) against the
    reference's jnp ``transform_param`` (ndtr / ndtri)."""
    out_t = out_t.detach().numpy()
    out_j = np.asarray(out_j)
    m = np.broadcast_to(np.asarray(mode_b), w.shape)
    sig = np.broadcast_to(sd, w.shape)
    excess = np.abs(out_t - out_j) / sig
    np.testing.assert_array_equal(out_t[m == CLEAN], w[m == CLEAN])
    uk = _u64(w, mu, sd) * k
    off = (m == FROZEN) & (excess > TOL_LEVEL_SIGMA)
    assert np.all(np.abs(uk - np.round(uk))[off] < EDGE)
    assert off.sum() <= 4
    zh = (out_j - np.broadcast_to(mu, w.shape)) / sig
    bad = (m == NOISE) & (excess > _noise_tol_sigma(zh))
    assert not bad.any(), (excess[bad], zh[bad])


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("stacked,shape", [(False, (24, 40)),
                                           (True, (3, 24, 40)),
                                           (False, (3, 24, 40))])
def test_transform_param_matches_reference(stacked, shape, per_channel):
    """A plain 2-D leaf, a stacked leaf with per-layer modes, and a plain
    3-D leaf (grouped along its first axis, one statistic for all)."""
    rng = np.random.default_rng(7)
    w = (rng.standard_normal(shape) * 0.03).astype(np.float32)
    cfg_j = juniq.UniqConfig(w_bits=4, per_channel=per_channel)
    cfg_t = tuniq.UniqConfig(w_bits=4, per_channel=per_channel)
    key = jax.random.PRNGKey(11)
    e01 = np.asarray(jax.random.uniform(key, shape, dtype=jnp.float32))
    mode = np.array([CLEAN, NOISE, FROZEN], np.int32) if stacked \
        else np.int32(NOISE)
    out_j = juniq.transform_param(jnp.asarray(w), key, jnp.asarray(mode),
                                  cfg_j, stacked=stacked)
    out_t = tuniq.transform_param(_t(w), _t(e01), torch.tensor(mode), cfg_t,
                                  stacked=stacked)
    model = juniq._fit_dist(jnp.asarray(w), cfg_j, stacked)
    mu = np.broadcast_to(np.asarray(model.mu), shape)
    sd = np.broadcast_to(np.asarray(model.sigma), shape)
    mode_b = np.asarray(mode).reshape((-1,) + (1,) * (len(shape) - 1)) \
        if stacked else mode
    _cmp_train_transform(out_t, out_j, w, mu, sd, mode_b, 16)
    if not stacked:                                  # and a FROZEN leaf
        out_j = juniq.transform_param(jnp.asarray(w), key,
                                      jnp.int32(FROZEN), cfg_j)
        out_t = tuniq.transform_param(_t(w), _t(e01), torch.tensor(FROZEN),
                                      cfg_t)
        _cmp_train_transform(out_t, out_j, w, mu, sd, FROZEN, 16)


def test_transform_tree_takes_the_reference_noise_per_leaf():
    """The noise hook: the port's ``transform_tree`` fed the reference's
    own per-leaf draw ``uniform(_fold_path(rng, path))`` gives the
    reference's result leaf by leaf."""
    rng = np.random.default_rng(3)
    params = {"embed": rng.standard_normal((32, 16)) * 0.05,
              "layers": {"wq": rng.standard_normal((2, 16, 24)) * 0.03,
                         "attn_norm": np.ones((2, 16))},
              "lm_head": rng.standard_normal((16, 32)) * 0.04}
    params = {k: ({kk: vv.astype(np.float32) for kk, vv in v.items()}
                  if isinstance(v, dict) else v.astype(np.float32))
              for k, v in params.items()}
    modes = np.array([NOISE, FROZEN], np.int32)
    key = jax.random.PRNGKey(5)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    out_j = juniq.transform_tree(pj, key, juniq.lm_mode_fn(
        jnp.asarray(modes)), juniq.UniqConfig(w_bits=4))
    draws = {}

    def ref_noise(path, leaf):
        e = jax.random.uniform(juniq._fold_path(key, path), tuple(leaf.shape),
                               dtype=jnp.float32)
        draws[path] = e
        return _t(np.asarray(e))

    pt = {k: ({kk: _t(vv) for kk, vv in v.items()} if isinstance(v, dict)
              else _t(v)) for k, v in params.items()}
    out_t = tuniq.transform_tree(pt, ref_noise,
                                 tuniq.lm_mode_fn(torch.tensor(modes)),
                                 tuniq.UniqConfig(w_bits=4))
    assert sorted(draws) == ["embed", "layers/wq", "lm_head"]
    assert torch.equal(out_t["layers"]["attn_norm"],
                       pt["layers"]["attn_norm"])
    for path, mode_b in (("embed", NOISE), ("lm_head", FROZEN),
                         ("layers/wq", modes.reshape(-1, 1, 1))):
        keys = path.split("/")
        w = params[keys[0]] if len(keys) == 1 else params[keys[0]][keys[1]]
        oj = out_j[keys[0]] if len(keys) == 1 else out_j[keys[0]][keys[1]]
        ot = out_t[keys[0]] if len(keys) == 1 else out_t[keys[0]][keys[1]]
        stacked = path.startswith("layers")
        axes = tuple(range(1, w.ndim)) if stacked else None
        mu = w.mean(axis=axes, keepdims=True, dtype=np.float64)
        sd = w.std(axis=axes, keepdims=True, dtype=np.float64)
        _cmp_train_transform(ot, oj, w, np.broadcast_to(mu, w.shape),
                             np.broadcast_to(sd, w.shape), mode_b, 16)


def test_leaf_noise_is_keyed_by_seed_step_and_path():
    """Order-independent: the same (seed, step, path) gives the same bits
    whatever else was drawn before; another step or path gives others."""
    leaf = torch.zeros(4, 8)
    a = tuniq.leaf_noise(3, 7)
    first = a("layers/wq", leaf)
    a("embed", leaf)
    assert torch.equal(tuniq.leaf_noise(3, 7)("layers/wq", leaf), first)
    assert not torch.equal(tuniq.leaf_noise(3, 8)("layers/wq", leaf), first)
    assert not torch.equal(a("layers/wk", leaf), first)
    assert first.dtype == torch.float32
    assert float(first.min()) >= 0.0 and float(first.max()) < 1.0


def test_inject_kquantile_matches_reference_formula():
    """The unfused ``core/noise`` transform: the port's draw handed to the
    reference's formula (GaussianModel cdf, clip, quantile)."""
    rng = np.random.default_rng(9)
    w = (rng.standard_normal((40, 24)) * 0.02).astype(np.float32)
    k = 16
    out_t = tnoise.inject_kquantile(_t(w), torch.Generator().manual_seed(4),
                                    k)
    e = tnoise.uniform_noise(torch.Generator().manual_seed(4), w.shape, k)
    assert float(e.abs().max()) <= 0.5 / k
    model = JGaussian.fit(jnp.asarray(w))
    u_hat = jnp.clip(model.cdf(jnp.asarray(w)) + jnp.asarray(e.numpy()),
                     0.5 / k * 1e-3, 1.0 - 0.5 / k * 1e-3)
    out_j = np.asarray(model.quantile(u_hat))
    sig = float(model.sigma.reshape(()))
    # ndtr / ndtri on both sides (torch.special and jax.scipy)
    zh = (out_j - float(model.mu.reshape(()))) / sig
    excess = np.abs(out_t.numpy() - out_j) / sig
    assert (excess <= _noise_tol_sigma(zh)).all()
    # and the reference's own draw, for the shape of the result
    out_ref = jnoise.inject_kquantile(jnp.asarray(w), jax.random.PRNGKey(0),
                                      k)
    assert out_ref.shape == out_t.shape


def test_not_yet_ported_quantizers_raise_plainly():
    """The training half of dist='empirical' runs now (its parity with the
    reference is test_torch_empirical_train's); so do the uniform / k-means
    ablation quantizers (test_torch_quantizers'); an unknown method still
    raises plainly."""
    w = torch.randn(8, 8, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(0)
    for method in ("uniform", "kmeans"):
        out = tnoise.inject(w, gen, 16, method=method)
        assert out.shape == w.shape and torch.isfinite(out).all()
        for mode in (CLEAN, NOISE, FROZEN):
            out = tuniq.transform_param(w, torch.rand(8, 8), mode,
                                        tuniq.UniqConfig(method=method))
            assert out.shape == w.shape and torch.isfinite(out).all()
            assert torch.equal(out, w) == (mode == CLEAN)
    for mode in (NOISE, FROZEN):
        out = tuniq.transform_param(w, torch.rand(8, 8), mode,
                                    tuniq.UniqConfig(dist="empirical"))
        assert out.shape == w.shape and torch.isfinite(out).all()
    out = tnoise.inject_kquantile(w, gen, 16, dist="empirical")
    assert out.shape == w.shape and torch.isfinite(out).all()
    with pytest.raises(ValueError):
        tnoise.inject(w, gen, 16, method="lloyd")
