"""PyTorch port vs JAX reference: the paper's Table-3 ablation quantizers
(uniform over [-3 sigma, 3 sigma], k-means / Lloyd-Max), their noise
injection (per-bin amplitudes found by ``searchsorted``), the ablation
branch of ``transform_param``, and the BOPs accounting.

The same numpy inputs go to both; the reference draws its noise inside from
a key, so the test draws those bits (``jax.random.uniform(key)``) and hands
them to the port.  What may differ, with the tolerance each comparison
states: ``ndtr`` / ``ndtri`` (torch.special against jax.scipy) by ulps,
magnified by 1 / pdf(z_hat) after the quantile; a weight whose u sits
within rounding of a bin threshold may take the neighbouring bin (another
code, another noise amplitude); Lloyd's centroid sums run in another order.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bops as jbops
from repro.core import noise as jnoise
from repro.core import quantizers as jQ
from repro.core import uniq as juniq
from repro.core.distributions import GaussianModel as JGaussian
from repro.configs import base as jcb

from repro_torch.configs import base as tcb
from repro_torch.core import bops as tbops
from repro_torch.core import noise as tnoise
from repro_torch.core import quantizers as tQ
from repro_torch.core import uniq as tuniq
from repro_torch.core.distributions import GaussianModel as TGaussian


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
# relative error of thresholds / levels computed from the same f32
# statistics (mu +- 3 sigma, a few f32 operations)
TOL_GRID_REL = 1e-6
# Lloyd-Max levels: 25 iterations of centroids summed in another order (a
# one-hot product here and there), relative to sigma
TOL_LLOYD_SIGMA = 1e-5
# NOISE outputs: four ulps of u either side of the transform, magnified by
# 1 / pdf(z_hat), plus the levels' tolerance (as test_torch_uniq_noise)
TOL_NOISE_U = 4 * 2.0 ** -24
TOL_LEVEL_SIGMA = 1e-5
# a weight may take the neighbouring bin only this close to a threshold (in
# u for the noise injection; in grid steps for the uniform codes)
EDGE = 1e-5
EDGE_STEPS = 1e-4


def _w(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.04 + 0.003).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _models(w, channel_axis=None):
    return (JGaussian.fit(jnp.asarray(w), channel_axis=channel_axis),
            TGaussian.fit(_t(w), channel_axis=channel_axis))


# --------------------------------------------------------------------------
# Uniform and k-means quantizers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("channel_axis", [None, -1])
@pytest.mark.parametrize("k", [4, 16])
def test_uniform_quantizer_matches_reference(k, channel_axis):
    w = _w((64, 24), seed=k)
    mj, mt = _models(w, channel_axis)
    thr_j, lev_j = jQ.uniform_thresholds(mj, k)
    thr_t, lev_t = tQ.uniform_thresholds(mt, k)
    assert tuple(thr_t.shape) == thr_j.shape
    assert tuple(lev_t.shape) == lev_j.shape
    scale = float(np.max(np.abs(lev_j)))
    np.testing.assert_allclose(thr_t.numpy(), np.asarray(thr_j), rtol=0,
                               atol=TOL_GRID_REL * scale)
    np.testing.assert_allclose(lev_t.numpy(), np.asarray(lev_j), rtol=0,
                               atol=TOL_GRID_REL * scale)
    c_j = np.asarray(jQ.uniform_quantize(jnp.asarray(w), mj, k))
    c_t = tQ.uniform_quantize(_t(w), mt, k).numpy()
    assert c_t.dtype == np.int8
    # a code may differ only where w sits on a threshold (to rounding)
    sig = np.asarray(mj.sigma)
    step = 6.0 * sig / k
    pos = (w - (np.asarray(mj.mu) - 3 * sig)) / step
    off = c_t != c_j
    assert np.all(np.abs(pos - np.round(pos))[off] < EDGE_STEPS)
    assert off.sum() <= 2
    fq_j = np.asarray(jQ.uniform_fakequant(jnp.asarray(w), mj, k))
    fq_t = tQ.uniform_fakequant(_t(w), mt, k).numpy()
    same = ~off
    np.testing.assert_allclose(fq_t[same], fq_j[same], rtol=0,
                               atol=TOL_GRID_REL * scale)
    np.testing.assert_allclose(
        tQ.uniform_dequantize(_t(c_j), mt, k).numpy(),
        np.asarray(jQ.uniform_dequantize(jnp.asarray(c_j), mj, k)), rtol=0,
        atol=TOL_GRID_REL * scale)


@pytest.mark.parametrize("k", [4, 16])
def test_lloyd_max_matches_reference(k):
    w = _w((40, 50), seed=10 + k)
    lev_j = np.asarray(jQ.lloyd_max(jnp.asarray(w), k))
    lev_t = tQ.lloyd_max(_t(w), k).numpy()
    sig = float(w.std())
    np.testing.assert_allclose(lev_t, lev_j, rtol=0,
                               atol=TOL_LLOYD_SIGMA * sig)
    assert np.all(np.diff(lev_t) > 0)
    # codes and values for one codebook: searchsorted and a gather, exact
    c_j = np.asarray(jQ.levels_quantize(jnp.asarray(w), jnp.asarray(lev_j)))
    c_t = tQ.levels_quantize(_t(w), _t(lev_j)).numpy()
    np.testing.assert_array_equal(c_t, c_j)
    np.testing.assert_array_equal(
        tQ.levels_dequantize(_t(c_t), _t(lev_j)).numpy(),
        np.asarray(jQ.levels_dequantize(jnp.asarray(c_j),
                                        jnp.asarray(lev_j))))
    fq_j = np.asarray(jQ.kmeans_fakequant(jnp.asarray(w), k))
    fq_t = tQ.kmeans_fakequant(_t(w), k).numpy()
    # the same level, or a neighbour where w sits on a Lloyd midpoint
    near = np.abs(fq_t - fq_j) <= TOL_LLOYD_SIGMA * sig
    mid = 0.5 * (lev_j[1:] + lev_j[:-1])
    dist = np.min(np.abs(w[..., None] - mid), axis=-1)
    assert np.all(dist[~near] < 2 * TOL_LLOYD_SIGMA * sig)


@pytest.mark.parametrize("method", ["kquantile", "uniform", "kmeans"])
def test_fakequant_dispatch_matches_reference(method):
    w = _w((32, 16), seed=3)
    fq_j = np.asarray(jQ.fakequant(jnp.asarray(w), 16, method=method))
    fq_t = tQ.fakequant(_t(w), 16, method=method).numpy()
    sig = float(w.std())
    close = np.abs(fq_t - fq_j) <= 2 * TOL_LEVEL_SIGMA * sig
    assert close.mean() >= 1 - 2 / w.size          # an edge at most twice
    with pytest.raises(ValueError):
        tQ.fakequant(_t(w), 16, method="lloyd")


# --------------------------------------------------------------------------
# Noise injection with per-bin amplitudes
# --------------------------------------------------------------------------

def _e01(key, shape):
    return np.asarray(jax.random.uniform(key, shape, dtype=jnp.float32))


def _check_noise(out_t, out_j, u_j, thr_u, mu, sig):
    """NOISE outputs per element, with the tolerance of the docstring; a
    weight whose u sits within EDGE of a threshold may take the other
    bin's amplitude."""
    zh = (out_j - mu) / sig
    pdf = np.exp(-0.5 * np.square(zh)) / math.sqrt(2.0 * math.pi)
    excess = np.abs(out_t - out_j) / sig
    bad = excess > TOL_NOISE_U / pdf + TOL_LEVEL_SIGMA
    dist = np.min(np.abs(u_j[..., None] - np.asarray(thr_u)), axis=-1)
    assert np.all(dist[bad] < EDGE), (excess[bad], dist[bad])
    assert bad.sum() <= 2


@pytest.mark.parametrize("k", [4, 16])
def test_inject_levels_matches_reference(k):
    w = _w((48, 20), seed=20 + k)
    key = jax.random.PRNGKey(k)
    mj, mt = _models(w)
    thr_u = np.sort(np.random.default_rng(k).uniform(0.02, 0.98, k - 1)
                    ).astype(np.float32)
    out_j = np.asarray(jnoise.inject_levels(jnp.asarray(w), key,
                                            jnp.asarray(thr_u), mj))
    out_t = tnoise.inject_levels(_t(w), _t(_e01(key, w.shape)), _t(thr_u),
                                 mt).numpy()
    _check_noise(out_t, out_j, np.asarray(mj.cdf(jnp.asarray(w))), thr_u,
                 float(mj.mu.reshape(())), float(mj.sigma.reshape(())))


@pytest.mark.parametrize("method", ["uniform", "kmeans"])
@pytest.mark.parametrize("k", [4, 16])
def test_ablation_injection_matches_reference(method, k):
    w = _w((3, 3, 8, 16), seed=30 + k)
    key = jax.random.PRNGKey(100 + k)
    mj, mt = _models(w)
    if method == "uniform":
        out_j = jnoise.inject_uniform_quantizer(jnp.asarray(w), key, k)
        out_t = tnoise.inject_uniform_quantizer(_t(w), _t(_e01(key, w.shape)),
                                                k)
        thr, _ = jQ.uniform_thresholds(mj, k)
    else:
        out_j = jnoise.inject_kmeans_quantizer(jnp.asarray(w), key, k)
        out_t = tnoise.inject_kmeans_quantizer(_t(w), _t(_e01(key, w.shape)),
                                               k)
        lev = jQ.lloyd_max(jnp.asarray(w), k)
        thr = 0.5 * (lev[1:] + lev[:-1])
    thr_u = np.asarray(mj.cdf(thr.reshape(-1))).reshape(-1)
    assert out_t.shape == tuple(out_j.shape) and out_t.dtype == torch.float32
    _check_noise(out_t.numpy(), np.asarray(out_j),
                 np.asarray(mj.cdf(jnp.asarray(w))), thr_u,
                 float(mj.mu.reshape(())), float(mj.sigma.reshape(())))


def test_inject_dispatch():
    w = _t(_w((16, 8)))
    for method in ("kquantile", "uniform", "kmeans"):
        out = tnoise.inject(w, torch.Generator().manual_seed(0), 16,
                            method=method)
        assert out.shape == w.shape and torch.isfinite(out).all()
        assert not torch.equal(out, w)
    with pytest.raises(ValueError):
        tnoise.inject(w, torch.Generator().manual_seed(0), 16,
                      method="lloyd")


# --------------------------------------------------------------------------
# transform_param: the ablation branch, forward and gradient
# --------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["uniform", "kmeans"])
def test_transform_param_ablation_matches_reference(method):
    """Each mode through the reference's ``transform_param`` (its leaf key)
    and the port's (the same key's bits handed over), forward and, for
    NOISE, the gradient of a weighted sum."""
    w = _w((3, 3, 4, 8), seed=7)
    key = jax.random.PRNGKey(9)
    cfg_j = juniq.UniqConfig(w_bits=4, method=method)
    cfg_t = tuniq.UniqConfig(w_bits=4, method=method)
    e01 = _t(_e01(key, w.shape))
    cot = np.random.default_rng(1).standard_normal(w.shape).astype(
        np.float32)
    mj, _ = _models(w)
    mu, sig = float(mj.mu.reshape(())), float(mj.sigma.reshape(()))
    fwd_j = jax.jit(lambda wj, m: juniq.transform_param(wj, key, m, cfg_j))
    grad_j = jax.jit(jax.grad(lambda wj, m: jnp.sum(
        juniq.transform_param(wj, key, m, cfg_j) * jnp.asarray(cot))))
    for mode in (CLEAN, NOISE, FROZEN):
        out_j = np.asarray(fwd_j(jnp.asarray(w), jnp.int32(mode)))
        g_j = np.asarray(grad_j(jnp.asarray(w), jnp.int32(mode)))
        wt = _t(w).clone().requires_grad_(True)
        out = tuniq.transform_param(wt, e01, mode, cfg_t)
        (out * _t(cot)).sum().backward()
        out_t, g_t = out.detach().numpy(), wt.grad.numpy()
        if mode == CLEAN:
            np.testing.assert_array_equal(out_t, w)
            np.testing.assert_array_equal(g_t, cot)
        elif mode == FROZEN:
            close = np.abs(out_t - out_j) <= 2 * TOL_LEVEL_SIGMA * sig
            assert close.mean() >= 1 - 2 / w.size
            np.testing.assert_array_equal(g_t, np.zeros_like(cot))
        else:
            zh = np.abs((out_j - mu) / sig)
            pdf = np.exp(-0.5 * zh * zh) / math.sqrt(2.0 * math.pi)
            dzh = TOL_NOISE_U / pdf + TOL_LEVEL_SIGMA
            ok = np.abs(out_t - out_j) / sig <= dzh
            assert ok.mean() >= 1 - 2 / w.size
            # d w_hat / d w = pdf(z) / pdf(z_hat): relative error |zh| dzh
            rel = np.abs(g_t - g_j) / np.maximum(np.abs(g_j), 1e-30)
            assert np.all((rel <= 2 * zh * dzh + 1e-5)[ok])
    # the on-chip source's key draws the ablation noise from a generator
    out_key = tuniq.transform_param(_t(w), 1234, NOISE, cfg_t)
    want = tuniq.transform_param(
        _t(w), tuniq.keyed_uniform(1234, _t(w)), NOISE, cfg_t)
    assert torch.equal(out_key, want)


def test_unknown_method_raises():
    with pytest.raises(ValueError):
        tuniq.transform_param(_t(_w((4, 4))), 1, NOISE,
                              tuniq.UniqConfig(method="lloyd"))


# --------------------------------------------------------------------------
# BOPs
# --------------------------------------------------------------------------

BOPS_ROWS = [("resnet18_imagenet", 32, 32), ("resnet18_imagenet", 4, 8),
             ("mobilenet_v1_imagenet", 32, 32),
             ("mobilenet_v1_imagenet", 8, 8),
             ("resnet18_imagenet", 2, 8), ("resnet18_imagenet", 16, 8)]


@pytest.mark.parametrize("row", BOPS_ROWS, ids=[f"{r[0]}-w{r[1]}a{r[2]}"
                                                for r in BOPS_ROWS])
def test_bops_rows_equal_the_reference(row):
    """The rows of tests/test_substrates.py::TestBops: pure arithmetic in
    the same order, so equal floats."""
    name, b_w, b_a = row
    for qfl in (True, False):
        t = getattr(tbops, name)(b_w, b_a, quantize_first_last=qfl)
        j = getattr(jbops, name)(b_w, b_a, quantize_first_last=qfl)
        assert t.table_row() == j.table_row()
        assert t.compute_bops == j.compute_bops
        assert [(l.name, l.macs, l.n_params) for l in t.layers] == \
            [(l.name, l.macs, l.n_params) for l in j.layers]


def test_bops_table1_and_monotone():
    """The reference's own Table-1 bounds hold for the port's copy."""
    rows = [(tbops.resnet18_imagenet(32, 32), 1920, 374.4),
            (tbops.resnet18_imagenet(4, 8), 93.2, 46.4),
            (tbops.mobilenet_v1_imagenet(32, 32), 626, 135.2),
            (tbops.mobilenet_v1_imagenet(8, 8), 46.7, 33.6)]
    for model_bops, gbops_ref, mbit_ref in rows:
        assert abs(model_bops.gbops - gbops_ref) / gbops_ref < 0.30
        assert abs(model_bops.model_size_mbit - mbit_ref) / mbit_ref < 0.05
    g = [tbops.resnet18_imagenet(b, 8).gbops for b in (2, 4, 8, 16)]
    assert g == sorted(g)


@pytest.mark.parametrize("arch", ["granite_3_8b", "gemma2_9b", "yi_6b"])
def test_lm_bops_on_the_ports_config(arch):
    t = tbops.lm_bops(tcb.get(arch), 4, 8, tokens=16)
    j = jbops.lm_bops(jcb.get(arch), 4, 8, tokens=16)
    assert t.table_row() == j.table_row()
    assert len(t.layers) == len(j.layers)
