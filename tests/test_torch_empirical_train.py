"""PyTorch port vs JAX reference: UNIQ training under ``dist="empirical"``
and the remaining surface (``quantize_tree``, ``swiglu``, ``ShapeConfig`` /
``SHAPES`` / ``cell_applicable`` / ``input_specs``).

An empirical leaf (per-tensor, unstacked) is transformed through the CDF of
its sorted (sub)sample: ``u = cdf(w)`` is a ``searchsorted``, so in NOISE
mode the transform passes no gradient to its weight, in both frameworks;
stacked and per-channel leaves stay Gaussian.  The same numpy inputs and
the reference's own U[0, 1) draw go through both.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.core import distributions as jdist
from repro.core import uniq as juniq
from repro.models import layers as jlayers

from repro_torch.configs import base as tcb
from repro_torch.core import noise as tnoise
from repro_torch.core import packing as tpack
from repro_torch.core import uniq as tuniq
from repro_torch.core.distributions import EmpiricalModel
from repro_torch.models import layers as tlayers

from test_torch_uniq_noise import _cmp_train_transform


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
K = 16

# w_hat through the empirical quantile: the same sorted sample of n values
# on both sides; XLA may fuse or reorder u = (idx - 1/2) / n, u + e and
# pos = u n - 1/2, which moves pos by up to TOL_EMP_POS_ULPS ulps of n, and
# the interpolation between neighbours then moves w_hat by that times the
# widest gap between neighbouring order statistics; plus a few f32 ulps
# of the largest |w| for the interpolation's own rounding
TOL_EMP_POS_ULPS = 2
TOL_EMP_ULPS = 4
# codes of quantize_tree's leaves: the codec's flip bound at bin edges
# (test_torch_codec.WEIGHT_CODE_MISMATCH)
WEIGHT_CODE_MISMATCH = 1e-4


def _w(shape, seed=0, scale=0.03):
    r = np.random.default_rng(seed)
    # a heavy-tailed leaf, where an empirical CDF differs from a Gaussian
    return (r.standard_t(4, size=shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _emp_tol(w):
    ref = EmpiricalModel.fit(_t(w)).sorted_ref.numpy()
    n = ref.shape[0]
    return (TOL_EMP_POS_ULPS * n * 2.0 ** -23 * float(np.diff(ref).max())
            + TOL_EMP_ULPS * float(np.abs(w).max()) * 2.0 ** -23)


@functools.partial(jax.jit, static_argnums=(3,))
def _jtransform(w, key, mode, cfg, g):
    """The reference's w_hat and the gradient of sum(w_hat * g)."""
    out, vjp = jax.vjp(lambda a: juniq.transform_param(a, key, mode, cfg), w)
    return out, vjp(g)[0]


@functools.partial(jax.jit, static_argnums=(3,))
def _jtree(params, key, modes, cfg):
    return juniq.transform_tree(params, key, juniq.lm_mode_fn(modes), cfg)


@pytest.mark.parametrize("mode", [NOISE, FROZEN, CLEAN])
@pytest.mark.parametrize("shape", [(24, 40), (300, 260)])
def test_transform_param_empirical_matches_reference(mode, shape):
    """w_hat of an empirical leaf (the larger one is fitted on its strided
    subsample of 65,536), and the gradient of a loss through it: zero in
    NOISE and FROZEN on both sides, the identity in CLEAN."""
    w = _w(shape)
    key = jax.random.PRNGKey(3)
    e01 = np.asarray(jax.random.uniform(key, shape, dtype=jnp.float32))
    cfg_j = juniq.UniqConfig(w_bits=4, dist="empirical", per_channel=False)
    cfg_t = tuniq.UniqConfig(w_bits=4, dist="empirical", per_channel=False)
    g = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    out_j, gj = _jtransform(jnp.asarray(w), key, jnp.int32(mode), cfg_j,
                            jnp.asarray(g))
    wt = _t(w).requires_grad_(True)
    out_t = tuniq.transform_param(wt, _t(e01), torch.tensor(mode), cfg_t)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=0, atol=_emp_tol(w))
    if mode == FROZEN:                     # k levels of the leaf, at most
        assert len(np.unique(out_t.detach().numpy())) <= K
    gj = np.asarray(gj)
    (gt,) = torch.autograd.grad((out_t * _t(g)).sum(), [wt])
    want = g if mode == CLEAN else np.zeros_like(g)
    np.testing.assert_array_equal(gj, want)                   # exact
    np.testing.assert_array_equal(gt.numpy(), want)           # exact


def test_noise_gradient_is_zero_only_under_the_empirical_model():
    """The control: the same NOISE leaf under the Gaussian model has a
    gradient in both frameworks."""
    w = _w((64, 32), seed=4)
    key = jax.random.PRNGKey(0)
    e01 = _t(jax.random.uniform(key, w.shape, dtype=jnp.float32))
    for dist in ("gaussian", "empirical"):
        _, gj = _jtransform(jnp.asarray(w), key, jnp.int32(NOISE),
                            juniq.UniqConfig(dist=dist),
                            jnp.ones(w.shape, jnp.float32))
        wt = _t(w).requires_grad_(True)
        (gt,) = torch.autograd.grad(tuniq.transform_param(
            wt, e01, torch.tensor(NOISE),
            tuniq.UniqConfig(dist=dist)).sum(), [wt])
        nj, nt = float(jnp.linalg.norm(gj)), float(gt.norm())
        if dist == "gaussian":
            assert nj > 1.0 and nt > 1.0
            np.testing.assert_allclose(nt, nj, rtol=1e-3)
        else:
            assert nj == 0.0 and nt == 0.0


def test_empirical_leaf_keeps_the_on_chip_key_path():
    """An int key (the CNN trainer's noise source) draws the leaf's
    U[0, 1) as ``keyed_uniform``: the same result as handing that draw."""
    w = _t(_w((16, 24), seed=5))
    cfg = tuniq.UniqConfig(dist="empirical")
    a = tuniq.transform_param(w, 1234, torch.tensor(NOISE), cfg)
    b = tuniq.transform_param(w, tuniq.keyed_uniform(1234, w),
                              torch.tensor(NOISE), cfg)
    assert torch.equal(a, b)


@pytest.mark.parametrize("per_channel", [False, True])
def test_stacked_and_per_channel_leaves_stay_gaussian(per_channel):
    """Under dist="empirical" the stacked leaf (and every leaf at
    per_channel) takes the Gaussian model in both frameworks: the same
    result as dist="gaussian", to the bit in the port."""
    w = _w((3, 24, 40), seed=6)
    key = jax.random.PRNGKey(2)
    e01 = np.asarray(jax.random.uniform(key, w.shape, dtype=jnp.float32))
    modes = np.array([CLEAN, NOISE, FROZEN], np.int32)
    for stacked in (True, False):
        if not stacked and not per_channel:
            continue                       # the per-tensor empirical case
        cfg_j = juniq.UniqConfig(dist="empirical", per_channel=per_channel)
        assert isinstance(juniq._fit_dist(jnp.asarray(w), cfg_j, stacked),
                          jdist.GaussianModel)
        mode = torch.tensor(modes) if stacked else torch.tensor(NOISE)
        emp, gau = (tuniq.transform_param(
            _t(w), _t(e01), mode, tuniq.UniqConfig(dist=d,
                                                   per_channel=per_channel),
            stacked=stacked) for d in ("empirical", "gaussian"))
        assert torch.equal(emp, gau)


def test_transform_tree_empirical_matches_reference():
    """The LM tree at per_channel=False: the embedding and the head go
    empirical, the stacked layer weight Gaussian; the reference's own
    per-leaf draw handed across."""
    r = np.random.default_rng(8)
    params = {"embed": _w((48, 16), seed=9),
              "layers": {"wq": (r.standard_normal((2, 16, 24)) * 0.03
                                ).astype(np.float32),
                         "attn_norm": np.ones((2, 16), np.float32)},
              "lm_head": _w((16, 48), seed=10)}
    modes = np.array([NOISE, FROZEN], np.int32)
    key = jax.random.PRNGKey(5)
    cfg_j = juniq.UniqConfig(w_bits=4, dist="empirical")
    cfg_t = tuniq.UniqConfig(w_bits=4, dist="empirical")
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    out_j = _jtree(pj, key, jnp.asarray(modes), cfg_j)

    def ref_noise(path, leaf):
        return _t(jax.random.uniform(juniq._fold_path(key, path),
                                     tuple(leaf.shape), dtype=jnp.float32))

    pt = {"embed": _t(params["embed"]), "lm_head": _t(params["lm_head"]),
          "layers": {k: _t(v) for k, v in params["layers"].items()}}
    out_t = tuniq.transform_tree(pt, ref_noise, tuniq.lm_mode_fn(
        torch.tensor(modes)), cfg_t)
    for name in ("embed", "lm_head"):      # NOISE (first block), FROZEN
        np.testing.assert_allclose(out_t[name].numpy(),
                                   np.asarray(out_j[name]), rtol=0,
                                   atol=_emp_tol(params[name]))
    w = params["layers"]["wq"]
    mu = w.mean(axis=(1, 2), keepdims=True, dtype=np.float64)
    sd = w.std(axis=(1, 2), keepdims=True, dtype=np.float64)
    _cmp_train_transform(out_t["layers"]["wq"], out_j["layers"]["wq"], w,
                         np.broadcast_to(mu, w.shape),
                         np.broadcast_to(sd, w.shape),
                         modes.reshape(-1, 1, 1), K)


def test_inject_kquantile_empirical_matches_reference_formula():
    """``core/noise`` under dist="empirical": the port's draw handed to the
    reference's EmpiricalModel (fit, cdf, the 0.5 / k * 1e-3 clip,
    quantile); no gradient reaches w."""
    w = _w((40, 24), seed=11)
    gen = torch.Generator().manual_seed(4)
    wt = _t(w).requires_grad_(True)
    out_t = tnoise.inject_kquantile(wt, gen, K, dist="empirical")
    e = tnoise.uniform_noise(torch.Generator().manual_seed(4), w.shape, K)
    model = jdist.EmpiricalModel.fit(jnp.asarray(w))
    u_hat = jnp.clip(model.cdf(jnp.asarray(w)) + jnp.asarray(e.numpy()),
                     0.5 / K * 1e-3, 1.0 - 0.5 / K * 1e-3)
    np.testing.assert_allclose(out_t.detach().numpy(),
                               np.asarray(model.quantile(u_hat)), rtol=0,
                               atol=_emp_tol(w))
    assert not out_t.requires_grad
    em = EmpiricalModel.fit(wt)
    assert torch.equal(em.sorted_ref, torch.sort(_t(w).reshape(-1)).values)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("per_channel", [True, False])
def test_quantize_tree_matches_reference(bits, per_channel):
    r = np.random.default_rng(12)
    params = {"embed": (r.standard_normal((32, 16)) * 0.05).astype(
                  np.float32),
              "layers": {"wq": (r.standard_normal((2, 16, 24)) * 0.03
                                ).astype(np.float32),
                         "attn_norm": np.ones((2, 16), np.float32)},
              "final_norm": np.ones((16,), np.float32)}
    qj = juniq.quantize_tree(jax.tree_util.tree_map(jnp.asarray, params),
                             bits, per_channel=per_channel)
    pt = {"embed": _t(params["embed"]), "final_norm": _t(
        params["final_norm"]), "layers": {k: _t(v) for k, v in
                                          params["layers"].items()}}
    qt = tuniq.quantize_tree(pt, bits, per_channel=per_channel)
    assert torch.equal(qt["final_norm"], pt["final_norm"])
    assert torch.equal(qt["layers"]["attn_norm"], pt["layers"]["attn_norm"])
    for a, b in ((qj["embed"], qt["embed"]),
                 (qj["layers"]["wq"], qt["layers"]["wq"])):
        assert isinstance(b, tuniq.QuantizedTensor)
        assert (b.bits, b.shape) == (a.bits, tuple(a.shape))
        assert tuple(b.mu.shape) == tuple(a.mu.shape)
        # the statistics: f32 reductions in other orders
        np.testing.assert_allclose(b.mu.numpy(), np.asarray(a.mu),
                                   atol=1e-7)
        np.testing.assert_allclose(b.sigma.numpy(), np.asarray(a.sigma),
                                   rtol=1e-5)
        cj, ct = np.asarray(a.codes), b.codes
        if bits == 4:
            cj = np.asarray(tpack.unpack_int4(torch.from_numpy(cj)))
            ct = tpack.unpack_int4(ct)
        d = np.abs(cj.astype(np.int64) - ct.numpy().astype(np.int64))
        assert d.max() <= 1 and (d > 0).mean() <= WEIGHT_CODE_MISMATCH


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_swiglu_matches_reference(act):
    r = np.random.default_rng(13)
    x = r.standard_normal((2, 5, 16)).astype(np.float32)
    wg, wu = (r.standard_normal((16, 24)).astype(np.float32) * 0.2
              for _ in range(2))
    wd = r.standard_normal((24, 16)).astype(np.float32) * 0.2
    want = np.asarray(jlayers.swiglu(*(jnp.asarray(a) for a in
                                       (x, wg, wu, wd)), act=act))
    got = tlayers.swiglu(*(_t(a) for a in (x, wg, wu, wd)), act=act)
    # f32 matmuls and activations in two frameworks: 1e-5 of the largest
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
    xb = _t(x).to(torch.bfloat16)
    assert tlayers.swiglu(xb, *(_t(a) for a in (wg, wu, wd)),
                          act=act).dtype == torch.bfloat16
    with pytest.raises(ValueError):
        tlayers.swiglu(_t(x), _t(wg), _t(wu), _t(wd), act="relu")


def test_shapes_cells_and_input_specs_match_reference():
    """Every registered arch x SHAPES: applicability and its reason, and
    the input specs' keys, shapes and dtypes (meta tensors: no storage);
    tokens, targets and positions int32 as the reference's."""
    assert list(tcb.SHAPES) == list(jcb.SHAPES)
    for name, sj in jcb.SHAPES.items():
        st = tcb.SHAPES[name]
        assert (st.name, st.seq_len, st.global_batch, st.kind) == \
            (sj.name, sj.seq_len, sj.global_batch, sj.kind)
    assert tcb.ARCH_IDS == jcb.ARCH_IDS
    want_dtype = {jnp.dtype(jnp.int32): torch.int32,
                  jnp.dtype(jnp.bfloat16): torch.bfloat16}
    for arch in jcb.ARCH_IDS:
        cj, ct = jcb.get(arch), tcb.get(arch)
        assert (ct.is_attention_free, ct.sub_quadratic) == \
            (cj.is_attention_free, cj.sub_quadratic)
        for name in jcb.SHAPES:
            assert tcb.cell_applicable(ct, tcb.SHAPES[name]) == \
                jcb.cell_applicable(cj, jcb.SHAPES[name]), (arch, name)
            sj = jcb.input_specs(cj, jcb.SHAPES[name])
            st = tcb.input_specs(ct, tcb.SHAPES[name])
            assert sorted(st) == sorted(sj), (arch, name)
            for key, spec in sj.items():
                t = st[key]
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(spec.shape), (arch, name, key)
                assert t.dtype == want_dtype[jnp.dtype(spec.dtype)]
