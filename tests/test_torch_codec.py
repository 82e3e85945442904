"""PyTorch port vs JAX reference: packing, the k-quantile codec, the
weight quantizer, the KV codec and the byte accounting.

Same numpy inputs (from a seed) go through both packages on the CPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.core import distributions as jdist
from repro.core import packing as jpack
from repro.core import quantizers as jquant
from repro.core import uniq as juniq
from repro.kernels import ref as jref
from repro.models import kv_cache as jkv

from repro_torch.configs import base as tcb
from repro_torch.core import distributions as tdist
from repro_torch.core import packing as tpack
from repro_torch.core import quantizers as tquant
from repro_torch.core import uniq as tuniq
from repro_torch.kernels import ref as tref
from repro_torch.models import kv_cache as tkv

from test_torch_kquantile import flip_report


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread for this module, restored after it: at
    these sizes more threads only add their OpenMP spin-waits, which take
    the cores of the suite's other parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# Codes flip where the two frameworks' CDFs differ in the last ulp at a bin
# edge.  Measured on these tensors: <= 6e-6 (weights, ndtr) and <= 8e-5 (KV
# rows, erf, including rows whose bf16 sigma landed one ulp apart); never
# by more than one code.
WEIGHT_CODE_MISMATCH = 1e-4
KV_CODE_MISMATCH = 5e-4

ARCHS = ("granite_3_8b", "gemma2_9b", "yi_6b")


def _rng(seed=0):
    return np.random.default_rng(seed)


def _codes_close(cj, ct, bound, inputs=None):
    """As ``test_torch_kquantile._codes_close``: with ``inputs`` (w, mu,
    sigma, k) a failure lists every flipped element (``flip_report``)."""
    d = np.abs(cj.astype(np.int64) - ct.astype(np.int64))
    ok = d.max() <= 1 and (d > 0).mean() <= bound
    why = "" if ok or inputs is None else "\n" + flip_report(cj, ct, inputs)
    assert d.max() <= 1, "a code is off by more than one bin" + why
    assert (d > 0).mean() <= bound, f"mismatch rate {(d > 0).mean():.2e}" \
        + why


# -- packing ---------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 6), (3, 5, 8), (2, 2, 3, 16)])
def test_pack_int4_bit_equal(shape):
    # values beyond a nibble on purpose: both packers must mask them
    codes = _rng(1).integers(0, 64, size=shape)
    pj = np.asarray(jpack.pack_int4(jnp.asarray(codes)))
    pt = tpack.pack_int4(torch.from_numpy(codes))
    assert pt.dtype == torch.uint8
    np.testing.assert_array_equal(pj, pt.numpy())          # bit-equal
    uj = np.asarray(jpack.unpack_int4(jnp.asarray(pj)))
    ut = tpack.unpack_int4(pt)
    assert ut.dtype == torch.int8
    np.testing.assert_array_equal(uj, ut.numpy())
    np.testing.assert_array_equal(ut.numpy(), codes & 0x0F)


def test_pack_int4_rejects_odd_last_dim():
    with pytest.raises(ValueError):
        tpack.pack_int4(torch.zeros((2, 3), dtype=torch.int32))


@pytest.mark.parametrize("bits", [4, 8])
def test_packed_shape_and_storage_dtype(bits):
    shape = (3, 10, 8)
    assert tpack.packed_shape(shape, bits) == jpack.packed_shape(shape, bits)
    want = {4: torch.uint8, 8: torch.int8}[bits]
    assert tpack.storage_dtype(bits) == want
    assert np.dtype(jpack.storage_dtype(bits)).name == \
        str(want).replace("torch.", "")
    with pytest.raises(ValueError):
        tpack.packed_shape(shape, 3)
    with pytest.raises(ValueError):
        tpack.storage_dtype(16)


# -- codec (kernels/ref.py) ------------------------------------------------

@pytest.mark.parametrize("k", [16, 256])
def test_level_table(k):
    tj = np.asarray(jref.level_table(k))
    tt = tref.level_table(k)
    assert tt.dtype == torch.float32 and tt.shape == (k,)
    np.testing.assert_allclose(tt.numpy(), tj, atol=1e-6, rtol=0)
    assert tref.code_offset(k) == jref.code_offset(k)


def test_phi_and_phi_inv():
    z = _rng(2).standard_normal(4096).astype(np.float32) * 2
    # two f32 erf implementations: a few ulps of a value in (0, 1)
    np.testing.assert_allclose(tref.phi(torch.from_numpy(z)).numpy(),
                               np.asarray(jref.phi(jnp.asarray(z))),
                               atol=3e-7, rtol=0)
    u = _rng(3).uniform(1e-4, 1 - 1e-4, 4096).astype(np.float32)
    # erfinv near the tails amplifies the last ulp of u
    np.testing.assert_allclose(tref.phi_inv(torch.from_numpy(u)).numpy(),
                               np.asarray(jref.phi_inv(jnp.asarray(u))),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("k", [16, 256])
def test_kquantile_codes_and_dequant(k):
    r = _rng(4)
    w = (r.standard_normal((3, 64, 48)) * 0.05).astype(np.float32)
    mu = w.mean(axis=1, keepdims=True)
    sd = w.std(axis=1, keepdims=True)
    cj = np.asarray(jref.kquantile_codes_ref(jnp.asarray(w), jnp.asarray(mu),
                                             jnp.asarray(sd), k))
    ct = tref.kquantile_codes_ref(torch.from_numpy(w), torch.from_numpy(mu),
                                  torch.from_numpy(sd), k)
    assert ct.dtype == torch.int8
    _codes_close(cj, ct.numpy(), KV_CODE_MISMATCH, inputs=(w, mu, sd, k))
    # dequant of the SAME codes: identical table gather + one multiply-add
    dj = np.asarray(jref.kquantile_dequant_ref(
        jnp.asarray(cj), jnp.asarray(mu), jnp.asarray(sd), k,
        dtype=jnp.float32))
    dt = tref.kquantile_dequant_ref(torch.from_numpy(np.array(cj)),
                                    torch.from_numpy(mu),
                                    torch.from_numpy(sd), k,
                                    dtype=torch.float32)
    np.testing.assert_allclose(dt.numpy(), dj, atol=1e-6, rtol=0)


# -- distributions / quantizers --------------------------------------------

@pytest.mark.parametrize("channel_axis", [None, 1, -1])
def test_gaussian_model(channel_axis):
    w = (_rng(5).standard_normal((40, 24)) * 0.3 + 0.1).astype(np.float32)
    mj = jdist.GaussianModel.fit(jnp.asarray(w), channel_axis=channel_axis)
    mt = tdist.GaussianModel.fit(torch.from_numpy(w),
                                 channel_axis=channel_axis)
    assert tuple(mt.mu.shape) == tuple(mj.mu.shape)
    # population deviation on both sides (a sample deviation would be off
    # by sqrt(n/(n-1)) ~ 1e-2 here); f32 reductions in another order
    np.testing.assert_allclose(mt.mu.numpy(), np.asarray(mj.mu), atol=1e-6)
    np.testing.assert_allclose(mt.sigma.numpy(), np.asarray(mj.sigma),
                               rtol=1e-5)
    np.testing.assert_allclose(mt.cdf(torch.from_numpy(w)).numpy(),
                               np.asarray(mj.cdf(jnp.asarray(w))), atol=1e-6)
    u = _rng(6).uniform(0.001, 0.999, (40, 24)).astype(np.float32)
    np.testing.assert_allclose(mt.quantile(torch.from_numpy(u)).numpy(),
                               np.asarray(mj.quantile(jnp.asarray(u))),
                               atol=1e-5)
    lj = np.asarray(mj.level_values(16))
    lt = mt.level_values(16)
    assert tuple(lt.shape) == lj.shape
    np.testing.assert_allclose(lt.numpy(), lj, atol=1e-5)


@pytest.mark.parametrize("k", [4, 16, 256])
def test_kquantile_quantizer(k):
    w = (_rng(7).standard_normal((64, 32)) * 0.2).astype(np.float32)
    mj = jdist.GaussianModel.fit(jnp.asarray(w))
    mt = tdist.GaussianModel.fit(torch.from_numpy(w))
    cj = np.asarray(jquant.kquantile_quantize(jnp.asarray(w), mj, k))
    ct = tquant.kquantile_quantize(torch.from_numpy(w), mt, k)
    assert ct.dtype == torch.int32
    assert int(ct.min()) >= 0 and int(ct.max()) <= k - 1
    _codes_close(cj, ct.numpy(), 1e-3,       # 2048 values: at most 2 flips
                 inputs=(w, mt.mu.numpy(), mt.sigma.numpy(), k))
    dj = np.asarray(jquant.kquantile_dequantize(jnp.asarray(cj), mj, k))
    dt = tquant.kquantile_dequantize(torch.from_numpy(cj), mt, k)
    np.testing.assert_allclose(dt.numpy(), dj, atol=1e-5)
    fq = tquant.kquantile_fakequant(torch.from_numpy(w), mt, k)
    fj = np.asarray(jquant.kquantile_fakequant(jnp.asarray(w), mj, k))
    same = ct.numpy() == cj
    np.testing.assert_allclose(fq.numpy()[same], fj[same], atol=1e-5)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("stacked", [True, False])
def test_quantize_tensor(bits, per_channel, stacked):
    shape = (3, 96, 64) if stacked else (96, 64)
    w = (_rng(8).standard_normal(shape) * 0.05).astype(np.float32)
    qj = juniq.quantize_tensor(jnp.asarray(w), bits, per_channel=per_channel,
                               stacked=stacked)
    qt = tuniq.quantize_tensor(torch.from_numpy(w), bits,
                               per_channel=per_channel, stacked=stacked)
    assert qt.bits == qj.bits and qt.shape == qj.shape and qt.k == qj.k
    assert tuple(qt.mu.shape) == tuple(qj.mu.shape)
    assert tuple(qt.codes.shape) == tuple(qj.codes.shape)
    assert qt.codes.dtype == tpack.storage_dtype(bits)
    np.testing.assert_allclose(qt.mu.numpy(), np.asarray(qj.mu), atol=1e-7)
    np.testing.assert_allclose(qt.sigma.numpy(), np.asarray(qj.sigma),
                               rtol=1e-5)
    cj, ct = np.asarray(qj.codes), qt.codes
    if bits == 4:
        cj = np.asarray(jpack.unpack_int4(qj.codes))
        ct = tpack.unpack_int4(qt.codes)
    _codes_close(cj, ct.numpy(), WEIGHT_CODE_MISMATCH,
                 inputs=(w, qt.mu.numpy(), qt.sigma.numpy(), 2 ** bits))
    dj = np.asarray(qj.dequantize(jnp.float32))
    dt = qt.dequantize(torch.float32).numpy()
    same = cj == ct.numpy()
    # ndtri on the same k centers in two f32 implementations
    np.testing.assert_allclose(dt[same], dj[same], atol=1e-6)
    # the level-table dequant the model uses agrees with the analytic one
    dm = tref.kquantile_dequant_ref(ct, qt.mu, qt.sigma, 2 ** bits,
                                    dtype=torch.float32).numpy()
    np.testing.assert_allclose(dm, dt, atol=1e-6)


def test_quantize_tensor_rejects_other_bits():
    with pytest.raises(ValueError):
        tuniq.quantize_tensor(torch.zeros(4, 4), 3)


def test_stats_axes_filter_and_paths():
    for shape in [(8,), (8, 4), (2, 8, 4), (2, 3, 8, 4)]:
        for pc in (True, False):
            for st in (True, False):
                assert tuniq._stats_axes(torch.zeros(shape), pc, st) == \
                    juniq._stats_axes(jnp.zeros(shape), pc, st)
    for path in ("layers/wq", "layers/attn_norm", "embed", "lm_head",
                 "layers/router", "final_norm", "layers/d", "x/conv_w",
                 "layers/w_down", "a/bias"):
        for shape in [(8,), (8, 4)]:
            assert tuniq.default_quant_filter(path, torch.zeros(shape)) == \
                juniq.default_quant_filter(path, jnp.zeros(shape)), path
    assert tuniq.path_str(("layers", "wq")) == "layers/wq"


# -- KV codec --------------------------------------------------------------

@pytest.mark.parametrize("kv_bits", [8, 4])
def test_quantize_kv(kv_bits):
    x = _rng(9).standard_normal((32, 17, 2, 16)).astype(np.float32)
    sj, mj, gj = jkv.quantize_kv(jnp.asarray(x), kv_bits)
    st, mt, gt = tkv.quantize_kv(torch.from_numpy(x), kv_bits)
    assert st.dtype == tpack.storage_dtype(kv_bits)
    assert tuple(st.shape) == tuple(sj.shape)
    assert mt.dtype == torch.bfloat16 and gt.dtype == torch.bfloat16
    mjn = np.asarray(mj.astype(jnp.float32))
    gjn = np.asarray(gj.astype(jnp.float32))
    # the mean / deviation reductions run in another order, so a statistic
    # may land one bf16 ulp (2^-8 relative) away
    np.testing.assert_allclose(mt.float().numpy(), mjn, atol=2 ** -8)
    np.testing.assert_allclose(gt.float().numpy(), gjn, rtol=2 ** -7)
    assert (gt.float().numpy() != gjn).mean() < 5e-3
    cj, ct = np.asarray(sj), st
    if kv_bits == 4:
        cj, ct = np.asarray(jpack.unpack_int4(sj)), tpack.unpack_int4(st)
    _codes_close(cj, ct.numpy(), KV_CODE_MISMATCH,
                 inputs=(x, mt.float().numpy()[..., None],
                         gt.float().numpy()[..., None], 2 ** kv_bits))
    # what attention sees: the dequantized rows.  One code step of a
    # kv4 row is up to ~0.6 sigma at the tails, of a kv8 row ~0.3 sigma.
    dj = np.asarray(jkv.dequantize_kv(sj, mj, gj, kv_bits))
    dt = tkv.dequantize_kv(st, mt, gt, kv_bits).numpy()
    assert (np.abs(dj - dt) > 1e-5).mean() < 5e-3
    np.testing.assert_allclose(dt, dj, atol=1.0)
    # same codes + same stats -> same values
    dt2 = tkv.dequantize_kv(torch.from_numpy(np.asarray(sj)),
                            torch.from_numpy(mjn).to(torch.bfloat16),
                            torch.from_numpy(gjn).to(torch.bfloat16),
                            kv_bits).numpy()
    np.testing.assert_allclose(dt2, dj, atol=1e-6)


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_fake_quant_kv_roundtrip_is_stable(kv_bits):
    """Within the port: requantizing dequantized rows against the stored
    stats reproduces the codes bit for bit (codes are taken against the
    bf16-rounded statistics)."""
    x = torch.from_numpy(_rng(10).standard_normal((8, 5, 2, 16))
                         .astype(np.float32))
    x_dq, st, mu, sg = tkv.fake_quant_kv(x, kv_bits)
    assert x_dq.dtype == x.dtype
    again = tref.kquantile_codes_ref(x_dq, mu.float()[..., None],
                                     sg.float()[..., None], 2 ** kv_bits)
    codes = tpack.unpack_int4(st) if kv_bits == 4 else st
    assert torch.equal(again, codes)


def test_quantize_kv_uses_population_deviation():
    x = torch.from_numpy(_rng(11).standard_normal((4, 2, 16))
                         .astype(np.float32))
    _, _, sg = tkv.quantize_kv(x, 8)
    want = x.numpy().std(axis=-1)                  # ddof = 0
    np.testing.assert_allclose(sg.float().numpy(), want, rtol=2 ** -8)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_page_kv_bytes_integer_equal(arch, kv_bits):
    for get_j, get_t in ((jcb.get, tcb.get), (jcb.get_smoke, tcb.get_smoke)):
        cj, ct = get_j(arch), get_t(arch)
        for page in (8, 64):
            for itemsize in (2, 4):
                assert tkv.page_kv_bytes(ct, page, kv_bits, itemsize) == \
                    jkv.page_kv_bytes(cj, page, kv_bits, itemsize)
        assert tkv.token_kv_bytes(ct, kv_bits) == \
            jkv.token_kv_bytes(cj, kv_bits)


def test_kv_bits_checks():
    tkv.check_kv_bits(8, 16)
    with pytest.raises(ValueError):
        tkv.check_kv_bits(5)
    with pytest.raises(ValueError):
        tkv.check_kv_bits(4, 15)
    assert tkv.is_quantized_cache({"k_codes": None})
    assert not tkv.is_quantized_cache({"k": None})


def test_equal_pool_bytes_admit_more_sequences():
    """Byte accounting restated: at the pool bytes that hold 16 kv16
    sequences of granite_3_8b_smoke geometry scaled to head_dim 128, kv8
    holds 1.94x and kv4 3.56x the tokens (codes + bf16 stats per row)."""
    cfg = tcb.get("granite_3_8b")
    b16 = tkv.token_kv_bytes(cfg, 16)
    assert b16 / tkv.token_kv_bytes(cfg, 8) == pytest.approx(256 / 132)
    assert b16 / tkv.token_kv_bytes(cfg, 4) == pytest.approx(256 / 68)


# -- configs ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_arch_configs_match_reference(arch):
    for get_j, get_t in ((jcb.get, tcb.get), (jcb.get_smoke, tcb.get_smoke)):
        assert dataclasses.asdict(get_t(arch)) == \
            dataclasses.asdict(get_j(arch))
    assert arch in tcb.entries()
