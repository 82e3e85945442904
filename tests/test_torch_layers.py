"""PyTorch port vs JAX reference: norms, RoPE, soft-capping, initializers
and every attention variant of the serving path (f32, CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import kv_cache as jkv
from repro.models import layers as jlayers

from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread for this module, restored after it: at
    these sizes more threads only add their OpenMP spin-waits, which take
    the cores of the suite's other parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(x):
    return torch.from_numpy(np.array(x))


# f32 elementwise math in two implementations: a few ulps of O(1) values
ATOL = 2e-6


@pytest.mark.parametrize("zero_centered", [False, True])
def test_rms_norm(zero_centered):
    x = _rng(1).standard_normal((2, 5, 64)).astype(np.float32) * 3
    s = _rng(2).standard_normal(64).astype(np.float32) * 0.1 + 1
    want = np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6,
                                       zero_centered))
    got = tlayers.rms_norm(_t(x), _t(s), 1e-6, zero_centered)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL * 4)
    # bf16 activations keep their dtype and agree to one bf16 ulp
    got16 = tlayers.rms_norm(_t(x).to(torch.bfloat16), _t(s), 1e-6,
                             zero_centered)
    assert got16.dtype == torch.bfloat16
    want16 = np.asarray(jlayers.rms_norm(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(s), 1e-6,
        zero_centered).astype(jnp.float32))
    np.testing.assert_allclose(got16.float().numpy(), want16, rtol=2 ** -7,
                               atol=2 ** -8)


def test_layer_norm():
    x = _rng(3).standard_normal((3, 4, 32)).astype(np.float32)
    s = _rng(4).standard_normal(32).astype(np.float32)
    b = _rng(5).standard_normal(32).astype(np.float32)
    want = np.asarray(jlayers.layer_norm(jnp.asarray(x), jnp.asarray(s),
                                         jnp.asarray(b)))
    got = tlayers.layer_norm(_t(x), _t(s), _t(b))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL * 4)


@pytest.mark.parametrize("theta", [10000.0, 5000000.0])
def test_rope(theta):
    np.testing.assert_allclose(tlayers.rope_freqs(16, theta).numpy(),
                               np.asarray(jlayers.rope_freqs(16, theta)),
                               rtol=1e-6)
    x = _rng(6).standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    want = np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         theta))
    got = tlayers.apply_rope(_t(x), _t(pos), theta)
    # sin/cos of angles up to ~100 rad in two f32 implementations
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    # split-halves convention: element i pairs with i + D/2, so position 0
    # is the identity and the norm of each (i, i + D/2) pair is preserved
    np.testing.assert_allclose(got.numpy()[0, 0], x[0, 0], atol=1e-7)
    n_in = x[..., :8] ** 2 + x[..., 8:] ** 2
    n_out = got.numpy()[..., :8] ** 2 + got.numpy()[..., 8:] ** 2
    np.testing.assert_allclose(n_out, n_in, rtol=1e-5)


@pytest.mark.parametrize("cap", [None, 0.0, 30.0])
def test_softcap(cap):
    x = _rng(7).standard_normal((4, 9)).astype(np.float32) * 40
    want = np.asarray(jlayers.softcap(jnp.asarray(x), cap))
    got = tlayers.softcap(_t(x), cap)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_initializers_are_truncated_normals_from_a_generator():
    gen = torch.Generator().manual_seed(0)
    w = tlayers.dense_init(gen, (4, 256, 128))
    assert w.dtype == torch.float32 and tuple(w.shape) == (4, 256, 128)
    std = (1.0 / 256) ** 0.5
    assert float(w.abs().max()) <= 2 * std + 1e-6          # +-2 sigma
    # a unit normal truncated to [-2, 2] has deviation 0.8796
    assert float(w.std()) == pytest.approx(0.8796 * std, rel=0.02)
    e = tlayers.embed_init(gen, (512, 64))
    assert float(e.abs().max()) <= 0.04 + 1e-7
    assert float(e.std()) == pytest.approx(0.8796 * 0.02, rel=0.03)
    again = tlayers.dense_init(torch.Generator().manual_seed(0),
                               (4, 256, 128))
    assert torch.equal(w, again)


# -- attention ---------------------------------------------------------------

def _qkv(B=2, Sq=6, Sk=6, H=4, KV=2, D=16, seed=0):
    r = _rng(seed)
    return (r.standard_normal((B, Sq, H, D)).astype(np.float32),
            r.standard_normal((B, Sk, KV, D)).astype(np.float32),
            r.standard_normal((B, Sk, KV, D)).astype(np.float32))


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("cap", [None, 50.0])
@pytest.mark.parametrize("per_seq", [False, True])
def test_full_attention(window, cap, per_seq):
    q, k, v = _qkv(Sq=6, Sk=10, seed=8)
    q_pos = np.arange(4, 10, dtype=np.int32)
    if per_seq:
        q_pos = np.stack([q_pos, q_pos - 2])
    k_pos = np.arange(10, dtype=np.int32)
    want = np.asarray(jattn.full_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
        jnp.asarray(k_pos), jattn.AttnParams(window, cap)))
    got = tattn.full_attention(_t(q), _t(k), _t(v), _t(q_pos), _t(k_pos),
                               tattn.AttnParams(window, cap))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    mj = np.asarray(jattn._mask(jnp.asarray(q_pos), jnp.asarray(k_pos),
                                jattn.AttnParams(window, cap)))
    mt = tattn._mask(_t(q_pos), _t(k_pos), tattn.AttnParams(window, cap))
    np.testing.assert_array_equal(mt.numpy(), mj)


@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("cap", [None, 50.0])
def test_decode_attention(window, cap):
    q, k, v = _qkv(Sq=1, Sk=12, seed=9)
    q_pos = np.array([3, 11], np.int32)
    want = np.asarray(jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
        jattn.AttnParams(window, cap)))
    got = tattn.decode_attention(_t(q), _t(k), _t(v), _t(q_pos),
                                 tattn.AttnParams(window, cap))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def _dense_pool(B=2, page=4, n_pages=3, KV=2, D=16, seed=0):
    r = _rng(seed)
    P = B * n_pages + 1
    kp = r.standard_normal((P, page, KV, D)).astype(np.float32)
    vp = r.standard_normal((P, page, KV, D)).astype(np.float32)
    tables = np.arange(1, P, dtype=np.int32).reshape(B, n_pages)
    tables[0, -1] = 0                                      # a sink entry
    return kp, vp, tables


@pytest.mark.parametrize("window", [None, 5])
def test_paged_decode_attention(window):
    kp, vp, tables = _dense_pool(seed=10)
    q = _rng(11).standard_normal((2, 1, 4, 16)).astype(np.float32)
    q_pos = np.array([6, 11], np.int32)
    want = np.asarray(jattn.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(q_pos),
        jattn.AttnParams(window, 50.0)))
    got = tattn.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                       _t(q_pos),
                                       tattn.AttnParams(window, 50.0))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("per_seq", [False, True])
def test_paged_prefill_attention(per_seq):
    kp, vp, tables = _dense_pool(seed=12)
    q = _rng(13).standard_normal((2, 4, 4, 16)).astype(np.float32)
    q_pos = np.arange(4, 8, dtype=np.int32)
    if per_seq:
        q_pos = np.stack([q_pos, q_pos - 4])
    want = np.asarray(jattn.paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(q_pos),
        jattn.AttnParams(None, None)))
    got = tattn.paged_prefill_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                        _t(q_pos),
                                        tattn.AttnParams(None, None))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_paged_prefill_attention_quant(kv_bits):
    """Same codes and stats (coded by the reference) through both."""
    kp, vp, tables = _dense_pool(seed=14)
    k_st, k_mu, k_sg = jkv.quantize_kv(jnp.asarray(kp), kv_bits)
    v_st, v_mu, v_sg = jkv.quantize_kv(jnp.asarray(vp), kv_bits)
    cache = {"k_codes": k_st, "k_mu": k_mu, "k_sigma": k_sg,
             "v_codes": v_st, "v_mu": v_mu, "v_sigma": v_sg}
    tc = {n: (_t(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
              if x.dtype == jnp.bfloat16 else _t(x))
          for n, x in cache.items()}
    q = _rng(15).standard_normal((2, 4, 4, 16)).astype(np.float32)
    q_pos = np.stack([np.arange(4, 8), np.arange(0, 4)]).astype(np.int32)
    want = np.asarray(jattn.paged_prefill_attention_quant(
        jnp.asarray(q), cache, jnp.asarray(tables), jnp.asarray(q_pos),
        jattn.AttnParams(6, 50.0), kv_bits=kv_bits))
    got = tattn.paged_prefill_attention_quant(
        _t(q), tc, _t(tables), _t(q_pos), tattn.AttnParams(6, 50.0),
        kv_bits=kv_bits)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
