"""PyTorch port vs JAX reference: decode attention off the coded KV pool.

The port's plain version (what its wrapper computes for CPU tensors, and
what the CUDA kernel is held against on the card) is compared with the
reference's Pallas kernel in interpret mode and with its jnp reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import paged_attn as jpa
from repro.models import attention as jattn
from repro.models import kv_cache as jkv

from repro_torch.kernels import paged_attn as tpa
from repro_torch.kernels import ref as tkref
from repro_torch.models import attention as tattn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread for this module, restored after it: at
    these sizes more threads only add their OpenMP spin-waits, which take
    the cores of the suite's other parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _pool(kv_bits, page, n_pages, B=3, KV=2, G=2, hd=16, seed=0):
    """A pool coded by the reference (so both sides read identical codes
    and stats), with page 0 the zero sink."""
    r = np.random.default_rng(seed)
    S, H = page * n_pages, KV * G
    k = r.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = (r.standard_normal((B, S, KV, hd)) * 0.5).astype(np.float32)
    q = r.standard_normal((B, 1, H, hd)).astype(np.float32)
    k_st, k_mu, k_sig = jkv.quantize_kv(jnp.asarray(k), kv_bits)
    v_st, v_mu, v_sig = jkv.quantize_kv(jnp.asarray(v), kv_bits)

    def paged(x):
        pool = jnp.zeros((B * n_pages + 1, page) + x.shape[2:], x.dtype)
        return pool.at[1:].set(x.reshape(B * n_pages, page, *x.shape[2:]))

    cache = {"k_codes": paged(k_st), "v_codes": paged(v_st),
             "k_mu": paged(k_mu), "k_sigma": paged(k_sig),
             "v_mu": paged(v_mu), "v_sigma": paged(v_sig)}
    tables = np.arange(1, B * n_pages + 1, dtype=np.int32).reshape(B, n_pages)
    return q, cache, tables, S


def _to_torch(cache):
    out = {}
    for name, leaf in cache.items():
        if leaf.dtype == jnp.bfloat16:
            out[name] = torch.from_numpy(
                np.array(leaf.astype(jnp.float32))).to(torch.bfloat16)
        else:
            out[name] = torch.from_numpy(np.array(leaf))
    return out


def _call(fn, q, tc, tables, q_pos, **kw):
    return fn(torch.from_numpy(q), tc["k_codes"], tc["k_mu"], tc["k_sigma"],
              tc["v_codes"], tc["v_mu"], tc["v_sigma"],
              torch.from_numpy(tables), torch.from_numpy(q_pos), **kw)


@pytest.mark.parametrize("kv_bits", [4, 8])
@pytest.mark.parametrize("page,n_pages", [(4, 6), (8, 3)])
@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("logit_cap", [None, 30.0])
def test_plain_matches_reference(kv_bits, page, n_pages, window, logit_cap):
    q, cache, tables, S = _pool(kv_bits, page, n_pages)
    q_pos = np.array([2, S // 2, S - 1], np.int32)
    p = jattn.AttnParams(window=window, logit_cap=logit_cap)
    want = np.asarray(jattn.paged_decode_attention_quant(
        jnp.asarray(q), cache, jnp.asarray(tables), jnp.asarray(q_pos), p,
        kv_bits=kv_bits, use_pallas=False))
    got = _call(tpa.paged_quant_attention, q, _to_torch(cache), tables,
                q_pos, kv_bits=kv_bits, window=window, logit_cap=logit_cap)
    assert tuple(got.shape) == q.shape and got.dtype == torch.float32
    # identical codes and stats; f32 softmax in two implementations
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # through the model-level entry point as well
    tp = tattn.AttnParams(window=window, logit_cap=logit_cap)
    got2 = tattn.paged_decode_attention_quant(
        torch.from_numpy(q), _to_torch(cache), torch.from_numpy(tables),
        torch.from_numpy(q_pos), tp, kv_bits=kv_bits)
    assert torch.equal(got, got2)


@pytest.mark.parametrize("kv_bits", [4, 8])
@pytest.mark.parametrize("splits", [1, 2, 3, 4])
def test_plain_matches_reference_kernel_interpreted(kv_bits, splits):
    """Every split count of the reference kernel — including counts that
    do not divide the 5 pages — gives what the port's plain version gives."""
    q, cache, tables, S = _pool(kv_bits, 4, 5, seed=1)
    q_pos = np.array([2, S // 2, S - 1], np.int32)
    tc = _to_torch(cache)
    for window in (None, 7):
        out_k = np.asarray(jpa.paged_quant_attention(
            jnp.asarray(q), cache["k_codes"], cache["k_mu"],
            cache["k_sigma"], cache["v_codes"], cache["v_mu"],
            cache["v_sigma"], jnp.asarray(tables), jnp.asarray(q_pos),
            kv_bits=kv_bits, window=window, logit_cap=30.0, splits=splits,
            interpret=True))
        got = _call(tpa.paged_quant_attention, q, tc, tables, q_pos,
                    kv_bits=kv_bits, window=window, logit_cap=30.0,
                    splits=splits)
        # erfinv per element (reference kernel) vs the level table
        np.testing.assert_allclose(got.numpy(), out_k, atol=1e-5)


@pytest.mark.parametrize("hd", [7, 33])
def test_odd_head_dim_at_kv8_matches_reference(hd):
    """An odd head_dim at kv8, which the reference takes (its
    ``check_kv_bits`` refuses one only at kv4): the plain version against
    the reference's jnp path and its kernel interpreted, window and cap
    included."""
    q, cache, tables, S = _pool(8, 4, 5, hd=hd, seed=4)
    q_pos = np.array([2, S // 2, S - 1], np.int32)
    tc = _to_torch(cache)
    for window, cap in ((None, None), (7, 30.0)):
        p = jattn.AttnParams(window=window, logit_cap=cap)
        want = np.asarray(jattn.paged_decode_attention_quant(
            jnp.asarray(q), cache, jnp.asarray(tables), jnp.asarray(q_pos),
            p, kv_bits=8, use_pallas=False))
        out_k = np.asarray(jpa.paged_quant_attention(
            jnp.asarray(q), cache["k_codes"], cache["k_mu"],
            cache["k_sigma"], cache["v_codes"], cache["v_mu"],
            cache["v_sigma"], jnp.asarray(tables), jnp.asarray(q_pos),
            kv_bits=8, window=window, logit_cap=cap, splits=2,
            interpret=True))
        got = _call(tpa.paged_quant_attention, q, tc, tables, q_pos,
                    kv_bits=8, window=window, logit_cap=cap)
        assert tuple(got.shape) == q.shape
        # identical codes and stats; f32 softmax in two implementations
        # (as test_plain_matches_reference), erfinv per element in the
        # interpreted kernel (as test_plain_matches_reference_kernel_...)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), out_k, atol=1e-5)


def test_kv4_refuses_an_odd_head_dim():
    """kv4 packs two codes a byte along head_dim: an odd one is refused, as
    the reference's ``check_kv_bits`` refuses it."""
    q, cache, tables, S = _pool(4, 4, 3, hd=16)
    tc = _to_torch(cache)
    q_pos = np.array([1, 2, 3], np.int32)
    odd = {n: (t[..., :7] if n.endswith("codes") else t)
           for n, t in tc.items()}
    with pytest.raises(ValueError):
        _call(tpa.paged_quant_attention, q[..., :15].copy(), odd, tables,
              q_pos, kv_bits=4)
    with pytest.raises(ValueError):
        jkv.check_kv_bits(4, 15)


@pytest.mark.parametrize("kv_bits", [4, 8])
def test_all_masked_row_gives_zeros_like_the_reference_kernel(kv_bits):
    """A query before every row (q_pos = -1) sees nothing: the reference
    kernel combines it to exact zeros, and so does the plain version."""
    q, cache, tables, S = _pool(kv_bits, 4, 3, seed=2)
    q_pos = np.array([-1, 3, S - 1], np.int32)
    out_k = np.asarray(jpa.paged_quant_attention(
        jnp.asarray(q), cache["k_codes"], cache["k_mu"], cache["k_sigma"],
        cache["v_codes"], cache["v_mu"], cache["v_sigma"],
        jnp.asarray(tables), jnp.asarray(q_pos), kv_bits=kv_bits, splits=2,
        interpret=True))
    got = _call(tpa.paged_quant_attention, q, _to_torch(cache), tables,
                q_pos, kv_bits=kv_bits).numpy()
    assert np.all(out_k[0] == 0.0) and np.all(got[0] == 0.0)
    np.testing.assert_allclose(got, out_k, atol=1e-5)


def test_sink_rows_are_never_seen():
    """Table entries past the valid prefix point at the sink page; filling
    the sink with garbage changes nothing."""
    q, cache, tables, S = _pool(8, 4, 4, seed=3)
    q_pos = np.array([3, 5, 9], np.int32)
    tables = tables.copy()
    tables[0, 1:] = 0
    tables[1, 2:] = 0
    tables[2, 3:] = 0
    tc = _to_torch(cache)
    a = _call(tpa.paged_quant_attention, q, tc, tables, q_pos, kv_bits=8)
    tc2 = {k: v.clone() for k, v in tc.items()}
    tc2["k_codes"][0] = 77
    tc2["v_codes"][0] = -5
    for n in ("k_mu", "k_sigma", "v_mu", "v_sigma"):
        tc2[n][0] = 3.0
    b = _call(tpa.paged_quant_attention, q, tc2, tables, q_pos, kv_bits=8)
    assert torch.equal(a, b)


def test_split_axis_and_window_sentinel():
    """Splits stay a config axis with the reference's defaults."""
    for n in (1, 3, 7, 8, 9, 32, 100):
        assert tpa.default_splits(n) == jpa.default_splits(n)
    assert tpa.BIG_WINDOW == jpa.BIG_WINDOW


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, cache, tables, S = _pool(8, 4, 3)
    tc = _to_torch(cache)
    q_pos = np.array([1, 2, 3], np.int32)
    with pytest.raises(ValueError):
        _call(tpa.paged_quant_attention, q, tc, tables, q_pos, kv_bits=16)
    with pytest.raises(ValueError):
        _call(tpa.paged_quant_attention, q[:, 0], tc, tables, q_pos,
              kv_bits=8)
    with pytest.raises(ValueError):                # kv4 codes are uint8
        _call(tpa.paged_quant_attention, q, tc, tables, q_pos, kv_bits=4)
    with pytest.raises(ValueError):
        _call(tpa.paged_quant_attention, q, tc, tables[:2], q_pos, kv_bits=8)
    with pytest.raises(ValueError):
        _call(tpa.paged_quant_attention, q, tc, tables, q_pos, kv_bits=8,
              window=0)


# ---------------------------------------------------------------------------
# The CUDA bodies' host-side rules (the kernels themselves run on the card:
# chip_smoke.py phase 3 holds both against the plain version)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,KV,D,page,kv_bits", [
    (32, 8, 128, 64, 8), (32, 8, 128, 64, 4),     # granite_3_8b's pool
    (64, 8, 128, 64, 8), (8, 8, 128, 64, 4),      # G = 8 and G = 1
    (32, 8, 64, 64, 8), (16, 8, 256, 16, 4),      # D = 64 and 256
    (4, 2, 16, 8, 4), (32, 4, 128, 8, 8)])
def test_attn_route_sends_bf16_to_the_tensor_cores(H, KV, D, page, kv_bits):
    assert tpa.attn_route(torch.bfloat16, D, KV, page, kv_bits) \
        == tpa.TENSOR_CORE
    assert tpa.attn_route(torch.float32, D, KV, page, kv_bits) \
        == tpa.CUDA_CORE


@pytest.mark.parametrize("KV,D,page,kv_bits,why", [
    (2, 24, 8, 8, "D not a multiple of 16"),
    (8, 128, 4, 8, "page not a multiple of 8"),
    (8, 128, 12, 4, "page not a multiple of 8"),
    (1, 16, 8, 4, "kv4, KV odd, D not a multiple of 32"),
    (3, 48, 8, 4, "kv4, KV odd, D not a multiple of 32")])
def test_attn_route_names_each_bf16_exception(KV, D, page, kv_bits, why):
    assert tpa.attn_route(torch.bfloat16, D, KV, page, kv_bits) \
        == tpa.CUDA_CORE, why


def test_tc_heads_divides_kv_and_the_block_warps():
    for KV in range(1, 33):
        h = tpa.tc_heads(KV)
        assert KV % h == 0 and 8 % h == 0
        assert h == max(d for d in (1, 2, 4, 8) if KV % d == 0)


@pytest.mark.parametrize("B", [1, 2, 8, 16, 64, 132, 200])
@pytest.mark.parametrize("n_pages,page", [(1, 8), (3, 16), (32, 64),
                                          (40, 16), (8, 24)])
@pytest.mark.parametrize("sms", [tpa.H100_SMS, 114])
def test_tc_splits_fills_one_wave_from_host_shapes(B, n_pages, page, sms):
    import inspect
    # host-side shapes and the card's SM count, never q_pos
    assert list(inspect.signature(tpa.tc_splits).parameters) == \
        ["B", "n_pages", "page", "sms"]
    chunks = n_pages * -(-page // tpa.TC_ROWS)
    s = tpa.tc_splits(B, n_pages, page, sms)
    assert 1 <= s <= chunks
    # one wave and no partial second one: B * s <= sms < B * (s + 1),
    # unless the table or a batch wider than the card bounds it
    if B <= sms:
        assert B * s <= sms
        assert s == chunks or B * (s + 1) > sms
    else:
        assert s == 1
    assert tpa.tc_splits(B, n_pages, page, sms) == s
    assert tpa.tc_splits(B, n_pages, page) == \
        tpa.tc_splits(B, n_pages, page, tpa.H100_SMS)


@settings(max_examples=300, deadline=None)
@given(q_pos=st.integers(-3, 700), window=st.integers(1, 800),
       page=st.sampled_from([8, 16, 24, 40, 64]),
       n_pages=st.integers(1, 12), splits=st.integers(1, 40))
def test_split_row_ranges_cover_each_valid_row_once(q_pos, window, page,
                                                    n_pages, splits):
    chunk = tpa.TC_ROWS
    parts = tpa.split_row_ranges(q_pos, window, page, n_pages, splits)
    assert len(parts) == splits
    hi = min(q_pos, n_pages * page - 1)
    lo = max(0, q_pos - window + 1)
    seen = {}
    for s, chunks in enumerate(parts):
        for a, b in chunks:
            assert a < b <= n_pages * page
            assert a // page == (b - 1) // page         # within one page
            assert b - a <= chunk and (a % page) % chunk == 0
            # a chunk is visited only if it holds a valid row
            assert any(lo <= r <= hi for r in range(a, b))
            for r in range(a, b):
                assert r not in seen, (r, s, seen.get(r))
                seen[r] = s
    assert all(r in seen for r in range(lo, hi + 1))
    # the splits walk consecutive, page-ordered chunks, busy ones first
    order = [c for chunks in parts for c in chunks]
    assert order == sorted(order)
    busy = [bool(chunks) for chunks in parts]
    assert busy == sorted(busy, reverse=True)


def _bf16_bits_rne(x):
    """float32 -> bf16 bit patterns, round to nearest even, in numpy."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


@pytest.mark.parametrize("kv_bits", [4, 8])
def test_plain_dequant_is_the_kernels_formula(kv_bits):
    """The plain version's bf16 K / V element is bf16(f32(mu) + f32(sigma)
    * f32(t[c])), one rounding after the multiply and one after the add:
    the tensor-core body builds its fragments by the same formula
    (``__fadd_rn(mu, __fmul_rn(sigma, t[c]))``) and is exact against it."""
    r = np.random.default_rng(7)
    n, d = 64, 32
    k = 2 ** kv_bits
    codes = r.integers(0, k, (n, d))
    stored = codes - (128 if kv_bits == 8 else 0)
    if kv_bits == 4:
        packed = (codes[:, 0::2] | (codes[:, 1::2] << 4)).astype(np.uint8)
        c_t = torch.from_numpy(packed)
    else:
        c_t = torch.from_numpy(stored.astype(np.int8))
    mu = torch.from_numpy(r.standard_normal(n).astype(np.float32) * 0.1) \
        .to(torch.bfloat16)
    sigma = torch.from_numpy(np.abs(r.standard_normal(n)).astype(np.float32)
                             + 0.5).to(torch.bfloat16)
    got = tpa._dequant(c_t, mu, sigma, kv_bits, torch.bfloat16)
    t = tkref.level_table(k).numpy()
    mu32 = mu.float().numpy()[:, None]
    sg32 = sigma.float().numpy()[:, None]
    want = _bf16_bits_rne(mu32 + (sg32 * t[codes]).astype(np.float32))
    assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                          want)
