"""PyTorch port vs JAX reference: the prefill pool read
(``kernels/kquantile.py:kquantile_dequantize_paged``, one launch on the
card for the block-table gather and the dequantize of one layer's coded
pool).

The same numpy inputs (from a seed) are coded by the reference's
``quantize_kv`` and read by the reference's gather + ``dequantize_kv`` and
by the port's entry, which computes its plain version for CPU tensors.
Pools are small: 6 pages of 4 rows, 2 KV heads, head_dim 16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import kv_cache as jkv

from repro_torch.kernels import kquantile as tkq
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn
from repro_torch.models import kv_cache as tkv


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread for this module, restored after it: at
    these sizes more threads only add their OpenMP spin-waits, which take
    the cores of the suite's other parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


P, PAGE, KV, HD = 6, 4, 2, 16
# test_torch_codec.py::test_quantize_kv: the same codes and statistics
# dequantize within this in f32 (the two frameworks' level tables differ
# in the last ulps: erf_inv against erfinv)
ATOL = 1e-6


def _rng(seed):
    return np.random.default_rng(seed)


def _pool(kv_bits, seed):
    """One layer's coded pool, coded by the reference: codes, mu, sigma as
    numpy (bf16 statistics as f32 values, exact)."""
    x = _rng(seed).standard_normal((P, PAGE, KV, HD)).astype(np.float32)
    x *= _rng(seed + 1).uniform(0.5, 2.0, (P, PAGE, KV, 1)).astype(
        np.float32)
    st, mu, sg = jkv.quantize_kv(jnp.asarray(x), kv_bits)
    return (np.asarray(st), np.asarray(mu.astype(jnp.float32)),
            np.asarray(sg.astype(jnp.float32)))


def _tables(B, seed, dtype=np.int32):
    """(B, 3) page ids: real pages, then sink-page (0) repeats; sequence 1
    shares sequence 0's first page."""
    r = _rng(seed)
    t = (1 + r.permutation(P - 1))[:B * 3].reshape(B, 3) if B * 3 < P \
        else r.integers(1, P, size=(B, 3))
    t = t.astype(dtype)
    if B > 1:
        t[1, 0] = t[0, 0]
        t[1, 2] = 0
        t[-1, 1:] = 0
    return t


def _torch_pool(st, mu, sg):
    return (torch.from_numpy(st.copy()),
            torch.from_numpy(mu.copy()).to(torch.bfloat16),
            torch.from_numpy(sg.copy()).to(torch.bfloat16))


def _reference_read(st, mu, sg, tables, kv_bits):
    """The reference's prefill read: gather by block table, then
    ``dequantize_kv`` (``src/repro/models/attention.py``)."""
    B, n = tables.shape
    S = n * PAGE
    c = jnp.asarray(st)[tables].reshape(B, S, KV, st.shape[-1])
    m = jnp.asarray(mu).astype(jnp.bfloat16)[tables].reshape(B, S, KV)
    s = jnp.asarray(sg).astype(jnp.bfloat16)[tables].reshape(B, S, KV)
    return np.asarray(jkv.dequantize_kv(c, m, s, kv_bits,
                                        dtype=jnp.float32))


def _gather(pool, block_tables):
    B, n_pages = block_tables.shape
    g = pool[block_tables.to(torch.long)]
    return g.reshape(B, n_pages * pool.shape[1], *pool.shape[2:])


def _before(q, cache, block_tables, q_pos, p, kv_bits):
    """The port's ``paged_prefill_attention_quant`` before the paged entry:
    three gathers, then ``dequantize_kv``, then ``full_attention``."""
    def gather_dequant(codes, mu, sigma):
        return tkv.dequantize_kv(_gather(codes, block_tables),
                                 _gather(mu, block_tables),
                                 _gather(sigma, block_tables), kv_bits,
                                 dtype=q.dtype)

    k = gather_dequant(cache["k_codes"], cache["k_mu"], cache["k_sigma"])
    v = gather_dequant(cache["v_codes"], cache["v_mu"], cache["v_sigma"])
    k_pos = torch.arange(k.shape[1], device=q.device)
    return tattn.full_attention(q, k, v, q_pos, k_pos, p)


@pytest.mark.parametrize("table_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("kv_bits", [8, 4])
def test_plain_read_matches_reference(kv_bits, B, table_dtype):
    st, mu, sg = _pool(kv_bits, seed=kv_bits + B)
    tables = _tables(B, seed=B, dtype=table_dtype)
    want = _reference_read(st, mu, sg, tables, kv_bits)
    args = (*_torch_pool(st, mu, sg), torch.from_numpy(tables))
    got = tkq.kquantile_dequantize_paged_plain(*args, kv_bits=kv_bits,
                                               out_dtype=torch.float32)
    assert got.shape == (B, 3 * PAGE, KV, HD) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # the entry's CPU path is its plain version, bit for bit
    assert torch.equal(got, tkq.kquantile_dequantize_paged(
        *args, kv_bits=kv_bits, out_dtype=torch.float32))


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("kv_bits", [8, 4])
def test_bf16_read_is_the_f32_read_rounded(kv_bits, B):
    """bf16 out is the f32 value rounded once (the kernel's last step)."""
    st, mu, sg = _pool(kv_bits, seed=20 + B)
    args = (*_torch_pool(st, mu, sg), torch.from_numpy(_tables(B, seed=3)))
    f32 = tkq.kquantile_dequantize_paged(*args, kv_bits=kv_bits,
                                         out_dtype=torch.float32)
    bf16 = tkq.kquantile_dequantize_paged(*args, kv_bits=kv_bits)
    assert bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, f32.to(torch.bfloat16))


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("kv_bits", [8, 4])
def test_read_equals_the_eager_chain_it_replaced(kv_bits, B):
    """Bit-equal to the three gathers + ``dequantize_kv`` of the dense
    entry (``kops.dequantize_weights``) that the engine ran before."""
    st, mu, sg = _pool(kv_bits, seed=30 + B)
    c, m, s = _torch_pool(st, mu, sg)
    bt = torch.from_numpy(_tables(B, seed=4))
    for dtype in (torch.float32, torch.bfloat16):
        old = tkv.dequantize_kv(_gather(c, bt), _gather(m, bt),
                                _gather(s, bt), kv_bits, dtype=dtype)
        assert torch.equal(tkq.kquantile_dequantize_paged(
            c, m, s, bt, kv_bits=kv_bits, out_dtype=dtype), old)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("kv_bits", [8, 4])
def test_prefill_attention_bit_equal_to_before(kv_bits, B, use_kernel):
    """The port's ``paged_prefill_attention_quant`` through the paged
    entry gives the bits it gave before it, on the CPU."""
    kst, kmu, ksg = _pool(kv_bits, seed=40 + B)
    vst, vmu, vsg = _pool(kv_bits, seed=50 + B)
    cache = dict(zip(("k_codes", "k_mu", "k_sigma"),
                     _torch_pool(kst, kmu, ksg)))
    cache.update(zip(("v_codes", "v_mu", "v_sigma"),
                     _torch_pool(vst, vmu, vsg)))
    bt = torch.from_numpy(_tables(B, seed=5))
    q = torch.from_numpy(_rng(6).standard_normal((B, 4, 4, HD)).astype(
        np.float32))
    q_pos = torch.arange(4, 8)[None].expand(B, 4)
    p = tattn.AttnParams(6, 50.0)
    got = tattn.paged_prefill_attention_quant(q, cache, bt, q_pos, p,
                                              kv_bits=kv_bits,
                                              use_kernel=use_kernel)
    assert torch.equal(got, _before(q, cache, bt, q_pos, p, kv_bits))


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_prefill_attention_matches_reference(kv_bits):
    """Against the reference's chunked-prefill attention on one coded
    pool (the reference codes it; bf16 statistics)."""
    kst, kmu, ksg = _pool(kv_bits, seed=60)
    vst, vmu, vsg = _pool(kv_bits, seed=61)
    tables = _tables(2, seed=7)
    q = _rng(8).standard_normal((2, 4, 4, HD)).astype(np.float32)
    q_pos = np.stack([np.arange(4, 8), np.arange(0, 4)]).astype(np.int32)
    jcache = {"k_codes": jnp.asarray(kst),
              "k_mu": jnp.asarray(kmu).astype(jnp.bfloat16),
              "k_sigma": jnp.asarray(ksg).astype(jnp.bfloat16),
              "v_codes": jnp.asarray(vst),
              "v_mu": jnp.asarray(vmu).astype(jnp.bfloat16),
              "v_sigma": jnp.asarray(vsg).astype(jnp.bfloat16)}
    want = np.asarray(jattn.paged_prefill_attention_quant(
        jnp.asarray(q), jcache, jnp.asarray(tables), jnp.asarray(q_pos),
        jattn.AttnParams(None, None), kv_bits=kv_bits))
    cache = dict(zip(("k_codes", "k_mu", "k_sigma"),
                     _torch_pool(kst, kmu, ksg)))
    cache.update(zip(("v_codes", "v_mu", "v_sigma"),
                     _torch_pool(vst, vmu, vsg)))
    got = tattn.paged_prefill_attention_quant(
        torch.from_numpy(q), cache, torch.from_numpy(tables),
        torch.from_numpy(q_pos), tattn.AttnParams(None, None),
        kv_bits=kv_bits)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_every_row_is_written_sink_rows_too():
    """Rows of table entries that repeat the sink page 0 hold page 0's
    dequantized rows, as the gather gives them (the causal mask hides them
    later); an all-sink sequence reads page 0 throughout."""
    st, mu, sg = _pool(8, seed=70)
    c, m, s = _torch_pool(st, mu, sg)
    bt = torch.tensor([[3, 0, 0], [0, 0, 0]], dtype=torch.int32)
    out = tkq.kquantile_dequantize_paged(c, m, s, bt, kv_bits=8,
                                         out_dtype=torch.float32)
    page0 = tkq.kquantile_dequantize_paged(
        c, m, s, torch.zeros((1, 1), dtype=torch.int32), kv_bits=8,
        out_dtype=torch.float32)[0]
    for b, j in ((0, 1), (0, 2), (1, 0), (1, 1), (1, 2)):
        assert torch.equal(out[b, j * PAGE:(j + 1) * PAGE], page0)


@pytest.mark.parametrize("bad", ["negative", "past_end"])
def test_page_ids_outside_the_pool_are_refused(bad):
    """The kernel traps on a page id outside [0, P); the plain version
    raises (a negative id is not wrapped to the pool's end)."""
    st, mu, sg = _pool(8, seed=80)
    bt = torch.tensor([[1, -1 if bad == "negative" else P]],
                      dtype=torch.int32)
    with pytest.raises((RuntimeError, IndexError)):
        tkq.kquantile_dequantize_paged(*_torch_pool(st, mu, sg), bt,
                                       kv_bits=8)


def test_entry_rejects_what_the_kernel_does_not_take():
    st, mu, sg = _pool(8, seed=90)
    c, m, s = _torch_pool(st, mu, sg)
    bt = torch.from_numpy(_tables(1, seed=9))
    with pytest.raises(ValueError):                   # kv_bits
        tkq.kquantile_dequantize_paged(c, m, s, bt, kv_bits=16)
    with pytest.raises(ValueError):                   # int8 codes at kv4
        tkq.kquantile_dequantize_paged(c, m, s, bt, kv_bits=4)
    with pytest.raises(ValueError):                   # f32 statistics
        tkq.kquantile_dequantize_paged(c, m.float(), s, bt, kv_bits=8)
    with pytest.raises(ValueError):                   # statistics shape
        tkq.kquantile_dequantize_paged(c, m[:, :2], s, bt, kv_bits=8)
    with pytest.raises(ValueError):                   # table dtype
        tkq.kquantile_dequantize_paged(c, m, s, bt.float(), kv_bits=8)
    with pytest.raises(ValueError):                   # table rank
        tkq.kquantile_dequantize_paged(c, m, s, bt[0], kv_bits=8)
    with pytest.raises(TypeError):
        tkq.kquantile_dequantize_paged(c, m, s, bt, kv_bits=8,
                                       out_dtype=torch.float16)


def test_cpu_reads_launch_no_kernel():
    before = tops.launch_counts()
    st, mu, sg = _pool(4, seed=100)
    tkq.kquantile_dequantize_paged(*_torch_pool(st, mu, sg),
                                   torch.from_numpy(_tables(3, seed=10)),
                                   kv_bits=4)
    assert tops.launch_counts() == before
    assert "kquantile_dequantize_paged" in before


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_route_of_the_pool_read(kv_bits):
    """A (row, head) of hd values is the group of the per-group body: the
    16-byte route for head dims that are whole chunks of 16 codes, the
    scalar one otherwise or for codes off their chunk's alignment."""
    def route(hd, codes_ptr=0, out_ptr=0):
        return tkq.codec_route(tkq.DEQUANTIZE, (4 * 2048 * 8, 1, hd), False,
                               torch.bfloat16, kv_bits == 4,
                               (out_ptr, codes_ptr))
    assert route(128) == route(16) == tkq.VECTOR
    assert route(24) == route(8) == tkq.SCALAR
    assert route(128, codes_ptr=8) == (tkq.VECTOR if kv_bits == 4
                                       else tkq.SCALAR)
    assert route(128, codes_ptr=4) == route(128, out_ptr=8) == tkq.SCALAR
