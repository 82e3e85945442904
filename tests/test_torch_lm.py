"""PyTorch port vs JAX reference: the dense decoder's serving path.

One ``init_params`` tree of the reference (quantized there for W4, so the
codes are identical) is carried across as numpy; prefill, the paged insert,
one decode step and chunked prefill then run in both on the CPU in f32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.models import model as jmodel
from repro.models.lm import ModelOpts as JOpts

from repro_torch import convert
from repro_torch.configs import base as tcb
from repro_torch.models import kv_cache as tkv
from repro_torch.models import lm as tlm
from repro_torch.models import model as tmodel


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread for this module, restored after it: at
    these sizes more threads only add their OpenMP spin-waits, which take
    the cores of the suite's other parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PAGE = 8
B, S = 2, 12

# f32 logits of O(1) after two layers, same weights, same codes: different
# summation orders and transcendental implementations.
TOL_LOGITS = 2e-4
# With a coded KV cache a row whose bf16 statistic lands one ulp apart in
# the two frameworks is coded differently (see test_torch_codec); such a
# row moves the logits by up to ~1e-2 at these widths (measured <= 4e-3).
TOL_LOGITS_KVQ = 2e-2


@functools.lru_cache(maxsize=None)
def _params(arch, w_bits):
    cfg_j = jcb.get_smoke(arch)
    p = jmodel.init(jax.random.PRNGKey(0), cfg_j)
    if w_bits < 16:
        p = jmodel.quantize_for_serving(p, w_bits)
    tree = jax.tree_util.tree_map(np.asarray, p)
    return p, convert.params_from_numpy(tree, device="cpu")


def _opts(kv_bits):
    jo = JOpts(compute_dtype=jnp.float32, remat=False,
               attn_chunked_min_len=1 << 30, kv_bits=kv_bits)
    to = tlm.ModelOpts(compute_dtype=torch.float32, kv_bits=kv_bits)
    return jo, to


def _tokens(cfg, seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=shape).astype(np.int32)


def _dense_view(cache_np, kv_bits):
    """Pool / prefill cache as dense f32 K and V rows (numpy)."""
    if kv_bits == 16:
        return cache_np["k"].astype(np.float32), \
            cache_np["v"].astype(np.float32)
    out = []
    for n in ("k", "v"):
        out.append(tkv.dequantize_kv(
            torch.from_numpy(np.array(cache_np[f"{n}_codes"])),
            torch.from_numpy(np.array(cache_np[f"{n}_mu"])),
            torch.from_numpy(np.array(cache_np[f"{n}_sigma"])),
            kv_bits).numpy())
    return out


def _jax_cache_np(cache):
    return {n: np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                          else x) for n, x in cache.items()}


def _compare_kv(cj, ct, kv_bits):
    """KV contents agree: exactly-ish at kv16; at kv8/kv4 by dequantized
    value, all but the rare rows coded against a statistic one bf16 ulp
    apart (bound on their share: 2%)."""
    for a, b in zip(_dense_view(cj, kv_bits), _dense_view(ct, kv_bits)):
        assert a.shape == b.shape
        if kv_bits == 16:
            np.testing.assert_allclose(b, a, atol=1e-4)
        else:
            assert (np.abs(a - b) > 1e-3).mean() < 0.02
            np.testing.assert_allclose(b, a, atol=1.5)


CASES = [("granite_3_8b", 16, 16), ("granite_3_8b", 4, 8),
         ("granite_3_8b", 4, 4), ("granite_3_8b", 16, 8),
         ("granite_3_8b", 4, 16), ("granite_3_8b", 8, 8),
         ("gemma2_9b", 16, 16), ("gemma2_9b", 4, 8), ("gemma2_9b", 4, 4)]


@pytest.mark.parametrize("arch,w_bits,kv_bits", CASES)
def test_prefill_insert_decode(arch, w_bits, kv_bits):
    cfg_j, cfg_t = jcb.get_smoke(arch), tcb.get_smoke(arch)
    pj, pt = _params(arch, w_bits)
    jo, to = _opts(kv_bits)
    toks = _tokens(cfg_t)
    tol = TOL_LOGITS if kv_bits == 16 else TOL_LOGITS_KVQ

    # prefill with per-sequence last positions (right-padded group)
    last = np.array([S - 1, S - 4], np.int32)
    lj, kvj = jmodel.prefill(pj, cfg_j, jo, {"tokens": jnp.asarray(toks)},
                             last_idx=jnp.asarray(last))
    lt, kvt = tmodel.prefill(pt, cfg_t, to,
                             {"tokens": torch.from_numpy(toks)},
                             last_idx=torch.from_numpy(last))
    assert lt.dtype == torch.float32 and tuple(lt.shape) == (B, cfg_t.vocab)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=tol)
    _compare_kv(_jax_cache_np(kvj), convert.cache_to_numpy(kvt), kv_bits)

    # scatter into the paged pool, then one decode step at position S
    n_pool = 1 + B * 3
    tables = np.arange(1, n_pool, dtype=np.int32).reshape(B, 3)
    cj = jmodel.init_paged_cache(cfg_j, n_pool, PAGE, jnp.float32,
                                 kv_bits=kv_bits)
    ct = tmodel.init_paged_cache(cfg_t, n_pool, PAGE, torch.float32,
                                 kv_bits=kv_bits, device="cpu")
    assert {n: tuple(x.shape) for n, x in ct.items()} == \
        {n: tuple(x.shape) for n, x in cj.items()}
    cj = jmodel.cache_insert_paged(cj, kvj, jnp.asarray(tables[:, :2]))
    ct = tmodel.cache_insert_paged(ct, kvt, torch.from_numpy(tables[:, :2]))
    nxt = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    pos = np.array([S, S - 3], np.int32)
    dj, cj = jmodel.decode(pj, cfg_j, jo, cj, jnp.asarray(nxt)[:, None],
                           jnp.asarray(pos),
                           block_tables=jnp.asarray(tables))
    dt, ct = tmodel.decode(pt, cfg_t, to, ct,
                           torch.from_numpy(nxt)[:, None],
                           torch.from_numpy(pos),
                           block_tables=torch.from_numpy(tables))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=tol)
    # the pool outside the sink page (pad rows write the sink in any order)
    pool_j = {n: x[:, 1:] for n, x in _jax_cache_np(cj).items()}
    pool_t = {n: x[:, 1:] for n, x in convert.cache_to_numpy(ct).items()}
    _compare_kv(pool_j, pool_t, kv_bits)


@pytest.mark.parametrize("arch,w_bits,kv_bits", [
    ("granite_3_8b", 4, 8), ("granite_3_8b", 16, 16), ("gemma2_9b", 4, 4)])
def test_prefill_chunk_matches_reference_and_whole_prefill(arch, w_bits,
                                                           kv_bits):
    cfg_j, cfg_t = jcb.get_smoke(arch), tcb.get_smoke(arch)
    pj, pt = _params(arch, w_bits)
    jo, to = _opts(kv_bits)
    n_tok = 2 * PAGE + 3                     # two full chunks + a ragged one
    toks = _tokens(cfg_t, seed=1, shape=(B, n_tok))
    n_pool = 1 + B * 3
    tables = np.arange(1, n_pool, dtype=np.int32).reshape(B, 3)
    cj = jmodel.init_paged_cache(cfg_j, n_pool, PAGE, jnp.float32,
                                 kv_bits=kv_bits)
    ct = tmodel.init_paged_cache(cfg_t, n_pool, PAGE, torch.float32,
                                 kv_bits=kv_bits, device="cpu")
    tol = TOL_LOGITS if kv_bits == 16 else TOL_LOGITS_KVQ
    for c in range(3):
        a = c * PAGE
        valid = min(PAGE, n_tok - a)
        chunk = np.zeros((B, PAGE), np.int32)
        chunk[:, :valid] = toks[:, a:a + valid]
        positions = np.broadcast_to(a + np.arange(PAGE), (B, PAGE)) \
            .astype(np.int32)
        wp = np.zeros((B, PAGE), np.int32)
        wr = np.zeros((B, PAGE), np.int32)
        wp[:, :valid] = tables[:, c:c + 1]
        wr[:, :valid] = np.arange(valid)
        last = np.full((B,), valid - 1, np.int32)
        lj, cj = jmodel.prefill_chunk(
            pj, cfg_j, jo, cj, jnp.asarray(chunk), jnp.asarray(positions),
            jnp.asarray(wp), jnp.asarray(wr), jnp.asarray(tables),
            jnp.asarray(last))
        lt, ct = tmodel.prefill_chunk(
            pt, cfg_t, to, ct, torch.from_numpy(chunk),
            torch.from_numpy(positions.copy()), torch.from_numpy(wp),
            torch.from_numpy(wr), torch.from_numpy(tables),
            torch.from_numpy(last))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=tol)

    # within the port: chunked == whole prefill
    lw, kvw = tmodel.prefill(pt, cfg_t, to,
                             {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(lt.numpy(), lw.numpy(), atol=TOL_LOGITS)
    whole = tmodel.init_paged_cache(cfg_t, n_pool, PAGE, torch.float32,
                                    kv_bits=kv_bits, device="cpu")
    whole = tmodel.cache_insert_paged(whole, kvw, torch.from_numpy(tables))
    for name in ct:
        x = ct[name][:, 1:].reshape(cfg_t.n_layers, B, 3 * PAGE, -1)
        y = whole[name][:, 1:].reshape(cfg_t.n_layers, B, 3 * PAGE, -1)
        if kv_bits < 16:
            # a row's codes depend only on that row's K/V: bit-identical
            # in the first layer; deeper layers see attention outputs whose
            # reduction order differs between the two paths
            assert torch.equal(x[0, :, :n_tok], y[0, :, :n_tok]), name
        else:
            np.testing.assert_allclose(x[:, :, :n_tok].numpy(),
                                       y[:, :, :n_tok].numpy(), atol=1e-4)


def test_quantize_params_for_serving_matches_reference_layout():
    """The port's own quantizer over the reference's dense tree: same
    leaves coded, same shapes and dtypes, codes within the bin-edge bound;
    the odd-last-dim rule skips nothing here but is honoured."""
    arch = "granite_3_8b"
    pj_dense, pt_dense = _params(arch, 16)
    for bits in (4, 8):
        pj_q, _ = _params(arch, bits)
        pt_q = tlm.quantize_params_for_serving(pt_dense, bits, device="cpu")
        flat_j = dict(_flat(jax.tree_util.tree_map(np.asarray, pj_q)))
        flat_t = dict(_flat(pt_q))
        assert set(flat_j) == set(flat_t)
        flips = total = 0
        for key, tj in flat_j.items():
            tt = flat_t[key]
            assert tuple(tt.shape) == tj.shape, key
            if key[-1] == "q_codes":
                assert str(tt.dtype).replace("torch.", "") == tj.dtype.name
                if bits == 8:
                    d = np.abs(tj.astype(int) - tt.numpy().astype(int))
                    assert d.max() <= 1, key
                    flips += int((d > 0).sum())
                else:
                    # a flipped nibble changes its byte
                    flips += int((tj != tt.numpy()).sum())
                total += tj.size * (2 if bits == 4 else 1)
            else:
                np.testing.assert_allclose(tt.numpy(), tj, rtol=1e-5,
                                           atol=1e-7)
        assert flips / total <= 1e-4, (bits, flips, total)
    odd = {"w": torch.randn(8, 7)}
    assert not tlm.is_qweight(
        tlm.quantize_params_for_serving(odd, 4, device="cpu")["w"])
    assert tlm.is_qweight(
        tlm.quantize_params_for_serving(odd, 8, device="cpu")["w"])


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _quant_error_bound(w, q, bits):
    """Per-element bound on |dequant(code(w)) - w| for per-column k-quantile
    levels: inside the outermost levels an element lies in a bin whose
    level is within the widest gap between neighbouring levels; outside
    them it is coded to the outer level and is exactly its distance from
    it.  1e-6 of slack for the f32 level arithmetic."""
    from repro_torch.kernels import ref as tref
    levels = q["q_mu"] + q["q_sigma"] * tref.level_table(2 ** bits)[:, None,
                                                                     None]
    lo, hi = levels[0], levels[-1]                      # (1, C) each
    gap = (levels[1:] - levels[:-1]).amax(dim=0)        # (1, C)
    return torch.where(w < lo, lo - w,
                       torch.where(w > hi, w - hi, gap)) + 1e-6


def test_materialize_infers_bits_from_dtype():
    gen = torch.Generator().manual_seed(1249)
    w = torch.randn(16, 8, generator=gen) * 0.1
    for bits, dtype in ((4, torch.uint8), (8, torch.int8)):
        q = tlm.quantize_params_for_serving({"w": w}, bits, device="cpu")["w"]
        assert q["q_codes"].dtype == dtype
        dense = tlm.materialize(q, torch.float32)
        assert tuple(dense.shape) == (16, 8)
        assert bool(((dense - w).abs() <= _quant_error_bound(w, q,
                                                             bits)).all())
    assert tlm.materialize(w, torch.bfloat16).dtype == torch.bfloat16
    x = torch.randn(3, 16, generator=gen)
    q = tlm.quantize_params_for_serving({"w": w}, 4, device="cpu")["w"]
    np.testing.assert_allclose(
        tlm.mm(x, q).numpy(),
        (x @ tlm.materialize(q, torch.float32)).numpy(), atol=1e-5)


def test_init_params_codes_layer_by_layer():
    """init_params(w_bits=4) == quantize(init_params()) without ever
    holding a dense stacked leaf; the lm_head of an odd vocabulary stays
    dense at W4 and is coded at W8."""
    import dataclasses
    cfg = dataclasses.replace(tcb.get_smoke("granite_3_8b"), vocab=511)
    dense = tlm.init_params(3, cfg, device="cpu")
    for bits in (4, 8):
        direct = tlm.init_params(3, cfg, device="cpu", w_bits=bits)
        via = tlm.quantize_params_for_serving(dense, bits, device="cpu")
        fd, fv = dict(_flat(direct)), dict(_flat(via))
        assert set(fd) == set(fv)
        for key in fd:
            assert torch.equal(fd[key], fv[key]), key
        assert tlm.is_qweight(direct["lm_head"]) == (bits == 8)
        assert tlm.is_qweight(direct["layers"]["w_down"])
        assert not tlm.is_qweight(direct["layers"]["attn_norm"])


def test_not_yet_ported_options_raise_plainly():
    """A family not ported (ssm) still raises; the int8 activation codec
    (serve_a_bits=8) and empirical codebooks are ported and now serve
    (their parity with the reference is test_torch_serve_modes.py), and so
    is the slot cache layout (tests/test_torch_slot.py)."""
    cfg = tcb.get_smoke("granite_3_8b")
    _, pt = _params("granite_3_8b", 4)
    toks = torch.from_numpy(_tokens(cfg))
    full, _ = tmodel.prefill(pt, cfg,
                             tlm.ModelOpts(compute_dtype=torch.float32),
                             {"tokens": toks})
    a8, _ = tmodel.prefill(pt, cfg, tlm.ModelOpts(compute_dtype=torch.float32,
                                                  serve_a_bits=8),
                           {"tokens": toks})
    assert tuple(a8.shape) == (B, cfg.vocab) and bool(torch.isfinite(a8).all())
    # int8 activations move O(1) logits by a few 1e-2 at these widths
    assert 0 < float((a8 - full).abs().max()) < 0.2
    q = tlm.quantize_params_for_serving(
        {"w": torch.randn(4, 4, generator=torch.Generator().manual_seed(0))},
        4, dist="empirical", device="cpu")["w"]
    assert set(q) == {"q_codes", "q_lut"} and tuple(q["q_lut"].shape) == (16,)
    with pytest.raises(ValueError):
        tlm.quantize_params_for_serving({"w": torch.zeros(4, 4)}, 4,
                                        dist="laplace", device="cpu")
    # the slot layout: decode without block tables writes row 0 of each
    # batch row's region and attends over it
    cache = tmodel.init_cache(cfg, B, PAGE, torch.float32, device="cpu")
    logits, out = tmodel.decode(pt, cfg,
                                tlm.ModelOpts(compute_dtype=torch.float32),
                                cache, toks[:, :1],
                                torch.zeros(B, dtype=torch.long))
    assert out is cache and tuple(logits.shape) == (B, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    assert cache["k"][:, :, 0].abs().sum() > 0
    assert not cache["k"][:, :, 1:].any()
    # whisper_base's smoke config (family "audio", once not ported) draws
    # its encoder-decoder tree; lm.init_params still refuses it
    wcfg = tcb.get_smoke("whisper_base")
    wp = tmodel.init(0, wcfg, device="cpu")
    assert tuple(wp["enc_layers"]["wq"].shape)[0] == wcfg.enc_layers
    assert tuple(wp["dec_layers"]["cross_wq"].shape)[0] == wcfg.dec_layers
    with pytest.raises(NotImplementedError, match="audio"):
        tlm.init_params(0, wcfg, device="cpu")


def test_default_device_is_the_card():
    """Entry points take device='cuda' by default and raise, not fall back,
    where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tcb.get_smoke("granite_3_8b")
    with pytest.raises(RuntimeError, match="cuda"):
        tmodel.init(0, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        tmodel.init_paged_cache(cfg, 3, PAGE)
    with pytest.raises(RuntimeError, match="cuda"):
        tlm.quantize_params_for_serving({"w": torch.zeros(4, 4)}, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.params_from_numpy({"w": np.zeros((2, 2), np.float32)})


def test_forward_prefill_raises_where_the_reference_would_chunk():
    """The reference's ``_attn_block`` switches to ``chunked_attention`` at
    S >= ``attn_chunked_min_len`` for every caller; so does the port's,
    instead of building the full score tensor, and it runs unchanged
    below it."""
    import dataclasses
    cfg = tcb.get_smoke("granite_3_8b")
    _, pt = _params("granite_3_8b", 4)
    _, to = _opts(8)
    small = dataclasses.replace(to, attn_chunked_min_len=8, kv_chunk=4)
    toks8 = {"tokens": torch.from_numpy(_tokens(cfg, shape=(B, 8)))}
    got, kv = tlm.forward_prefill(pt, cfg, small, toks8)
    want, kv_w = tlm.forward_prefill(pt, cfg, to, toks8)
    # f32, the softmax summed in another order: 1e-5 of the logits; the
    # first layer's K/V come before any attention, so its codes are equal
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * max(1.0, float(want.abs().max())))
    assert torch.equal(kv["k_codes"][0], kv_w["k_codes"][0])
    toks = {"tokens": torch.from_numpy(_tokens(cfg, shape=(B, 7)))}
    got, _ = tlm.forward_prefill(pt, cfg, small, toks)
    want, _ = tlm.forward_prefill(pt, cfg, to, toks)
    assert torch.equal(got, want)
