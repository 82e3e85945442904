"""PyTorch port vs JAX reference: the audio family (whisper) on the serving
path (``models/encdec.py``, dispatched by ``models/model.py``).

One reference tree of ``whisper_base_smoke``, dense or coded there at W4 /
W8 / W4 empirical, is carried across by ``convert.params_from_numpy``; the
encoder, prefill (logits and the four caches) and decode then run in both
on the CPU in f32, from the same numpy frames and tokens.  Also: the port's
own coding against the reference's (the LM head of an odd vocab left
dense at W4), its layer-by-layer draw, ``generate``'s greedy tokens past
the self cache's ``max_len // 2`` rows (where the reference drops the
writes), ``--a-bits 8`` (which the reference does not apply here), the
refusals, the cache layouts and the serving CLI's closed batch.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.configs.base import ShapeConfig
from repro.models import encdec as jencdec
from repro.models import model as jmodel
from repro.models.lm import ModelOpts as JOpts
from repro.serve import serve as jserve

from repro_torch import convert
from repro_torch.configs import base as tcb
from repro_torch.models import encdec as tencdec
from repro_torch.models import lm as tlm
from repro_torch.models import model as tmodel
from repro_torch.serve import engine as teng
from repro_torch.serve import serve as tserve


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread for this module, restored after it: at
    these sizes more threads only add their OpenMP spin-waits, which take
    the cores of the suite's other parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "whisper_base"
B, S, TE = 2, 6, 10

# f32 logits, encoder outputs and caches of O(1) after 2 + 2 layers, the
# same weights and codes on both sides: different summation orders and
# transcendental implementations (``test_torch_lm.py``'s TOL_LOGITS).
# Stated relative to max(1, the largest reference value).
TOL = 2e-4


def _cfgs(vocab=None):
    cj, ct = jcb.get_smoke(ARCH), tcb.get_smoke(ARCH)
    if vocab:
        cj, ct = (dataclasses.replace(c, vocab=vocab) for c in (cj, ct))
    return cj, ct


@functools.lru_cache(maxsize=None)
def _dense_ref(vocab=None):
    return jmodel.init(jax.random.PRNGKey(0), _cfgs(vocab)[0])


@functools.lru_cache(maxsize=None)
def _params(w_bits, dist="gaussian"):
    p = _dense_ref()
    if w_bits < 16:
        p = jmodel.quantize_for_serving(p, w_bits, dist=dist)
    return p, convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p), device="cpu")


def _opts(a_bits=32):
    jo = JOpts(compute_dtype=jnp.float32, remat=False,
               attn_chunked_min_len=1 << 30, a_bits=a_bits)
    to = tlm.ModelOpts(compute_dtype=torch.float32, a_bits=a_bits)
    return jo, to


_jencode = jax.jit(jencdec.encode, static_argnums=(1, 2))
_jprefill = jax.jit(jmodel.prefill, static_argnums=(1, 2))
_jdecode = jax.jit(jmodel.decode, static_argnums=(1, 2))


def _tokens(cfg, seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=shape).astype(np.int32)


def _frames(cfg, seed=0, te=TE):
    return np.random.default_rng(seed).standard_normal(
        (B, te, cfg.d_model)).astype(np.float32)


def _batch(cfg, seed=0):
    toks, frames = _tokens(cfg, seed), _frames(cfg, seed)
    return ({"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
            {"tokens": torch.from_numpy(toks),
             "frames": torch.from_numpy(frames)})


def _close(got, want, what=""):
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), (what, err)


def _caches_close(ct, cj, what):
    assert set(ct) == set(cj) == {"k", "v", "cross_k", "cross_v"}, what
    for name in cj:
        assert str(ct[name].dtype).replace("torch.", "") == \
            str(cj[name].dtype), (what, name)
        _close(ct[name], cj[name], f"{what} {name}")


CODINGS = [(16, "gaussian"), (4, "gaussian"), (8, "gaussian"),
           (4, "empirical")]


@pytest.mark.parametrize("bits,dist", CODINGS)
def test_encode_matches_reference(bits, dist):
    pj, pt = _params(bits, dist)
    jo, to = _opts()
    cj, ct = _cfgs()
    frames = _frames(cj)
    want = _jencode(pj, cj, jo, jnp.asarray(frames))
    got = tencdec.encode(pt, ct, to, torch.from_numpy(frames))
    assert got.dtype == torch.float32
    _close(got, want, "encoder output")


@pytest.mark.parametrize("bits,dist", CODINGS)
def test_prefill_matches_reference(bits, dist):
    """Last-position logits and all four caches: the self K/V (Ld, B, S,
    KV, hd) and the cross K/V (Ld, B, Te, KV, hd)."""
    pj, pt = _params(bits, dist)
    jo, to = _opts()
    cj, ct = _cfgs()
    bj, bt = _batch(cj)
    lj, cachej = _jprefill(pj, cj, jo, bj)
    lt, cachet = tmodel.prefill(pt, ct, to, bt)
    assert lt.dtype == torch.float32 and tuple(lt.shape) == (B, ct.vocab)
    assert tuple(cachet["k"].shape) == (ct.dec_layers, B, S, ct.n_kv_heads,
                                        ct.head_dim)
    assert tuple(cachet["cross_k"].shape)[2] == TE
    _close(lt, lj, "logits")
    _caches_close(cachet, cachej, "prefill cache")


@pytest.mark.parametrize("bits,dist", CODINGS[:3])
def test_decode_from_zeros_matches_reference_past_the_rows(bits, dist):
    """Six decode steps from ``init_cache`` for max_len 8, whose self rows
    are 8 // 2 = 4: the writes at positions 4 and 5 are dropped as the
    reference's scatter drops them, and every row stays visible.  Logits
    at every step and the cache after the last (written in place)."""
    pj, pt = _params(bits, dist)
    jo, to = _opts()
    cj, ct = _cfgs()
    cachej = jmodel.init_cache(cj, ShapeConfig("d", 8, B, "decode"),
                               dtype=jnp.float32)
    cachet = tmodel.init_cache(ct, B, 8, torch.float32, device="cpu")
    assert tuple(cachet["k"].shape)[2] == 4
    toks = _tokens(cj, seed=1)
    for t in range(6):
        pos = np.full((B,), t, np.int32)
        lj, cachej = _jdecode(pj, cj, jo, cachej,
                              jnp.asarray(toks[:, t:t + 1]),
                              jnp.asarray(pos))
        lt, out = tmodel.decode(pt, ct, to, cachet,
                                torch.from_numpy(toks[:, t:t + 1]),
                                torch.from_numpy(pos))
        assert out is cachet
        _close(lt, lj, f"logits at step {t}")
    _caches_close(cachet, cachej, "decode cache")
    assert not cachet["cross_k"].any() and not cachet["cross_v"].any()


@pytest.mark.parametrize("bits,dist", CODINGS)
def test_decode_from_prefill_matches_reference(bits, dist):
    """Two decode steps after a prefill, its self K/V grown by two rows on
    both sides: the cross-attention reads the encoder's K/V."""
    pj, pt = _params(bits, dist)
    jo, to = _opts()
    cj, ct = _cfgs()
    bj, bt = _batch(cj, seed=2)
    lj, cachej = _jprefill(pj, cj, jo, bj)
    lt, cachet = tmodel.prefill(pt, ct, to, bt)
    for name in ("k", "v"):
        cachej[name] = jnp.pad(cachej[name],
                               [(0, 0), (0, 0), (0, 2), (0, 0), (0, 0)])
        cachet[name] = torch.cat([cachet[name],
                                  cachet[name].new_zeros(
                                      cachet[name][:, :, :2].shape)], dim=2)
    nj, nt = jnp.argmax(lj, -1), lt.argmax(-1)
    for t in (S, S + 1):
        pos = np.full((B,), t, np.int32)
        lj, cachej = _jdecode(pj, cj, jo, cachej, nj[:, None],
                              jnp.asarray(pos))
        lt, cachet = tmodel.decode(pt, ct, to, cachet, nt[:, None],
                                   torch.from_numpy(pos))
        _close(lt, lj, f"logits at position {t}")
        nj, nt = jnp.argmax(lj, -1), lt.argmax(-1)
    _caches_close(cachet, cachej, "decode cache")


def test_decode_stepping_matches_prefill_with_zero_frames():
    """Stepping the prompt through ``decode`` over zero cross K/V gives the
    prefill of zero-valued cross K/V, i.e. frames whose encoder output is
    projected to zeros: the prefill's self K/V equal the stepped ones."""
    _, pt = _params(16)
    _, to = _opts()
    _, ct = _cfgs()
    toks = torch.from_numpy(_tokens(ct, seed=3))
    zero = {k: (dict(v, cross_wk=torch.zeros_like(v["cross_wk"]),
                     cross_wv=torch.zeros_like(v["cross_wv"]))
                if k == "dec_layers" else v) for k, v in pt.items()}
    lp, cp = tmodel.prefill(zero, ct, to, {
        "tokens": toks, "frames": torch.zeros((B, 4, ct.d_model))})
    cache = tmodel.init_cache(ct, B, 2 * S, torch.float32, device="cpu")
    for t in range(S):
        ld, cache = tmodel.decode(pt, ct, to, cache, toks[:, t:t + 1],
                                  torch.full((B,), t, dtype=torch.long))
    _close(ld, lp.numpy(), "logits")
    for name in ("k", "v"):
        _close(cache[name], cp[name].numpy(), name)


def test_a_write_past_the_rows_is_dropped_not_raised():
    """Positions at and past the self rows leave the cache as it was (the
    reference's dropped scatter; torch's index write would raise), and a
    batch that mixes both kinds writes only the rows in range."""
    _, pt = _params(4)
    _, to = _opts()
    _, ct = _cfgs()
    cache = tmodel.init_cache(ct, B, 6, torch.float32, device="cpu")
    toks = torch.from_numpy(_tokens(ct, seed=4, shape=(B, 1)))
    tmodel.decode(pt, ct, to, cache, toks, torch.tensor([0, 1]))
    before = {k: v.clone() for k, v in cache.items()}
    logits, _ = tmodel.decode(pt, ct, to, cache, toks, torch.tensor([3, 7]))
    assert bool(torch.isfinite(logits).all())
    for name in cache:
        assert torch.equal(cache[name], before[name]), name
    tmodel.decode(pt, ct, to, cache, toks, torch.tensor([2, 9]))
    assert not torch.equal(cache["k"][:, 0, 2], before["k"][:, 0, 2])
    assert torch.equal(cache["k"][:, 1], before["k"][:, 1])


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _coded_paths(tree):
    return {keys[:-1] for keys, _ in _flat(tree) if keys[-1] == "q_codes"}


_PROJ = ("wq", "wk", "wv", "wo", "w_up", "w_down")
WANT_CODED = {("embed",), ("lm_head",)} \
    | {("enc_layers", n) for n in _PROJ} \
    | {("dec_layers", n) for n in _PROJ
       + ("cross_wq", "cross_wk", "cross_wv", "cross_wo")}


def _same_codes(pt_q, pj_q, bits):
    """Every leaf's shape and dtype equal; codes equal but for the pinned
    bin-edge flips (at most 1e-4 of them, as the other families' tests);
    statistics and codebooks within f32 rounding."""
    flat_j = dict(_flat(jax.tree_util.tree_map(np.asarray, pj_q)))
    flat_t = dict(_flat(pt_q))
    assert set(flat_j) == set(flat_t)
    flips = total = 0
    for key, tj in flat_j.items():
        tt = flat_t[key]
        assert tuple(tt.shape) == tj.shape, key
        assert str(tt.dtype).replace("torch.", "") == tj.dtype.name, key
        if key[-1] == "q_codes":
            if bits == 8:
                d = np.abs(tj.astype(int) - tt.numpy().astype(int))
                assert d.max() <= 1, key
                flips += int((d > 0).sum())
            else:
                flips += int((tj != tt.numpy()).sum())
            total += tj.size * (2 if bits == 4 else 1)
        else:
            np.testing.assert_allclose(tt.numpy(), tj, rtol=1e-5, atol=1e-7)
    assert flips / total <= 1e-4, (bits, flips, total)


@pytest.mark.parametrize("bits,dist", CODINGS[1:])
def test_quantize_for_serving_matches_reference(bits, dist):
    """The port's coding of the reference's dense tree: the same leaves
    coded (the stacked encoder and decoder projections per layer, the
    embedding and the head; the LayerNorm dicts dense), the codes equal."""
    _, pt_dense = _params(16)
    pj_q, _ = _params(bits, dist)
    pt_q = tmodel.quantize_for_serving(pt_dense, bits, dist=dist,
                                       device="cpu")
    assert _coded_paths(pt_q) == _coded_paths(pj_q) == WANT_CODED
    _same_codes(pt_q, pj_q, bits)
    if dist == "empirical":
        Le = tcb.get_smoke(ARCH).enc_layers
        assert tuple(pt_q["enc_layers"]["wq"]["q_lut"].shape) == (Le, 16)
        assert tuple(pt_q["lm_head"]["q_lut"].shape) == (16,)


@pytest.mark.parametrize("bits", [4, 8])
def test_odd_vocab_head_stays_dense_at_w4_only(bits):
    """whisper_base's vocab, 51865, is odd: int4 packing pairs columns, so
    at W4 the reference leaves the (d, vocab) head dense, and codes it at
    W8.  The port does the same, by its coding and by its draw."""
    pj = _dense_ref(511)
    pj_q = jmodel.quantize_for_serving(pj, bits)
    pt = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                                   device="cpu")
    pt_q = tmodel.quantize_for_serving(pt, bits, device="cpu")
    want = WANT_CODED - {("lm_head",)} if bits == 4 else WANT_CODED
    assert _coded_paths(pt_q) == _coded_paths(pj_q) == want
    _same_codes(pt_q, pj_q, bits)
    drawn = tmodel.init(1, _cfgs(511)[1], device="cpu", w_bits=bits)
    assert _coded_paths(drawn) == want
    assert tlm.is_qweight(drawn["lm_head"]) == (bits == 8)


@pytest.mark.parametrize("w_dist", ["gaussian", "empirical"])
def test_init_codes_each_layer_as_quantize_codes_the_dense_draw(w_dist):
    """``model.init(..., w_bits=4)`` codes each slice as it is drawn: the
    same tree as coding the dense draw afterwards.  The LayerNorm leaves
    stay f32 whatever ``dense_dtype`` is."""
    _, ct = _cfgs()
    dense = tmodel.init(3, ct, device="cpu")
    coded = tmodel.init(3, ct, device="cpu", w_bits=4, w_dist=w_dist)
    want = tmodel.quantize_for_serving(dense, 4, dist=w_dist, device="cpu")
    flat_c, flat_w = dict(_flat(coded)), dict(_flat(want))
    assert set(flat_c) == set(flat_w)
    for key, t in flat_w.items():
        assert torch.equal(flat_c[key], t), key
    # the reference's tree: the same paths and shapes
    flat_j = dict(_flat(jax.tree_util.tree_map(np.asarray, _dense_ref())))
    flat_d = dict(_flat(dense))
    assert set(flat_j) == set(flat_d)
    for key, a in flat_j.items():
        assert tuple(flat_d[key].shape) == a.shape, key
    bf = tmodel.init(3, ct, device="cpu", dense_dtype=torch.bfloat16)
    assert bf["dec_layers"]["cross_norm"]["bias"].dtype == torch.float32
    assert bf["enc_final_norm"]["scale"].dtype == torch.float32
    assert bf["dec_layers"]["cross_wq"].dtype == torch.bfloat16


@pytest.mark.parametrize("bits,dist", [(16, "gaussian"), (4, "gaussian"),
                                       (4, "empirical")])
def test_generate_matches_reference_past_half_the_length(bits, dist):
    """Greedy tokens of ``serve.generate`` equal the reference's with
    n_new (6) above max_len / 2 (10 / 2): the self cache holds 5 rows and
    the steps at positions 5..8 drop their writes in both.  The reference
    codes its params with ``prepare_params``, the port takes the codes
    across."""
    pj = _dense_ref()
    sc_j = jserve.ServeConfig(w_bits=bits, w_dist=dist)
    sc_t = tserve.ServeConfig(w_bits=bits, w_dist=dist)
    qj = jserve.prepare_params(pj, sc_j)
    qt = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, qj),
                                   device="cpu")
    jo, to = _opts()
    cj, ct = _cfgs()
    prompts = _tokens(cj, seed=5, shape=(B, 4))
    want = np.asarray(jserve.generate(qj, cj, jserve.make_serve_opts(jo, sc_j),
                                      sc_j, jnp.asarray(prompts), 6))
    got = tserve.generate(qt, ct, tserve.make_serve_opts(to, sc_t), sc_t,
                          torch.from_numpy(prompts), 6)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_a_bits_8_leaves_whisper_unchanged_as_in_the_reference():
    """The reference's encoder-decoder applies no activation fake-quant:
    its tokens at a_bits 8 equal those at 32, and so do the port's (which
    equal the reference's)."""
    pj, pt = _params(4)
    cj, ct = _cfgs()
    prompts = _tokens(cj, seed=6, shape=(B, 3))
    outs = {}
    for a_bits in (32, 8):
        jo, to = _opts(a_bits)
        sc_j = jserve.ServeConfig(w_bits=4, a_bits=a_bits)
        sc_t = tserve.ServeConfig(w_bits=4, a_bits=a_bits)
        outs[a_bits] = (
            np.asarray(jserve.generate(pj, cj,
                                       jserve.make_serve_opts(jo, sc_j),
                                       sc_j, jnp.asarray(prompts), 4)),
            tserve.generate(pt, ct, tserve.make_serve_opts(to, sc_t), sc_t,
                            torch.from_numpy(prompts), 4).numpy())
    np.testing.assert_array_equal(outs[8][0], outs[32][0])
    np.testing.assert_array_equal(outs[8][1], outs[32][1])
    np.testing.assert_array_equal(outs[8][1], outs[8][0])


def test_whisper_refuses_what_it_does_not_serve():
    """The engine keeps the reference's ValueError; the paged pool, the
    slot cache, chunked and padded prefill are refused as in the
    reference.  Training is ported: the loss of the dense tree is finite
    (its parity with the reference is ``test_torch_train_families.py``'s)."""
    _, ct = _cfgs()
    _, pt = _params(4)
    _, to = _opts()
    with pytest.raises(ValueError, match="decoder-only KV families"):
        teng.Engine(pt, ct, to, teng.EngineConfig(), device="cpu")
    _, bt = _batch(ct)
    with pytest.raises(ValueError, match="last_idx"):
        tmodel.prefill(pt, ct, to, bt, last_idx=torch.zeros(B,
                                                            dtype=torch.long))
    cache = tmodel.init_cache(ct, 1, 4, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="paged decode"):
        tmodel.decode(pt, ct, to, cache,
                      torch.zeros((1, 1), dtype=torch.long),
                      torch.zeros(1, dtype=torch.long),
                      block_tables=torch.zeros((1, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="paged cache"):
        tmodel.init_paged_cache(ct, 4, 8, device="cpu")
    with pytest.raises(ValueError, match="chunked prefill"):
        tmodel.prefill_chunk(pt, ct, to, cache, None, None, None, None,
                             None, None)
    with pytest.raises(ValueError, match="slot cache"):
        tmodel.init_slot_cache(ct, 2, 8, device="cpu")
    _, dense = _params(16)
    loss = tmodel.loss_fn(dense, ct, to, dict(bt, targets=bt["tokens"]))
    assert loss.shape == () and bool(torch.isfinite(loss))
    assert not tmodel.supports_paged_cache(ct)
    assert not tmodel.supports_slot_cache(ct)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cache_layout_matches_reference(dtype):
    """``init_cache`` / ``cache_specs``: the reference's four leaves of
    (Ld, B, max_len // 2, KV, hd), at the smoke and the full config."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    for cfg_j, cfg_t in ((jcb.get_smoke(ARCH), tcb.get_smoke(ARCH)),
                         (jcb.get(ARCH), tcb.get(ARCH))):
        want = jmodel.cache_specs(cfg_j, ShapeConfig("d", 41, 3, "decode"),
                                  dtype=jdt)
        specs = tmodel.cache_specs(cfg_t, 3, 41, dtype)
        assert set(specs) == set(want)
        for name, w in want.items():
            got = specs[name]
            assert got.device.type == "meta"
            assert tuple(got.shape) == w.shape, name
            assert str(got.dtype).replace("torch.", "") == str(w.dtype), name
    cache = tmodel.init_cache(tcb.get_smoke(ARCH), 3, 41, dtype,
                              device="cpu")
    assert all(not leaf.any() and leaf.dtype == dtype
               for leaf in cache.values())


@pytest.mark.parametrize("bits,dist", CODINGS)
def test_convert_carries_the_tree(bits, dist):
    """``params_from_numpy`` carries the reference's whisper tree leaf for
    leaf: the nested ``enc_layers`` / ``dec_layers``, the LayerNorm
    ``{"scale", "bias"}`` dicts, the coded leaves' dicts."""
    pj, pt = _params(bits, dist)
    flat_j = dict(_flat(jax.tree_util.tree_map(np.asarray, pj)))
    flat_t = dict(_flat(pt))
    assert set(flat_j) == set(flat_t)
    for key, a in flat_j.items():
        assert str(flat_t[key].dtype).replace("torch.", "") == a.dtype.name
        np.testing.assert_array_equal(flat_t[key].numpy(), a)
    assert set(pt["dec_layers"]["cross_norm"]) == {"scale", "bias"}
    back = convert.cache_to_numpy(
        tmodel.init_cache(tcb.get_smoke(ARCH), 2, 6, torch.bfloat16,
                          device="cpu"))
    assert set(back) == {"k", "v", "cross_k", "cross_v"}
    assert all(a.dtype == np.float32 for a in back.values())


def test_attention_raises_where_the_reference_would_chunk():
    """From S = attn_chunked_min_len on (the encoder's frames, then the
    decoder's tokens as well) both stacks attend in KV chunks, as the
    reference does; below it the materialized path runs unchanged.  Chunks
    of 2 rows divide both lengths; 3 rows fall back to one chunk."""
    _, pt = _params(16)
    _, to = _opts()
    _, ct = _cfgs()
    _, bt = _batch(ct)
    want, _ = tmodel.prefill(pt, ct, to, bt)
    for n in (TE, S):
        for kc in (2, 3):
            got, _ = tmodel.prefill(pt, ct, dataclasses.replace(
                to, attn_chunked_min_len=n, kv_chunk=kc), bt)
            # f32, the softmax summed in another order: 1e-5 of the logits
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=1e-5 * max(1.0, float(
                                           want.abs().max())))
    got, _ = tmodel.prefill(pt, ct, dataclasses.replace(
        to, attn_chunked_min_len=TE + 1), bt)
    assert torch.equal(got, want)


def test_decode_takes_both_tree_forms():
    """The decoder loop gives the same step on the stacked tree and on the
    per-layer list of ``dec_layers`` that ``generate`` slices once."""
    _, pt = _params(4)
    _, to = _opts()
    _, ct = _cfgs()
    flat = tlm.unstack_layers(pt, ct.dec_layers, "dec_layers")
    assert isinstance(flat["dec_layers"], list)
    assert flat["enc_layers"] is pt["enc_layers"]
    toks = torch.from_numpy(_tokens(ct, shape=(B, 1)))
    pos = torch.tensor([0, 3])
    (lg, cg), (lf, cf) = [
        tmodel.decode(tree, ct, to, tmodel.init_cache(ct, B, 8, torch.float32,
                                                      device="cpu"),
                      toks, pos) for tree in (pt, flat)]
    assert torch.equal(lg, lf)
    for name in cg:
        assert torch.equal(cg[name], cf[name]), name


@pytest.mark.parametrize("extra", [[], ["--w-dist", "empirical"],
                                   ["--a-bits", "8"]])
def test_closed_batch_through_the_cli_on_cpu(capsys, extra):
    """The serving CLI without --engine: dense weights from --seed, then
    their W4 copy; tok/s, agreement, a sample, replayable by --seed;
    --a-bits 8 is accepted, said to change nothing, and changes nothing;
    --engine raises the reference's ValueError."""
    from repro_torch.launch import serve as tlaunch
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--w-bits", "4",
            "--batch", "2", "--prompt-len", "4", "--new-tokens", "8",
            "--seed", "5"]
    stats = tlaunch.main(argv + extra)
    out = capsys.readouterr().out
    assert "tok/s host-loop" in out and "greedy agreement" in out
    assert ("leaves whisper_base_smoke unchanged" in out) == \
        ("--a-bits" in extra)
    assert tuple(stats["tokens"].shape) == (2, 8)
    assert 0 <= int(stats["tokens"].min()) and \
        int(stats["tokens"].max()) < 512
    if extra[:1] != ["--w-dist"]:
        assert torch.equal(tlaunch.main(argv)["tokens"], stats["tokens"])
    with pytest.raises(ValueError, match="decoder-only KV families"):
        tlaunch.main(argv[:9] + ["--engine", "--requests", "1"])
