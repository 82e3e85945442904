"""PyTorch port vs JAX reference: the two serving modes of the third slice,
int8 activations (``a_bits=8``: W4A8 / W8A8) and empirical codebooks
(``dist="empirical"``: ``{"q_codes", "q_lut"}`` weights), end to end.

Parameters are made and coded by the reference (so both engines multiply
identical codes and codebooks), carried across as numpy, and the same
greedy request stream goes through both engines — through a prefix-cache
hit with copy-on-write — and must give the same tokens.  Prefill and decode
logits are compared in f32 on the CPU; within the port, codebook serving
equals serving the same weights dequantized to dense, and layer-by-layer
coding at init equals coding the dense tree.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.models import model as jmodel
from repro.models.lm import ModelOpts as JOpts
from repro.serve import engine as jeng

from repro_torch import convert
from repro_torch.configs import base as tcb
from repro_torch.models import lm as tlm
from repro_torch.models import model as tmodel
from repro_torch.serve import engine as teng


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread for this module, restored after it: at
    these sizes more threads only add their OpenMP spin-waits, which take
    the cores of the suite's other parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "granite_3_8b"
PAGE = 8
B, S = 2, 12

# f32 logits of O(1) through two layers from identical codes: summation
# orders and transcendental implementations (as test_torch_lm.TOL_LOGITS).
TOL_LOGITS = 2e-4
# int8 activations: a token whose x / scale lands within rounding of a
# half-integer in one framework codes one step apart in the other (one
# step is scale = absmax / 127), and a kv8 row may be recoded
# (test_torch_lm.TOL_LOGITS_KVQ).  On this input nothing was recoded: the
# four modes' prefill logits agree within 1.8e-6.
TOL_LOGITS_A8 = 2e-2

# (w_bits, dist, a_bits, kv_bits): the four modes the slice serves
MODES = [(4, "gaussian", 8, 8), (8, "gaussian", 8, 16),
         (4, "empirical", 32, 8), (8, "empirical", 32, 16)]
MODE_IDS = ["W4A8-kv8", "W8A8-kv16", "W4emp-kv8", "W8emp-kv16"]


@functools.lru_cache(maxsize=None)
def _params(w_bits, dist):
    cfg = jcb.get_smoke(ARCH)
    p = jmodel.quantize_for_serving(jmodel.init(jax.random.PRNGKey(0), cfg),
                                    w_bits, dist=dist)
    return p, convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p), device="cpu")


def _opts(a_bits, kv_bits):
    jo = JOpts(compute_dtype=jnp.float32, remat=False,
               attn_chunked_min_len=1 << 30, kv_bits=kv_bits,
               serve_a_bits=a_bits)
    to = tlm.ModelOpts(compute_dtype=torch.float32, kv_bits=kv_bits,
                       serve_a_bits=a_bits)
    return jo, to


def _prompts(lens, seed, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in lens]


def _reqs(mod, prompts, n_new):
    return [mod.Request(uid=i, prompt=p.copy(), sampling=mod.SamplingParams(
        max_new_tokens=n_new, seed=i)) for i, p in enumerate(prompts)]


def _tok(outs):
    return [o.token_ids for o in outs]


@pytest.mark.parametrize("w_bits,dist,a_bits,kv_bits", MODES, ids=MODE_IDS)
def test_greedy_stream_with_prefix_hit_and_cow_matches_reference(
        w_bits, dist, a_bits, kv_bits):
    """A prompt registered with the prefix cache is submitted again twice
    (hits; the partial tail page is copied on write) next to an unrelated
    and an extending prompt, in both engines."""
    pj, pt = _params(w_bits, dist)
    ec = dict(max_slots=4, max_len=64, prefill_batch=2, min_bucket=8,
              page_size=PAGE, kv_bits=kv_bits, prefix_cache=True,
              a_bits=a_bits)
    JO = JOpts(compute_dtype=jnp.float32, remat=False,
               attn_chunked_min_len=1 << 30)
    TO = tlm.ModelOpts(compute_dtype=torch.float32)
    ej = jeng.Engine(pj, jcb.get_smoke(ARCH), JO, jeng.EngineConfig(**ec))
    et = teng.Engine(pt, tcb.get_smoke(ARCH), TO, teng.EngineConfig(**ec),
                     device="cpu")
    base = _prompts([19], seed=1)[0]
    ext = np.concatenate([base[:16], _prompts([7], seed=2)[0]])
    other = _prompts([11], seed=3)[0]
    results = []
    for mod, eng in ((jeng, ej), (teng, et)):
        first = eng.generate(_reqs(mod, [base], 6))
        second = eng.generate(_reqs(mod, [base, ext, other, base], 6))
        results.append((_tok(first), _tok(second), eng.stats()))
    (f_j, s_j, st_j), (f_t, s_t, st_t) = results
    assert st_j["cache_hits"] >= 3 and st_j["cow_copies"] >= 1
    for key in ("cache_hits", "cache_hit_pages", "cow_copies",
                "cached_pages"):
        assert st_t[key] == st_j[key], key
    assert f_t == f_j and s_t == s_j
    assert s_t[0] == f_t[0] == s_t[3]      # a hit serves what a cold run did
    assert et.opts.serve_a_bits == a_bits
    et.scheduler.check_invariants()


@pytest.mark.parametrize("w_bits,dist,a_bits,kv_bits", MODES, ids=MODE_IDS)
def test_prefill_and_decode_logits_match_reference(w_bits, dist, a_bits,
                                                   kv_bits):
    cfg_j, cfg_t = jcb.get_smoke(ARCH), tcb.get_smoke(ARCH)
    pj, pt = _params(w_bits, dist)
    jo, to = _opts(a_bits, kv_bits)
    tol = TOL_LOGITS if (a_bits == 32 and kv_bits == 16) else TOL_LOGITS_A8
    toks = np.random.default_rng(4).integers(0, cfg_t.vocab, size=(B, S)) \
        .astype(np.int32)
    lj, kvj = jmodel.prefill(pj, cfg_j, jo, {"tokens": jnp.asarray(toks)})
    lt, kvt = tmodel.prefill(pt, cfg_t, to, {"tokens": torch.from_numpy(toks)})
    assert lt.dtype == torch.float32 and tuple(lt.shape) == (B, cfg_t.vocab)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=tol)
    n_pool = 1 + B * 3
    tables = np.arange(1, n_pool, dtype=np.int32).reshape(B, 3)
    cj = jmodel.init_paged_cache(cfg_j, n_pool, PAGE, jnp.float32,
                                 kv_bits=kv_bits)
    ct = tmodel.init_paged_cache(cfg_t, n_pool, PAGE, torch.float32,
                                 kv_bits=kv_bits, device="cpu")
    cj = jmodel.cache_insert_paged(cj, kvj, jnp.asarray(tables[:, :2]))
    ct = tmodel.cache_insert_paged(ct, kvt, torch.from_numpy(tables[:, :2]))
    nxt = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    pos = np.array([S, S], np.int32)
    dj, _ = jmodel.decode(pj, cfg_j, jo, cj, jnp.asarray(nxt)[:, None],
                          jnp.asarray(pos), block_tables=jnp.asarray(tables))
    dt, _ = tmodel.decode(pt, cfg_t, to, ct, torch.from_numpy(nxt)[:, None],
                          torch.from_numpy(pos),
                          block_tables=torch.from_numpy(tables))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=tol)


@pytest.mark.parametrize("w_bits", [8, 4])
def test_codebook_serving_equals_dense_serving(w_bits):
    """The reference's test_engine.py LUT-vs-dense equality, within the
    port: greedy generation over the {"q_codes", "q_lut"} dicts equals
    generation over the same weights dequantized to dense f32 — the
    codebook matmul is the only difference."""
    _, pt = _params(w_bits, "empirical")
    leaves = [v for _, v in tlm._walk(pt) if tlm.is_qweight(v)]
    assert leaves and all("q_lut" in v and "q_mu" not in v for v in leaves)
    dense = {}
    for keys, v in tlm._walk(pt):
        tlm._set(dense, keys, tlm.materialize(v, torch.float32))
    prompts = _prompts([10, 7], seed=5)
    outs = []
    for params in (pt, dense):
        eng = teng.Engine(params, tcb.get_smoke(ARCH),
                          tlm.ModelOpts(compute_dtype=torch.float32),
                          teng.EngineConfig(max_slots=2, max_len=32,
                                            min_bucket=8, page_size=PAGE),
                          device="cpu")
        outs.append(_tok(eng.generate(_reqs(teng, prompts, 8))))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("w_bits", [4, 8])
def test_init_codes_empirical_layer_by_layer(w_bits):
    """init_params(w_dist="empirical") == quantize_params_for_serving(
    init_params(), dist="empirical") without a dense stacked leaf; every
    stacked leaf carries one codebook per layer."""
    cfg = dataclasses.replace(tcb.get_smoke(ARCH), vocab=511)
    dense = tlm.init_params(3, cfg, device="cpu")
    direct = tlm.init_params(3, cfg, device="cpu", w_bits=w_bits,
                             w_dist="empirical")
    via = tlm.quantize_params_for_serving(dense, w_bits, dist="empirical",
                                          device="cpu")
    fd, fv = dict(tlm._walk(direct)), dict(tlm._walk(via))
    assert set(fd) == set(fv)
    for key, v in fd.items():
        if tlm.is_qweight(v):
            assert set(v) == set(fv[key]) == {"q_codes", "q_lut"}
            for part in v:
                assert torch.equal(v[part], fv[key][part]), (key, part)
        else:
            assert torch.equal(v, fv[key]), key
    L, k = cfg.n_layers, 2 ** w_bits
    assert tuple(direct["layers"]["w_up"]["q_lut"].shape) == (L, k)
    assert tlm.is_qweight(direct["lm_head"]) == (w_bits == 8)
    with pytest.raises(ValueError):
        tlm.init_params(3, cfg, device="cpu", w_bits=w_bits, w_dist="lloyd")


def test_codebook_tree_crosses_the_frameworks_and_back():
    """A reference {"q_codes", "q_lut"} tree carried across keeps its codes'
    dtypes and its f32 codebooks whatever dtype the dense leaves take, and
    comes back to the same arrays."""
    pj, _ = _params(4, "empirical")
    tree = jax.tree_util.tree_map(np.asarray, pj)
    pt = convert.params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    assert pt["layers"]["wq"]["q_lut"].dtype == torch.float32
    assert pt["layers"]["wq"]["q_codes"].dtype == torch.uint8
    assert pt["embed"]["q_lut"].dtype == torch.float32
    assert pt["final_norm"].dtype == torch.bfloat16
    back = convert.train_state_to_numpy(pt)
    flat_j = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    for path, arr in jax.tree_util.tree_flatten_with_path(
            jax.tree_util.tree_map(np.asarray, back))[0]:
        want = flat_j[path]
        if path[-1].key in ("q_codes", "q_lut"):
            assert arr.dtype == want.dtype
            np.testing.assert_array_equal(arr, want)
        else:           # dense leaves went through bf16 on the way
            np.testing.assert_allclose(arr, want, rtol=2 ** -8, atol=0)


@pytest.mark.parametrize("flags", [["--a-bits", "8"],
                                   ["--w-dist", "empirical"],
                                   ["--a-bits", "8", "--w-dist", "empirical",
                                    "--w-bits", "8", "--kv-bits", "16"]])
def test_cli_serves_the_new_modes_on_cpu(flags, capsys):
    from repro_torch.launch import serve as tserve
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--engine",
            "--w-bits", "4", "--kv-bits", "8", "--requests", "6", "--rate",
            "200", "--max-slots", "4", "--new-tokens", "3", "--prompt-len",
            "12", "--max-len", "64", "--page-size", "8", "--prefix-cache",
            "--shared-prefix", "16", "--min-cache-hit-pages", "1"] + flags
    stats = tserve.main(argv)
    assert stats["requests"] == 6 and stats["new_tokens"] == 18
    assert stats["cache_hit_pages"] >= 1
    assert "[engine]" in capsys.readouterr().out
