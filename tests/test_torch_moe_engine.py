"""PyTorch port vs JAX reference: the MoE family (kimi_k2, llama4) and
stablelm_12b on the serving path.

Parameters of the reference (W4-coded there, so the codes are identical)
are carried across as numpy.  Prefill, the paged insert and one decode
step give logits within test_torch_lm.py's bounds; the paged engine at
kv16 / kv8 / kv4 and the slot engine give the reference engine's greedy
tokens; so does ``serve.generate``.  As the reference's own engine test
(``tests/test_engine.py::test_engine_moe_family``), the engine runs use
``capacity_factor=64.0``: padding rows (decode buckets, padded prompt
groups) then never push a real token's copy past its expert's capacity,
so a stream does not depend on its co-tenants; the drops themselves are
held bit-equal in ``tests/test_torch_moe.py``.
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
from repro.serve import serve as jserve

from repro_torch import convert
from repro_torch.configs import base as tcb
from repro_torch.kernels import ops as tops
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


MOE_ARCHS = ("kimi_k2_1t_a32b", "llama4_maverick_400b_a17b")
PAGE = 8
B, S = 2, 12
# as test_torch_lm.py: f32 logits, same weights and codes; and with a coded
# KV cache, where a row's bf16 statistic may land one ulp apart
TOL_LOGITS = 2e-4
TOL_LOGITS_KVQ = 2e-2
NO_DROP = 64.0


def _cfgs(arch, cf=None):
    cj, ct = jcb.get_smoke(arch), tcb.get_smoke(arch)
    if cf is not None:
        cj = dataclasses.replace(cj, capacity_factor=cf)
        ct = dataclasses.replace(ct, capacity_factor=cf)
    return cj, ct


@functools.lru_cache(maxsize=None)
def _params(arch, w_bits):
    p = jmodel.init(jax.random.PRNGKey(0), jcb.get_smoke(arch))
    if w_bits < 16:
        p = jmodel.quantize_for_serving(p, w_bits)
    return p, convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p), device="cpu")


JOPTS = JOpts(compute_dtype=jnp.float32, remat=False,
              attn_chunked_min_len=1 << 30)
TOPTS = tlm.ModelOpts(compute_dtype=torch.float32)


def _tokens(cfg, seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=shape).astype(np.int32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("w_bits,kv_bits", [(16, 16), (4, 16), (4, 8),
                                            (4, 4)])
def test_moe_prefill_insert_decode_matches_reference(arch, w_bits, kv_bits):
    """At the config's own capacity factor (24 rows, C = 8: copies drop
    in prefill, the same ones in both frameworks)."""
    cj, ct = _cfgs(arch)
    pj, pt = _params(arch, w_bits)
    jo = dataclasses.replace(JOPTS, kv_bits=kv_bits)
    to = dataclasses.replace(TOPTS, kv_bits=kv_bits)
    tol = TOL_LOGITS if kv_bits == 16 else TOL_LOGITS_KVQ
    toks = _tokens(ct)
    last = np.array([S - 1, S - 4], np.int32)
    lj, kvj = jmodel.prefill(pj, cj, jo, {"tokens": jnp.asarray(toks)},
                             last_idx=jnp.asarray(last))
    before = tops.launch_counts()
    lt, kvt = tmodel.prefill(pt, ct, to, {"tokens": torch.from_numpy(toks)},
                             last_idx=torch.from_numpy(last))
    assert tops.launch_counts() == before           # CPU: no launch
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=tol)

    n_pool = 1 + B * 3
    tables = np.arange(1, n_pool, dtype=np.int32).reshape(B, 3)
    cache_j = jmodel.init_paged_cache(cj, n_pool, PAGE, jnp.float32,
                                      kv_bits=kv_bits)
    cache_t = tmodel.init_paged_cache(ct, n_pool, PAGE, torch.float32,
                                      kv_bits=kv_bits, device="cpu")
    cache_j = jmodel.cache_insert_paged(cache_j, kvj,
                                        jnp.asarray(tables[:, :2]))
    cache_t = tmodel.cache_insert_paged(cache_t, kvt,
                                        torch.from_numpy(tables[:, :2]))
    nxt = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    pos = np.array([S, S - 3], np.int32)
    dj, _ = jmodel.decode(pj, cj, jo, cache_j, jnp.asarray(nxt)[:, None],
                          jnp.asarray(pos), block_tables=jnp.asarray(tables))
    dt, _ = tmodel.decode(pt, ct, to, cache_t,
                          torch.from_numpy(nxt)[:, None],
                          torch.from_numpy(pos),
                          block_tables=torch.from_numpy(tables))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=tol)


def _prompts(lens, seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in lens]


def _reqs(mod, prompts, n_new):
    return [mod.Request(uid=i, prompt=p.copy(), sampling=mod.SamplingParams(
        max_new_tokens=n_new, seed=i)) for i, p in enumerate(prompts)]


def _tok(outs):
    return [o.token_ids for o in outs]


ENGINES = {
    "paged_kv16": dict(kv_bits=16, page_size=PAGE),
    "paged_kv8": dict(kv_bits=8, page_size=PAGE),
    "paged_kv4": dict(kv_bits=4, page_size=PAGE, prefill_chunk=1),
    "slot": dict(cache_mode="slot"),
}


def _engine_parity(arch, w_bits, mode, cf, prompts, n_new):
    cj, ct = _cfgs(arch, cf)
    pj, pt = _params(arch, w_bits)
    ec = dict(max_slots=3, max_len=48, prefill_batch=2, min_bucket=8,
              **ENGINES[mode])
    ej = jeng.Engine(pj, cj, JOPTS, jeng.EngineConfig(**ec))
    et = teng.Engine(pt, ct, TOPTS, teng.EngineConfig(**ec), device="cpu")
    oj = ej.generate(_reqs(jeng, prompts, n_new))
    ot = et.generate(_reqs(teng, prompts, n_new))
    assert _tok(ot) == _tok(oj)
    assert [o.finish_reason for o in ot] == [o.finish_reason for o in oj]
    assert et.n_decode_steps == ej.n_decode_steps
    return et


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("mode", list(ENGINES))
def test_moe_engine_greedy_stream_matches_reference(arch, mode):
    """Five greedy requests through three slots (slots reused, groups and
    decode batches padded; kv4 prefills a page at a time) at W4."""
    prompts = _prompts([9, 5, 13, 7, 20], seed=3)
    et = _engine_parity(arch, 4, mode, NO_DROP, prompts, 8)
    assert et.paged == (mode != "slot")


def test_moe_generate_matches_reference():
    """``serve.generate`` (the closed batch over the slot cache) on the
    kimi_k2 smoke config at W4, every capacity rule the config's own (B
    rows a step: no drops at that load)."""
    arch = "kimi_k2_1t_a32b"
    cj, ct = _cfgs(arch)
    pj, pt = _params(arch, 4)
    prompts = np.random.default_rng(1).integers(
        0, ct.vocab, size=(2, 10)).astype(np.int32)
    sc_j, sc_t = jserve.ServeConfig(w_bits=4), tserve.ServeConfig(w_bits=4)
    want = np.asarray(jserve.generate(pj, cj,
                                      jserve.make_serve_opts(JOPTS, sc_j),
                                      sc_j, jnp.asarray(prompts), 8))
    got = tserve.generate(pt, ct, tserve.make_serve_opts(TOPTS, sc_t), sc_t,
                          torch.from_numpy(prompts), 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_stablelm_engine_matches_reference_at_kv8():
    """stablelm_12b (dense, head_dim 20 in the smoke config, 160 at full
    width) serves through the paged kv8 engine as the reference's."""
    prompts = _prompts([9, 5, 13, 7, 20], seed=4)
    _engine_parity("stablelm_12b", 4, "paged_kv8", None, prompts, 8)


def test_moe_cli_engine_and_closed_batch_on_cpu(capsys):
    """``--arch kimi_k2_1t_a32b --smoke``: the engine stream and the closed
    batch run through the CLI's ``main``."""
    from repro_torch.launch import serve as tserve_cli
    stats = tserve_cli.main([
        "--arch", "kimi_k2_1t_a32b", "--smoke", "--device", "cpu",
        "--engine", "--w-bits", "4", "--kv-bits", "8", "--requests", "4",
        "--rate", "200", "--max-slots", "4", "--new-tokens", "4",
        "--prompt-len", "12", "--max-len", "64", "--page-size", "8"])
    assert stats["requests"] == 4 and stats["new_tokens"] == 16
    closed = tserve_cli.main(["--arch", "llama4_maverick_400b_a17b",
                              "--smoke", "--device", "cpu", "--batch", "2",
                              "--prompt-len", "6", "--new-tokens", "3"])
    assert tuple(closed["tokens"].shape) == (2, 3)
    assert "greedy agreement" in capsys.readouterr().out
