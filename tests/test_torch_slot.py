"""PyTorch port vs JAX reference: the slot KV cache and the slot-mode engine.

The same numpy inputs go through ``repro`` (JAX, CPU) and ``repro_torch``
(CPU) on the ``*_smoke`` configs of granite_3_8b, gemma2_9b (sliding
windows and logit caps) and yi_6b: the slot cache's layout, ``cache_insert``,
the slot branch of ``decode_step`` over several steps, activation fake-quant
(``a_bits``) in prefill and decode, and the slot-mode engine against the
reference's slot engine and the port's own paged kv16 engine.  Also the
engine's debug aids: ``checkify`` (raising on a bad position and on NaN
logits) and ``profile_annotations`` (the five ``torch.profiler`` ranges).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.models import lm as jlm
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


ARCHS = ("granite_3_8b", "gemma2_9b", "yi_6b")
B, S = 2, 28            # gemma2's smoke window is 32: decode crosses it
STEPS = 8               # decode steps after the prompt
MAX_LEN = S + STEPS + 4

# f32 logits of O(1) after two layers, same weights: different summation
# orders and transcendental implementations (as test_torch_lm.py).
TOL_LOGITS = 2e-4

# the reference's steps, compiled once per (config, options)
_jprefill = jax.jit(jmodel.prefill, static_argnums=(1, 2))
_jdecode = jax.jit(jmodel.decode, static_argnums=(1, 2))


@functools.lru_cache(maxsize=None)
def _params(arch, w_bits):
    p = jmodel.init(jax.random.PRNGKey(0), jcb.get_smoke(arch))
    if w_bits < 16:
        p = jmodel.quantize_for_serving(p, w_bits)
    return p, convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p), device="cpu")


def _opts(a_bits=32):
    jo = JOpts(compute_dtype=jnp.float32, remat=False,
               attn_chunked_min_len=1 << 30, a_bits=a_bits)
    to = tlm.ModelOpts(compute_dtype=torch.float32, a_bits=a_bits)
    return jo, to


def _tokens(cfg, seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=shape).astype(np.int32)


def test_cache_layout_matches_reference():
    for arch in ARCHS:
        cj, ct = jcb.get_smoke(arch), tcb.get_smoke(arch)
        want = jlm.init_cache(cj, 3, 40, jnp.float32)
        got = tmodel.init_cache(ct, 3, 40, torch.float32, device="cpu")
        specs = tmodel.cache_specs(ct, 3, 40, torch.bfloat16)
        for name in ("k", "v"):
            assert tuple(got[name].shape) == want[name].shape
            assert got[name].dtype == torch.float32
            assert not got[name].any()
            assert tuple(specs[name].shape) == want[name].shape
            assert specs[name].device.type == "meta"
            assert specs[name].dtype == torch.bfloat16
        slot = tmodel.init_slot_cache(ct, 3, 40, device="cpu")
        assert slot["k"].dtype == torch.bfloat16
        assert tuple(slot["k"].shape) == want["k"].shape


def test_supports_slot_cache_as_the_reference():
    for arch in jcb.ARCH_IDS:
        cfg = jcb.get_smoke(arch)
        tcfg = dataclasses.replace(tcb.get_smoke("granite_3_8b"),
                                   family=cfg.family)
        assert tmodel.supports_slot_cache(tcfg) == \
            jmodel.supports_slot_cache(cfg), arch
    ssm = dataclasses.replace(tcb.get_smoke("granite_3_8b"), family="ssm")
    with pytest.raises(ValueError):
        tmodel.init_slot_cache(ssm, 2, 8, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_insert_matches_reference(arch):
    """``cache_insert`` of a padded prefill block into slots (one named
    twice, as the engine pads a group): bit-equal at f32, rows past the
    block untouched."""
    cj, ct = jcb.get_smoke(arch), tcb.get_smoke(arch)
    r = np.random.default_rng(1)
    shape = (cj.n_layers, 3, 12, cj.n_kv_heads, cj.head_dim)
    kv = {n: r.standard_normal(shape).astype(np.float32) for n in ("k", "v")}
    start = {n: r.standard_normal((cj.n_layers, 4, 20, cj.n_kv_heads,
                                   cj.head_dim)).astype(np.float32)
             for n in ("k", "v")}
    slots = np.array([2, 0, 2], np.int32)
    kv["k"][:, 2], kv["v"][:, 2] = kv["k"][:, 0], kv["v"][:, 0]
    want = jmodel.cache_insert({n: jnp.asarray(x) for n, x in start.items()},
                               {n: jnp.asarray(x) for n, x in kv.items()},
                               jnp.asarray(slots))
    got = {n: torch.from_numpy(x.copy()) for n, x in start.items()}
    out = tmodel.cache_insert(got, {n: torch.from_numpy(x)
                                    for n, x in kv.items()},
                              torch.from_numpy(slots))
    for n in ("k", "v"):
        assert out[n] is got[n]                          # in place
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
        np.testing.assert_array_equal(got[n][:, :, 12:].numpy(),
                                      start[n][:, :, 12:])
    # bf16 cache: the block is cast to the cache's dtype
    b16 = {n: torch.zeros(start[n].shape, dtype=torch.bfloat16)
           for n in ("k", "v")}
    tmodel.cache_insert(b16, {n: torch.from_numpy(x) for n, x in kv.items()},
                        torch.from_numpy(slots))
    assert torch.equal(b16["k"][:, 0, :12],
                       torch.from_numpy(kv["k"][:, 1]).to(torch.bfloat16))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("w_bits", [16, 4])
@pytest.mark.parametrize("a_bits", [32, 8])
def test_slot_decode_matches_reference(arch, w_bits, a_bits):
    """Prefill (right-padded group, per-row last positions), insert into
    slots 1 and 0 of a three-slot cache, then STEPS decode steps at per-row
    positions: logits within TOL_LOGITS of the reference's at every step,
    and the cache rows each step writes equal to the reference's within
    the same bound.  The port's cache rows past each row's position hold
    random values, the reference's zeros: they must not matter.  At
    ``a_bits`` 8 every layer's output is fake-quantized on both sides
    (``_maybe_quant_act``)."""
    cfg_j, cfg_t = jcb.get_smoke(arch), tcb.get_smoke(arch)
    pj, pt = _params(arch, w_bits)
    jo, to = _opts(a_bits)
    toks = _tokens(cfg_t)
    last = np.array([S - 1, S - 5], np.int32)
    lj, kvj = _jprefill(pj, cfg_j, jo, {"tokens": jnp.asarray(toks)},
                        last_idx=jnp.asarray(last))
    lt, kvt = tmodel.prefill(pt, cfg_t, to, {"tokens": torch.from_numpy(toks)},
                             last_idx=torch.from_numpy(last))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL_LOGITS)

    slots = np.array([1, 0], np.int32)
    cj = jmodel.cache_insert(jlm.init_cache(cfg_j, 3, MAX_LEN, jnp.float32),
                             kvj, jnp.asarray(slots))
    ct = tmodel.init_cache(cfg_t, 3, MAX_LEN, torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(5)
    for leaf in ct.values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen) * 3.0)
    ct = tmodel.cache_insert(ct, kvt, torch.from_numpy(slots))
    # the reference's cache holds zeros past each prompt; the port's holds
    # random rows there (and in slot 2, which decodes garbage throughout)
    pos = np.array([0, 0, 0], np.int32)
    pos[slots] = last + 1
    nxt = np.zeros(3, np.int32)
    nxt[slots] = np.asarray(jnp.argmax(lj, -1))
    for step in range(STEPS):
        dj, cj = _jdecode(pj, cfg_j, jo, cj, jnp.asarray(nxt)[:, None],
                          jnp.asarray(pos))
        dt, ct = tmodel.decode(pt, cfg_t, to, ct,
                               torch.from_numpy(nxt)[:, None],
                               torch.from_numpy(pos))
        np.testing.assert_allclose(dt.numpy()[slots],
                                   np.asarray(dj)[slots], atol=TOL_LOGITS,
                                   err_msg=f"step {step}")
        for n in ("k", "v"):
            for s in slots:
                np.testing.assert_allclose(
                    ct[n][:, s, pos[s]].numpy(),
                    np.asarray(cj[n])[:, s, pos[s]], atol=TOL_LOGITS)
        nxt = np.asarray(jnp.argmax(dj, -1)).astype(np.int32)
        pos = pos + 1


def test_decode_refuses_a_coded_cache_without_block_tables():
    cfg = tcb.get_smoke("granite_3_8b")
    _, pt = _params("granite_3_8b", 4)
    pool = tmodel.init_paged_cache(cfg, 3, 8, torch.float32, kv_bits=8,
                                   device="cpu")
    with pytest.raises(ValueError, match="paged"):
        tmodel.decode(pt, cfg, _opts()[1], pool,
                      torch.zeros((2, 1), dtype=torch.long),
                      torch.zeros(2, dtype=torch.long))


# -- the slot-mode engine --------------------------------------------------

JOPTS, TOPTS = _opts()


def _prompts(lens, seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in lens]


def _reqs(mod, prompts, n_new, temperature=0.0, seeds=None):
    return [mod.Request(uid=i, prompt=p.copy(), sampling=mod.SamplingParams(
        temperature=temperature, max_new_tokens=n_new,
        seed=(seeds[i] if seeds else i))) for i, p in enumerate(prompts)]


def _tok(outs):
    return [o.token_ids for o in outs]


SLOT_EC = dict(max_slots=3, max_len=64, prefill_batch=2, min_bucket=8,
               cache_mode="slot")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("w_bits", [16, 4])
def test_slot_engine_matches_reference(arch, w_bits):
    """Five greedy requests through three slots (slots reused, groups
    padded) in the reference's slot engine and the port's: equal tokens,
    finish reasons, decode steps and prefill calls."""
    pj, pt = _params(arch, w_bits)
    prompts = _prompts([9, 5, 13, 7, 30], seed=3)
    ej = jeng.Engine(pj, jcb.get_smoke(arch), JOPTS,
                     jeng.EngineConfig(**SLOT_EC))
    et = teng.Engine(pt, tcb.get_smoke(arch), TOPTS,
                     teng.EngineConfig(**SLOT_EC), device="cpu")
    oj = ej.generate(_reqs(jeng, prompts, 12))
    ot = et.generate(_reqs(teng, prompts, 12))
    assert _tok(ot) == _tok(oj)
    assert [o.finish_reason for o in ot] == [o.finish_reason for o in oj]
    assert et.n_decode_steps == ej.n_decode_steps
    assert et.n_prefill_calls == ej.n_prefill_calls
    assert not et.paged and et.scheduler.paged is False


@pytest.mark.parametrize("temperature", [0.0, 0.9])
@pytest.mark.parametrize("arch", ["granite_3_8b", "gemma2_9b"])
def test_slot_engine_equals_the_paged_kv16_engine(arch, temperature):
    """The slot engine and the paged kv16 engine on one request set:
    greedy and sampled streams equal (sampling keyed by (seed, position)
    in both; the attended rows hold the same values)."""
    _, pt = _params(arch, 4)
    cfg = tcb.get_smoke(arch)
    prompts = _prompts([9, 5, 13, 7, 30], seed=4)
    seeds = [11, 12, 13, 14, 15]
    outs = []
    for ec in (SLOT_EC, dict(SLOT_EC, cache_mode="paged", page_size=8)):
        eng = teng.Engine(pt, cfg, TOPTS, teng.EngineConfig(**ec),
                          device="cpu")
        outs.append(eng.generate(_reqs(teng, prompts, 12, temperature,
                                       seeds)))
    assert _tok(outs[0]) == _tok(outs[1])
    assert all(o.finish_reason == "length" for o in outs[0])


def test_slot_engine_evicts_at_max_len():
    """A sequence that outgrows its fixed region is finished "evicted"
    (terminal) and its slot goes to the waiting request, as the
    reference's ``test_engine_slot_mode_eviction_on_cache_exhaustion``."""
    cfg = tcb.get_smoke("granite_3_8b")
    _, pt = _params("granite_3_8b", 16)
    ec = teng.EngineConfig(max_slots=1, max_len=16, prefill_batch=1,
                           min_bucket=8, cache_mode="slot")
    eng = teng.Engine(pt, cfg, TOPTS, ec, device="cpu")
    long_req, short_req = _reqs(teng, _prompts([8, 4], seed=5), 100)
    short_req.sampling = dataclasses.replace(short_req.sampling,
                                             max_new_tokens=2)
    outs = eng.generate([long_req, short_req])
    assert outs[0].finish_reason == "evicted"
    assert len(outs[0].token_ids) == ec.max_len - 8 + 1
    assert outs[1].finish_reason == "length"
    assert eng.scheduler.n_evicted == 1


def test_slot_engine_refuses_paged_only_options():
    cfg = tcb.get_smoke("granite_3_8b")
    _, pt = _params("granite_3_8b", 16)
    for kw in (dict(kv_bits=8), dict(pool_bytes=1 << 20),
               dict(prefix_cache=True), dict(prefill_chunk=1)):
        with pytest.raises(ValueError):
            teng.Engine(pt, cfg, TOPTS, teng.EngineConfig(**SLOT_EC, **kw),
                        device="cpu")


# -- checkify and profiler ranges ------------------------------------------

@pytest.mark.parametrize("cache_mode", ["slot", "paged"])
def test_checkify_and_annotations_leave_tokens_unchanged(cache_mode):
    _, pt = _params("granite_3_8b", 4)
    cfg = tcb.get_smoke("granite_3_8b")
    prompts = _prompts([9, 5, 13, 20], seed=6)
    ec = dict(SLOT_EC, cache_mode=cache_mode,
              **({"page_size": 8, "prefix_cache": True}
                 if cache_mode == "paged" else {}))
    outs = []
    for extra in ({}, {"checkify": True, "profile_annotations": True}):
        eng = teng.Engine(pt, cfg, TOPTS, teng.EngineConfig(**ec, **extra),
                          device="cpu")
        outs.append(_tok(eng.generate(_reqs(teng, prompts, 8, 0.7))))
    assert outs[0] == outs[1]


def test_checkify_raises_on_a_position_past_max_len():
    """A corrupted position is caught before the step writes with it: the
    error names the step and the check, and the cache is untouched."""
    _, pt = _params("granite_3_8b", 16)
    cfg = tcb.get_smoke("granite_3_8b")
    eng = teng.Engine(pt, cfg, TOPTS, teng.EngineConfig(**SLOT_EC,
                                                        checkify=True),
                      device="cpu")
    eng.submit(_reqs(teng, _prompts([9]), 8)[0])
    eng.step()                                        # admit + one decode
    slot = next(iter(eng._slots))
    eng._positions[slot] = SLOT_EC["max_len"] + 3
    before = {n: t.clone() for n, t in eng._cache.items()}
    with pytest.raises(RuntimeError, match="engine.decode.*positions"):
        eng.step()
    for n in before:
        assert torch.equal(eng._cache[n], before[n])


@pytest.mark.parametrize("cache_mode", ["slot", "paged"])
def test_checkify_raises_on_nan_logits(cache_mode):
    """A NaN in the final norm's scale makes every logit NaN: the prefill
    step raises, naming the check."""
    _, pt = _params("granite_3_8b", 16)
    cfg = tcb.get_smoke("granite_3_8b")
    bad = dict(pt, final_norm=torch.full_like(pt["final_norm"], np.nan))
    ec = dict(SLOT_EC, cache_mode=cache_mode,
              **({"page_size": 8} if cache_mode == "paged" else {}))
    eng = teng.Engine(bad, cfg, TOPTS, teng.EngineConfig(**ec, checkify=True),
                      device="cpu")
    eng.submit(_reqs(teng, _prompts([9]), 4)[0])
    with pytest.raises(RuntimeError, match="engine.prefill.*logits finite"):
        eng.step()
    # without checkify the same engine samples from NaN logits silently
    quiet = teng.Engine(bad, cfg, TOPTS, teng.EngineConfig(**ec),
                        device="cpu")
    assert len(quiet.generate(_reqs(teng, _prompts([9]), 2))) == 1


def test_checkify_raises_on_a_block_table_entry_past_the_pool():
    _, pt = _params("granite_3_8b", 16)
    cfg = tcb.get_smoke("granite_3_8b")
    eng = teng.Engine(pt, cfg, TOPTS, teng.EngineConfig(
        max_slots=2, max_len=64, prefill_batch=2, min_bucket=8, page_size=8,
        checkify=True), device="cpu")
    eng.submit(_reqs(teng, _prompts([9]), 8)[0])
    eng.step()
    slot = next(iter(eng._slots))
    eng.scheduler.block_tables[slot, 0] = eng.scheduler.total_pages
    with pytest.raises(RuntimeError, match="block_tables in range"):
        eng.step()


@pytest.mark.parametrize("cache_mode", ["slot", "paged"])
def test_profile_annotations_name_the_device_steps(cache_mode):
    """Under ``torch.profiler`` on the CPU the engine's device steps show
    up as the reference's five range names (the paged engine with prefix
    caching runs chunked prefill and a copy-on-write; whole prefill and
    the cache insert run in a paged engine without it and in the slot
    engine)."""
    _, pt = _params("granite_3_8b", 16)
    cfg = tcb.get_smoke("granite_3_8b")
    base = _prompts([19], seed=1)[0]
    names = set()
    configs = [dict(SLOT_EC, cache_mode=cache_mode,
                    **({"page_size": 8} if cache_mode == "paged" else {}))]
    if cache_mode == "paged":
        configs.append(dict(configs[0], prefix_cache=True))
    for ec in configs:
        eng = teng.Engine(pt, cfg, TOPTS, teng.EngineConfig(
            **ec, profile_annotations=True), device="cpu")
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            eng.generate(_reqs(teng, [base], 3))
            eng.generate(_reqs(teng, [base, base], 3))
        names |= {e.key for e in prof.key_averages()
                  if e.key.startswith("engine.")}
    want = {"engine.decode", "engine.prefill", "engine.cache_insert"}
    if cache_mode == "paged":
        want |= {"engine.prefill_chunk", "engine.cow"}
    assert names == want
    # off by default: no range
    eng = teng.Engine(pt, cfg, TOPTS, teng.EngineConfig(**configs[0]),
                      device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.generate(_reqs(teng, [base], 2))
    assert not any(e.key.startswith("engine.") for e in prof.key_averages())
