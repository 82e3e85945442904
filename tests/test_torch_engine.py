"""PyTorch port vs JAX reference: the continuous-batching engine.

The same greedy request stream goes through both engines on parameters
carried across by numpy (codes included), and must give the same tokens —
through a forced preemption/resume and through a prefix-cache hit with
copy-on-write.  Within the port: chunked == whole prefill, preempt/resume,
decode bucketing, prefill coalescing and telemetry on/off leave the token
streams bit-identical, and sampled streams replay from their seed.
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
from repro.serve import engine as jeng

from repro_torch import convert
from repro_torch.configs import base as tcb
from repro_torch.models import kv_cache as tkv
from repro_torch.models import lm as tlm
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


@functools.lru_cache(maxsize=None)
def _params(w_bits):
    cfg = jcb.get_smoke(ARCH)
    p = jmodel.init(jax.random.PRNGKey(0), cfg)
    if w_bits < 16:
        p = jmodel.quantize_for_serving(p, w_bits)
    return p, convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p), device="cpu")


JOPTS = JOpts(compute_dtype=jnp.float32, remat=False,
              attn_chunked_min_len=1 << 30)
TOPTS = tlm.ModelOpts(compute_dtype=torch.float32)


def _prompts(lens, seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in lens]


def _reqs(mod, prompts, n_new, temperature=0.0, top_k=0, seeds=None):
    return [mod.Request(uid=i, prompt=p.copy(), sampling=mod.SamplingParams(
        temperature=temperature, top_k=top_k, max_new_tokens=n_new,
        seed=(seeds[i] if seeds else i))) for i, p in enumerate(prompts)]


def _both(w_bits, ec_kw, prompts, n_new):
    pj, pt = _params(w_bits)
    ej = jeng.Engine(pj, jcb.get_smoke(ARCH), JOPTS,
                     jeng.EngineConfig(**ec_kw))
    et = teng.Engine(pt, tcb.get_smoke(ARCH), TOPTS,
                     teng.EngineConfig(**ec_kw), device="cpu")
    return ej, et


def _tok(outs):
    return [o.token_ids for o in outs]


@pytest.mark.parametrize("w_bits,kv_bits", [(4, 8), (16, 16)])
def test_greedy_stream_with_forced_preemption_matches_reference(w_bits,
                                                                kv_bits):
    """6 usable pages cannot hold two 32-token sequences: the newer one is
    preempted mid-decode and resumed by re-prefilling prompt + generated."""
    ec = dict(max_slots=2, max_len=64, prefill_batch=2, min_bucket=8,
              page_size=8, total_pages=7, kv_bits=kv_bits)
    prompts = _prompts([8, 8, 5])
    ej, et = _both(w_bits, ec, prompts, 24)
    oj = ej.generate(_reqs(jeng, prompts, 24))
    ot = et.generate(_reqs(teng, prompts, 24))
    assert ej.n_preemptions >= 1 and et.n_preemptions == ej.n_preemptions
    assert [o.n_preempts for o in ot] == [o.n_preempts for o in oj]
    assert [o.finish_reason for o in ot] == ["length"] * 3
    assert _tok(ot) == _tok(oj)
    assert et.n_decode_steps == ej.n_decode_steps
    assert et.n_prefill_tokens == ej.n_prefill_tokens
    et.scheduler.check_invariants()


@pytest.mark.parametrize("w_bits,kv_bits", [(4, 8), (16, 16)])
def test_greedy_stream_with_prefix_hit_and_cow_matches_reference(w_bits,
                                                                 kv_bits):
    """A prompt registered with the prefix cache is submitted again twice
    (hits; the partial tail page is copied on write) next to an unrelated
    and an extending prompt."""
    ec = dict(max_slots=4, max_len=64, prefill_batch=2, min_bucket=8,
              page_size=8, kv_bits=kv_bits, prefix_cache=True)
    base = _prompts([19], seed=1)[0]
    ext = np.concatenate([base[:16], _prompts([7], seed=2)[0]])
    other = _prompts([11], seed=3)[0]
    ej, et = _both(w_bits, ec, None, 6)
    results = []
    for mod, eng in ((jeng, ej), (teng, et)):
        first = eng.generate(_reqs(mod, [base], 6))
        second = eng.generate(_reqs(mod, [base, ext, other, base], 6))
        results.append((_tok(first), _tok(second), eng.stats()))
    (f_j, s_j, st_j), (f_t, s_t, st_t) = results
    assert st_j["cache_hits"] >= 3 and st_j["cow_copies"] >= 1
    for key in ("cache_hits", "cache_hit_pages", "cache_hit_tokens",
                "cow_copies", "preemptions", "cached_pages"):
        assert st_t[key] == st_j[key], key
    assert f_t == f_j and s_t == s_j
    assert s_t[0] == f_t[0] == s_t[3]      # a hit serves what a cold run did
    et.scheduler.check_invariants()


# -- the port's own bit-identity contracts ---------------------------------

def _engine(w_bits=4, **kw):
    _, pt = _params(w_bits)
    base = dict(max_slots=4, max_len=64, prefill_batch=2, min_bucket=8,
                page_size=8, kv_bits=8)
    base.update(kw)
    return teng.Engine(pt, tcb.get_smoke(ARCH), TOPTS,
                       teng.EngineConfig(**base), device="cpu")


MIXED = dict(temperature=0.9, top_k=20)


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
@pytest.mark.parametrize("chunk_pages", [1, 2])
def test_chunked_prefill_matches_whole(kv_bits, chunk_pages):
    prompts = _prompts([5, 12, 20, 9, 17], seed=4)
    whole = _engine(kv_bits=kv_bits)
    want = whole.generate(_reqs(teng, prompts, 6))
    chunked = _engine(kv_bits=kv_bits, prefill_chunk=chunk_pages)
    got = chunked.generate(_reqs(teng, prompts, 6))
    assert _tok(got) == _tok(want)
    assert chunked.chunked and not whole.chunked
    if kv_bits < 16:
        # codes of the first prompt's first page: byte-identical whichever
        # way they were prefilled (a fresh engine each, same page ids)
        a, b = _engine(kv_bits=kv_bits), \
            _engine(kv_bits=kv_bits, prefill_chunk=chunk_pages)
        for e in (a, b):
            e.generate(_reqs(teng, prompts[1:2], 1))
        for name in ("k_codes", "k_mu", "k_sigma"):
            assert torch.equal(a._cache[name][0, 1], b._cache[name][0, 1])


@pytest.mark.parametrize("w_bits", [16, 4])
def test_preempt_resume_is_bit_identical(w_bits):
    """Greedy and sampled streams survive preemption/resume exactly: the
    draw of a row depends on (seed, position) only."""
    prompts = _prompts([8, 8, 6], seed=5)
    for kw in (dict(), MIXED):
        roomy = _engine(w_bits, max_slots=2)
        want = roomy.generate(_reqs(teng, prompts, 24, **kw))
        tight = _engine(w_bits, max_slots=2, total_pages=7)
        got = tight.generate(_reqs(teng, prompts, 24, **kw))
        assert roomy.n_preemptions == 0 and tight.n_preemptions >= 1
        assert sum(o.n_preempts for o in got) >= 1
        assert _tok(got) == _tok(want)
        assert all(o.finish_reason == "length" for o in got)


def test_bucketed_decode_is_bit_identical():
    prompts = _prompts([5, 9, 7], seed=6)
    outs = {}
    for flag in (True, False):
        eng = _engine(max_slots=32, bucket_decode=flag)
        outs[flag] = _tok(eng.generate(_reqs(teng, prompts, 8, **MIXED)))
        assert (eng.n_bucketed_steps > 0) == flag
    assert outs[True] == outs[False]


def test_coalesced_chunk_prefill_is_bit_identical():
    prompts = _prompts([20, 12, 17, 9], seed=7)
    outs = {}
    for flag in (True, False):
        eng = _engine(prefill_chunk=1, coalesce_prefill=flag)
        outs[flag] = _tok(eng.generate(_reqs(teng, prompts, 6, **MIXED)))
        assert (eng.stats()["prefill_chunk_calls_saved"] > 0) == flag
    assert outs[True] == outs[False]


def test_telemetry_on_off_is_bit_identical():
    prompts = _prompts([20, 12, 17, 9], seed=8)
    outs = {}
    for flag in (True, False):
        eng = _engine(prefix_cache=True, telemetry=flag)
        outs[flag] = _tok(eng.generate(_reqs(teng, prompts, 6, **MIXED)))
        snap = eng.metrics_snapshot({"w_bits": 4})
        assert snap["meta"]["kv_bits"] == 8
        assert (len(eng.chrome_trace()["traceEvents"]) > 0) == flag
    assert outs[True] == outs[False]


def test_sampled_streams_replay_from_the_seed():
    prompts = _prompts([7, 7], seed=9)
    prompts[1] = prompts[0].copy()
    a = _tok(_engine().generate(_reqs(teng, prompts, 12, seeds=[21, 22],
                                      **MIXED)))
    b = _tok(_engine().generate(_reqs(teng, prompts, 12, seeds=[21, 22],
                                      **MIXED)))
    assert a == b                                   # reproducible
    assert a[0] != a[1]                             # the seed matters
    # ... and not the slot, the batch or the company a request keeps
    alone = _tok(_engine().generate(_reqs(teng, prompts[1:], 12, seeds=[22],
                                          **MIXED)))
    assert alone[0] == a[1]
    greedy = _tok(_engine().generate(_reqs(teng, prompts[:1], 12)))
    assert greedy[0] != a[0]


def test_stop_token_and_stats():
    prompts = _prompts([9], seed=10)
    eng = _engine()
    free = eng.generate(_reqs(teng, prompts, 8))[0].token_ids
    stop = free[3]
    req = teng.Request(uid=0, prompt=prompts[0], sampling=teng.SamplingParams(
        max_new_tokens=8, stop_token=int(stop)))
    out = _engine().generate([req])[0]
    assert out.finish_reason == "stop"
    assert out.token_ids == free[:free.index(stop) + 1]
    st = eng.stats()
    assert {"preemptions", "cache_hits", "cow_copies",
            "cached_pages"} <= set(st)
    assert 0.0 < eng.kv_utilization <= 1.0


def test_page_fingerprint_of_a_hit_equals_a_cold_prefill():
    prompt = _prompts([17], seed=11)[0]

    def first_page_fp(eng):
        hit, pages = eng.scheduler.prefix_cache.lookup(prompt)
        assert hit >= 8 and pages
        return tkv.page_fingerprint(eng._cache, int(pages[0]))

    a, b = _engine(prefix_cache=True), _engine(prefix_cache=True)
    a.generate(_reqs(teng, [prompt], 2))
    b.generate(_reqs(teng, [prompt], 2))
    b.generate(_reqs(teng, [prompt], 2))            # served from the cache
    assert first_page_fp(a) == first_page_fp(b)


def test_engine_rejects_what_is_not_ported_and_bad_configs():
    _, pt = _params(4)
    cfg = tcb.get_smoke(ARCH)

    def make(**kw):
        return teng.Engine(pt, cfg, TOPTS, teng.EngineConfig(**kw),
                           device="cpu")

    # the slot cache and both debug aids are ported (their behaviour is
    # tests/test_torch_slot.py): each builds
    slot = make(cache_mode="slot")
    assert not slot.paged and not slot.scheduler.paged
    assert tuple(slot._cache["k"].shape)[1:3] == (slot.ec.max_slots,
                                                  slot.ec.max_len)
    assert make(checkify=True).ec.checkify
    assert make(profile_annotations=True).ec.profile_annotations
    # the int8 activation codec is ported: a_bits reaches the model options
    for bits in (8, 4, 2):
        assert make(a_bits=bits).opts.serve_a_bits == bits
    for kw in (dict(cache_mode="ring"), dict(kv_bits=5), dict(a_bits=1),
               dict(prefill_chunk=0)):
        with pytest.raises(ValueError):
            make(**kw)
    # ported families without a KV pool (whisper_base's smoke config, family
    # "audio", and mamba2's, family "ssm"): the reference's ValueError
    audio = tcb.get_smoke("whisper_base")
    with pytest.raises(ValueError, match="decoder-only KV families"):
        teng.Engine(pt, audio, TOPTS, teng.EngineConfig(), device="cpu")
    ssm = tcb.get_smoke("mamba2_1_3b")
    with pytest.raises(ValueError, match="decoder-only KV families"):
        teng.Engine(pt, ssm, TOPTS, teng.EngineConfig(), device="cpu")


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, pt = _params(4)
    with pytest.raises(RuntimeError, match="cuda"):
        teng.Engine(pt, tcb.get_smoke(ARCH), TOPTS, teng.EngineConfig())
    from repro_torch.launch import serve as tserve
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.main(["--arch", ARCH, "--smoke", "--engine"])


def test_cli_engine_stream_on_cpu(capsys):
    from repro_torch.launch import serve as tserve
    stats = tserve.main([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--engine",
        "--w-bits", "4", "--kv-bits", "8", "--requests", "6", "--rate",
        "200", "--max-slots", "4", "--new-tokens", "4", "--prompt-len",
        "12", "--max-len", "64", "--page-size", "8", "--prefix-cache",
        "--shared-prefix", "16", "--min-cache-hit-pages", "1"])
    assert stats["requests"] == 6 and stats["new_tokens"] == 24
    assert stats["cache_hit_pages"] >= 1
    assert "[engine]" in capsys.readouterr().out
    # without --engine: the closed batch (tests/test_torch_generate.py)
    closed = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "6",
                          "--new-tokens", "3"])
    assert tuple(closed["tokens"].shape) == (2, 3)
    assert "greedy agreement" in capsys.readouterr().out


def test_cli_serves_prompts_past_attn_chunked_min_len(monkeypatch):
    """The CLI never switches to chunked attention, as the reference CLI
    (attn_chunked_min_len=1 << 30): with the option's default cut to 8 for
    the test, a 12-token prompt is still served."""
    from repro_torch.launch import serve as tserve
    monkeypatch.setattr(tserve, "ModelOpts", lambda **kw: tlm.ModelOpts(
        **{"attn_chunked_min_len": 8, **kw}))
    stats = tserve.main([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--engine",
        "--w-bits", "4", "--kv-bits", "8", "--requests", "2", "--rate",
        "200", "--max-slots", "2", "--new-tokens", "2", "--prompt-len",
        "12", "--max-len", "64", "--page-size", "8"])
    assert stats["requests"] == 2 and stats["new_tokens"] == 4
