"""The port's copies of the host-only serving modules (scheduler, prefix
cache, telemetry) behave exactly as the originals.

The reference's model checker drives a scheduler as a transition system; a
factory hands it the port's class, so recorded traces and random action
schedules run through both copies in lockstep and must reach the same
canonical ``fingerprint()`` and pass ``check_invariants()`` at every step.
"""

import glob
import json
import os

import numpy as np
import pytest

from repro.analysis import modelcheck as mc
from repro.serve import prefix_cache as jpc
from repro.serve import scheduler as jsched
from repro.serve import telemetry as jtele

from repro_torch.serve import prefix_cache as tpc
from repro_torch.serve import scheduler as tsched
from repro_torch.serve import telemetry as ttele

CORPUS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "data",
                                       "mc_corpus", "*.json")))


def _port_factory(u):
    return mc.build_scheduler(u, cls=tsched.Scheduler)


def _lockstep(u, actions):
    """Apply ``actions`` to both worlds; returns how many were applied."""
    wj, wt = mc.World(u), mc.World(u, _port_factory)
    assert isinstance(wt.s, tsched.Scheduler)
    assert isinstance(wt.s.prefix_cache, tpc.PrefixCache)
    applied = 0
    for raw in actions:
        action = (raw[0], raw[1])
        assert wj.enabled(action) == wt.enabled(action)
        if not wj.enabled(action):
            continue
        wj.apply(action)
        wt.apply(action)
        applied += 1
        assert wt.fingerprint() == wj.fingerprint()
        wt.s.check_invariants()
        np.testing.assert_array_equal(wt.s.block_tables, wj.s.block_tables)
        for attr in ("n_running", "n_waiting", "n_free_pages",
                     "pages_in_use", "bytes_in_use", "tokens_in_use",
                     "cached_pages", "n_preemptions", "n_cache_hits",
                     "n_cache_hit_pages", "n_cow_copies",
                     "n_cache_evictions"):
            assert getattr(wt.s, attr) == getattr(wj.s, attr), attr
    return applied


@pytest.mark.parametrize("path", CORPUS, ids=[os.path.basename(p)
                                              for p in CORPUS])
def test_corpus_trace_replays_identically(path):
    with open(path) as fh:
        trace = json.load(fh)
    u = mc.Universe.from_spec(trace["universe"])
    assert _lockstep(u, trace["actions"]) > 0
    # and the port's copy is clean on it, as the original is
    assert mc.replay_world(u, [tuple(a) for a in trace["actions"]],
                           _port_factory) is None


@pytest.mark.parametrize("uni", mc.UNIVERSES, ids=[u.name
                                                   for u in mc.UNIVERSES])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_action_schedules_replay_identically(uni, seed):
    rng = np.random.default_rng(seed)
    probe = mc.World(uni)
    actions = []
    for _ in range(60):
        enabled = probe.enabled_actions()
        if not enabled:
            break
        a = enabled[int(rng.integers(len(enabled)))]
        probe.apply(a)
        actions.append(a)
    assert len(actions) >= 20
    assert _lockstep(uni, actions) == len(actions)


def test_scheduler_helpers_match():
    for n in (1, 7, 8, 9, 100, 513):
        for lo in (8, 16):
            assert tsched.bucket_len(n, lo) == jsched.bucket_len(n, lo)
        for page in (8, 64):
            assert tsched.pages_for(n, page) == jsched.pages_for(n, page)
    toks = np.arange(8, dtype=np.int32)
    assert tpc.chunk_key(toks) == jpc.chunk_key(toks)


def test_byte_budget_admits_the_same_pages():
    """pool_bytes // page_bytes pages, integer-equal in both copies (kv8
    and kv4 admit 25 and 43 sequences where kv16 admits 16)."""
    for page_bytes, want in ((256 * 64, 16), (132 * 64, None),
                             (68 * 64, None)):
        kw = dict(page_size=64, page_bytes=page_bytes,
                  pool_bytes=16 * 4 * 256 * 64 + page_bytes)
        a = jsched.Scheduler(64, 4, 16, 256, **kw)
        b = tsched.Scheduler(64, 4, 16, 256, **kw)
        assert a.total_pages == b.total_pages
        assert a.pool_bytes_total == b.pool_bytes_total
        if want:
            assert (b.total_pages - 1) // 4 == want


def _drive(tele_mod):
    clock = iter(np.arange(0.0, 1000.0, 0.125))
    tel = tele_mod.Telemetry(enabled=True, trace_capacity=8,
                             clock=lambda: float(next(clock)))
    reg = tel.registry
    h = reg.histogram("ttft_s", help="arrival -> first token")
    b = reg.histogram("batch", tele_mod.linear_buckets(0, 1, 8))
    c = reg.counter("tokens", help="tokens")
    reg.gauge("depth").set(3)
    rng = np.random.default_rng(0)
    for i in range(200):
        tel.observe(h, float(rng.exponential(0.05)))
        tel.observe(b, int(rng.integers(0, 9)))
        tel.inc(c, 2)
        with tel.span("step", n=i):
            tel.instant("tick", track="requests", tid=i % 3)
        tel.tracer.add_span("decode", i * 1.0, i * 1.0 + 0.5,
                            args={"batch": i})
    return tel, h


def test_telemetry_copy_is_equivalent():
    tj, hj = _drive(jtele)
    tt, ht = _drive(ttele)
    assert tt.snapshot({"k": 1}) == tj.snapshot({"k": 1})
    assert tt.registry.to_prometheus() == tj.registry.to_prometheus()
    assert tt.tracer.to_chrome_trace() == tj.tracer.to_chrome_trace()
    assert tt.tracer.n_dropped == tj.tracer.n_dropped > 0
    assert ttele.percentile_summary(ht, scale=1e3) == \
        jtele.percentile_summary(hj, scale=1e3)
    off = ttele.Telemetry(enabled=False)
    off.observe(off.registry.histogram("x"), 1.0)
    assert off.registry["x"].snapshot()["count"] == 0
