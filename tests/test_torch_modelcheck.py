"""The port's model checker (``repro_torch.analysis.modelcheck``) against
the JAX package's (``repro.analysis.modelcheck``).

Both drive their package's own scheduler and prefix cache, so equal
exploration statistics, equal mutant counterexamples (raw and shrunk,
action for action) and equal corpus replays show the port's copies behave
as the originals over every bounded interleaving.  The corpus traces then
replay on the port's engine (on the CPU, over the reference's weights
carried across by numpy) and must trip the same invariant with no action
skipped; a healthy trace's greedy streams must equal the reference
engine's, and two replays must agree to the bit.
"""

import functools
import glob
import os

import jax
import numpy as np
import pytest
import torch

from repro.analysis import modelcheck as jmc
from repro.configs import base as jcb
from repro.models import model as jmodel

from repro_torch import convert
from repro_torch.analysis import modelcheck as tmc
from repro_torch.configs import base as tcb
from repro_torch.models.lm import ModelOpts

ARCH = "granite_3_8b"
CORPUS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "data",
                                       "mc_corpus", "*.json")))
# the committed universes and the mutants' own (five in all)
UNIVERSES = {u.name: u for u in tmc.UNIVERSES}
UNIVERSES.update({u.name: u for _, u in tmc.MUTANTS.values()})


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The engines here run tiny tensors, which intra-op threads only
    slow down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_universe(u):
    return jmc.Universe.from_spec(u.spec())


@functools.lru_cache(maxsize=None)
def _ref_stats(name):
    """The reference's exploration of one universe (computed once)."""
    st = jmc.explore(_ref_universe(UNIVERSES[name])).stats()
    st.pop("elapsed_s")
    return st


@functools.lru_cache(maxsize=None)
def _ref_hunt(name):
    res = jmc.hunt_mutant(name)
    _cls, u = jmc.MUTANTS[name]
    shrunk = jmc.shrink_trace(u, res.trace, res.violation_key,
                              jmc.mutant_factory(name))
    return res.violation_key, list(res.trace), list(shrunk)


@functools.lru_cache(maxsize=None)
def _port_engine_fixture():
    """The reference's replay model (smoke granite, f32, seed 0) carried
    into the port."""
    p = jmodel.init(jax.random.PRNGKey(0), jcb.get_smoke(ARCH))
    params = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                       device="cpu")
    opts = ModelOpts(compute_dtype=torch.float32, remat=False,
                     attn_chunked_min_len=1 << 30, kv_chunk=16, ssd_chunk=8,
                     ce_chunk=64)
    return params, tcb.get_smoke(ARCH), opts


def _replay_port(u, actions, mutant=None):
    params, cfg, opts = _port_engine_fixture()
    return tmc.replay_on_engine(u, actions, mutant=mutant, device="cpu",
                                params=params, cfg=cfg, opts=opts)


def drive_to_completion(u, n_requests, cap=64):
    """Deterministic forward walk: always the first enabled action among
    submit < schedule < chunk < decode, i.e. normal engine progress."""
    w = tmc.World(u)
    actions = []
    forward = ("submit", "schedule", "chunk", "decode")
    while w.n_finished < n_requests and len(actions) < cap:
        act = next(a for a in w.enabled_actions()
                   if a[0] in forward
                   and not (a[0] == "submit" and w.uid >= n_requests))
        w.apply(act)
        actions.append(act)
    assert w.n_finished == n_requests
    return actions


# -- exploration -------------------------------------------------------------

@pytest.mark.parametrize("name", [
    pytest.param(n, marks=pytest.mark.slow) if n == "u2p6" else n
    for n in sorted(UNIVERSES)])
def test_explore_statistics_equal_the_reference(name):
    st = tmc.explore(UNIVERSES[name]).stats()
    st.pop("elapsed_s")
    assert st == _ref_stats(name)
    assert st["exhausted"] and st["violation_key"] is None


def test_universes_and_mutants_are_the_reference_ones():
    assert [u.spec() for u in tmc.UNIVERSES] == \
        [u.spec() for u in jmc.UNIVERSES]
    assert sorted(tmc.MUTANTS) == sorted(jmc.MUTANTS)
    for name, (_cls, u) in tmc.MUTANTS.items():
        assert u.spec() == jmc.MUTANTS[name][1].spec()


# -- mutants -----------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(tmc.MUTANTS))
def test_mutant_traces_equal_the_reference(name):
    res = tmc.hunt_mutant(name)
    _cls, u = tmc.MUTANTS[name]
    shrunk = tmc.shrink_trace(u, res.trace, res.violation_key,
                              tmc.mutant_factory(name))
    key, raw, ref_shrunk = _ref_hunt(name)
    assert res.violation_key == key
    assert list(res.trace) == raw
    assert shrunk == ref_shrunk
    assert len(shrunk) <= 10
    got = tmc.replay_world(u, shrunk, tmc.mutant_factory(name))
    assert got is not None and got[1].key == key


# -- the corpus -------------------------------------------------------------

@pytest.mark.parametrize("path", CORPUS, ids=[os.path.basename(p)
                                              for p in CORPUS])
def test_corpus_replays_host_side_as_the_reference(path):
    doc, ref = tmc.load_trace(path), jmc.load_trace(path)
    u, actions = doc["universe"], doc["actions"]
    assert u.spec() == ref["universe"].spec() and actions == ref["actions"]
    if doc.get("expect_clean"):
        assert tmc.replay_world(u, actions) is None
        assert jmc.replay_world(ref["universe"], actions) is None
    else:
        got = tmc.replay_world(u, actions, tmc.mutant_factory(doc["mutant"]))
        want = jmc.replay_world(ref["universe"], actions,
                                jmc.mutant_factory(doc["mutant"]))
        assert got is not None and want is not None
        assert (got[0], got[1].key) == (want[0], want[1].key)
        assert got[1].key == doc["invariant"]


@pytest.mark.parametrize("path", CORPUS, ids=[os.path.basename(p)
                                              for p in CORPUS])
def test_corpus_replays_on_the_port_engine(path):
    """The counterexample is not an artifact of the host World: against
    the port's engine (device pool, COW copy, paged attention, KV append)
    it trips the same invariant, every action applied."""
    doc = tmc.load_trace(path)
    rep = _replay_port(doc["universe"], doc["actions"], mutant=doc["mutant"])
    assert rep.n_skipped == 0
    if doc.get("expect_clean"):
        assert rep.violation_key is None
    else:
        assert rep.violation_key == doc["invariant"]


def test_healthy_replay_streams_equal_the_reference_engine():
    """Same forward trace: the port's engine gives the reference engine's
    greedy streams, and two port replays agree to the bit."""
    u = UNIVERSES["u2p6"]
    actions = drive_to_completion(u, n_requests=2)
    a = _replay_port(u, actions)
    b = _replay_port(u, actions)
    ref = jmc.replay_on_engine(_ref_universe(u), actions)
    assert a.violation_key is None and ref.violation_key is None
    assert a.n_skipped == b.n_skipped == ref.n_skipped == 0
    assert a.streams and a.streams == b.streams == ref.streams


def test_default_engine_fixture_needs_the_card_unless_asked():
    """The replay runs on the card by default and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    u = UNIVERSES["u2p6"]
    with pytest.raises(RuntimeError, match="cuda"):
        tmc.replay_on_engine(u, [("submit", 0)])


# -- run_mc and the trace files ----------------------------------------------

def test_run_mc_budget_truncation_is_a_finding():
    findings, stats = tmc.run_mc(budget_s=0.0,
                                 universes=(UNIVERSES["u2p6"],))
    assert [f.rule for f in findings] == ["MC-BUDGET"]
    assert not stats[0]["exhausted"]


@pytest.mark.slow
def test_run_mc_full_pass_is_clean(tmp_path):
    findings, stats = tmc.run_mc(budget_s=120.0, corpus_dir=str(tmp_path))
    assert findings == []
    assert all(st["exhausted"] for st in stats)
    assert os.listdir(str(tmp_path)) == []


def test_trace_files_cross_load(tmp_path):
    """A trace the port writes loads in the reference and back."""
    u = UNIVERSES["u2p6"]
    actions = [("submit", 0), ("schedule", None), ("chunk", 0)]
    path = str(tmp_path / "t.json")
    tmc.save_trace(path, u, actions, "refcount-mismatch", "msg",
                   mutant="leak_on_release", extra={"shrunk_from": 9})
    ref = jmc.load_trace(path)
    assert ref["universe"] == _ref_universe(u)
    assert ref["actions"] == actions and ref["shrunk_from"] == 9
    doc = tmc.load_trace(path)
    assert doc["universe"] == u and doc["mutant"] == "leak_on_release"
