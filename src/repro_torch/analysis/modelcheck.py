"""uniqmc: explicit-state bounded model checking of the port's paged
scheduler.

The serving stack's hard correctness problem is host-side: the paged
scheduler (serve/scheduler.py) refcounts quantized KV pages shared
across COW, preemption, chunked prefill and LRU eviction.  Randomized
traces sample that state space; this module *exhausts* it up to a bound —
every interleaving of scheduler actions over a small universe, with the
full invariant catalog checked after every transition.

Design rules:

  * **no parallel model** — the transition system *is* the real
    ``Scheduler`` + ``PrefixCache``, driven through the deterministic
    action API (``clone``/``preempt_slot``/``reserve_pages``/...).  A
    shadow model would drift; this one cannot.
  * **engine-faithful actions** — each action replays exactly the call
    sequence ``serve/engine.py`` makes (schedule -> mark prefilling;
    prepare_chunk_writes -> drain COW -> chunk; ensure_decode_pages ->
    drain COW -> decode; complete on finish), plus transitions the
    engine only takes under pressure (forced preempt, pool-pressure
    injection, cache flush) so rare interleavings are covered, not
    sampled.
  * **canonical hashing** — states isomorphic under physical page
    relabeling and submission-uid shifts hash equal (pages are
    relabeled by first appearance in a fixed traversal; sequences by
    FCFS rank + prompt identity), so the DFS explores equivalence
    classes, not raw states.
  * **counterexamples are artifacts** — a violation is delta-debug
    shrunk to a 1-minimal action trace, serialized as JSON, and
    replayable both host-side (``replay_world``) and against a live
    ``serve/engine.py`` (``replay_on_engine``, on the card by default:
    its device pool, the COW copy, the paged attention and KV append
    kernels) where the same invariant must trip.

The traces, universes and keys are those of the JAX package's checker, so
a trace written by either replays on both.

Entry points: ``explore`` (one universe), ``run_mc`` (the ``mc`` pass
behind ``analysis/check.py``), ``MUTANTS`` (fault-injection scheduler
subclasses proving the checker's teeth).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve.scheduler import (Request, SamplingParams, Scheduler,
                                         pages_for)

__all__ = [
    "Universe", "World", "InvariantViolation", "MCResult", "ReplayResult",
    "UNIVERSES", "MUTANTS", "build_scheduler", "explore", "replay_world",
    "shrink_trace", "save_trace", "load_trace", "replay_on_engine",
    "run_mc", "classify_message",
]


# ---------------------------------------------------------------------------
# universes: the bounded worlds the checker exhausts
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Universe:
    """A bounded scheduler world: pool geometry + closed traffic alphabet.

    ``prompts`` is the whole token universe — submit actions choose an
    index, so prefix overlap between entries is how COW/cache sharing
    enters the explored space.  ``max_live`` bounds in-flight requests
    (waiting + running), ``pressure_cap`` bounds externally reserved
    pages; together with ``depth`` they make the state space finite.
    """
    name: str
    max_slots: int = 2
    page_size: int = 4
    total_pages: Optional[int] = 7      # incl. the reserved sink page
    pool_bytes: Optional[int] = None    # alternative byte-budget sizing
    kv_bits: int = 16                   # sets the synthetic page_bytes
    prefill_batch: int = 2
    prompts: Tuple[Tuple[int, ...], ...] = ((0, 0, 0, 0, 0, 1), (0, 0, 0))
    max_new: int = 1                    # max_new_tokens for every request
    max_live: int = 2                   # waiting + running bound
    pressure_cap: int = 1               # reserve_pages() bound
    depth: int = 12                     # default DFS bound

    @property
    def page_bytes(self) -> int:
        """Synthetic per-page cost at ``kv_bits`` (codes-domain scaling:
        the same byte budget buys ~2x pages at kv8, ~4x at kv4)."""
        return max(1, self.page_size * 2 * self.kv_bits // 8)

    @property
    def max_len(self) -> int:
        """Per-sequence capacity: the longest possible sequence rounded
        up to whole pages (so the block-table span is exact)."""
        worst = max(len(p) for p in self.prompts) + self.max_new
        return pages_for(worst, self.page_size) * self.page_size

    def spec(self) -> dict:
        d = dataclasses.asdict(self)
        d["prompts"] = [list(p) for p in self.prompts]
        return d

    @staticmethod
    def from_spec(d: dict) -> "Universe":
        d = dict(d)
        d["prompts"] = tuple(tuple(p) for p in d["prompts"])
        return Universe(**d)


def build_scheduler(u: Universe, cls: type = Scheduler) -> Scheduler:
    """Instantiate the (real or mutant) scheduler for a universe."""
    s = cls(u.max_slots, u.prefill_batch, min_bucket=u.page_size,
            max_len=u.max_len, page_size=u.page_size,
            total_pages=u.total_pages, page_bytes=u.page_bytes,
            pool_bytes=u.pool_bytes, prefix_cache=True)
    for p in u.prompts:
        worst = len(p) + u.max_new
        if worst > s.capacity or \
                pages_for(worst, u.page_size) > s.usable_pages:
            raise ValueError(f"universe {u.name}: prompt of {len(p)} tokens "
                             f"cannot complete in {s.usable_pages} pages")
    return s


# the committed exploration matrix: the flagship 2-slot/6-usable-page
# world must exhaust at depth 12 inside the CI budget; the variants
# cover byte-budgeted admission (kv8) and a wider page/slot geometry
# (kv4, page 8) at a shallower bound.
UNIVERSES: Tuple[Universe, ...] = (
    Universe(name="u2p6", max_slots=2, page_size=4, total_pages=7,
             kv_bits=16, prompts=((0, 0, 0, 0, 0, 1), (0, 0, 0)),
             max_new=2, max_live=2, pressure_cap=1, depth=12),
    Universe(name="u2p6b-kv8", max_slots=2, page_size=4, total_pages=None,
             pool_bytes=56, kv_bits=8,    # 56 B / 8 B-page => same 7 pages
             prompts=((0, 0, 0, 0, 0, 0), (1, 1)),
             max_new=1, max_live=2, pressure_cap=1, depth=10),
    Universe(name="u3p8-kv4", max_slots=3, page_size=8, total_pages=5,
             kv_bits=4, prompts=((0,) * 10, (0,) * 9 + (1,), (1, 1)),
             max_new=1, max_live=3, pressure_cap=1, depth=8),
)


# ---------------------------------------------------------------------------
# invariant vocabulary
# ---------------------------------------------------------------------------

class InvariantViolation(Exception):
    """An invariant tripped.  ``key`` is the stable finding identity
    (shrinking keeps a trace only if it trips the *same* key)."""

    def __init__(self, key: str, message: str):
        super().__init__(f"{key}: {message}")
        self.key = key
        self.message = message


# scheduler/prefix-cache assertion messages -> stable invariant keys
# (substring match, first hit wins; extend when check_invariants grows)
_KEY_PATTERNS: Tuple[Tuple[str, str], ...] = (
    ("aliased block-table", "aliased-block-table"),
    ("sink page in table", "sink-in-table"),
    ("dangling entries", "dangling-entries"),
    ("refcount mismatch", "refcount-mismatch"),
    ("refcount underflow", "refcount-underflow"),
    ("duplicate pages in the free list", "free-list-duplicate"),
    ("inconsistent with free-list", "free-vs-ref"),
    ("page conservation", "page-conservation"),
    ("bytes_in_use out of sync", "bytes-accounting"),
    ("both free and running", "slot-free-and-running"),
    ("free list out of order", "free-list-order"),
    ("duplicate reserved", "reserved-duplicate"),
    ("external reservations are exclusive", "reserved-exclusivity"),
    ("also owned by a slot or the cache", "reserved-exclusivity"),
    ("pending COW", "cow-pending"),
    ("indexed twice", "cache-index"),
    ("parent/key link", "cache-index"),
    ("dead interior node", "cache-index"),
    ("entry map", "cache-index"),
    ("LRU ticks", "cache-index"),
    ("page pool exhausted", "alloc-exhausted"),
    ("reserve_pages", "alloc-exhausted"),
)


def classify_message(msg: str) -> str:
    for needle, key in _KEY_PATTERNS:
        if needle in msg:
            return key
    return "invariant"


# ---------------------------------------------------------------------------
# the transition system: real scheduler + engine-protocol action layer
# ---------------------------------------------------------------------------

Action = Tuple[str, Optional[int]]


def _enabled_actions(s: Scheduler, prefilling: Dict[int, object],
                     active: Dict[int, object], u: Universe) -> List[Action]:
    """Actions enabled in a state, in a fixed deterministic order.
    Shared between the host World and the engine replay harness so a
    trace means the same thing in both."""
    acts: List[Action] = []
    if s.n_waiting + s.n_running < u.max_live:
        for pi in range(len(u.prompts)):
            acts.append(("submit", pi))
    if s.n_waiting and s._free:
        acts.append(("schedule", None))
    for slot in sorted(prefilling):
        acts.append(("chunk", slot))
    if active:
        acts.append(("decode", None))
    for slot in sorted(set(prefilling) | set(active)):
        acts.append(("preempt", slot))
    if s.cached_pages:
        acts.append(("flush", None))
    if len(s._reserved_pages) < u.pressure_cap and s.available_pages > 0:
        acts.append(("pressure", None))
    if s._reserved_pages:
        acts.append(("unpressure", None))
    return acts


class World:
    """The real scheduler driven as a transition system.

    Mirrors the engine's per-step call protocol exactly (see
    serve/engine.py step()/_advance_prefill()) but exposes each call as
    a separate action, so the checker can interleave them in every
    order the engine could ever produce — and a few it can't yet
    (forced preemption at arbitrary points, pool-pressure injection).
    The generated-token stream is a deterministic function of (prompt,
    position) and never of submission uid, so canonical hashing can
    identify states that differ only by traffic history.
    """

    def __init__(self, u: Universe,
                 factory: Optional[Callable[[Universe], Scheduler]] = None):
        self.u = u
        self.s = (factory or build_scheduler)(u)
        self.prefilling: Dict[int, object] = {}   # slot -> Sequence
        self.active: Dict[int, object] = {}       # slot -> Sequence
        self.uid = 0
        self.n_finished = 0
        self.meta: Dict[int, int] = {}            # uid -> prompt index

    # -- forking -----------------------------------------------------------

    def clone(self) -> "World":
        w = object.__new__(World)
        w.u = self.u
        w.s = self.s.clone()
        # the per-slot maps must point at the *cloned* Sequence objects
        w.prefilling = {k: w.s._running[k] for k in self.prefilling}
        w.active = {k: w.s._running[k] for k in self.active}
        w.uid = self.uid
        w.n_finished = self.n_finished
        w.meta = dict(self.meta)
        return w

    # -- action layer ------------------------------------------------------

    def enabled_actions(self) -> List[Action]:
        return _enabled_actions(self.s, self.prefilling, self.active, self.u)

    def enabled(self, action: Action) -> bool:
        return tuple(action) in set(self.enabled_actions())

    def apply(self, action: Action) -> None:
        """Apply one action and audit every invariant.  Raises
        ``InvariantViolation`` (with a stable key) on any breach."""
        op, arg = action
        try:
            getattr(self, "_act_" + op)(arg)
            self._audit()
        except InvariantViolation:
            raise
        except (AssertionError, RuntimeError) as e:
            raise InvariantViolation(classify_message(str(e)), str(e)) from e

    def _act_submit(self, pi: int) -> None:
        prompt = np.asarray(self.u.prompts[pi], np.int32)
        self.s.submit(Request(
            uid=self.uid, prompt=prompt,
            sampling=SamplingParams(max_new_tokens=self.u.max_new)))
        self.meta[self.uid] = pi
        self.uid += 1

    def _act_schedule(self, _=None) -> None:
        s = self.s
        # admission-liveness precondition: an empty pool with no other
        # owner must always admit (submit() pre-checked worst-case fit)
        must_admit = (not s._running and not s._reserved_pages
                      and s.n_waiting and s._free)
        group = s.schedule()
        for ss in group:
            ss.seq.prefill_progress = ss.seq.cache_hit_tokens
            self.prefilling[ss.slot] = ss.seq
        if must_admit and not group:
            raise InvariantViolation(
                "admission-liveness",
                "empty pool, free slot, waiting work — nothing admitted")

    def _act_chunk(self, slot: int) -> None:
        s, u = self.s, self.u
        seq = self.prefilling[slot]
        a = seq.prefill_progress
        b = min(a + u.page_size, seq.full_prompt.size)
        self._drop(s.prepare_chunk_writes(slot, a, b))
        self._take_cows()
        self._assert_exclusive_range(slot, a, b)
        seq.prefill_progress = b
        if b >= seq.full_prompt.size:
            # final chunk: publish prompt pages, sample first token
            s.on_prefill_complete(slot)
            seq.prefill_progress = None
            del self.prefilling[slot]
            self._append_token(seq)
            self.active[slot] = seq
            self._maybe_complete(slot)

    def _act_decode(self, _=None) -> None:
        s = self.s
        self._drop(s.ensure_decode_pages(writing=set(self.active)))
        self._take_cows()
        for slot in sorted(self.active):
            self._assert_exclusive_row(slot,
                                       self.active[slot].next_write_pos)
        for slot in sorted(self.active):
            self._append_token(self.active[slot])
        for slot in sorted(self.active):
            self._maybe_complete(slot)

    def _act_preempt(self, slot: int) -> None:
        self.s.preempt_slot(slot)
        self.prefilling.pop(slot, None)
        self.active.pop(slot, None)

    def _act_flush(self, _=None) -> None:
        self.s.flush_prefix_cache()

    def _act_pressure(self, _=None) -> None:
        self.s.reserve_pages(1)

    def _act_unpressure(self, _=None) -> None:
        self.s.release_reserved(1)

    # -- engine-protocol helpers ------------------------------------------

    def _drop(self, preempted) -> None:
        """Victims of prepare/ensure preemption lose their slot maps
        (the engine's _clear_slot)."""
        for slot, _seq in preempted:
            self.prefilling.pop(slot, None)
            self.active.pop(slot, None)

    def _take_cows(self) -> List[Tuple[int, int]]:
        """Drain pending COW pairs like Engine._apply_cow, auditing the
        batch shape clone_pages relies on: dst pages distinct, fresh
        (never the sink, never a source of the same batch entry)."""
        copies = self.s.take_cow_copies()
        dsts = set()
        for src, dst in copies:
            if dst == 0 or src == dst or dst in dsts:
                raise InvariantViolation(
                    "cow-batch", f"malformed COW batch {copies}")
            dsts.add(dst)
        return copies

    def _append_token(self, seq) -> None:
        # deterministic, uid-free token stream: canonical hashing may
        # identify worlds whose sequences differ only in submission uid
        tok = (int(seq.full_prompt.sum()) + len(seq.generated)) % 3
        seq.generated.append(tok)

    def _maybe_complete(self, slot: int) -> None:
        seq = self.active[slot]
        if len(seq.generated) >= seq.request.sampling.max_new_tokens:
            self.s.complete(slot)
            del self.active[slot]
            self.n_finished += 1

    # -- write-exclusivity (the COW contract) ------------------------------

    def _assert_exclusive_range(self, slot: int, start: int,
                                end: int) -> None:
        _assert_exclusive_range(self.s, slot, start, end)

    def _assert_exclusive_row(self, slot: int, pos: int) -> None:
        _assert_exclusive_range(self.s, slot, pos, pos + 1)

    # -- the invariant catalog (DESIGN.md Sec. 12) -------------------------

    def _audit(self) -> None:
        s = self.s
        # 1-9: conservation, refcount, aliasing, byte-accounting, order,
        # reservation exclusivity, COW sanity, cache-index consistency
        s.check_invariants(exhaustive=True)
        # 10: every COW batch was drained within its action
        if s._cow_pending:
            raise InvariantViolation(
                "cow-not-drained",
                f"{len(s._cow_pending)} pending pairs across actions")
        # 11: request conservation (counter drift trips here)
        if s.n_submitted != self.n_finished + s.n_waiting + s.n_running:
            raise InvariantViolation(
                "request-conservation",
                f"submitted {s.n_submitted} != finished {self.n_finished} "
                f"+ waiting {s.n_waiting} + running {s.n_running}")
        if s.n_completed != self.n_finished or s.n_submitted != self.uid:
            raise InvariantViolation(
                "counter-drift",
                f"n_completed {s.n_completed} vs {self.n_finished}, "
                f"n_submitted {s.n_submitted} vs {self.uid}")
        if s.n_cache_hits > s.n_cache_lookups \
                or s.n_cache_hit_pages > s.n_cache_hit_tokens:
            raise InvariantViolation(
                "counter-drift", "cache hit counters inconsistent")
        # 12: the world's slot maps and the scheduler agree
        slots = set(self.prefilling) | set(self.active)
        if set(self.prefilling) & set(self.active) \
                or slots != set(s.running()):
            raise InvariantViolation(
                "state-divergence",
                f"world slots {sorted(slots)} vs scheduler "
                f"{sorted(s.running())}")
        for slot, seq in self.prefilling.items():
            if seq.prefill_progress is None:
                raise InvariantViolation(
                    "state-divergence", f"slot {slot} prefilling w/o cursor")
        for slot, seq in self.active.items():
            if seq.prefill_progress is not None:
                raise InvariantViolation(
                    "state-divergence", f"slot {slot} active mid-prefill")

    # -- canonical state hashing ------------------------------------------

    def fingerprint(self) -> Tuple:
        """Canonical state encoding: physical page ids are relabeled by
        first appearance in a fixed traversal (sink stays 0) and
        sequences by FCFS rank + prompt identity, so states isomorphic
        under page renaming / uid shifts collapse to one node.  Encodes
        exactly what future behavior depends on: per-slot page rows and
        cursors, waiting order, trie shape, LRU order (ticks as ranks,
        plus registration order — eviction tie-breaks on it), free and
        reserved page *counts* (their identities are spent)."""
        s, label = self.s, {0: 0}

        def canon(p) -> int:
            p = int(p)
            if p not in label:
                label[p] = len(label)
            return label[p]

        running = sorted(s._running.items(), key=lambda kv: kv[1].order)
        orders = sorted([seq.order for _, seq in running]
                        + [q.order for q in s._waiting])
        rank = {o: i for i, o in enumerate(orders)}
        run_part = tuple(
            (rank[seq.order], self.meta[seq.request.uid],
             len(seq.generated),
             -1 if seq.prefill_progress is None else seq.prefill_progress,
             seq.cache_hit_tokens,
             "P" if slot in self.prefilling else "A",
             tuple(canon(p) for p in
                   s.block_tables[slot, :int(s._n_pages[slot])]))
            for slot, seq in running)
        wait_part = tuple((rank[q.order], self.meta[q.request.uid],
                           len(q.generated)) for q in s._waiting)
        trie_part = s.prefix_cache.fingerprint(canon)
        lru_part = tuple(canon(p) for p in s.prefix_cache.lru_order())
        reg_part = tuple(canon(p) for p in s.prefix_cache.pages())
        return (run_part, wait_part, trie_part, lru_part, reg_part,
                len(s._free_pages), len(s._reserved_pages))


def _assert_exclusive_range(s: Scheduler, slot: int, start: int,
                            end: int) -> None:
    """The COW contract: KV writes [start, end) of ``slot`` may only
    land in pages the writer owns exclusively (refcount 1)."""
    if start >= end:
        return
    held = int(s._n_pages[slot])
    for idx in range(start // s.page_size, (end - 1) // s.page_size + 1):
        if idx >= held:
            raise InvariantViolation(
                "write-page-missing",
                f"slot {slot} writes rows [{start},{end}) but holds only "
                f"{held} pages")
        page = int(s.block_tables[slot, idx])
        if int(s._ref[page]) != 1:
            raise InvariantViolation(
                "write-exclusivity",
                f"slot {slot} writes rows [{start},{end}) into page {page} "
                f"with refcount {int(s._ref[page])} and no COW")


# ---------------------------------------------------------------------------
# the explorer: DFS over canonical states
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MCResult:
    universe: str
    depth: int
    states: int = 0
    transitions: int = 0
    invariant_checks: int = 0
    elapsed_s: float = 0.0
    exhausted: bool = False
    violation_key: Optional[str] = None
    violation_message: Optional[str] = None
    trace: Optional[List[Action]] = None

    def stats(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("trace")
        return d


def explore(u: Universe, depth: Optional[int] = None,
            deadline: Optional[float] = None,
            factory: Optional[Callable[[Universe], Scheduler]] = None) \
        -> MCResult:
    """Exhaust every action interleaving of ``u`` to ``depth``, checking
    the whole invariant catalog after each transition.  Stops at the
    first violation (returning its raw trace) or at ``deadline``
    (monotonic seconds; ``exhausted`` is False then)."""
    d = u.depth if depth is None else depth
    res = MCResult(universe=u.name, depth=d)
    t0 = time.monotonic()
    # transposition table: canonical fingerprint -> deepest remaining
    # budget already explored from it (re-expand only with more budget)
    seen: Dict[Tuple, int] = {}
    truncated = False

    def dfs(w: World, rem: int,
            path: List[Action]) -> Optional[Tuple[List[Action],
                                                  InvariantViolation]]:
        nonlocal truncated
        if deadline is not None and time.monotonic() > deadline:
            truncated = True
            return None
        fp = w.fingerprint()
        prev = seen.get(fp, -1)
        if prev >= rem:
            return None
        if prev < 0:
            res.states += 1
        seen[fp] = rem
        if rem == 0:
            return None
        for action in w.enabled_actions():
            child = w.clone()
            res.invariant_checks += 1
            try:
                child.apply(action)
            except InvariantViolation as v:
                return path + [action], v
            res.transitions += 1
            got = dfs(child, rem - 1, path + [action])
            if got is not None:
                return got
        return None

    hit = dfs(World(u, factory), d, [])
    res.elapsed_s = time.monotonic() - t0
    res.exhausted = hit is None and not truncated
    if hit is not None:
        res.trace, v = hit
        res.violation_key, res.violation_message = v.key, v.message
    return res


# ---------------------------------------------------------------------------
# replay + delta-debugging shrink
# ---------------------------------------------------------------------------

def replay_world(u: Universe, actions: List[Action],
                 factory: Optional[Callable[[Universe], Scheduler]] = None) \
        -> Optional[Tuple[int, InvariantViolation]]:
    """Re-execute an action trace host-side.  Actions not enabled in
    the current state are skipped (shrinking removes prefixes, which
    can disable later actions — skipping keeps the rest meaningful).
    Returns (index, violation) of the first invariant trip, else None."""
    w = World(u, factory)
    for i, raw in enumerate(actions):
        action = (raw[0], raw[1])
        if not w.enabled(action):
            continue
        try:
            w.apply(action)
        except InvariantViolation as v:
            return i, v
    return None


def shrink_trace(u: Universe, actions: List[Action], key: str,
                 factory: Optional[Callable[[Universe], Scheduler]] = None) \
        -> List[Action]:
    """Delta-debug a violating trace to 1-minimality: truncate to the
    violating prefix, then repeatedly drop any action whose removal
    still trips the *same* invariant key."""
    def check(cand: List[Action]) -> Optional[int]:
        got = replay_world(u, cand, factory)
        return got[0] if got is not None and got[1].key == key else None

    idx = check(list(actions))
    if idx is None:
        raise ValueError(f"trace does not reproduce invariant {key!r}")
    cur = list(actions)[:idx + 1]
    changed = True
    while changed:
        changed = False
        i = 0
        while i < len(cur):
            cand = cur[:i] + cur[i + 1:]
            idx = check(cand)
            if idx is not None:
                cur, changed = cand[:idx + 1], True
            else:
                i += 1
    return cur


# -- trace serialization (the counterexample corpus) ------------------------

def save_trace(path: str, u: Universe, actions: List[Action], key: str,
               message: str, mutant: Optional[str] = None,
               extra: Optional[dict] = None) -> None:
    doc = {
        "version": 1,
        "universe": u.spec(),
        "mutant": mutant,
        "invariant": key,
        "message": message,
        "actions": [[op, arg] for op, arg in actions],
    }
    doc.update(extra or {})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


def load_trace(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    doc["universe"] = Universe.from_spec(doc["universe"])
    doc["actions"] = [(op, arg) for op, arg in doc["actions"]]
    return doc


# ---------------------------------------------------------------------------
# fault-injection mutants: the checker's teeth
# ---------------------------------------------------------------------------

class _LeakOnRelease(Scheduler):
    """Off-by-one refcount: releasing a slot leaks one reference on its
    last held page (the classic forgotten _unref)."""

    def _release_slot(self, slot):
        held = int(self._n_pages[slot])
        if held:
            self._ref[int(self.block_tables[slot, held - 1])] += 1
        return super()._release_slot(slot)


class _DoubleFreeOnRelease(Scheduler):
    """Premature free: releasing a slot drops one reference too many on
    its first page (frees pages the cache or a sharer still owns)."""

    def _release_slot(self, slot):
        held = int(self._n_pages[slot])
        first = int(self.block_tables[slot, 0]) if held else 0
        seq = super()._release_slot(slot)
        if held and int(self._ref[first]) > 0:
            self._unref(first)
        return seq


class _SkipCow(Scheduler):
    """Skipped COW: shared pages are never copied before a write, so a
    chunk/decode write would corrupt another sequence's (or the
    cache's) KV bytes."""

    def _cow_if_shared(self, slot, idx):
        return []


class _AdmitOvercommit(Scheduler):
    """Admission-currency drift: the scheduler believes it has one more
    page than the pool holds, so admission can pass and allocation then
    hits a dry pool."""

    @property
    def available_pages(self):
        return super().available_pages + 1


# per-mutant universes: geometry chosen so the bug is reachable within
# a shallow bound AND the trace replays bit-exactly on the live engine
# (max_new=1 keeps generated-token values out of every cache key, so
# the synthetic host tokens and the engine's sampled tokens induce the
# same scheduling decisions).
_MU_SHARE = Universe(
    name="mut-share", max_slots=2, page_size=4, total_pages=7, kv_bits=16,
    prompts=((0, 0, 0, 0, 0, 0), (0, 0, 0, 0, 0, 1)),
    max_new=1, max_live=2, pressure_cap=0, depth=8)
_MU_PRESSURE = Universe(
    name="mut-pressure", max_slots=2, page_size=4, total_pages=7,
    kv_bits=16, prompts=((0, 0, 0, 0, 0, 0),),
    max_new=1, max_live=1, pressure_cap=5, depth=7)

MUTANTS: Dict[str, Tuple[type, Universe]] = {
    "leak_on_release": (_LeakOnRelease, _MU_SHARE),
    "double_free_on_release": (_DoubleFreeOnRelease, _MU_SHARE),
    "skip_cow": (_SkipCow, _MU_SHARE),
    "admit_overcommit": (_AdmitOvercommit, _MU_PRESSURE),
}


def mutant_factory(name: str) -> Callable[[Universe], Scheduler]:
    cls, _u = MUTANTS[name]
    return lambda u: build_scheduler(u, cls)


def hunt_mutant(name: str, depth: Optional[int] = None,
                deadline: Optional[float] = None) -> MCResult:
    """Model-check a fault-injected scheduler in its paired universe;
    the result's trace (if any) is the raw counterexample."""
    _cls, u = MUTANTS[name]
    return explore(u, depth=depth, deadline=deadline,
                   factory=mutant_factory(name))


# ---------------------------------------------------------------------------
# engine replay: counterexamples must reproduce on the real engine
# ---------------------------------------------------------------------------

_ENGINE_FIXTURE: Dict[tuple, tuple] = {}


def _engine_fixture(arch: str, device):
    """Smoke model params/config/opts for replay engines: f32, remat off
    (cached per device: replays share one model, each builds a fresh
    Engine + pool)."""
    import torch
    key = (arch, str(device))
    if key not in _ENGINE_FIXTURE:
        from repro_torch.configs import base as cb
        from repro_torch.models import model
        from repro_torch.models.lm import ModelOpts
        cfg = cb.get_smoke(arch)
        opts = ModelOpts(compute_dtype=torch.float32, remat=False,
                         attn_chunked_min_len=1 << 30, kv_chunk=16,
                         ssd_chunk=8, ce_chunk=64)
        params = model.init(0, cfg, device=device)
        _ENGINE_FIXTURE[key] = (params, cfg, opts)
    return _ENGINE_FIXTURE[key]


@dataclasses.dataclass
class ReplayResult:
    violation_key: Optional[str] = None
    violation_message: Optional[str] = None
    violation_index: Optional[int] = None
    streams: Dict[int, List[int]] = dataclasses.field(default_factory=dict)
    n_applied: int = 0
    n_skipped: int = 0
    # the engine's model calls over the replay (what its kernel launches
    # are counted against)
    prefill_calls: int = 0
    decode_steps: int = 0


def replay_on_engine(u: Universe, actions: List[Action],
                     mutant: Optional[str] = None,
                     arch: str = "granite_3_8b", device="cuda",
                     params=None, cfg=None, opts=None) -> ReplayResult:
    """Re-execute a trace against a live ``serve/engine.py``, mirroring
    the engine's own step protocol call for call and auditing the same
    invariant catalog after each action.

    The engine runs on ``device`` (the card unless the caller asks for
    the CPU) over ``params`` / ``cfg`` / ``opts`` when given, else over
    ``arch``'s smoke model in f32 drawn from seed 0.  With ``mutant`` set
    the scheduler is swapped for the fault-injected subclass — a
    host-found counterexample must trip the same invariant here,
    pool-side, before any corrupted bytes reach the device.  Returns the
    violation (if any) plus every request's token stream (uid -> tokens),
    the bit-identity obligation for healthy replays.
    """
    from repro_torch.serve.engine import Engine, EngineConfig
    if params is None:
        params, cfg, opts = _engine_fixture(arch, device)
    elif cfg is None or opts is None:
        raise ValueError("replay_on_engine: params need their cfg and opts")
    host = build_scheduler(u)   # resolves total_pages for pool_bytes worlds
    ec = EngineConfig(
        max_slots=u.max_slots, max_len=u.max_len,
        prefill_batch=u.prefill_batch, min_bucket=u.page_size,
        cache_mode="paged", page_size=u.page_size,
        total_pages=host.total_pages, kv_bits=u.kv_bits,
        prefix_cache=True, prefill_chunk=1, telemetry=False)
    eng = Engine(params, cfg, opts, ec, device=device)
    if mutant is not None:
        cls, _mu = MUTANTS[mutant]
        eng.scheduler = cls(
            ec.max_slots, ec.prefill_batch, ec.min_bucket, ec.max_len,
            page_size=ec.page_size, total_pages=host.total_pages,
            page_bytes=eng.page_bytes, prefix_cache=True)
    s = eng.scheduler
    res = ReplayResult()
    uid = 0
    n_finished = 0

    def finish(outs) -> None:
        nonlocal n_finished
        for o in outs:
            res.streams[o.uid] = list(o.token_ids)
            n_finished += 1

    def audit() -> None:
        s.check_invariants(exhaustive=True)
        if s._cow_pending:
            raise InvariantViolation(
                "cow-not-drained",
                f"{len(s._cow_pending)} pending pairs across actions")
        if s.n_submitted != n_finished + s.n_waiting + s.n_running:
            raise InvariantViolation(
                "request-conservation",
                f"submitted {s.n_submitted} != finished {n_finished} "
                f"+ waiting {s.n_waiting} + running {s.n_running}")
        slots = set(eng._prefilling) | set(eng._slots)
        if set(eng._prefilling) & set(eng._slots) \
                or slots != set(s.running()):
            raise InvariantViolation(
                "state-divergence",
                f"engine slots {sorted(slots)} vs scheduler "
                f"{sorted(s.running())}")

    def step(action: Action) -> None:
        op, arg = action
        if op == "submit":
            nonlocal uid
            eng.submit(Request(
                uid=uid, prompt=np.asarray(u.prompts[arg], np.int32),
                sampling=SamplingParams(max_new_tokens=u.max_new)))
            uid += 1
        elif op == "schedule":
            must_admit = (not s._running and not s._reserved_pages
                          and s.n_waiting and s._free)
            group = s.schedule()
            now = time.perf_counter()
            for ss in group:
                ss.seq.admit_time = now
                ss.seq.prefill_progress = ss.seq.cache_hit_tokens
                eng._prefilling[ss.slot] = ss.seq
            if must_admit and not group:
                raise InvariantViolation(
                    "admission-liveness",
                    "empty pool, free slot, waiting work — no admission")
        elif op == "chunk":
            seq = eng._prefilling[arg]
            a = seq.prefill_progress
            b = min(a + eng.chunk_tokens, seq.full_prompt.size)
            for vslot, _v in s.prepare_chunk_writes(arg, a, b):
                eng._clear_slot(vslot)
            _check_cow_pairs(s._cow_pending)
            _assert_exclusive_range(s, arg, a, b)
            # _advance_prefill_group re-runs prepare (a no-op now), drains
            # the COW batch onto the device, runs the chunk, maybe activates
            finish(eng._advance_prefill_group([arg]))
        elif op == "decode":
            for vslot, _v in s.ensure_decode_pages(writing=set(eng._slots)):
                eng._clear_slot(vslot)
            _check_cow_pairs(s._cow_pending)
            for slot, seq in eng._slots.items():
                _assert_exclusive_range(s, slot, seq.next_write_pos,
                                        seq.next_write_pos + 1)
            eng._apply_cow()
            finish(eng._decode_active())
        elif op == "preempt":
            s.preempt_slot(arg)
            eng._clear_slot(arg)
        elif op == "flush":
            s.flush_prefix_cache()
        elif op == "pressure":
            s.reserve_pages(1)
        elif op == "unpressure":
            s.release_reserved(1)
        else:
            raise ValueError(f"unknown action {op!r}")

    for i, raw in enumerate(actions):
        action = (raw[0], raw[1])
        if action not in set(_enabled_actions(s, eng._prefilling,
                                              eng._slots, u)):
            res.n_skipped += 1
            continue
        try:
            step(action)
            audit()
        except InvariantViolation as v:
            res.violation_key, res.violation_message = v.key, v.message
            res.violation_index = i
            break
        except (AssertionError, RuntimeError) as e:
            res.violation_key = classify_message(str(e))
            res.violation_message = str(e)
            res.violation_index = i
            break
        res.n_applied += 1
    else:
        for seq in s.running().values():
            res.streams[seq.request.uid] = list(seq.generated)
    res.prefill_calls, res.decode_steps = (eng.n_prefill_calls,
                                           eng.n_decode_steps)
    return res


def _check_cow_pairs(pending: List[Tuple[int, int]]) -> None:
    dsts = set()
    for src, dst in pending:
        if dst == 0 or src == dst or dst in dsts:
            raise InvariantViolation(
                "cow-batch", f"malformed COW batch {pending}")
        dsts.add(dst)


# ---------------------------------------------------------------------------
# the `mc` pass (analysis/check.py --mc)
# ---------------------------------------------------------------------------

def run_mc(depth: Optional[int] = None, budget_s: float = 60.0,
           corpus_dir: Optional[str] = None,
           universes: Optional[Tuple[Universe, ...]] = None):
    """Model-check every committed universe within one wall-clock
    budget.  Returns (findings, stats): findings are
    ``analysis/findings.py`` rows (rule MC-INVARIANT, one per violated
    universe, shrunk trace saved under ``corpus_dir``); stats is one
    dict per universe (states / transitions / invariant audits /
    exhausted), the exhaustiveness evidence check.py reports."""
    from repro_torch.analysis.findings import Finding
    deadline = time.monotonic() + budget_s
    findings: List[Finding] = []
    stats: List[dict] = []
    for u in universes if universes is not None else UNIVERSES:
        res = explore(u, depth=depth, deadline=deadline)
        stats.append(res.stats())
        if res.trace is None:
            if not res.exhausted:
                # truncation is a gate failure too: "checked" must mean
                # the whole bounded space, not the prefix we had time for
                findings.append(Finding(
                    rule="MC-BUDGET", path=f"modelcheck[{u.name}]",
                    detail=f"depth{res.depth}",
                    message=(f"budget exhausted after {res.states} states /"
                             f" {res.transitions} transitions — universe "
                             f"not fully explored at depth {res.depth}")))
            continue
        trace = shrink_trace(u, res.trace, res.violation_key)
        if corpus_dir:
            save_trace(os.path.join(corpus_dir,
                                    f"{u.name}-{res.violation_key}.json"),
                       u, trace, res.violation_key, res.violation_message,
                       extra={"states_explored": res.states,
                              "shrunk_from": len(res.trace)})
        findings.append(Finding(
            rule="MC-INVARIANT",
            path=f"modelcheck[{u.name}]",
            detail=res.violation_key,
            message=(f"{res.violation_message} — {len(trace)}-action "
                     f"counterexample: {' '.join(op for op, _ in trace)}")))
    return findings, stats
