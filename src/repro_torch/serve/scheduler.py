"""Request scheduler for the continuous-batching engine (DESIGN.md Sec. 6–7).

Pure host-side bookkeeping — no jax. The engine owns the device state
(KV cache, jitted steps); the scheduler decides *which* request goes
*where* and keeps the shapes the engine compiles against fixed:

  * a FCFS waiting queue of submitted sequences (resumed preemptees keep
    their original priority, so they re-enter ahead of younger traffic),
  * a fixed pool of decode slots (free-list, lowest id first so the same
    traffic pattern replays deterministically),
  * bucketed admission: each scheduling round drains up to
    ``prefill_batch`` waiting requests whose prompts fit the same padded
    length bucket (next power of two >= prompt length, floor
    ``min_bucket``), so one batched prefill serves the whole group and the
    number of distinct compiled prefill shapes stays
    O(log(max_len) * prefill_batch).

Two KV accounting modes:

  * **paged** (``page_size`` set, the default engine mode): KV lives in a
    shared pool of fixed-size pages; each running slot owns a block-table
    row naming its pages. Admission charges pages for the prompt; decode
    growth allocates one page at a time (``ensure_decode_pages``). On pool
    exhaustion the *lowest-priority* (latest-submitted) running sequence
    is preempted: its pages are freed and it is returned to the waiting
    queue carrying its generated tokens, to be resumed later by
    re-prefilling prompt+generated. Preemption is never terminal — the
    FCFS priority order guarantees the oldest sequence always progresses,
    and ``submit`` rejects requests whose worst case could not fit even an
    otherwise-empty pool, so a sole survivor can always grow to completion.
  * **slot** (legacy baseline, kept for the equal-HBM A/B benchmark): one
    fixed ``max_len`` region per slot; a sequence that outgrows its region
    is evicted *terminally* (``complete(slot, evicted=True)``).

Pool accounting is in **bytes**: a page is still the allocation unit, but
its cost is ``page_bytes`` (the exact codes+stats HBM of one page at the
engine's ``kv_bits``; see ``models/kv_cache.page_kv_bytes``), and the pool
can be sized by a byte budget (``pool_bytes``) instead of a page count —
the same budget yields ~2x the pages at kv8, ~3.6x at kv4, which is how
quantized KV trades directly into concurrency at equal HBM.

With ``prefix_cache=True`` (paged mode only) pages become *shared*:

  * every usable page carries a refcount; a slot's block-table row holds
    one reference per entry and ``serve/prefix_cache.PrefixCache`` holds
    one reference per registered page,
  * admission looks the prompt up in the radix index and attaches the
    matching pages instead of re-prefilling them (the hit is capped at
    ``len(prompt) - 1`` — at least one token must run to produce logits),
  * a write into a page with refcount > 1 triggers copy-on-write: the
    writer swaps in a fresh page and the engine replays the pending
    (src, dst) device copies (``take_cow_copies``) before the step runs,
  * a sequence's full prompt pages are registered when its prefill
    completes; the partially-filled tail page (and pages grown during
    decode) are registered when the slot is released, so a sequence never
    copy-on-writes against its own registration,
  * on pool pressure the allocator reclaims least-recently-used cache-only
    pages before preempting running sequences.

Sharing is *exact*, not approximate: pages hold integer k-quantile codes
that are a deterministic function of the token prefix, so an index hit
serves bit-identical KV to what a cold prefill would write.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.serve.prefix_cache import PrefixCache


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling controls (fixed-shape: traced as arrays)."""
    temperature: float = 0.0     # 0 => greedy
    top_k: int = 0               # 0 => full distribution
    max_new_tokens: int = 32
    stop_token: int = -1         # -1 => never stop on a token id
    seed: int = 0


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                    # (S0,) int32 token ids
    sampling: SamplingParams = SamplingParams()
    arrival_time: Optional[float] = None
    # None = "not yet stamped" (the engine stamps perf_counter() at
    # submit).  A caller that measured a real arrival sets it explicitly
    # — including a legitimate 0.0, which the old sentinel encoding
    # would have clobbered, skewing every TTFT measured from it.

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError(f"request {self.uid}: empty prompt")


@dataclasses.dataclass
class Sequence:
    """A request's mutable serving state, surviving preemption/resume.

    ``generated`` accumulates across preemptions; on resume the engine
    re-prefills ``full_prompt`` (original prompt + generated so far) and
    sampling continues exactly where it left off — sample keys are folded
    by (seed, position), never by slot or batch.

    ``prefill_progress`` is the chunked-prefill cursor: the number of
    prompt KV rows already written this admission (None once decoding).
    ``cache_hit_tokens`` is where this admission's prefill starts — the
    prefix served from the cache.
    """
    request: Request
    order: int                            # submission index = FCFS priority
    generated: List[int] = dataclasses.field(default_factory=list)
    first_token_time: Optional[float] = None
    admit_time: float = 0.0
    n_preempts: int = 0
    prefill_progress: Optional[int] = None
    cache_hit_tokens: int = 0

    @property
    def full_prompt(self) -> np.ndarray:
        if not self.generated:
            return self.request.prompt
        return np.concatenate([
            self.request.prompt,
            np.asarray(self.generated, np.int32)])

    @property
    def next_write_pos(self) -> int:
        """KV row the next decode step writes: the last generated token's
        position (its KV is written by the step that samples the next)."""
        return self.request.prompt.size + len(self.generated) - 1


@dataclasses.dataclass
class ScheduledSeq:
    """An admission decision: sequence -> slot, padded to a bucket."""
    seq: Sequence
    slot: int
    bucket: int                           # padded prompt length

    @property
    def request(self) -> Request:         # convenience for callers/tests
        return self.seq.request


def bucket_len(n: int, min_bucket: int = 16) -> int:
    """Next power of two >= n, floored at min_bucket."""
    b = min_bucket
    while b < n:
        b *= 2
    return b


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` KV rows."""
    return -(-n_tokens // page_size)


class Scheduler:
    """FCFS admission over a fixed slot pool; paged or slot KV accounting."""

    def __init__(self, max_slots: int, prefill_batch: int = 4,
                 min_bucket: int = 16, max_len: int = 2048,
                 page_size: Optional[int] = None,
                 total_pages: Optional[int] = None,
                 page_bytes: int = 1,
                 pool_bytes: Optional[int] = None,
                 prefix_cache: bool = False):
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        if page_bytes < 1:
            raise ValueError("page_bytes must be >= 1")
        self.max_slots = max_slots
        self.prefill_batch = max(1, prefill_batch)
        self.min_bucket = min_bucket
        self.max_len = max_len
        self.paged = page_size is not None
        self._waiting: Deque[Sequence] = deque()
        self._free: List[int] = list(range(max_slots))
        self._running: Dict[int, Sequence] = {}      # slot -> sequence
        self._order = 0
        # counters for the perf report
        self.n_submitted = 0
        self.n_completed = 0
        self.n_evicted = 0
        self.n_preemptions = 0
        self.n_cache_lookups = 0
        self.n_cache_hits = 0
        self.n_cache_hit_tokens = 0
        self.n_cache_hit_pages = 0
        self.n_cow_copies = 0
        self.n_cache_evictions = 0

        if not self.paged and prefix_cache:
            raise ValueError("prefix_cache requires paged KV "
                             "(page_size must be set)")
        self.prefix_cache: Optional[PrefixCache] = None
        if self.paged:
            if page_size < 1:
                raise ValueError("page_size must be >= 1")
            self.page_size = page_size
            self.page_bytes = page_bytes
            self.pages_per_slot = pages_for(max_len, page_size)
            # capacity is the block-table span, a whole number of pages
            self.capacity = self.pages_per_slot * page_size
            if total_pages is not None and pool_bytes is not None:
                raise ValueError("give total_pages or pool_bytes, not both")
            if total_pages is None and pool_bytes is not None:
                # byte-budgeted pool: however many whole pages fit
                total_pages = pool_bytes // page_bytes
            if total_pages is None:
                # equal HBM with a slot cache of the same (slots, max_len),
                # plus the reserved sink page
                total_pages = max_slots * self.pages_per_slot + 1
            if total_pages < 2:
                hint = (f" (pool_bytes {pool_bytes} / page_bytes "
                        f"{page_bytes})" if pool_bytes is not None else "")
                raise ValueError("pool must hold >= 2 pages (page 0 is the "
                                 f"reserved sink); got {total_pages}{hint}")
            self.total_pages = total_pages
            self.usable_pages = total_pages - 1
            self._free_pages: List[int] = list(range(1, total_pages))
            # per-page reference counts: block-table entries + the prefix
            # cache each hold one reference; 0 <=> on the free list
            self._ref = np.zeros((total_pages,), np.int32)
            # block tables: (max_slots, pages_per_slot) int32, row-owned by
            # the running slot; 0 = sink. Handed to the jitted decode step
            # as a traced array every iteration.
            self.block_tables = np.zeros((max_slots, self.pages_per_slot),
                                         np.int32)
            self._n_pages = np.zeros((max_slots,), np.int32)
            if prefix_cache:
                self.prefix_cache = PrefixCache(page_size)
            # (src, dst) device copies owed before the next cache write;
            # the engine drains these via take_cow_copies()
            self._cow_pending: List[Tuple[int, int]] = []
            # pages held by an *external* consumer (pool-pressure
            # injection: tests, the model checker, a future co-resident
            # replica).  Each holds one reference; check_invariants
            # accounts for them like any other owner.
            self._reserved_pages: List[int] = []
        else:
            self.capacity = max_len

    # -- queue side --------------------------------------------------------

    def submit(self, request: Request) -> None:
        worst = request.prompt.size + request.sampling.max_new_tokens
        if self.paged:
            if worst > self.capacity:
                raise ValueError(
                    f"request {request.uid}: prompt {request.prompt.size} + "
                    f"max_new_tokens {request.sampling.max_new_tokens} "
                    f"exceeds per-sequence capacity {self.capacity} "
                    f"({self.pages_per_slot} pages x {self.page_size})")
            if pages_for(worst, self.page_size) > self.usable_pages:
                raise ValueError(
                    f"request {request.uid}: worst case needs "
                    f"{pages_for(worst, self.page_size)} pages but the pool "
                    f"has {self.usable_pages} — could never complete")
        elif request.prompt.size >= self.max_len:
            raise ValueError(
                f"request {request.uid}: prompt len {request.prompt.size} "
                f">= max_len {self.max_len} leaves no room to decode")
        self._waiting.append(Sequence(request, self._order))
        self._order += 1
        self.n_submitted += 1

    @property
    def n_waiting(self) -> int:
        return len(self._waiting)

    @property
    def n_running(self) -> int:
        return len(self._running)

    @property
    def has_work(self) -> bool:
        return bool(self._waiting or self._running)

    @property
    def pages_in_use(self) -> int:
        """Distinct pool pages referenced by running sequences (shared
        pages count once — this is actual HBM occupancy)."""
        if not self.paged:
            return 0
        pages: Set[int] = set()
        for slot in self._running:
            held = int(self._n_pages[slot])
            pages.update(int(p) for p in self.block_tables[slot, :held])
        return len(pages)

    @property
    def cached_pages(self) -> int:
        """Pages currently registered in the prefix cache."""
        return self.prefix_cache.n_pages if self.prefix_cache else 0

    @property
    def bytes_in_use(self) -> int:
        """Pool bytes held by running sequences (page-granular)."""
        return self.pages_in_use * self.page_bytes if self.paged else 0

    @property
    def pool_bytes_total(self) -> int:
        """Whole-pool byte size (including the reserved sink page)."""
        return self.total_pages * self.page_bytes if self.paged else 0

    @property
    def tokens_in_use(self) -> int:
        """Valid KV rows held by running sequences (utilization numerator)."""
        return sum(s.next_write_pos for s in self._running.values())

    @property
    def n_free_pages(self) -> int:
        """Pages on the free list right now (occupancy gauge)."""
        return len(self._free_pages) if self.paged else 0

    @property
    def available_pages(self) -> int:
        """Pages obtainable right now: free plus cache-reclaimable."""
        if not self.paged:
            return 0
        n = len(self._free_pages)
        if self.prefix_cache is not None:
            n += self.prefix_cache.count_reclaimable(self._ref)
        return n

    def running(self) -> Dict[int, Sequence]:
        return dict(self._running)

    # -- admission ---------------------------------------------------------

    def _bucket(self, seq: Sequence) -> int:
        # clamp: a bucket never exceeds the per-sequence cache capacity
        return min(bucket_len(seq.full_prompt.size, self.min_bucket),
                   self.capacity)

    def schedule(self) -> List[ScheduledSeq]:
        """Admit up to min(free slots, prefill_batch) sequences that share
        one padded-length bucket; FCFS, the head of the queue pins the
        bucket for the round. In paged mode admission additionally charges
        the pool for each prompt's pages and stops when it cannot pay
        (head-of-line blocking keeps FCFS exact). With the prefix cache
        on, cached prefix pages are attached (refcounted) instead of
        allocated, and ``seq.cache_hit_tokens`` tells the engine where to
        start prefilling. Returns [] when nothing is admissible."""
        if not self._waiting or not self._free:
            return []

        head_bucket = self._bucket(self._waiting[0])
        group: List[ScheduledSeq] = []
        kept: Deque[Sequence] = deque()
        blocked = False
        while self._waiting and self._free and not blocked and \
                len(group) < self.prefill_batch:
            seq = self._waiting.popleft()
            if self._bucket(seq) != head_bucket:
                kept.append(seq)
                continue
            hit, shared = 0, []
            if self.paged:
                prompt = seq.full_prompt
                need = pages_for(prompt.size, self.page_size)
                worst = pages_for(seq.request.prompt.size
                                  + seq.request.sampling.max_new_tokens,
                                  self.page_size)
                if self.prefix_cache is not None:
                    self.n_cache_lookups += 1
                    raw_hit, hit_pages = self.prefix_cache.lookup(prompt)
                    # at least one token must run to produce logits
                    hit = min(raw_hit, prompt.size - 1)
                    if hit > 0:
                        shared = [int(p) for p in
                                  hit_pages[:pages_for(hit, self.page_size)]]
                    # attach before the availability check so the shared
                    # pages stop counting as reclaimable
                    for p in shared:
                        self._ref[p] += 1
                fresh = need - len(shared)
                # one page of decode-growth headroom (when the sequence
                # will grow at all): admitting into an exactly-full pool
                # would preempt the newcomer at the next page boundary and
                # re-pay its whole prefill. A partially-hit tail page also
                # reserves one page for its copy-on-write.
                cow_reserve = 1 if hit % self.page_size else 0
                if fresh + cow_reserve + min(1, worst - need) \
                        > self.available_pages:
                    for p in shared:      # roll back the attach
                        self._ref[p] -= 1
                    kept.append(seq)
                    blocked = True    # FCFS: don't let younger traffic pass
                    continue
            slot = self._free.pop(0)
            if self.paged:
                if shared:
                    self.block_tables[slot, :len(shared)] = shared
                    self._n_pages[slot] = len(shared)
                self._alloc_pages(slot, fresh)
                seq.cache_hit_tokens = hit
                if hit > 0:
                    self.n_cache_hits += 1
                    self.n_cache_hit_tokens += hit
                    self.n_cache_hit_pages += len(shared)
                    self.prefix_cache.touch(shared)
            self._running[slot] = seq
            group.append(ScheduledSeq(seq, slot, head_bucket))
        self._waiting = kept + self._waiting   # preserve FCFS order
        return group

    def page_table_rows(self, group: List[ScheduledSeq],
                        bucket: int) -> np.ndarray:
        """(len(group), ceil(bucket/page_size)) page ids for cache insert;
        entries past a sequence's allocated pages are 0 (sink)."""
        n = pages_for(bucket, self.page_size)
        rows = np.zeros((len(group), n), np.int32)
        for i, ss in enumerate(group):
            take = min(n, int(self._n_pages[ss.slot]))
            rows[i, :take] = self.block_tables[ss.slot, :take]
        return rows

    # -- paged page pool ---------------------------------------------------

    def _take_page(self) -> Optional[int]:
        """Pop a free page (refcount set to 1), reclaiming LRU cache-only
        pages when the free list is dry. None when truly exhausted."""
        if not self._free_pages and self.prefix_cache is not None:
            freed = self.prefix_cache.evict_reclaimable(self._ref, 1)
            self.n_cache_evictions += len(freed)
            for p in freed:
                self._ref[p] = 0
                bisect.insort(self._free_pages, p)
        if not self._free_pages:
            return None
        page = self._free_pages.pop(0)
        self._ref[page] = 1
        return page

    def _unref(self, page: int) -> None:
        self._ref[page] -= 1
        if self._ref[page] == 0:
            bisect.insort(self._free_pages, page)
        elif self._ref[page] < 0:
            raise RuntimeError(f"page {page}: refcount underflow")

    def _alloc_pages(self, slot: int, n: int) -> None:
        for _ in range(n):
            page = self._take_page()
            if page is None:
                raise RuntimeError("page pool exhausted — admission must "
                                   "check available_pages first")
            self.block_tables[slot, self._n_pages[slot]] = page
            self._n_pages[slot] += 1

    def _written_rows(self, seq: Sequence) -> int:
        """KV rows [0, n) of this sequence that hold final content."""
        if seq.prefill_progress is not None:
            return seq.prefill_progress
        return max(seq.next_write_pos, 0)

    def _register_prefix(self, slot: int, seq: Sequence, upto: int) -> None:
        if self.prefix_cache is None or upto <= 0:
            return
        upto = min(upto, int(self._n_pages[slot]) * self.page_size)
        pages = [int(p) for p in
                 self.block_tables[slot, :pages_for(upto, self.page_size)]]
        for p in self.prefix_cache.register(seq.full_prompt[:upto], upto,
                                            pages):
            self._ref[p] += 1

    def on_prefill_complete(self, slot: int) -> None:
        """Register the slot's *full* prompt pages in the prefix cache.
        The partially-filled tail page waits for release, so a sequence
        never copy-on-writes against its own registration."""
        if self.prefix_cache is None:
            return
        seq = self._running[slot]
        upto = (self._written_rows(seq) // self.page_size) * self.page_size
        self._register_prefix(slot, seq, upto)

    def _release_slot(self, slot: int) -> Sequence:
        seq = self._running.pop(slot)
        if self.paged:
            # register everything written — including the partial tail and
            # decode-grown pages, which serve multi-turn follow-ups
            if self.prefix_cache is not None:
                self._register_prefix(slot, seq, self._written_rows(seq))
            held = int(self._n_pages[slot])
            for p in self.block_tables[slot, :held]:
                self._unref(int(p))
            self.block_tables[slot, :] = 0
            self._n_pages[slot] = 0
        self._free.append(slot)
        self._free.sort()
        return seq

    def _preempt(self, slot: int) -> Sequence:
        """Free a running sequence's pages and requeue it (FCFS position
        restored via its submission order)."""
        seq = self._release_slot(slot)
        seq.prefill_progress = None      # resume restarts its prefill
        seq.cache_hit_tokens = 0
        seq.n_preempts += 1
        self.n_preemptions += 1
        orders = [s.order for s in self._waiting]
        self._waiting.insert(bisect.bisect_left(orders, seq.order), seq)
        return seq

    # -- copy-on-write -----------------------------------------------------

    def _cow_if_shared(self, slot: int,
                       idx: int) -> List[Tuple[int, Sequence]]:
        """Make block-table entry ``idx`` of ``slot`` exclusively owned
        before a write lands in it. Prefers a fresh copy (keeping the
        cache entry warm); under pool exhaustion it instead evicts the
        cache's claim, and as a last resort preempts other sharers.
        Returns preempted (slot, sequence) pairs."""
        preempted: List[Tuple[int, Sequence]] = []
        while True:
            page = int(self.block_tables[slot, idx])
            if self._ref[page] <= 1:
                return preempted
            dst = self._take_page()
            if dst is not None:
                self._cow_pending.append((page, dst))
                self.n_cow_copies += 1
                self.block_tables[slot, idx] = dst
                self._unref(page)
                return preempted
            # no page anywhere: sacrifice the cache's claim on this page
            if self.prefix_cache is not None \
                    and self.prefix_cache.unregister(page):
                self.n_cache_evictions += 1
                self._ref[page] -= 1     # cache's reference; never last
                continue
            # still shared with other running sequences: preempt the
            # newest of them (never the writer itself)
            others = [s for s in self._running if s != slot]
            victim = max(others, key=lambda s: self._running[s].order)
            preempted.append((victim, self._preempt(victim)))

    def prepare_chunk_writes(self, slot: int, start: int,
                             end: int) -> List[Tuple[int, Sequence]]:
        """Copy-on-write every page a prefill chunk's KV writes
        [start, end) land in. Returns preempted (slot, sequence) pairs;
        the engine must drain ``take_cow_copies()`` before the chunk."""
        if not self.paged or start >= end:
            return []
        preempted: List[Tuple[int, Sequence]] = []
        first = start // self.page_size
        last = (end - 1) // self.page_size
        for idx in range(first, min(last + 1, int(self._n_pages[slot]))):
            preempted.extend(self._cow_if_shared(slot, idx))
        return preempted

    def take_cow_copies(self) -> List[Tuple[int, int]]:
        """Drain the pending (src_page, dst_page) copy-on-write pairs.
        The engine must apply them to the device pool before the next
        cache-writing step."""
        if not self.paged:
            return []
        out, self._cow_pending = self._cow_pending, []
        return out

    # -- paged decode growth / preemption ---------------------------------

    def ensure_decode_pages(self, writing: Optional[Set[int]] = None) \
            -> List[Tuple[int, Sequence]]:
        """Before a decode step: make sure every running slot owns the page
        its next KV write lands in — exclusively, copy-on-writing shared
        pages — preempting lowest-priority sequences on pool exhaustion.
        ``writing`` names the slots the coming step actually writes (all
        decoding slots by default); slots mid-chunked-prefill are skipped
        (their pages are preallocated and their writes guarded by
        ``prepare_chunk_writes``). Returns the (slot, sequence) pairs
        preempted this round — the engine must clear their device-side
        slot state and drain ``take_cow_copies()``.
        """
        if not self.paged:
            return []
        preempted: List[Tuple[int, Sequence]] = []
        for slot in sorted(self._running,
                           key=lambda s: self._running[s].order):
            if slot not in self._running:     # preempted as a victim below
                continue
            seq = self._running[slot]
            if seq.prefill_progress is not None:
                continue
            need = seq.next_write_pos // self.page_size + 1
            while int(self._n_pages[slot]) < need:
                page = self._take_page()
                if page is not None:
                    self.block_tables[slot, self._n_pages[slot]] = page
                    self._n_pages[slot] += 1
                    continue
                victim = max(self._running,
                             key=lambda s: self._running[s].order)
                preempted.append((victim, self._preempt(victim)))
                if victim == slot:
                    break                     # preempted itself; move on
            if slot not in self._running:
                continue
            if writing is not None and slot not in writing:
                continue
            idx = seq.next_write_pos // self.page_size
            if idx < int(self._n_pages[slot]):
                preempted.extend(self._cow_if_shared(slot, idx))
        return preempted

    # -- completion / eviction --------------------------------------------

    def complete(self, slot: int, evicted: bool = False) -> Sequence:
        """Release a slot (finished sequence, or slot-mode eviction); the
        slot — and in paged mode its pages — are reusable from the next
        schedule() round."""
        if slot not in self._running:
            raise KeyError(f"slot {slot} is not running")
        seq = self._release_slot(slot)
        self.n_completed += 1
        self.n_evicted += int(evicted)
        return seq

    # -- deterministic action API (model checker / tests; DESIGN.md Sec. 12)

    def preempt_slot(self, slot: int) -> Sequence:
        """Force-preempt one running slot (pages freed, sequence requeued
        at its FCFS position).  The engine only preempts under pool
        pressure; exposing the transition directly lets the model checker
        and tests explore preemption at *every* point, not just the ones
        current pool geometry happens to trigger.  The caller owns any
        engine-side slot state (``Engine._clear_slot``)."""
        if slot not in self._running:
            raise KeyError(f"slot {slot} is not running")
        if not self.paged:
            raise ValueError("preempt_slot requires paged KV (slot-mode "
                             "eviction is terminal: use complete)")
        return self._preempt(slot)

    def reserve_pages(self, n: int = 1) -> List[int]:
        """Take ``n`` pages out of circulation for an external consumer
        (pool-pressure injection).  Goes through ``_take_page`` so LRU
        cache reclaim applies, exactly like a real allocation.  All-or-
        nothing: on exhaustion the partial grab is rolled back and
        RuntimeError raised."""
        if not self.paged:
            raise ValueError("reserve_pages requires paged KV")
        got: List[int] = []
        for _ in range(n):
            page = self._take_page()
            if page is None:
                for p in got:
                    self._unref(p)
                raise RuntimeError(
                    f"reserve_pages({n}): page pool exhausted after "
                    f"{len(got)}")
            got.append(page)
        self._reserved_pages.extend(got)
        return got

    def release_reserved(self, n: Optional[int] = None) -> int:
        """Return externally reserved pages to the pool (LIFO); ``None``
        releases all.  Returns the number released."""
        if not self.paged:
            return 0
        take = len(self._reserved_pages) if n is None \
            else min(n, len(self._reserved_pages))
        for _ in range(take):
            self._unref(self._reserved_pages.pop())
        return take

    def clone(self) -> "Scheduler":
        """Deep, engine-independent copy of the full scheduler state.
        The model checker forks the state per explored transition; tests
        use it to diff before/after.  Subclasses (fault-injection
        mutants) clone to their own type.  Request objects and prompt
        arrays are shared (never mutated); everything mutable is copied."""
        c = object.__new__(type(self))
        c.max_slots = self.max_slots
        c.prefill_batch = self.prefill_batch
        c.min_bucket = self.min_bucket
        c.max_len = self.max_len
        c.paged = self.paged
        c.capacity = self.capacity
        c._order = self._order
        for k in ("n_submitted", "n_completed", "n_evicted",
                  "n_preemptions", "n_cache_lookups", "n_cache_hits",
                  "n_cache_hit_tokens", "n_cache_hit_pages",
                  "n_cow_copies", "n_cache_evictions"):
            setattr(c, k, getattr(self, k))
        clones: Dict[int, Sequence] = {}

        def seq_clone(seq: Sequence) -> Sequence:
            got = clones.get(id(seq))
            if got is None:
                got = dataclasses.replace(seq,
                                          generated=list(seq.generated))
                clones[id(seq)] = got
            return got

        c._waiting = deque(seq_clone(s) for s in self._waiting)
        c._free = list(self._free)
        c._running = {slot: seq_clone(s)
                      for slot, s in self._running.items()}
        c.prefix_cache = None
        if self.paged:
            c.page_size = self.page_size
            c.page_bytes = self.page_bytes
            c.pages_per_slot = self.pages_per_slot
            c.total_pages = self.total_pages
            c.usable_pages = self.usable_pages
            c._free_pages = list(self._free_pages)
            c._ref = self._ref.copy()
            c.block_tables = self.block_tables.copy()
            c._n_pages = self._n_pages.copy()
            c._cow_pending = list(self._cow_pending)
            c._reserved_pages = list(self._reserved_pages)
            if self.prefix_cache is not None:
                c.prefix_cache = self.prefix_cache.clone()
        return c

    def flush_prefix_cache(self) -> int:
        """Unregister every cached page (e.g. after warmup, so benchmark
        hits are earned, not inherited). Pages still shared with running
        sequences stay allocated; the rest return to the free list."""
        if self.prefix_cache is None:
            return 0
        n = 0
        for p in self.prefix_cache.pages():
            self.prefix_cache.unregister(int(p))
            self._unref(int(p))
            n += 1
        return n

    # -- invariants (property-test harness; cheap enough for debug use) ----

    def check_invariants(self, exhaustive: bool = False) -> None:
        """Assert pool conservation: every usable page is either free or
        refcounted; refcounts equal block-table membership plus cache
        registration plus external reservations; no aliased/dangling
        block-table entries; byte accounting matches distinct pages in
        use.

        ``exhaustive=True`` is the model-checker mode (DESIGN.md
        Sec. 12): it additionally audits free-list order, pending-COW
        pair sanity, reservation exclusivity and the prefix-cache
        index's internal consistency — checks cheap at model-checking
        scale (4-12 pages) that would be wasted work per engine step at
        serving scale, where this method guards debug/property runs."""
        if not self.paged:
            return
        ref_expect = np.zeros((self.total_pages,), np.int64)
        for slot, _seq in self._running.items():
            held = int(self._n_pages[slot])
            row = [int(p) for p in self.block_tables[slot, :held]]
            if len(set(row)) != held:
                raise AssertionError(
                    f"slot {slot}: aliased block-table entries {row}")
            if any(p == 0 for p in row):
                raise AssertionError(f"slot {slot}: sink page in table")
            if (self.block_tables[slot, held:] != 0).any():
                raise AssertionError(
                    f"slot {slot}: dangling entries past n_pages={held}")
            for p in row:
                ref_expect[p] += 1
        if self.prefix_cache is not None:
            for p in self.prefix_cache.pages():
                ref_expect[int(p)] += 1
        for p in self._reserved_pages:
            ref_expect[p] += 1
        if not (ref_expect == self._ref).all():
            bad = np.nonzero(ref_expect != self._ref)[0]
            raise AssertionError(
                f"refcount mismatch at pages {bad.tolist()}: expected "
                f"{ref_expect[bad].tolist()}, got "
                f"{self._ref[bad].tolist()}")
        free = set(self._free_pages)
        if len(free) != len(self._free_pages):
            raise AssertionError("duplicate pages in the free list")
        for p in range(1, self.total_pages):
            if (int(self._ref[p]) > 0) == (p in free):
                raise AssertionError(
                    f"page {p}: ref {int(self._ref[p])} inconsistent with "
                    f"free-list membership {p in free}")
        if int((self._ref[1:] > 0).sum()) + len(free) != self.usable_pages:
            raise AssertionError("page conservation violated")
        if self.bytes_in_use != self.pages_in_use * self.page_bytes:
            raise AssertionError("bytes_in_use out of sync with pages")
        for slot in self._free:
            if slot in self._running:
                raise AssertionError(f"slot {slot} both free and running")
        if not exhaustive:
            return
        if self._free_pages != sorted(self._free_pages):
            raise AssertionError("free list out of order (lowest-first "
                                 "allocation determinism broken)")
        if len(set(self._reserved_pages)) != len(self._reserved_pages):
            raise AssertionError("duplicate reserved pages")
        held_anywhere = set()
        for slot in self._running:
            held_anywhere.update(
                int(p) for p in
                self.block_tables[slot, :int(self._n_pages[slot])])
        for p in self._reserved_pages:
            if int(self._ref[p]) != 1:
                raise AssertionError(
                    f"reserved page {p}: ref {int(self._ref[p])} != 1 "
                    "(external reservations are exclusive)")
            if p in held_anywhere or (self.prefix_cache is not None
                                      and self.prefix_cache.owns(p)):
                raise AssertionError(
                    f"reserved page {p} also owned by a slot or the cache")
        for src, dst in self._cow_pending:
            if dst == 0 or src == dst:
                raise AssertionError(
                    f"pending COW ({src}, {dst}): bad pair")
            if int(self._ref[dst]) != 1:
                raise AssertionError(
                    f"pending COW dst {dst}: ref {int(self._ref[dst])} "
                    "!= 1 (dst must be freshly owned by the writer)")
        if self.prefix_cache is not None:
            self.prefix_cache.check_consistency()
