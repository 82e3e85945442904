"""Codes-domain prefix cache: a radix/trie index over prompt page chunks.

Real serving traffic is dominated by shared prefixes — system prompts,
few-shot templates, multi-turn history.  Because UNIQ KV pages are *exact
integer k-quantile codes* (models/kv_cache.py: a row's codes depend only
on that row's fresh K/V values, themselves a deterministic function of the
token prefix), two sequences with the same token prefix produce
bit-identical pages — so prefix sharing needs no numerical-tolerance
argument.  A match in this index is a correctness proof: the cached page
holds exactly the bytes a cold prefill of the same tokens would write
(``models/kv_cache.page_fingerprint`` pins this in tests).

The index is a radix trie keyed by *token-id page chunks*:

  * an edge at depth i is the ``page_size`` token ids covering positions
    ``[i*page, (i+1)*page)`` — walking the trie from the root therefore
    conditions every node on the **entire** token prefix, which is what
    the causal dependence of KV rows on all preceding tokens requires
    (equivalent to vLLM's chained block hashes, without hash collisions).
  * a node stores the pool page id holding those positions' KV (all
    layers: page ids index the stacked (L, total_pages, ...) pool axis).
  * **partial tails**: a node may also carry entries for sub-page token
    runs (a completed sequence's last, partially-filled page).  A lookup
    may extend a full-page match into a partial entry — or into the
    *prefix* of a full child chunk — sharing a page whose later rows hold
    other content; those rows are masked by the causal ``k_pos <= q_pos``
    attention mask until the new owner copy-on-writes the page
    (serve/scheduler.py).

The cache owns one reference on every registered page (the scheduler's
per-page refcounts); eviction is LRU over *reclaimable* entries — pages
referenced by nothing but the cache, with no live descendant entries (so
a surviving chain is always contiguous from the root).  All bookkeeping
is host-side and O(cache size); the device-side pool is untouched until
the scheduler frees or clones pages.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["PrefixCache", "chunk_key"]


def chunk_key(tokens: np.ndarray) -> bytes:
    """Canonical trie-edge key for a run of token ids."""
    return np.ascontiguousarray(tokens, np.int32).tobytes()


def _key_tokens(key: bytes) -> np.ndarray:
    return np.frombuffer(key, np.int32)


def _common_prefix(a: np.ndarray, b: np.ndarray) -> int:
    n = min(a.size, b.size)
    if n == 0:
        return 0
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if neq.size else n


@dataclasses.dataclass
class _Partial:
    """Sub-page entry: ``tokens`` cover the first ``tokens.size`` rows of
    ``page``; rows past that hold the donor's later writes (masked until
    a consumer overwrites them post-COW)."""
    tokens: np.ndarray
    page: int


class _Node:
    __slots__ = ("children", "partials", "page", "parent", "key")

    def __init__(self, parent: Optional["_Node"] = None,
                 key: Optional[bytes] = None):
        self.children: Dict[bytes, "_Node"] = {}
        self.partials: Dict[bytes, _Partial] = {}
        self.page: Optional[int] = None
        self.parent = parent
        self.key = key


class PrefixCache:
    """Radix index from token-id chunks to pool page ids (host-side)."""

    def __init__(self, page_size: int):
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.page_size = page_size
        self._root = _Node()
        # page id -> ("node", node) | ("partial", node, key); plus LRU ticks
        self._entries: Dict[int, Tuple] = {}
        self._last_used: Dict[int, int] = {}
        self._clock = 0
        self.n_evictions = 0

    # -- introspection -----------------------------------------------------

    @property
    def n_pages(self) -> int:
        return len(self._entries)

    @property
    def n_nodes(self) -> int:
        """Radix-trie node count (index-size gauge for telemetry; the
        page entries are the HBM cost, this is the host-side cost)."""
        n = 0
        stack = [self._root]
        while stack:
            node = stack.pop()
            n += 1
            stack.extend(node.children.values())
        return n

    def pages(self) -> Iterator[int]:
        return iter(list(self._entries))

    def owns(self, page: int) -> bool:
        return page in self._entries

    def touch(self, pages) -> None:
        self._clock += 1
        for p in pages:
            if int(p) in self._entries:
                self._last_used[int(p)] = self._clock

    def lru_order(self) -> List[int]:
        """Registered pages, least-recently-used first (ties broken by
        registration order, matching ``evict_reclaimable``'s scan)."""
        return sorted(self._entries,
                      key=lambda p: self._last_used.get(p, 0))

    # -- model-checker support (DESIGN.md Sec. 12) ---------------------------

    def fingerprint(self, page_label=lambda p: p) -> Tuple:
        """Canonical structural fingerprint of the index: the trie shape
        with child keys sorted and page ids passed through ``page_label``
        (the model checker supplies a relabeling so isomorphic states —
        same structure, different physical page numbers — hash equal)."""

        def walk(node: _Node) -> Tuple:
            kids = tuple(
                (key,
                 -1 if node.children[key].page is None
                 else page_label(node.children[key].page),
                 walk(node.children[key]))
                for key in sorted(node.children))
            parts = tuple((key, page_label(node.partials[key].page))
                          for key in sorted(node.partials))
            return (kids, parts)

        return walk(self._root)

    def clone(self) -> "PrefixCache":
        """Deep copy of the index (trie, entries, LRU state).  Token
        arrays are shared — they are never mutated after registration."""
        c = object.__new__(PrefixCache)
        c.page_size = self.page_size
        c._clock = self._clock
        c.n_evictions = self.n_evictions
        c._last_used = dict(self._last_used)
        c._entries = {}

        def walk(node: _Node, parent: Optional[_Node]) -> _Node:
            n = _Node(parent=parent, key=node.key)
            n.page = node.page
            if n.page is not None:
                c._entries[n.page] = ("node", n)
            for key, part in node.partials.items():
                p2 = _Partial(part.tokens, part.page)
                n.partials[key] = p2
                c._entries[p2.page] = ("partial", n, key)
            for key, child in node.children.items():
                n.children[key] = walk(child, n)
            return n

        c._root = walk(self._root, None)
        # preserve page-entry insertion order: evict_reclaimable breaks
        # LRU ties by dict order, so a clone must tie-break identically
        c._entries = {p: c._entries[p] for p in self._entries}
        return c

    def check_consistency(self) -> None:
        """Structural audit (model-checker exhaustive mode): the entry
        map and the trie must describe each other exactly; parent/key
        links must be intact; no dead (prunable) interior nodes linger."""
        seen: Dict[int, Tuple] = {}
        stack = [self._root]
        while stack:
            node = stack.pop()
            if node.page is not None:
                if node.page in seen:
                    raise AssertionError(
                        f"page {node.page} indexed twice")
                seen[node.page] = ("node", node)
            for key, part in node.partials.items():
                if part.page in seen:
                    raise AssertionError(
                        f"page {part.page} indexed twice")
                seen[part.page] = ("partial", node, key)
            for key, child in node.children.items():
                if child.parent is not node or child.key != key:
                    raise AssertionError(
                        f"broken parent/key link at {key!r}")
                if (child is not self._root and child.page is None
                        and not child.children and not child.partials):
                    raise AssertionError("dead interior node not pruned")
                stack.append(child)
        if set(seen) != set(self._entries):
            raise AssertionError(
                f"entry map out of sync with trie: "
                f"{sorted(set(seen) ^ set(self._entries))}")
        for page, entry in self._entries.items():
            if seen[page] != entry:
                raise AssertionError(
                    f"page {page}: entry map points at the wrong node")
        extra = set(self._last_used) - set(self._entries)
        if extra:
            raise AssertionError(
                f"LRU ticks for unregistered pages {sorted(extra)}")

    # -- lookup ------------------------------------------------------------

    def lookup(self, tokens: np.ndarray) -> Tuple[int, List[int]]:
        """Longest cached prefix of ``tokens``: (hit_tokens, page_ids).

        ``page_ids`` cover positions [0, hit_tokens) in order; the last
        page is partially covered when ``hit_tokens`` is not page-aligned
        (the caller must copy-on-write it before any write).  Read-only:
        refcounts and LRU state are the caller's to update on commit.
        """
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        ps = self.page_size
        node, n, pages = self._root, 0, []
        while n + ps <= tokens.size:
            child = node.children.get(chunk_key(tokens[n:n + ps]))
            if child is None or child.page is None:
                break
            pages.append(child.page)
            node = child
            n += ps
        rem = tokens[n:]
        if rem.size:
            best_m, best_page = 0, None
            for key in sorted(node.partials):
                m = _common_prefix(node.partials[key].tokens, rem)
                if m > best_m:
                    best_m, best_page = m, node.partials[key].page
            for key in sorted(node.children):
                child = node.children[key]
                if child.page is None:
                    continue
                m = _common_prefix(_key_tokens(key), rem)
                if m > best_m:
                    best_m, best_page = m, child.page
            if best_m > 0:
                pages.append(best_page)
                n += best_m
        return n, pages

    # -- registration ------------------------------------------------------

    def register(self, tokens: np.ndarray, upto: int,
                 pages: List[int]) -> List[int]:
        """Index the pages holding ``tokens[:upto]``; returns the page ids
        newly taken into the cache (the caller owes each one reference).
        Existing entries win — a prefix already indexed is left pointing
        at the original donor page.

        One entry per page: a page already indexed is never re-indexed
        under a second key.  A sequence that attaches a partially-hit
        cache page and releases *before writing into it* (preempted
        mid-admission) re-registers that page under a shorter token run;
        a second trie entry would double-count the cache's single
        reference and corrupt the refcount ledger (found by uniqmc,
        DESIGN.md Sec. 12 — an un-COWed tail page is the live donor
        entry's page, so the shorter run is already served by it)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        ps = self.page_size
        if upto > tokens.size or upto < 0:
            raise ValueError(f"upto {upto} out of range for "
                             f"{tokens.size} tokens")
        if len(pages) * ps < upto:
            raise ValueError(f"{len(pages)} pages cannot hold {upto} tokens")
        self._clock += 1
        node, n, i, new = self._root, 0, 0, []
        while n + ps <= upto:
            key = chunk_key(tokens[n:n + ps])
            child = node.children.get(key)
            if child is None:
                child = _Node(parent=node, key=key)
                node.children[key] = child
            if child.page is None:
                page = int(pages[i])
                if page in self._entries:
                    # indexed elsewhere (e.g. as another run's partial
                    # tail): stop so the registered prefix stays
                    # contiguous and the page keeps its single entry
                    self._prune(child)
                    return new
                child.page = page
                self._entries[page] = ("node", child)
                new.append(page)
            self._last_used[child.page] = self._clock
            node, n, i = child, n + ps, i + 1
        if upto - n > 0:
            key = chunk_key(tokens[n:upto])
            if key not in node.partials \
                    and int(pages[i]) not in self._entries:
                part = _Partial(tokens[n:upto].copy(), int(pages[i]))
                node.partials[key] = part
                self._entries[part.page] = ("partial", node, key)
                new.append(part.page)
            if key in node.partials:
                self._last_used[node.partials[key].page] = self._clock
        return new

    # -- removal / eviction ------------------------------------------------

    def unregister(self, page: int) -> bool:
        """Drop one page's entry (the caller releases the cache's
        reference).  Used for COW fallback and explicit flushes."""
        entry = self._entries.pop(page, None)
        if entry is None:
            return False
        self._last_used.pop(page, None)
        if entry[0] == "node":
            node = entry[1]
            node.page = None
            self._prune(node)
        else:
            _, node, key = entry
            del node.partials[key]
            self._prune(node)
        return True

    def _prune(self, node: _Node) -> None:
        while (node.parent is not None and node.page is None
               and not node.children and not node.partials):
            del node.parent.children[node.key]
            node = node.parent

    def _live_descendant(self, node: _Node) -> bool:
        if node.partials:
            return True
        for child in node.children.values():
            if child.page is not None or self._live_descendant(child):
                return True
        return False

    def _evictable(self, page: int, ref: np.ndarray) -> bool:
        """Reclaimable now: only the cache references it, and nothing
        cached hangs below it (chains stay contiguous from the root)."""
        if int(ref[page]) != 1:
            return False
        entry = self._entries[page]
        if entry[0] == "partial":
            return True
        return not self._live_descendant(entry[1])

    def evict_reclaimable(self, ref: np.ndarray, need: int = 1) -> List[int]:
        """Evict up to ``need`` pages, least-recently-used first; returns
        the freed page ids (refcount 1 -> the caller zeroes and frees).
        Interior pages become evictable as their descendants go, so the
        scan repeats until satisfied or dry."""
        freed: List[int] = []
        while len(freed) < need:
            candidates = [p for p in self._entries
                          if self._evictable(p, ref)]
            if not candidates:
                break
            page = min(candidates, key=lambda p: self._last_used.get(p, 0))
            self.unregister(page)
            self.n_evictions += 1
            freed.append(page)
        return freed

    def count_reclaimable(self, ref: np.ndarray) -> int:
        """How many pages eviction could free in total (the transitive
        closure: a subtree counts only if no page in it is shared with a
        running sequence)."""

        def walk(node: _Node) -> Tuple[int, bool]:
            count, clean = 0, True
            for part in node.partials.values():
                if int(ref[part.page]) == 1:
                    count += 1
                else:
                    clean = False
            for child in node.children.values():
                c_count, c_clean = walk(child)
                count += c_count
                clean &= c_clean
                if child.page is not None:
                    if int(ref[child.page]) != 1:
                        clean = False
                    elif c_clean:
                        count += 1
            return count, clean

        return walk(self._root)[0]
