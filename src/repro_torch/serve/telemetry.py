"""Structured observability for the serving stack (DESIGN.md Sec. 11).

The engine's perf story used to live in an ad-hoc ``stats()`` dict and
scattered ``time.perf_counter()`` deltas; this module replaces that with
three small, dependency-free primitives:

  * a **metrics registry** — named counters, gauges and fixed-bucket
    histograms with percentile estimation, exported as a stable JSON
    snapshot or Prometheus text exposition.  Gauges that mirror live
    state (pool occupancy, queue depth) are refreshed by *collector*
    callbacks at snapshot time, so the hot path never pays for them.
  * a **span tracer** — a bounded in-memory ring buffer of completed
    spans and instant events on named (process, thread) tracks,
    exportable as Chrome-trace / Perfetto JSON (``chrome://tracing``).
    Spans are recorded *complete* (start + duration), so the export can
    always emit matched B/E pairs — a ring-buffer eviction can drop a
    whole span but never orphan half of one.
  * a **Telemetry** bundle tying the two together behind one ``enabled``
    flag, with null-object behavior when disabled: every method stays
    callable and O(1), records nothing, and the engine's device work is
    bit-identical either way (pinned by tests/test_telemetry.py).

Hot-path contract: this module is **host-only** (pure stdlib — no jax;
enforced by uniqcheck rule UQ106) and every per-step operation is
O(1) python — a couple of clock reads, a bisect into a fixed bucket
table, an append to a bounded deque.  Nothing here ever materializes a
device array or changes what the jitted steps compute.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import math
import re
import time
from collections import deque
from typing import Callable, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Span", "Instant", "Tracer", "Telemetry", "NULL_TELEMETRY",
    "time_buckets", "linear_buckets",
]


# --------------------------------------------------------------------------
# Metrics
# --------------------------------------------------------------------------

def time_buckets(lo: float = 1e-5, hi: float = 120.0,
                 factor: float = 1.15) -> Tuple[float, ...]:
    """Log-spaced duration buckets (seconds): ~15% relative resolution
    from 10us to 2min — tight enough that a histogram p99 lands within
    one bucket of the exact order statistic (tests pin this)."""
    edges = [lo]
    while edges[-1] < hi:
        edges.append(edges[-1] * factor)
    return tuple(edges)


def linear_buckets(lo: float, width: float, n: int) -> Tuple[float, ...]:
    """``n`` equal-width buckets starting at ``lo`` (upper edges)."""
    return tuple(lo + width * (i + 1) for i in range(n))


_DEFAULT_TIME_BUCKETS = time_buckets()


class Counter:
    """Monotonically increasing count (requests, tokens, events)."""
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help, self.value = name, help, 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """Last-written value (occupancy, bytes in use); usually refreshed
    by a registry collector at snapshot time rather than on the hot
    path."""
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help, self.value = name, help, 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def reset(self) -> None:
        self.value = 0.0


class Histogram:
    """Fixed-bucket histogram with percentile estimation.

    ``buckets`` are ascending upper edges; an implicit +inf bucket
    catches overflow.  ``observe`` is a bisect + two adds — O(log B)
    with B fixed at construction, no allocation.  Percentiles linearly
    interpolate inside the containing bucket, clamped to the observed
    min/max so single-value histograms report exactly.
    """
    __slots__ = ("name", "help", "buckets", "counts", "sum", "count",
                 "vmin", "vmax")

    def __init__(self, name: str, buckets: Tuple[float, ...], help: str = ""):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"{name}: bucket edges must be ascending")
        self.name, self.help = name, help
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)     # +1: +inf bucket
        self.sum = 0.0
        self.count = 0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def reset(self) -> None:
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0
        self.vmin = math.inf
        self.vmax = -math.inf

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Estimated q-th percentile (0..100) by linear interpolation
        within the containing bucket; 0.0 on an empty histogram."""
        if not self.count:
            return 0.0
        # nearest-rank position, matching numpy's 'linear' closely enough
        # at bucket resolution
        rank = (q / 100.0) * self.count
        acc = 0.0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            lo = self.buckets[i - 1] if i > 0 else min(self.vmin, 0.0)
            hi = self.buckets[i] if i < len(self.buckets) else self.vmax
            if acc + c >= rank:
                frac = min(max((rank - acc) / c, 0.0), 1.0)
                v = lo + (hi - lo) * frac
                return min(max(v, self.vmin), self.vmax)
            acc += c
        return self.vmax

    def snapshot(self) -> Dict:
        return {
            "buckets": list(self.buckets),
            "counts": list(self.counts),
            "count": self.count,
            "sum": self.sum,
            "min": self.vmin if self.count else 0.0,
            "max": self.vmax if self.count else 0.0,
            "mean": self.mean,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


_PROM_NAME = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    n = _PROM_NAME.sub("_", name)
    return n if not n[:1].isdigit() else "_" + n


class MetricsRegistry:
    """Named metric store with collector callbacks and stable exports."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._collectors: List[Callable[[], None]] = []

    def _get(self, name: str, kind, factory):
        m = self._metrics.get(name)
        if m is None:
            m = factory()
            self._metrics[name] = m
        elif not isinstance(m, kind):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, lambda: Counter(name, help))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, lambda: Gauge(name, help))

    def histogram(self, name: str,
                  buckets: Tuple[float, ...] = _DEFAULT_TIME_BUCKETS,
                  help: str = "") -> Histogram:
        return self._get(name, Histogram,
                         lambda: Histogram(name, buckets, help))

    def add_collector(self, fn: Callable[[], None]) -> None:
        """Register a callback that refreshes state-mirroring gauges;
        runs at snapshot/exposition time, never on the hot path."""
        self._collectors.append(fn)

    def collect(self) -> None:
        for fn in self._collectors:
            fn()

    def reset(self) -> None:
        for m in self._metrics.values():
            m.reset()

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __getitem__(self, name: str):
        return self._metrics[name]

    def snapshot(self) -> Dict:
        """Stable JSON-serializable snapshot: metric names sorted, gauges
        refreshed through the collectors first."""
        self.collect()
        out: Dict[str, Dict] = {"counters": {}, "gauges": {},
                                "histograms": {}}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = m.snapshot()
        return out

    def to_prometheus(self, prefix: str = "uniq_") -> str:
        """Prometheus text exposition (v0.0.4)."""
        self.collect()
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            pn = _prom_name(prefix + name)
            if isinstance(m, Counter):
                if m.help:
                    lines.append(f"# HELP {pn} {m.help}")
                lines.append(f"# TYPE {pn} counter")
                lines.append(f"{pn} {m.value}")
            elif isinstance(m, Gauge):
                if m.help:
                    lines.append(f"# HELP {pn} {m.help}")
                lines.append(f"# TYPE {pn} gauge")
                lines.append(f"{pn} {m.value:.9g}")
            else:
                if m.help:
                    lines.append(f"# HELP {pn} {m.help}")
                lines.append(f"# TYPE {pn} histogram")
                acc = 0
                for edge, c in zip(m.buckets, m.counts):
                    acc += c
                    lines.append(f'{pn}_bucket{{le="{edge:.9g}"}} {acc}')
                acc += m.counts[-1]
                lines.append(f'{pn}_bucket{{le="+Inf"}} {acc}')
                lines.append(f"{pn}_sum {m.sum:.9g}")
                lines.append(f"{pn}_count {m.count}")
        return "\n".join(lines) + "\n"


# --------------------------------------------------------------------------
# Tracing
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Span:
    """A completed span: ``[start, start + dur)`` seconds on a track."""
    name: str
    start: float
    dur: float
    track: str = "engine"
    tid: int = 0
    args: Optional[Dict] = None


@dataclasses.dataclass(frozen=True)
class Instant:
    name: str
    ts: float
    track: str = "engine"
    tid: int = 0
    args: Optional[Dict] = None


class _SpanCtx:
    """Context manager recording one span on exit (O(1))."""
    __slots__ = ("_tracer", "_name", "_track", "_tid", "_args", "_t0")

    def __init__(self, tracer, name, track, tid, args):
        self._tracer, self._name = tracer, name
        self._track, self._tid, self._args = track, tid, args

    def __enter__(self):
        self._t0 = self._tracer.clock()
        return self

    def __exit__(self, *exc):
        t1 = self._tracer.clock()
        self._tracer.add_span(self._name, self._t0, t1, self._track,
                              self._tid, self._args)
        return False


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()

# stable pid per track name in the Chrome export (alphabetical extras)
_TRACK_PIDS = {"engine": 1, "requests": 2}


class Tracer:
    """Bounded ring buffer of spans/instants with Chrome-trace export.

    All timestamps are ``clock()`` seconds (``time.perf_counter`` —
    monotonic); the export rebases on the tracer's epoch and converts to
    integer microseconds, the Chrome trace event format's unit.
    """

    def __init__(self, capacity: int = 65536,
                 clock: Callable[[], float] = time.perf_counter):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.clock = clock
        self.epoch = clock()
        self._spans: deque = deque(maxlen=capacity)
        self._instants: deque = deque(maxlen=capacity)
        self.n_spans_total = 0       # including ring-evicted
        self.n_instants_total = 0

    # -- recording ---------------------------------------------------------

    def span(self, name: str, track: str = "engine", tid: int = 0,
             **args) -> _SpanCtx:
        return _SpanCtx(self, name, track, tid, args or None)

    def add_span(self, name: str, start: float, end: float,
                 track: str = "engine", tid: int = 0,
                 args: Optional[Dict] = None) -> None:
        self._spans.append(Span(name, start, max(end - start, 0.0),
                                track, tid, args))
        self.n_spans_total += 1

    def instant(self, name: str, ts: Optional[float] = None,
                track: str = "engine", tid: int = 0,
                args: Optional[Dict] = None) -> None:
        self._instants.append(Instant(name, self.clock() if ts is None
                                      else ts, track, tid, args))
        self.n_instants_total += 1

    # -- introspection -----------------------------------------------------

    @property
    def n_dropped(self) -> int:
        return (self.n_spans_total - len(self._spans)
                + self.n_instants_total - len(self._instants))

    def spans(self) -> Iterator[Span]:
        return iter(self._spans)

    def reset(self) -> None:
        self._spans.clear()
        self._instants.clear()
        self.n_spans_total = 0
        self.n_instants_total = 0
        self.epoch = self.clock()

    # -- export ------------------------------------------------------------

    def _us(self, t: float) -> int:
        return int(round((t - self.epoch) * 1e6))

    def to_chrome_trace(self) -> Dict:
        """Chrome trace event format (``chrome://tracing`` / Perfetto).

        Duration events are emitted as matched B/E pairs per
        (pid, tid).  Spans on one track may interleave arbitrarily in
        the ring; the export rebuilds proper nesting with a stack —
        a child's E always precedes its parent's E, and a child that
        outlives its parent is clamped to the parent's end (the engine
        only produces well-nested spans, so clamping is a no-op there).
        """
        events: List[Dict] = []
        pids: Dict[str, int] = {}

        def pid_of(track: str) -> int:
            if track not in pids:
                pids[track] = _TRACK_PIDS.get(
                    track, 100 + len([t for t in pids
                                      if t not in _TRACK_PIDS]))
                events.append({"name": "process_name", "ph": "M",
                               "pid": pids[track], "tid": 0,
                               "args": {"name": track}})
            return pids[track]

        by_lane: Dict[Tuple[str, int], List[Span]] = {}
        for s in self._spans:
            by_lane.setdefault((s.track, s.tid), []).append(s)

        for (track, tid), spans in sorted(by_lane.items()):
            pid = pid_of(track)
            # parents before children at equal start
            spans.sort(key=lambda s: (s.start, -s.dur))
            stack: List[Tuple[float, int]] = []     # (end, idx into evts)
            for s in spans:
                start = s.start
                while stack and stack[-1][0] <= start + 1e-12:
                    end, _ = stack.pop()
                    events.append({"name": "", "ph": "E", "pid": pid,
                                   "tid": tid, "ts": self._us(end)})
                end = s.start + s.dur
                if stack:
                    end = min(end, stack[-1][0])    # clamp to parent
                    start = max(start, 0.0)
                ev = {"name": s.name, "ph": "B", "pid": pid, "tid": tid,
                      "ts": self._us(start)}
                if s.args:
                    ev["args"] = dict(s.args)
                events.append(ev)
                stack.append((end, len(events) - 1))
            while stack:
                end, _ = stack.pop()
                events.append({"name": "", "ph": "E", "pid": pid,
                               "tid": tid, "ts": self._us(end)})
        for i in self._instants:
            ev = {"name": i.name, "ph": "i", "s": "t",
                  "pid": pid_of(i.track), "tid": i.tid,
                  "ts": self._us(i.ts)}
            if i.args:
                ev["args"] = dict(i.args)
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.n_dropped}}


# --------------------------------------------------------------------------
# Bundle
# --------------------------------------------------------------------------

class Telemetry:
    """Registry + tracer behind one ``enabled`` flag.

    Disabled, every call is still valid and O(1) but records nothing —
    the engine keeps exactly one code path, and the on/off token-stream
    parity is structural (telemetry never touches device data).
    """

    def __init__(self, enabled: bool = True, trace_capacity: int = 65536,
                 clock: Callable[[], float] = time.perf_counter):
        self.enabled = enabled
        self.registry = MetricsRegistry()
        self.tracer = Tracer(trace_capacity, clock)
        self.clock = clock

    def span(self, name: str, track: str = "engine", tid: int = 0,
             **args):
        if not self.enabled:
            return _NULL_CTX
        return self.tracer.span(name, track, tid, **args)

    def instant(self, name: str, **kw) -> None:
        if self.enabled:
            self.tracer.instant(name, **kw)

    def inc(self, counter: Counter, n: int = 1) -> None:
        if self.enabled:
            counter.inc(n)

    def observe(self, hist: Histogram, v: float) -> None:
        if self.enabled:
            hist.observe(v)

    def reset(self) -> None:
        self.registry.reset()
        self.tracer.reset()

    # -- exports -----------------------------------------------------------

    def snapshot(self, meta: Optional[Dict] = None) -> Dict:
        out = {"meta": dict(meta or {})}
        out.update(self.registry.snapshot())
        return out

    def write_metrics(self, path: str, meta: Optional[Dict] = None) -> None:
        """Write the JSON snapshot at ``path`` and the Prometheus text
        exposition next to it at ``path + '.prom'``."""
        with open(path, "w") as fh:
            json.dump(self.snapshot(meta), fh, indent=2, sort_keys=True)
        with open(path + ".prom", "w") as fh:
            fh.write(self.registry.to_prometheus())

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.tracer.to_chrome_trace(), fh)


# shared disabled instance for call sites with no telemetry wired in
# (every record call is a cheap no-op; nothing accumulates)
NULL_TELEMETRY = Telemetry(enabled=False, trace_capacity=1)


def percentile_summary(hist: Histogram, scale: float = 1.0,
                       ndigits: int = 4) -> Dict[str, float]:
    """{p50, p95, p99} of a histogram, scaled (e.g. 1e3 for ms)."""
    return {f"p{q}": round(hist.percentile(q) * scale, ndigits)
            for q in (50, 95, 99)}
