"""Continuous-batching serving engine over UNIQ-quantized weights.

Serves an open request stream:

  * **paged KV cache** — one device-resident page pool (leaves
    (L, total_pages, page_size, ...)), updated in place; a sequence's KV
    grows page by page through a per-slot block table.  On pool exhaustion
    the scheduler *preempts* the lowest-priority sequence (frees its pages,
    requeues it with its generated tokens) and *resumes* it later by
    re-prefilling prompt+generated — no request is ever lost mid-decode.
  * **bit-parametric pages** — ``kv_bits`` in {16, 8, 4}: quantized pools
    hold k-quantile codes + per-(row, head) statistics instead of dense
    rows (models/kv_cache.py); prefill codes K/V before attending and decode
    appends codes, so preemption/resume is bit-exact in the codes domain.
    The scheduler admits in *bytes* (``pool_bytes``), so at equal memory
    the kv8/kv4 pool holds ~2x/~3.6x the pages.
  * **slot cache** (``cache_mode="slot"``) — the legacy fixed-region
    layout: one ``max_len``-row kv16 region per decode slot, written
    positionally; a sequence whose region fills is finished as
    "evicted" (terminal).  Kept as the A/B baseline of the paged pool.
  * **batched prefill** — an admitted group runs ONE forward over the whole
    padded prompt block (``model.prefill`` with per-sequence ``last_idx``),
    then scatters its KV into pool pages (``model.cache_insert_paged``) or
    slots (``model.cache_insert``).
  * **continuous decode** — one fixed-shape step advances *all* active
    slots each iteration; sequences join and leave mid-stream.
  * **per-request sampling** — temperature / top-k / stop conditions are
    per-slot arrays, and the random draw of a row is a function of
    (request seed, absolute position) only — never of slot, batch or bucket
    — so a resumed sequence's sample stream continues exactly where
    preemption cut it.
  * **chunked prefill + prefix caching** (``prefill_chunk`` /
    ``prefix_cache``) — a prompt is prefilled page-chunk by page-chunk,
    interleaved with decode steps.  With the prefix cache on, admission
    attaches pages already holding the prompt's prefix (exact in the codes
    domain) and prefill starts after the hit; shared pages are
    copy-on-written before any write (``clone_pages``).

The weights may be k-quantile coded (``model.quantize_for_serving``): both
prefill and decode then run every layer matmul through the dequant-fused
``qmatmul`` kernel, and decode attention at kv8/kv4 through the paged
attention kernel.  Everything runs under ``torch.no_grad()``; the per-step
host sync is the copy of the sampled tokens to the host.

Two debug aids, both off by default and neither changing a token:
``checkify`` checks each device step's indices before it runs and its
logits after it (``RuntimeError`` naming the step and the check), and
``profile_annotations`` names the device steps in ``torch.profiler``
traces (``engine.decode``, ``engine.prefill``, ``engine.cache_insert``,
``engine.prefill_chunk``, ``engine.cow``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional, Sequence as Seq

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.devices import resolve_device
from repro_torch.models import kv_cache
from repro_torch.models import lm
from repro_torch.models import model
from repro_torch.models.lm import ModelOpts
from repro_torch.serve import sampling
from repro_torch.serve import telemetry as tele_lib
from repro_torch.serve.scheduler import (Request, SamplingParams,
                                         ScheduledSeq, Scheduler, Sequence)

__all__ = ["EngineConfig", "Engine", "Request", "SamplingParams",
           "RequestOutput"]

# smallest bucketed decode batch: engines at or below this never bucket
_DECODE_BUCKET_MIN = 8


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_slots: int = 8          # concurrent sequences (decode batch)
    max_len: int = 256          # per-sequence KV capacity (prompt + gen)
    prefill_batch: int = 4      # prompts prefilled per admission round
    min_bucket: int = 16        # smallest padded prompt length
    cache_mode: str = "paged"   # "paged" | "slot" (legacy A/B baseline)
    page_size: int = 64         # KV page size in tokens (paged mode)
    total_pages: Optional[int] = None
    # total_pages None => max_slots * ceil(max_len/page_size) + 1: every
    # slot can reach max_len, plus the reserved sink page, i.e. enough
    # that preemption only triggers when the pool is deliberately shrunk.
    kv_bits: int = 16           # 8/4 => k-quantile-coded KV pages (paged
                                #   mode only; models/kv_cache.py)
    a_bits: int = 32            # 2..8 => serve activations through the
                                #   real per-token int8 codec on quantized
                                #   matmuls (lm.mm_a: the qmatmul_a8
                                #   kernel, or qmatmul_lut on codebook
                                #   weights) in BOTH prefill and decode;
                                #   32 = full-precision activations.
                                #   Surfaces in the metrics-snapshot meta.
    pool_bytes: Optional[int] = None
    # byte budget for the page pool (alternative to total_pages): the pool
    # holds pool_bytes // page_kv_bytes(cfg, page_size, kv_bits) pages —
    # the dense kv16 page cost is charged at the dtype the pool is
    # actually allocated in, so the budget bounds real memory — and the
    # same budget admits ~2x the tokens at kv_bits=8, ~3.6x at 4.
    prefix_cache: bool = False  # radix prefix cache over pool pages (paged
                                #   mode; implies chunked prefill so hits
                                #   can skip the cached prefix)
    prefill_chunk: Optional[int] = None
    # pages per prefill chunk (paged mode): prompts prefill chunk-by-chunk
    # interleaved with decode steps instead of one whole padded prefill.
    # None with prefix_cache=True defaults to 1 page per chunk.
    coalesce_prefill: bool = True
    # batch every mid-prefill slot's next chunk into ONE prefill_chunk
    # call per engine step (padded to a power-of-two batch) instead of a
    # B=1 call per slot.  Bit-exact either way (pinned in tests; the
    # ``prefill_chunk_calls_saved`` counter tallies the coalesced calls);
    # False keeps the sequential path for A/B.
    bucket_decode: bool = True
    # paged mode: run the decode step at the power-of-two bucket of the
    # *active* slot count (floor 8, cap max_slots) instead of always at
    # max_slots — active rows are gathered into the bucket, pad rows
    # write the sink page.  A drained 43-slot pool decoding 5 stragglers
    # otherwise pays the full 43-row step.  Bit-exact either way: sampling
    # draws on (seed, position), never slot or batch (pinned in tests).
    # Engines with max_slots <= 8 never bucket.
    checkify: bool = False
    # opt-in debug sanitizer (OFF by default: it reads a flag from the
    # device before and after every device step, a host sync each): token
    # ids, positions, block-table entries, slots and copy-on-write pages
    # are checked to lie in range before a step writes with them, and its
    # logits to be finite after it, so a bad index or a NaN raises
    # RuntimeError at the offending step instead of corrupting the cache
    # silently (an out-of-range index write on the card would end the CUDA
    # context instead).  --checkify on launch/serve.py.
    telemetry: bool = True
    # structured observability (serve/telemetry.py): latency/queue
    # histograms, occupancy gauges and per-step spans in a bounded ring
    # buffer, exportable as a metrics snapshot + Chrome trace.  Host-side
    # and O(1) per step; token streams are bit-identical on/off (pinned in
    # tests).  False = the null object: same code path, records nothing.
    trace_capacity: int = 65536
    # span/instant ring-buffer capacity; oldest whole spans drop first
    # (the export never emits an orphaned half-span)
    profile_annotations: bool = False
    # wrap the device steps in torch.profiler.record_function ranges
    # (engine.decode / prefill / cache_insert / prefill_chunk / cow) so the
    # engine's phases show up named in torch.profiler traces.  OFF by
    # default: a range costs host time per call even with no profiler.


@dataclasses.dataclass
class RequestOutput:
    uid: int
    prompt: np.ndarray
    token_ids: List[int]
    finish_reason: str          # "stop" | "length" | "evicted" (slot mode)
    ttft_s: float               # arrival -> first token (wall clock)
    latency_s: float            # arrival -> completion (wall clock)
    n_preempts: int = 0         # preempt/resume round-trips survived


@torch.no_grad()
def _sample_batch(logits: torch.Tensor, temps: np.ndarray,
                  top_ks: np.ndarray, seeds: np.ndarray,
                  positions: np.ndarray) -> np.ndarray:
    """Per-row sampling: greedy at temperature 0 (ties to the lowest
    index), else categorical (Gumbel-max) with an optional top-k filter.
    Returns the sampled tokens on the host."""
    greedy = torch.argmax(logits, dim=-1)
    out = greedy.cpu().numpy().astype(np.int32)   # host sync
    V = logits.shape[-1]
    for i in np.nonzero(np.asarray(temps) > 0.0)[0]:
        lt = logits[i].to(torch.float32) / max(float(temps[i]), 1e-6)
        k = int(top_ks[i])
        if k > 0:
            kth = torch.sort(lt, descending=True).values[
                min(max(k - 1, 0), V - 1)]
            lt = torch.where(lt < kth, torch.full_like(lt, -torch.inf), lt)
        out[i] = int(sampling.gumbel_max(lt[None], seeds[i:i + 1],
                                         positions[i:i + 1])[0])
    return out


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


class Engine:
    """Continuous-batching engine.  ``submit`` requests, call ``step`` in a
    loop (or ``generate`` for a closed set); finished ``RequestOutput``s
    are returned as they complete."""

    def __init__(self, params, cfg: ArchConfig, opts: ModelOpts,
                 ec: EngineConfig = EngineConfig(), device="cuda"):
        self.device = resolve_device(device)
        model.require_ported(cfg, "Engine")
        if not model.supports_slot_cache(cfg):
            raise ValueError(
                f"engine serves decoder-only KV families; got {cfg.family}")
        if ec.cache_mode not in ("paged", "slot"):
            raise ValueError(f"unknown cache_mode: {ec.cache_mode!r}")
        kv_cache.check_kv_bits(ec.kv_bits, cfg.head_dim)
        if ec.kv_bits < 16 and ec.cache_mode != "paged":
            raise ValueError("kv_bits < 16 requires the paged cache (the "
                             "slot mode is the dense legacy baseline)")
        if ec.pool_bytes is not None and ec.cache_mode != "paged":
            raise ValueError("pool_bytes sizes the paged pool; the slot "
                             "cache is fixed at max_slots * max_len")
        if (ec.prefix_cache or ec.prefill_chunk is not None) \
                and ec.cache_mode != "paged":
            raise ValueError("prefix_cache / prefill_chunk require the "
                             "paged cache")
        if ec.prefill_chunk is not None and ec.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1 page")
        if ec.a_bits != 32 and not 2 <= ec.a_bits <= 8:
            raise ValueError("a_bits must be 32 (off) or 2..8 (the int8 "
                             f"activation codec); got {ec.a_bits}")
        self.cfg, self.ec = cfg, ec
        self.paged = ec.cache_mode == "paged"
        self.chunked = self.paged and (ec.prefix_cache
                                       or ec.prefill_chunk is not None)
        self.chunk_tokens = (ec.prefill_chunk or 1) * ec.page_size \
            if self.paged else 0
        self.opts = dataclasses.replace(opts, kv_bits=ec.kv_bits,
                                        serve_a_bits=ec.a_bits)
        for leaf in _leaves(params):
            if leaf.device.type != self.device.type:
                raise ValueError(
                    f"params live on {leaf.device} but the engine was asked "
                    f"to run on {self.device}")
        # per-layer views are sliced once here, not on every model call
        self.params = lm.unstack_layers(params, cfg.n_layers)
        cache_dtype = torch.float32 \
            if opts.compute_dtype == torch.float32 else torch.bfloat16
        if self.paged:
            self.page_bytes = kv_cache.page_kv_bytes(
                cfg, ec.page_size, ec.kv_bits,
                dense_itemsize=torch.empty((), dtype=cache_dtype)
                .element_size())
            self.scheduler = Scheduler(ec.max_slots, ec.prefill_batch,
                                       ec.min_bucket, ec.max_len,
                                       page_size=ec.page_size,
                                       total_pages=ec.total_pages,
                                       page_bytes=self.page_bytes,
                                       pool_bytes=ec.pool_bytes,
                                       prefix_cache=ec.prefix_cache)
            self._cache = model.init_paged_cache(
                cfg, self.scheduler.total_pages, ec.page_size, cache_dtype,
                kv_bits=ec.kv_bits, device=self.device)
        else:
            self.scheduler = Scheduler(ec.max_slots, ec.prefill_batch,
                                       ec.min_bucket, ec.max_len)
            self._cache = model.init_slot_cache(cfg, ec.max_slots,
                                                ec.max_len, cache_dtype,
                                                device=self.device)
        M = ec.max_slots
        self._positions = np.zeros((M,), np.int32)   # next KV write index
        self._cur_tok = np.zeros((M,), np.int32)     # last sampled token
        self._temps = np.zeros((M,), np.float32)
        self._topks = np.zeros((M,), np.int32)
        self._seeds = np.zeros((M,), np.int32)
        self._slots: dict[int, Sequence] = {}        # active slot -> seq
        self._prefilling: dict[int, Sequence] = {}   # mid-chunked-prefill
        self.n_decode_steps = 0
        self.n_bucketed_steps = 0   # decode steps run below max_slots
        self.n_prefill_calls = 0
        self.n_prefill_tokens = 0   # prefill *work* (resumes re-pay)
        self.n_prompt_tokens = 0    # unique prompt tokens (first admit only)
        # KV utilization accumulators (paged): valid rows vs held page rows
        self._util_tokens = 0
        self._util_page_tokens = 0
        self._last_decode_end: Optional[float] = None  # ITL anchor

        # -- telemetry: histograms observed on the
        # hot path are O(1) bisects; everything state-shaped is a gauge
        # refreshed by the collector at snapshot time only
        self.telemetry = tele_lib.Telemetry(enabled=ec.telemetry,
                                            trace_capacity=ec.trace_capacity)
        reg = self.telemetry.registry
        self._m_ttft = reg.histogram("ttft_s", help="arrival -> first token")
        self._m_itl = reg.histogram(
            "itl_s", help="gap between consecutive decode steps "
            "(= inter-token latency for every active sequence)")
        self._m_queue_wait = reg.histogram(
            "queue_wait_s", help="arrival -> admission")
        self._m_e2e = reg.histogram("e2e_latency_s",
                                    help="arrival -> completion")
        self._m_decode_step = reg.histogram(
            "decode_step_s", help="decode step incl. host sync")
        self._m_prefill_call = reg.histogram(
            "prefill_call_s", help="batched whole-prompt prefill call")
        self._m_chunk_call = reg.histogram(
            "prefill_chunk_s", help="single chunked-prefill call")
        self._m_batch = reg.histogram(
            "decode_batch", tele_lib.linear_buckets(0, 1, ec.max_slots),
            help="active decode slots per step")
        self._m_tok_decode = reg.counter(
            "tokens_decoded", help="tokens sampled by decode steps")
        self._m_tok_prefill_step = reg.counter(
            "prefill_step_tokens",
            help="prompt tokens run while decode slots were active "
            "(chunked-prefill interleaving)")
        self._m_chunk_saved = reg.counter(
            "prefill_chunk_calls_saved",
            help="B=1 prefill_chunk calls avoided by coalescing the "
            "step's mid-prefill slots into one batched call")
        reg.counter("requests_submitted")
        for reason in ("stop", "length", "evicted"):
            reg.counter(f"requests_finished_{reason}")
        self.telemetry.registry.add_collector(self._collect_gauges)

    # -- device steps (eager; the pool is updated in place) -----------------

    def _t(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), device=self.device)

    def _range(self, name: str):
        """A ``torch.profiler`` range around a device step when
        ``profile_annotations`` is on."""
        if self.ec.profile_annotations:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def _check(self, step: str, **ok) -> None:
        """``checkify``: each keyword is a device bool tensor, all True when
        its check holds.  Folds them into one flag tensor, reads it (a host
        sync) and raises RuntimeError naming the step and every failed
        check."""
        flags = torch.stack([torch.all(v) for v in ok.values()]).cpu()
        failed = [n for n, f in zip(ok, flags.tolist()) if not f]
        if failed:
            raise RuntimeError(
                f"checkify: {step} (decode step {self.n_decode_steps}, "
                f"prefill call {self.n_prefill_calls}) failed: "
                + ", ".join(failed))

    def _check_inputs(self, step: str, tokens=None, **index) -> None:
        """``checkify`` before a step: token ids in [0, vocab), positions
        in [0, max_len), page ids in [0, total_pages), slots in
        [0, max_slots)."""
        hi = {"positions": self.ec.max_len,
              "block_tables": getattr(self.scheduler, "total_pages", 0),
              "pages": getattr(self.scheduler, "total_pages", 0),
              "slots": self.ec.max_slots}
        if tokens is not None:
            index["tokens"] = tokens
            hi["tokens"] = self.cfg.vocab
        self._check(step, **{f"{n} in range": (t >= 0) & (t < hi[n])
                             for n, t in index.items()})

    def _decode_step(self, tokens, positions, block_tables, temps, topks,
                     seeds) -> np.ndarray:
        toks, pos = self._t(tokens)[:, None], self._t(positions)
        bt = self._t(block_tables) if self.paged else None
        if self.ec.checkify:
            self._check_inputs("engine.decode", toks, positions=pos,
                               **({"block_tables": bt} if self.paged
                                  else {}))
        with self._range("engine.decode"):
            logits, self._cache = model.decode(
                self.params, self.cfg, self.opts, self._cache, toks, pos,
                block_tables=bt)
            if self.ec.checkify:
                self._check("engine.decode",
                            **{"logits finite": torch.isfinite(logits)})
            return _sample_batch(logits, temps, topks, seeds, positions)

    def _prefill_step(self, tokens, last_idx, temps, topks, seeds):
        toks = self._t(tokens)
        if self.ec.checkify:
            self._check_inputs("engine.prefill", toks)
        with self._range("engine.prefill"):
            logits, kv = model.prefill(self.params, self.cfg, self.opts,
                                       {"tokens": toks},
                                       last_idx=self._t(last_idx))
            if self.ec.checkify:
                self._check("engine.prefill",
                            **{"logits finite": torch.isfinite(logits)})
            return _sample_batch(logits, temps, topks, seeds, last_idx), kv

    def _cache_insert(self, kv, rows) -> None:
        """Write a prefill block into the cache: ``rows`` are the group's
        page tables (paged) or slots (slot mode)."""
        rows = self._t(rows)
        if self.ec.checkify:
            self._check_inputs("engine.cache_insert",
                               **({"pages": rows} if self.paged
                                  else {"slots": rows}))
        with self._range("engine.cache_insert"):
            if self.paged:
                self._cache = model.cache_insert_paged(self._cache, kv, rows)
            else:
                self._cache = model.cache_insert(self._cache, kv, rows)

    def _chunk_step(self, tokens, positions, write_pages, write_rows,
                    block_tables, last_idx, last_pos, temps, topks,
                    seeds) -> np.ndarray:
        toks, pos, wp, bt = (self._t(tokens), self._t(positions),
                             self._t(write_pages), self._t(block_tables))
        if self.ec.checkify:
            # a chunk's pad positions may run past max_len: they only rotate
            # and mask rows that are written to the sink page
            self._check_inputs("engine.prefill_chunk", toks, pages=wp,
                               block_tables=bt)
        with self._range("engine.prefill_chunk"):
            logits, self._cache = model.prefill_chunk(
                self.params, self.cfg, self.opts, self._cache, toks, pos, wp,
                self._t(write_rows), bt, self._t(last_idx))
            if self.ec.checkify:
                self._check("engine.prefill_chunk",
                            **{"logits finite": torch.isfinite(logits)})
            # fold at the prompt's absolute last position: the sampled
            # first token matches whole-prefill (and preempt/resume) bit
            # for bit, whichever chunking produced it
            return _sample_batch(logits, temps, topks, seeds, last_pos)

    def _collect_gauges(self) -> None:
        """Snapshot-time collector: mirror engine/scheduler state into the
        registry.  Never runs on the hot path."""
        s = self.scheduler
        reg = self.telemetry.registry
        reg.counter("decode_steps").value = self.n_decode_steps
        reg.counter("prefill_calls").value = self.n_prefill_calls
        reg.counter("prefill_tokens").value = self.n_prefill_tokens
        reg.counter("prompt_tokens").value = self.n_prompt_tokens
        reg.counter("kv_rows_attended").value = self._util_tokens
        reg.counter("kv_page_rows_held").value = self._util_page_tokens
        reg.counter("requests_completed").value = s.n_completed
        reg.counter("preemptions").value = s.n_preemptions
        reg.counter("cache_lookups").value = s.n_cache_lookups
        reg.counter("cache_hits").value = s.n_cache_hits
        reg.counter("cache_hit_tokens").value = s.n_cache_hit_tokens
        reg.counter("cache_hit_pages").value = s.n_cache_hit_pages
        reg.counter("cow_copies").value = s.n_cow_copies
        reg.counter("cache_evictions").value = s.n_cache_evictions
        reg.counter("trace_spans_dropped").value = \
            self.telemetry.tracer.n_dropped
        reg.gauge("slots_running").set(s.n_running)
        reg.gauge("slots_prefilling").set(len(self._prefilling))
        reg.gauge("queue_depth").set(s.n_waiting)
        reg.gauge("kv_utilization").set(self.kv_utilization)
        if self.paged:
            reg.gauge("pages_in_use").set(s.pages_in_use)
            reg.gauge("pages_free").set(s.n_free_pages)
            reg.gauge("bytes_in_use").set(s.bytes_in_use)
            reg.gauge("pool_bytes_total").set(s.pool_bytes_total)
            reg.gauge("cached_pages").set(s.cached_pages)
            if s.prefix_cache is not None:
                reg.gauge("prefix_cache_nodes").set(s.prefix_cache.n_nodes)

    # -- request side ------------------------------------------------------

    def submit(self, request: Request) -> None:
        # None (not a 0.0 sentinel) means "unset": a caller that really
        # measured an arrival at t=0.0 keeps it, and TTFT is always
        # anchored at true arrival
        if request.arrival_time is None:
            request.arrival_time = time.perf_counter()
        self.scheduler.submit(request)
        self.telemetry.inc(
            self.telemetry.registry.counter("requests_submitted"))

    def reset_stats(self) -> None:
        """Zero perf counters (e.g. after a warmup request); slot state is
        untouched."""
        self.n_decode_steps = 0
        self.n_bucketed_steps = 0
        self.n_prefill_calls = 0
        self.n_prefill_tokens = 0
        self.n_prompt_tokens = 0
        self._util_tokens = 0
        self._util_page_tokens = 0
        self._last_decode_end = None
        self.telemetry.reset()
        self.scheduler.n_submitted = 0
        self.scheduler.n_completed = 0
        self.scheduler.n_evicted = 0
        self.scheduler.n_preemptions = 0
        self.scheduler.n_cache_lookups = 0
        self.scheduler.n_cache_hits = 0
        self.scheduler.n_cache_hit_tokens = 0
        self.scheduler.n_cache_hit_pages = 0
        self.scheduler.n_cow_copies = 0
        self.scheduler.n_cache_evictions = 0

    def flush_prefix_cache(self) -> int:
        """Drop every prefix-cache registration (pages return to the free
        list unless still shared with a running sequence).  Benchmarks
        call this after warmup so hits are earned, not inherited."""
        return self.scheduler.flush_prefix_cache()

    def stats(self) -> dict:
        """Legacy flat counter dict (perf reports, CI assertions) — now a
        view over the metrics registry; ``metrics_snapshot()`` is the
        full structured export."""
        self.telemetry.registry.collect()
        reg = self.telemetry.registry
        out = {k: reg.counter(k).value for k in (
            "preemptions", "cache_lookups", "cache_hits",
            "cache_hit_tokens", "cache_hit_pages", "cow_copies",
            "cache_evictions", "prefill_chunk_calls_saved")}
        out["cached_pages"] = self.scheduler.cached_pages
        return out

    def config_meta(self) -> dict:
        """Engine-side facts for the metrics snapshot ``meta`` block (the
        traceview attribution pass reconstructs cost models from these;
        the caller adds what only it knows — w_bits, dist)."""
        ec, cfg = self.ec, self.cfg
        meta = {
            "arch": cfg.name, "family": cfg.family,
            "cache_mode": ec.cache_mode, "kv_bits": ec.kv_bits,
            "a_bits": ec.a_bits,
            "page_size": ec.page_size, "max_slots": ec.max_slots,
            "max_len": ec.max_len, "prefill_batch": ec.prefill_batch,
            "prefix_cache": ec.prefix_cache,
            "prefill_chunk": ec.prefill_chunk,
            "bucket_decode": ec.bucket_decode,
            "telemetry": ec.telemetry,
        }
        if self.paged:
            meta["page_bytes"] = self.page_bytes
            meta["total_pages"] = self.scheduler.total_pages
            meta["token_kv_bytes"] = self.page_bytes // ec.page_size
        return meta

    def metrics_snapshot(self, meta: Optional[dict] = None) -> dict:
        """Stable JSON-serializable snapshot of every metric, gauges
        refreshed; ``meta`` is merged over ``config_meta()``."""
        m = self.config_meta()
        m.update(meta or {})
        return self.telemetry.snapshot(m)

    def chrome_trace(self) -> dict:
        """Chrome-trace/Perfetto JSON of the recorded spans."""
        return self.telemetry.tracer.to_chrome_trace()

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work

    @property
    def n_preemptions(self) -> int:
        return self.scheduler.n_preemptions

    @property
    def kv_utilization(self) -> float:
        """Mean fraction of held KV page rows holding valid tokens across
        the decode steps so far (paged mode; 0.0 before any step).

        Tokens are counted per sequence but pages are distinct physical
        pages, so with the prefix cache on this can exceed 1.0: shared
        pages serve several sequences' tokens from one set of rows —
        the over-commit is exactly the sharing win."""
        if not self._util_page_tokens:
            return 0.0
        return self._util_tokens / self._util_page_tokens

    # -- admission (batched prefill) ---------------------------------------

    def _admit(self, group: Seq[ScheduledSeq]) -> List[RequestOutput]:
        now = time.perf_counter()
        G, P = len(group), self.ec.prefill_batch
        bucket = group[0].bucket
        toks = np.zeros((P, bucket), np.int32)
        last = np.zeros((P,), np.int32)
        temps = np.zeros((P,), np.float32)
        topks = np.zeros((P,), np.int32)
        seeds = np.zeros((P,), np.int32)
        slots = np.zeros((P,), np.int32)
        prompts = [ss.seq.full_prompt for ss in group]
        for i, ss in enumerate(group):
            sp = ss.request.sampling
            n = prompts[i].size
            toks[i, :n] = prompts[i]
            last[i] = n - 1
            temps[i], topks[i], seeds[i] = sp.temperature, sp.top_k, sp.seed
            slots[i] = ss.slot
        if self.paged:
            # padded rows keep all-zero page tables: their KV scatters into
            # the reserved sink page, so the insert needs no masking
            rows = self.scheduler.page_table_rows(list(group), bucket)
            page_tables = np.zeros((P, rows.shape[1]), np.int32)
            page_tables[:G] = rows
        else:
            # pad rows beyond G with copies of row 0: identical KV written
            # to the same slot is a harmless repeat write
            for i in range(G, P):
                toks[i], last[i], slots[i] = toks[0], last[0], slots[0]

        tele = self.telemetry
        if tele.enabled:
            for ss in group:
                tele.observe(self._m_queue_wait,
                             now - (ss.request.arrival_time or now))
        first_tok, kv = self._prefill_step(toks, last, temps, topks, seeds)
        self._cache_insert(kv, page_tables if self.paged else slots)
        self.n_prefill_calls += 1
        self.n_prefill_tokens += int(sum(p.size for p in prompts[:G]))
        first_np = np.asarray(first_tok)

        finished: List[RequestOutput] = []
        t_first = time.perf_counter()
        if tele.enabled:
            tele.observe(self._m_prefill_call, t_first - now)
            tele.tracer.add_span("prefill", now, t_first,
                                 args={"batch": G, "bucket": bucket})
        for i, ss in enumerate(group):
            seq = ss.seq
            seq.admit_time = now
            if seq.first_token_time is None:
                seq.first_token_time = t_first
                self.n_prompt_tokens += int(seq.request.prompt.size)
                tele.observe(self._m_ttft,
                             t_first - (ss.request.arrival_time or t_first))
            seq.generated.append(int(first_np[i]))
            self._slots[ss.slot] = seq
            sp = ss.request.sampling
            self._positions[ss.slot] = prompts[i].size
            self._cur_tok[ss.slot] = first_np[i]
            self._temps[ss.slot] = sp.temperature
            self._topks[ss.slot] = sp.top_k
            self._seeds[ss.slot] = sp.seed
            done = self._finish_reason(ss.slot)
            if done:
                finished.append(self._complete(ss.slot, done))
        return finished

    # -- chunked prefill ---------------------------------------------------

    def _apply_cow(self) -> None:
        """Replay the scheduler's pending copy-on-write pairs on the
        device pool (src pages cloned onto fresh dst pages).  Batches are
        padded to a power of two with (0, 0) sink self-copies, so the
        copy sees few distinct shapes; dst pages are always freshly allocated, so no
        pair ever chains off another's destination."""
        if not self.paged:
            return
        copies = self.scheduler.take_cow_copies()
        if not copies:
            return
        n = 1
        while n < len(copies):
            n *= 2
        src = np.zeros((n,), np.int32)
        dst = np.zeros((n,), np.int32)
        for i, (s, d) in enumerate(copies):
            src[i], dst[i] = s, d
        if self.ec.checkify:
            self._check_inputs("engine.cow",
                               pages=self._t(np.concatenate([src, dst])))
        with self.telemetry.span("cow", n_copies=len(copies)), \
                self._range("engine.cow"):
            self._cache = kv_cache.clone_pages(self._cache, src, dst)

    def _advance_prefill_group(self, slots: List[int]) -> List[RequestOutput]:
        """Run one prompt chunk for a GROUP of mid-prefill sequences in a
        single batched ``prefill_chunk`` call (batch padded to a power of
        two; pad rows write only the sink page).  The final chunk of each
        sequence samples its first token (folded at the prompt's last
        position, exactly like whole prefill) and activates the slot.

        Coalescing is bit-exact vs one B=1 call per slot: rows' codes
        depend only on their own K/V, block tables are disjoint, and
        sample keys fold by (seed, position) — the
        ``prefill_chunk_calls_saved`` counter tallies the saved calls.
        """
        tele = self.telemetry
        t0 = tele.clock() if tele.enabled else 0.0
        # shared pages each chunk writes into must be copied first; a COW
        # preemption triggered by one slot can evict a peer from the group
        bounds: dict[int, tuple] = {}
        for slot in slots:
            if slot not in self._prefilling:
                continue
            seq = self._prefilling[slot]
            a = seq.prefill_progress
            b = min(a + self.chunk_tokens, seq.full_prompt.size)
            for vslot, vseq in self.scheduler.prepare_chunk_writes(
                    slot, a, b):
                tele.instant("preempt", track="requests",
                             tid=vseq.request.uid,
                             args={"by": seq.request.uid, "cause": "cow"})
                self._clear_slot(vslot)
            # apply per slot (not once for the group): a later prepare may
            # preempt an earlier slot and recycle its fresh COW dst pages,
            # so batching the pairs could alias two copies onto one dst
            self._apply_cow()
            bounds[slot] = (a, b)
        live = [s for s in slots if s in self._prefilling and s in bounds]
        if not live:
            return []
        G = len(live)
        Bp = 1                              # power-of-two batch bucket:
        while Bp < G:                       # few distinct shapes reach
            Bp *= 2                         # the kernels
        C = self.chunk_tokens
        page = self.ec.page_size
        tables_all = np.asarray(self.scheduler.block_tables)
        toks = np.zeros((Bp, C), np.int32)
        positions = np.zeros((Bp, C), np.int32)
        write_pages = np.zeros((Bp, C), np.int32)  # pad rows -> sink page 0
        write_rows = np.zeros((Bp, C), np.int32)
        tables = np.zeros((Bp, tables_all.shape[1]), np.int32)
        last_idx = np.zeros((Bp,), np.int32)
        last_pos = np.zeros((Bp,), np.int32)
        temps = np.zeros((Bp,), np.float32)
        topks = np.zeros((Bp,), np.int32)
        seeds = np.zeros((Bp,), np.int32)
        n_valid = 0
        for i, slot in enumerate(live):
            seq = self._prefilling[slot]
            prompt = seq.full_prompt
            a, b = bounds[slot]
            valid = b - a
            n_valid += valid
            toks[i, :valid] = prompt[a:b]
            positions[i] = a + np.arange(C)
            row = tables_all[slot]
            write_pages[i, :valid] = row[positions[i, :valid] // page]
            write_rows[i, :valid] = positions[i, :valid] % page
            tables[i] = row
            sp = seq.request.sampling
            last_idx[i] = valid - 1
            last_pos[i] = prompt.size - 1
            temps[i], topks[i], seeds[i] = (sp.temperature, sp.top_k,
                                            sp.seed)
        tok = self._chunk_step(toks, positions, write_pages, write_rows,
                               tables, last_idx, last_pos, temps, topks,
                               seeds)
        self.n_prefill_calls += 1
        self.n_prefill_tokens += n_valid
        if G > 1:
            self._m_chunk_saved.inc(G - 1)
        tok_np = np.asarray(tok)
        if tele.enabled:
            t1 = tele.clock()
            tele.observe(self._m_chunk_call, t1 - t0)
            tele.tracer.add_span("prefill_chunk", t0, t1,
                                 args={"batch": G, "tokens": n_valid})
            if self._slots:
                # decode was live while this chunk ran: interleaved
                # prefill work, the decode-stall currency
                self._m_tok_prefill_step.inc(n_valid)
        finished: List[RequestOutput] = []
        for i, slot in enumerate(live):
            seq = self._prefilling[slot]
            prompt = seq.full_prompt
            _, b = bounds[slot]
            seq.prefill_progress = b
            if b < prompt.size:
                continue
            # final chunk: publish the full prompt pages, activate the slot
            self.scheduler.on_prefill_complete(slot)
            seq.prefill_progress = None
            del self._prefilling[slot]
            first = int(tok_np[i])
            sp = seq.request.sampling
            if seq.first_token_time is None:
                seq.first_token_time = time.perf_counter()
                self.n_prompt_tokens += int(seq.request.prompt.size)
                tele.observe(self._m_ttft, seq.first_token_time
                             - (seq.request.arrival_time
                                or seq.first_token_time))
            seq.generated.append(first)
            self._slots[slot] = seq
            self._positions[slot] = prompt.size
            self._cur_tok[slot] = first
            self._temps[slot] = sp.temperature
            self._topks[slot] = sp.top_k
            self._seeds[slot] = sp.seed
            done = self._finish_reason(slot)
            if done:
                finished.append(self._complete(slot, done))
        return finished

    # -- decode ------------------------------------------------------------

    def _decode_active(self) -> List[RequestOutput]:
        tele = self.telemetry
        t0 = tele.clock() if tele.enabled else 0.0
        n_active = len(self._slots)
        row_of = None
        if self.paged:
            self._util_tokens += self.scheduler.tokens_in_use
            self._util_page_tokens += (self.scheduler.pages_in_use
                                       * self.ec.page_size)
            active = sorted(self._slots)
            Bb = self._decode_bucket(len(active))
            if self.ec.bucket_decode and active and Bb < self.ec.max_slots:
                # gather the active rows into the bucket; pad rows carry
                # zero block tables, so their scatter lands in the sink
                # page exactly like an inactive slot's in the full batch
                bt = np.asarray(self.scheduler.block_tables)
                rows = np.asarray(active, np.int32)
                toks = np.zeros(Bb, self._cur_tok.dtype)
                pos = np.zeros(Bb, self._positions.dtype)
                tabs = np.zeros((Bb, bt.shape[1]), bt.dtype)
                temps = np.zeros(Bb, self._temps.dtype)
                topks = np.zeros(Bb, self._topks.dtype)
                seeds = np.zeros(Bb, self._seeds.dtype)
                n = rows.size
                toks[:n] = self._cur_tok[rows]
                pos[:n] = self._positions[rows]
                tabs[:n] = bt[rows]
                temps[:n] = self._temps[rows]
                topks[:n] = self._topks[rows]
                seeds[:n] = self._seeds[rows]
                next_tok = self._decode_step(toks, pos, tabs, temps, topks,
                                             seeds)
                row_of = {slot: i for i, slot in enumerate(active)}
                self.n_bucketed_steps += 1
            else:
                block_tables = self.scheduler.block_tables
                if self._prefilling:
                    # mid-prefill slots are inactive in the decode step,
                    # but it still scatters their (zero) row-0 write —
                    # point those rows at the sink so real (possibly
                    # shared) pages are never touched
                    block_tables = block_tables.copy()
                    block_tables[list(self._prefilling)] = 0
                next_tok = self._decode_step(
                    self._cur_tok, self._positions, block_tables,
                    self._temps, self._topks, self._seeds)
        else:
            # every slot decodes; an inactive one writes row 0 of its own
            # region, which its next admission overwrites
            next_tok = self._decode_step(self._cur_tok, self._positions,
                                         None, self._temps, self._topks,
                                         self._seeds)
        self.n_decode_steps += 1
        next_np = np.asarray(next_tok)       # host sync: the step is done
        if tele.enabled:
            t1 = tele.clock()
            tele.observe(self._m_decode_step, t1 - t0)
            tele.observe(self._m_batch, n_active)
            self._m_tok_decode.inc(n_active)
            if self._last_decode_end is not None:
                # gap between consecutive sampled tokens — includes any
                # scheduling/COW/chunked-prefill work between the steps,
                # which is exactly what a waiting client experiences
                tele.observe(self._m_itl, t1 - self._last_decode_end)
            self._last_decode_end = t1
            tele.tracer.add_span("decode", t0, t1,
                                 args={"batch": n_active})
        finished: List[RequestOutput] = []
        for slot in list(self._slots):
            seq = self._slots[slot]
            tok = next_np[slot if row_of is None else row_of[slot]]
            seq.generated.append(int(tok))
            self._positions[slot] += 1
            self._cur_tok[slot] = tok
            done = self._finish_reason(slot)
            if done:
                finished.append(self._complete(slot, done))
        return finished

    def _decode_bucket(self, n_active: int) -> int:
        """Power-of-two decode batch bucket for an active-slot count:
        floor ``_DECODE_BUCKET_MIN``, cap ``max_slots``."""
        b = _DECODE_BUCKET_MIN
        while b < n_active:
            b *= 2
        return min(b, self.ec.max_slots)

    def _finish_reason(self, slot: int) -> Optional[str]:
        seq = self._slots[slot]
        sp = seq.request.sampling
        if sp.stop_token >= 0 and seq.generated[-1] == sp.stop_token:
            return "stop"
        if len(seq.generated) >= sp.max_new_tokens:
            return "length"
        if not self.paged and self._positions[slot] >= self.ec.max_len:
            return "evicted"       # slot region exhausted; terminal (legacy)
        return None

    def _clear_slot(self, slot: int) -> None:
        self._slots.pop(slot, None)
        self._prefilling.pop(slot, None)
        self._positions[slot] = 0
        self._cur_tok[slot] = 0
        self._temps[slot] = 0.0
        self._topks[slot] = 0
        self._seeds[slot] = 0

    def _complete(self, slot: int, reason: str) -> RequestOutput:
        seq = self._slots[slot]
        self.scheduler.complete(slot, evicted=(reason == "evicted"))
        self._clear_slot(slot)
        now = time.perf_counter()
        arrive = seq.request.arrival_time or seq.admit_time
        tele = self.telemetry
        if tele.enabled:
            tele.observe(self._m_e2e, now - arrive)
            tele.registry.counter(f"requests_finished_{reason}").inc()
            self._emit_lifecycle(seq, arrive, now, reason)
        return RequestOutput(
            uid=seq.request.uid, prompt=seq.request.prompt,
            token_ids=list(seq.generated), finish_reason=reason,
            ttft_s=(seq.first_token_time or now) - arrive,
            latency_s=now - arrive, n_preempts=seq.n_preempts)

    def _emit_lifecycle(self, seq: Sequence, arrive: float, finish: float,
                        reason: str) -> None:
        """Request-lifecycle spans on the ``requests`` track (tid = uid):
        queued [arrival, admit], prefill [admit, first token], decode
        [first token, finish].  Emitted whole at completion, so a ring
        eviction can only drop a whole request's lane, never half of
        one.  After preempt/resume, admit/first reflect the *last*
        admission; the preempt ``instant`` markers in between tell the
        story (args carry the round-trip count)."""
        tr = self.telemetry.tracer
        uid = seq.request.uid
        admit = min(max(seq.admit_time or arrive, arrive), finish)
        first = min(max(seq.first_token_time or finish, admit), finish)
        tr.add_span("queued", arrive, admit, track="requests", tid=uid,
                    args={"uid": uid})
        tr.add_span("prefill", admit, first, track="requests", tid=uid,
                    args={"prompt_tokens": int(seq.request.prompt.size),
                          "cache_hit_tokens": seq.cache_hit_tokens})
        tr.add_span("decode", first, finish, track="requests", tid=uid,
                    args={"new_tokens": len(seq.generated),
                          "n_preempts": seq.n_preempts,
                          "finish_reason": reason})

    # -- main loop ---------------------------------------------------------

    def step(self) -> List[RequestOutput]:
        """One engine iteration: admit every admissible prefill group
        (chunked mode only claims slots/pages — compute is spread over
        later steps), advance one prompt chunk per mid-prefill slot,
        grow/preempt/copy pages for the coming decode writes (paged
        mode), then advance all active slots one decode step."""
        tele = self.telemetry
        t_step = tele.clock() if tele.enabled else 0.0
        finished: List[RequestOutput] = []
        while True:
            group = self.scheduler.schedule()
            if not group:
                break
            if self.chunked:
                now = time.perf_counter()
                for ss in group:
                    tele.observe(self._m_queue_wait,
                                 now - (ss.request.arrival_time or now))
                    ss.seq.admit_time = now
                    ss.seq.prefill_progress = ss.seq.cache_hit_tokens
                    self._prefilling[ss.slot] = ss.seq
            else:
                finished.extend(self._admit(group))
        if self._prefilling:
            # one chunk for EVERY mid-prefill slot, oldest first: the
            # decode stall per step stays bounded by
            # n_prefilling * chunk_tokens (the chunk size is the policy
            # knob), while a whole admission wave advances together
            # instead of serializing one sequence per step
            order = sorted(self._prefilling,
                           key=lambda s: self._prefilling[s].order)
            if self.ec.coalesce_prefill:
                # ...and the whole wave shares ONE batched chunk call
                finished.extend(self._advance_prefill_group(order))
            else:
                for slot in order:
                    if slot in self._prefilling:  # not preempted by a peer
                        finished.extend(self._advance_prefill_group([slot]))
        if self.paged and self._slots:
            for slot, seq in self.scheduler.ensure_decode_pages(
                    writing=set(self._slots)):
                # sequence went back to the waiting queue with its tokens;
                # only the device-side slot state is dropped here
                tele.instant("preempt", track="requests",
                             tid=seq.request.uid,
                             args={"cause": "pool_exhausted"})
                self._clear_slot(slot)
            self._apply_cow()
        if self._slots:
            finished.extend(self._decode_active())
        else:
            # no decode ran: the next sampled token's gap is not an
            # inter-token latency (the stream was idle or pure-prefill)
            self._last_decode_end = None
        if tele.enabled:
            tele.tracer.add_span(
                "step", t_step, tele.clock(),
                args={"running": len(self._slots),
                      "prefilling": len(self._prefilling),
                      "waiting": self.scheduler.n_waiting})
        return finished

    def generate(self, requests: Seq[Request]) -> List[RequestOutput]:
        """Closed-set convenience: run a request list to completion."""
        for r in requests:
            self.submit(r)
        out: List[RequestOutput] = []
        while self.has_work:
            out.extend(self.step())
        return sorted(out, key=lambda o: o.uid)
