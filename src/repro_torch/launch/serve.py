"""Serving CLI: batched generation and the continuous-batching engine
under a request stream, with UNIQ-quantized weights, on the GPU (or, on
request, the CPU).

Closed batch (``serve.generate`` over the family's decode cache):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_8b \
        --w-bits 4 --batch 4 --prompt-len 16 --new-tokens 32

draws dense weights from --seed, generates greedily with them and with
their k-quantile-coded copy (--w-bits, --w-dist; --a-bits fake-quantizes
each layer's output), and reports tok/s of the host loop and the greedy
agreement of the coded model with the dense one.

Continuous-batching engine:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_8b \
        --engine --w-bits 4 --kv-bits 8 --requests 16 --rate 8 \
        --max-slots 16 --max-len 2048 --prompt-len 256 --new-tokens 32

drives a synthetic Poisson request stream and reports tokens/s,
time-to-first-token, inter-token latency, slot occupancy, preemptions and
effective KV utilization.  ``--smoke --device cpu`` runs the tiny variant of
the architecture on the CPU.  ``--arch`` takes every architecture of the
registry: dense (granite_3_8b, gemma2_9b, yi_6b, stablelm_12b) and moe
(kimi_k2_1t_a32b, llama4_maverick_400b_a17b) in both modes; ssm
(mamba2_1_3b), hybrid (zamba2_2_7b), audio (whisper_base) and vlm
(pixtral_12b) in the closed batch only (their decode caches are not the
engine's KV pool: --engine raises ValueError, as in the reference).  As in
the reference, the closed batch of ssm and hybrid applies no --a-bits
fake-quant in its decode steps, whisper's none at all (and never runs its
encoder: the cross-attention reads zero K/V), and pixtral's sees no patch
embeddings (the decode steps are the dense decoder's).

The KV cache is paged by default (--cache-mode paged): sequences grow page
by page out of a shared pool (--total-pages or a --pool-bytes byte budget)
and are preempted+resumed when it runs dry. --cache-mode slot keeps the
legacy fixed-region kv16 cache (one --max-len region per slot; a sequence
that fills it finishes "evicted") for A/B comparison. --kv-bits 8/4 stores
the pages as k-quantile codes + per-row stats (half / ~a third of the bytes,
so a byte budget admits proportionally more sequences); --total-pages small
enough forces preemption (--min-preemptions asserts it happened).

--prefix-cache turns on codes-domain prefix caching with chunked prefill:
admission attaches pool pages that already hold a prompt's prefix instead
of re-prefilling them, with copy-on-write on divergence.  --prefill-chunk N
prefills prompts N pages at a time interleaved with decode.
--shared-prefix S prepends one fixed S-token system prompt to every request
so the stream actually shares prefixes; --min-cache-hit-pages /
--min-cow-copies assert the hit and COW paths ran.  Every stream quantity —
prompt tokens, lengths, arrivals AND per-request sampling seeds — derives
from the single --seed, so a run is replayable end to end.

Weights are random, made from --seed on the device, and k-quantile-coded
to --w-bits one layer at a time: analytic Gaussian levels, or with
--w-dist empirical per-tensor empirical quantiles and their codebook
(served through the qmatmul_lut kernel).  --a-bits 8 serves every
quantized matmul on per-token int8 activation codes (qmatmul_a8).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import base as cb
from repro_torch.devices import resolve_device
from repro_torch.models import model
from repro_torch.models.lm import ModelOpts
from repro_torch.serve import serve as serve_lib
from repro_torch.serve import telemetry as tele_lib
from repro_torch.serve.engine import (Engine, EngineConfig, Request,
                                      SamplingParams)
from repro_torch.serve.scheduler import bucket_len


def _percentile(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else 0.0


def run_engine_stream(params, cfg, opts, args, device="cuda") -> dict:
    """Drive the engine with a Poisson arrival stream (rate req/s).

    Requests are submitted when their arrival time passes on the wall
    clock, so TTFT includes genuine queueing delay under load.
    """
    rng = np.random.default_rng(args.seed)
    n = args.requests
    sys_prompt = rng.integers(0, cfg.vocab, size=args.shared_prefix,
                              dtype=np.int64).astype(np.int32)
    lens = rng.integers(max(2, args.prompt_len // 2), args.prompt_len + 1,
                        size=n)
    arrivals = np.cumsum(rng.exponential(1.0 / args.rate, size=n))
    # per-request sampling seeds derive from --seed too: the whole stream
    # (prompts, lengths, arrivals, sample paths) replays from one number
    seeds = rng.integers(0, 2 ** 31 - 1, size=n)
    reqs = [Request(uid=i,
                    prompt=np.concatenate([
                        sys_prompt,
                        rng.integers(0, cfg.vocab, size=int(lens[i]),
                                     dtype=np.int64).astype(np.int32)]),
                    sampling=SamplingParams(
                        temperature=args.temperature,
                        max_new_tokens=args.new_tokens,
                        seed=int(seeds[i])))
            for i in range(n)]

    ec = EngineConfig(max_slots=args.max_slots, max_len=args.max_len,
                      prefill_batch=args.prefill_batch,
                      cache_mode=args.cache_mode, page_size=args.page_size,
                      total_pages=args.total_pages, kv_bits=args.kv_bits,
                      a_bits=args.a_bits,
                      pool_bytes=args.pool_bytes,
                      prefix_cache=args.prefix_cache,
                      prefill_chunk=args.prefill_chunk,
                      checkify=args.checkify,
                      telemetry=not args.no_telemetry,
                      profile_annotations=args.profile_annotations)
    if args.checkify:
        print("[engine] checkify ON (index and NaN checks around every "
              "device step; debug mode: two host syncs a step)")
    eng = Engine(params, cfg, opts, ec, device=device)
    if args.cache_mode == "paged":
        sch = eng.scheduler
        print(f"[engine] paged KV pool: {sch.total_pages} pages x "
              f"{args.page_size} tokens at kv_bits={args.kv_bits} "
              f"({eng.page_bytes} B/page, "
              f"{sch.pool_bytes_total / 1024:.1f} KiB total)")

    # warm the engine outside the timed region: builds the kernels and
    # runs the decode shape and every prefill bucket this request set hits
    seen = set()
    for r in reqs:
        b = min(bucket_len(r.prompt.size, ec.min_bucket), ec.max_len)
        if b not in seen:
            seen.add(b)
            eng.generate([Request(uid=-1 - len(seen), prompt=r.prompt.copy(),
                                  sampling=SamplingParams(max_new_tokens=2))])
    # warmup prompts must not pre-seed the prefix cache: hits below are
    # earned by the stream itself, not inherited from the warmup
    eng.flush_prefix_cache()
    eng.reset_stats()

    outs = []
    occupancy = []
    t0 = time.perf_counter()
    next_i = 0
    while next_i < n or eng.has_work:
        now = time.perf_counter() - t0
        while next_i < n and arrivals[next_i] <= now:
            reqs[next_i].arrival_time = t0 + arrivals[next_i]
            eng.submit(reqs[next_i])
            next_i += 1
        if not eng.has_work:
            time.sleep(min(1e-3, max(0.0, arrivals[next_i] - now)))
            continue
        outs.extend(eng.step())
        occupancy.append(eng.scheduler.n_running)
    wall = time.perf_counter() - t0

    new_tokens = sum(len(o.token_ids) for o in outs)
    ttfts = [o.ttft_s for o in outs]
    lats = [o.latency_s for o in outs]
    stats = {
        "requests": len(outs),
        "new_tokens": new_tokens,
        "prompt_tokens": eng.n_prompt_tokens,
        "prefill_tokens": eng.n_prefill_tokens,  # > prompt on resumes
        "wall_s": wall,
        "tok_per_s": new_tokens / max(wall, 1e-9),
        "ttft_mean_s": float(np.mean(ttfts)) if ttfts else 0.0,
        "ttft_p50_s": _percentile(ttfts, 50),
        "ttft_p95_s": _percentile(ttfts, 95),
        "ttft_p99_s": _percentile(ttfts, 99),
        "latency_p50_s": _percentile(lats, 50),
        "decode_steps": eng.n_decode_steps,
        "prefill_calls": eng.n_prefill_calls,
        "mean_occupancy": float(np.mean(occupancy)) if occupancy else 0.0,
        "evicted": eng.scheduler.n_evicted,
        "preemptions": eng.n_preemptions,
        "kv_utilization": eng.kv_utilization,
        **eng.stats(),
    }
    print(f"[engine] {stats['requests']} requests "
          f"({stats['prompt_tokens']} prompt + {new_tokens} new tokens) "
          f"in {wall:.2f}s -> {stats['tok_per_s']:.1f} new tok/s")
    print(f"[engine] TTFT mean {stats['ttft_mean_s'] * 1e3:.0f}ms "
          f"p50 {stats['ttft_p50_s'] * 1e3:.0f}ms "
          f"p95 {stats['ttft_p95_s'] * 1e3:.0f}ms; "
          f"latency p50 {stats['latency_p50_s'] * 1e3:.0f}ms")
    print(f"[engine] {stats['decode_steps']} decode steps, "
          f"{stats['prefill_calls']} prefill calls, mean occupancy "
          f"{stats['mean_occupancy']:.2f}/{args.max_slots} slots, "
          f"{stats['evicted']} evicted")
    if args.cache_mode == "paged":
        print(f"[engine] paged KV: {stats['preemptions']} preemptions, "
              f"effective utilization "
              f"{stats['kv_utilization'] * 100:.1f}% of held page rows")
        resumed = [o for o in outs if o.n_preempts > 0]
        if resumed:
            print(f"[engine] {len(resumed)} requests survived "
                  f"preempt/resume and completed")
        assert not any(o.finish_reason == "evicted" for o in outs), \
            "paged mode must never evict terminally"
    if args.prefix_cache:
        hit_rate = stats["cache_hits"] / max(stats["cache_lookups"], 1)
        print(f"[engine] prefix cache: {stats['cache_hits']}/"
              f"{stats['cache_lookups']} admissions hit "
              f"({hit_rate * 100:.0f}%), {stats['cache_hit_pages']} pages "
              f"attached ({stats['cache_hit_tokens']} tokens), "
              f"{stats['cow_copies']} copy-on-writes, "
              f"{stats['cache_evictions']} LRU evictions, "
              f"{stats['cached_pages']} pages cached at end")
    if args.min_cache_hit_pages and \
            stats["cache_hit_pages"] < args.min_cache_hit_pages:
        raise SystemExit(
            f"expected >= {args.min_cache_hit_pages} cache-hit pages, saw "
            f"{stats['cache_hit_pages']} — prefix-cache hit path not "
            f"exercised")
    if args.min_cow_copies and stats["cow_copies"] < args.min_cow_copies:
        raise SystemExit(
            f"expected >= {args.min_cow_copies} copy-on-writes, saw "
            f"{stats['cow_copies']} — COW divergence path not exercised")
    if args.min_preemptions and stats["preemptions"] < args.min_preemptions:
        raise SystemExit(
            f"expected >= {args.min_preemptions} preemptions, saw "
            f"{stats['preemptions']} — scheduler preempt path not exercised")
    if stats["requests"] != eng.scheduler.n_submitted:
        raise SystemExit(
            f"lost requests: {eng.scheduler.n_submitted} submitted, "
            f"{stats['requests']} completed")

    # -- telemetry exports (the traceview/CI consumables) -------------------
    if eng.telemetry.enabled:
        reg = eng.telemetry.registry
        itl = tele_lib.percentile_summary(reg["itl_s"], scale=1e3)
        qw = tele_lib.percentile_summary(reg["queue_wait_s"], scale=1e3)
        print(f"[engine] ITL p50 {itl['p50']:.1f}ms p95 {itl['p95']:.1f}ms "
              f"p99 {itl['p99']:.1f}ms; queue wait p50 {qw['p50']:.1f}ms "
              f"p95 {qw['p95']:.1f}ms")
        stats.update({f"itl_{k}_ms": v for k, v in itl.items()})
        stats.update({f"queue_wait_{k}_ms": v for k, v in qw.items()})
    if args.metrics_out or args.trace_out:
        # the CLI knows what the engine doesn't: quantizer + workload
        meta = {"w_bits": args.w_bits, "a_bits": args.a_bits,
                "dist": args.w_dist, "smoke": args.smoke,
                "rate": args.rate, "requests": args.requests,
                "shared_prefix": args.shared_prefix}
        if args.metrics_out:
            snap = eng.metrics_snapshot(meta)
            with open(args.metrics_out, "w") as fh:
                json.dump(snap, fh, indent=2, sort_keys=True)
            with open(args.metrics_out + ".prom", "w") as fh:
                fh.write(eng.telemetry.registry.to_prometheus())
            print(f"[engine] metrics snapshot -> {args.metrics_out} "
                  f"(+ .prom exposition)")
        if args.trace_out:
            trace = eng.chrome_trace()
            with open(args.trace_out, "w") as fh:
                json.dump(trace, fh)
            print(f"[engine] chrome trace -> {args.trace_out} "
                  f"({len(trace['traceEvents'])} events; load in "
                  f"chrome://tracing or ui.perfetto.dev)")
    return stats


def _timed_generate(params, cfg, opts, sc, prompts, args, device):
    """``serve.generate`` and its host-loop seconds (to a device sync)."""
    t0 = time.perf_counter()
    out = serve_lib.generate(params, cfg, opts, sc, prompts,
                             args.new_tokens, seed=args.seed,
                             check_finite=args.debug_nans)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def run_closed_batch(params, cfg, opts, args, device="cuda") -> dict:
    """Generate greedily for ``--batch`` prompts of ``--prompt-len`` tokens
    (drawn from --seed) with the dense params, then with their coded copy
    (``prepare_params`` at --w-bits / --w-dist, ``make_serve_opts`` with
    --a-bits); print tok/s of each host loop, the coded model's greedy
    agreement with the dense one, a sample and the compute dtype."""
    device = torch.device(device)
    gen = torch.Generator().manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen).to(device)
    sc = serve_lib.ServeConfig(w_bits=args.w_bits, a_bits=args.a_bits,
                               w_dist=args.w_dist)
    out_fp, dt_fp = _timed_generate(params, cfg, opts, sc, prompts, args,
                                    device)
    t0 = time.perf_counter()
    params_q = serve_lib.prepare_params(params, sc, device=device)
    prepare_s = time.perf_counter() - t0
    sopts = serve_lib.make_serve_opts(opts, sc)
    out_q, dt = _timed_generate(params_q, cfg, sopts, sc, prompts, args,
                                device) if args.w_bits < 16 \
        else (out_fp, dt_fp)
    match = float((out_fp == out_q).to(torch.float32).mean())
    n_tok = args.batch * args.new_tokens
    dtype = str(opts.compute_dtype).replace("torch.", "")
    print(f"[serve] {n_tok} tokens in {dt:.2f}s ({n_tok / max(dt, 1e-9):.1f} "
          f"tok/s host-loop; dense {n_tok / max(dt_fp, 1e-9):.1f} tok/s); "
          f"weights coded in {prepare_s:.2f}s; compute {dtype}")
    print(f"[serve] W{args.w_bits} ({args.w_dist}, a_bits {args.a_bits}) "
          f"greedy agreement with the dense {dtype} model: "
          f"{match * 100:.1f}%")
    print("sample (quantized):", out_q[0][:16].tolist())
    return {"tokens": out_q, "dense_tokens": out_fp, "agreement": match,
            "tok_per_s": n_tok / max(dt, 1e-9),
            "dense_tok_per_s": n_tok / max(dt_fp, 1e-9),
            "prepare_s": prepare_s, "compute_dtype": dtype}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True, choices=cb.ARCH_IDS,
                   help="a registered architecture; dense and moe serve "
                        "in both modes, ssm (mamba2), hybrid (zamba2), audio "
                        "(whisper) and vlm (pixtral) in the closed batch "
                        "only (--engine raises ValueError)")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--w-bits", type=int, default=4)
    p.add_argument("--w-dist", choices=("gaussian", "empirical"),
                   default="gaussian",
                   help="weight dequant levels: analytic Gaussian or the "
                        "empirical per-tensor codebook (LUT) — match the "
                        "checkpoint's training cfg.dist")
    p.add_argument("--a-bits", type=int, default=32,
                   help="activation bit-width: the closed batch applies "
                        "layer-output fake-quant; --engine mode serves a "
                        "real per-token int8 codec (2..8) on every quantized "
                        "matmul (prefill + decode, the qmatmul_a8 kernel) "
                        "and reports it in the metrics meta; 32 = off")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--new-tokens", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    # engine mode
    p.add_argument("--engine", action="store_true",
                   help="continuous-batching engine + Poisson stream")
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--rate", type=float, default=8.0,
                   help="Poisson arrival rate (requests/s)")
    p.add_argument("--max-slots", type=int, default=8)
    p.add_argument("--max-len", type=int, default=256,
                   help="per-sequence KV capacity (prompt + generation)")
    p.add_argument("--prefill-batch", type=int, default=4)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--cache-mode", choices=("paged", "slot"),
                   default="paged")
    p.add_argument("--page-size", type=int, default=64,
                   help="KV page size in tokens (paged mode)")
    p.add_argument("--total-pages", type=int, default=None,
                   help="KV pool size; default lets every slot reach "
                        "--max-len; smaller values force preemption/resume")
    p.add_argument("--kv-bits", type=int, default=16, choices=(16, 8, 4),
                   help="KV page bit-width: 8/4 store k-quantile codes + "
                        "per-row stats (paged mode only)")
    p.add_argument("--pool-bytes", type=int, default=None,
                   help="KV pool byte budget (alternative to "
                        "--total-pages): pages = pool_bytes // page bytes "
                        "at the chosen --kv-bits")
    p.add_argument("--prefix-cache", action="store_true",
                   help="codes-domain prefix caching over pool pages "
                        "(implies chunked prefill; paged mode only)")
    p.add_argument("--prefill-chunk", type=int, default=None,
                   help="prefill chunk size in pages: prompts prefill "
                        "chunk by chunk interleaved with decode (paged "
                        "mode; default 1 when --prefix-cache is on)")
    p.add_argument("--shared-prefix", type=int, default=0,
                   help="prepend one fixed system prompt of this many "
                        "tokens to every request (prefix-cache workload)")
    p.add_argument("--min-preemptions", type=int, default=0,
                   help="fail unless at least this many preemptions "
                        "happened (CI smoke of the preempt/resume path)")
    p.add_argument("--min-cache-hit-pages", type=int, default=0,
                   help="fail unless at least this many prefix-cache "
                        "pages were attached (CI smoke of the hit path)")
    p.add_argument("--min-cow-copies", type=int, default=0,
                   help="fail unless at least this many copy-on-writes "
                        "happened (CI smoke of the divergence path)")
    # observability (serve/telemetry.py)
    p.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="write the metrics snapshot JSON here (plus the "
                        "Prometheus text exposition at PATH.prom)")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="write the Chrome-trace JSON of the run here "
                        "(open in chrome://tracing / ui.perfetto.dev)")
    p.add_argument("--no-telemetry", action="store_true",
                   help="disable metrics + tracing (A/B the overhead; "
                        "token streams are bit-identical either way)")
    p.add_argument("--profile-annotations", action="store_true",
                   help="wrap the engine's device steps in "
                        "torch.profiler.record_function ranges (names show "
                        "up in traces captured by torch.profiler)")
    # opt-in debug sanitizers (both OFF by default)
    p.add_argument("--checkify", action="store_true",
                   help="check the engine's indices before every device "
                        "step and its logits after it (RuntimeError at the "
                        "offending step; debug runs, a host sync each)")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise at the first non-finite logits: eager "
                        "PyTorch has no jax_debug_nans, so this turns on "
                        "the per-step finite-logits check (--checkify's) in "
                        "the engine and after every step of the closed "
                        "batch; debug runs only")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the model runs; cuda raises when there is "
                        "no card (no silent CPU run)")
    p.add_argument("--compute-dtype", choices=("bfloat16", "float32"),
                   default=None,
                   help="activation dtype; default bfloat16 on cuda, "
                        "float32 on cpu")
    args = p.parse_args(argv)

    if (args.metrics_out or args.trace_out) and not args.engine:
        p.error("--metrics-out/--trace-out require --engine")
    if (args.metrics_out or args.trace_out) and args.no_telemetry:
        p.error("--metrics-out/--trace-out need telemetry enabled "
                "(drop --no-telemetry)")

    device = resolve_device(args.device)
    dtype_name = args.compute_dtype or (
        "bfloat16" if device.type == "cuda" else "float32")
    compute_dtype = getattr(torch, dtype_name)
    cfg = cb.get_smoke(args.arch) if args.smoke else cb.get(args.arch)
    # the reference CLI never switches to chunked attention: a long prompt
    # is served with full attention
    opts = ModelOpts(compute_dtype=compute_dtype,
                     attn_chunked_min_len=1 << 30)
    if args.debug_nans:
        args.checkify = True
    if not args.engine:
        if cfg.family == "audio" and args.a_bits < 32:
            print(f"[serve] --a-bits {args.a_bits} leaves {cfg.name} "
                  f"unchanged: the encoder-decoder applies no activation "
                  f"fake-quant, as in the reference")
        # dense weights, as the reference draws them (it codes them in
        # run_closed_batch), in the compute dtype
        params = model.init(args.seed, cfg, device=device,
                            dense_dtype=compute_dtype)
        return run_closed_batch(params, cfg, opts, args, device=device)
    # engine mode routes --a-bits through EngineConfig; ServeConfig stays
    # at a_bits=32 so activation quantization is never applied twice
    sc = serve_lib.ServeConfig(w_bits=args.w_bits, a_bits=32,
                               w_dist=args.w_dist)
    # weights are drawn and coded (Gaussian levels or an empirical
    # codebook) one layer at a time on the device: a full-width model never
    # holds a dense stacked leaf
    params = model.init(args.seed, cfg, device=device, w_bits=sc.w_bits,
                        dense_dtype=compute_dtype, w_dist=sc.w_dist)
    opts = serve_lib.make_serve_opts(opts, sc)
    return run_engine_stream(params, cfg, opts, args, device=device)


if __name__ == "__main__":
    main()
