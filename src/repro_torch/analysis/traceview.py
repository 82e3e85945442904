"""Trace / metrics viewers and achieved-vs-theoretical cost attribution.

Consumes the two artifacts the port's serving engine exports
(``serve/telemetry.py`` via ``launch/serve.py --metrics-out/--trace-out``):

  * the **metrics snapshot** (JSON): counters / gauges / histograms plus a
    ``meta`` block carrying the engine and quantizer facts (arch, w_bits,
    a_bits, kv_bits, dist, page geometry);
  * the **Chrome trace** (JSON): per-request lifecycle and per-step engine
    spans, loadable in chrome://tracing or ui.perfetto.dev.

Three jobs:

  1. ``validate_chrome_trace``: every duration-event lane monotonic in ts
     with matched B/E pairs (a malformed trace loads as a blank page in the
     viewer, which is worse than an error).
  2. ``require_nonzero``: named counters / histograms actually recorded
     (the smoke contract that telemetry stays wired in).
  3. ``attribution``: the paper's cost model (``core/bops.py``, Sec. 4.2)
     against the *measured* phase times: achieved BOPs/s and weight / KV
     bytes/s at prefill and decode beside the theoretical per-token
     numbers, so a W4-vs-W16 or kv4-vs-kv8 gap splits into weight traffic,
     KV traffic and dequant work.

CLI (exit 1 on any validation problem):

    PYTHONPATH=src python -m repro_torch.analysis.traceview \
        --metrics metrics.json --trace trace.json \
        --require-nonzero decode_steps,tokens_decoded,ttft_s \
        --format text
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple

from repro_torch.configs import base as cb
from repro_torch.core import bops
from repro_torch.models import kv_cache

__all__ = ["validate_chrome_trace", "trace_summary", "require_nonzero",
           "attribution", "format_attribution", "main"]

_DUR_PH = ("B", "E")
_KNOWN_PH = ("B", "E", "X", "i", "I", "M")


# --------------------------------------------------------------------------
# Chrome-trace validation
# --------------------------------------------------------------------------

def validate_chrome_trace(trace: Dict) -> List[str]:
    """Schema problems in a Chrome-trace dict ([] = loads cleanly).

    Checks the properties chrome://tracing actually cares about: every
    non-metadata event has a numeric non-negative ``ts`` and integer
    pid/tid; within each (pid, tid) lane the duration events are
    non-decreasing in ts and form a properly nested B/E stack (no E
    without a B, no B left open, no negative-duration span).
    """
    problems: List[str] = []
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    stacks: Dict[Tuple, List[Tuple[str, float]]] = {}
    last_ts: Dict[Tuple, float] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _KNOWN_PH:
            problems.append(f"event {i}: unknown ph {ph!r}")
            continue
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i}: bad ts {ts!r}")
            continue
        if not isinstance(ev.get("pid"), int) \
                or not isinstance(ev.get("tid"), int):
            problems.append(f"event {i}: pid/tid missing or non-integer")
            continue
        lane = (ev["pid"], ev["tid"])
        if ph not in _DUR_PH:
            continue
        if ts < last_ts.get(lane, 0.0):
            problems.append(f"event {i}: ts {ts} goes backwards in "
                            f"lane {lane}")
        last_ts[lane] = ts
        stack = stacks.setdefault(lane, [])
        if ph == "B":
            if not ev.get("name"):
                problems.append(f"event {i}: B event without a name")
            stack.append((ev.get("name", "?"), ts))
        else:
            if not stack:
                problems.append(f"event {i}: E with no open B in "
                                f"lane {lane}")
            else:
                name, begin_ts = stack.pop()
                if ts < begin_ts:
                    problems.append(f"event {i}: span {name!r} ends "
                                    f"before it begins ({ts} < {begin_ts})")
    for lane, stack in sorted(stacks.items()):
        if stack:
            names = ", ".join(n for n, _ in stack)
            problems.append(f"lane {lane}: {len(stack)} unmatched B "
                            f"event(s): {names}")
    return problems


def trace_summary(trace: Dict) -> Dict:
    """Event counts by name/phase plus the trace's wall extent."""
    by_name: Dict[str, int] = {}
    lanes = set()
    n_dur = n_inst = 0
    lo, hi = None, 0.0
    for ev in trace.get("traceEvents", []):
        ph = ev.get("ph")
        if ph == "M":
            continue
        lanes.add((ev.get("pid"), ev.get("tid")))
        ts = ev.get("ts", 0)
        lo = ts if lo is None else min(lo, ts)
        hi = max(hi, ts)
        if ph == "B":
            n_dur += 1
            by_name[ev.get("name", "?")] = by_name.get(
                ev.get("name", "?"), 0) + 1
        elif ph in ("i", "I"):
            n_inst += 1
            by_name[ev.get("name", "?")] = by_name.get(
                ev.get("name", "?"), 0) + 1
    return {"spans": n_dur, "instants": n_inst, "lanes": len(lanes),
            "wall_ms": round((hi - (lo or 0.0)) / 1e3, 3),
            "by_name": dict(sorted(by_name.items())),
            "dropped": trace.get("otherData", {}).get("dropped_events", 0)}


# --------------------------------------------------------------------------
# Metrics assertions
# --------------------------------------------------------------------------

def require_nonzero(metrics: Dict, names: List[str]) -> List[str]:
    """Problems for every named metric that is missing or zero.

    A name matches a counter (value > 0) or a histogram (count > 0) —
    the smoke-test contract that the engine actually recorded traffic.
    """
    problems: List[str] = []
    counters = metrics.get("counters", {})
    hists = metrics.get("histograms", {})
    for name in names:
        if name in counters:
            if counters[name] <= 0:
                problems.append(f"counter {name} is zero")
        elif name in hists:
            if hists[name].get("count", 0) <= 0:
                problems.append(f"histogram {name} recorded nothing")
        else:
            problems.append(f"metric {name} not in snapshot")
    return problems


# --------------------------------------------------------------------------
# Cost attribution (paper Sec. 4.2 against measured phase timings)
# --------------------------------------------------------------------------

# per-element dequant work by code family: how codes become weights on the
# way from HBM into the tensor cores (the port's kernels/qmatmul.py bodies)
DEQUANT_FAMILIES = (
    {"family": "gaussian", "ops_per_elem": 1.0, "unit": "lut_lookups",
     "note": "mu + sigma*Phi^-1((c+1/2)/k): the k-entry level table built "
             "once a launch, one register-table lookup a code "
             "(qmatmul_wg_kernel)"},
    {"family": "empirical", "ops_per_elem": 1.0, "unit": "lut_gathers",
     "note": "codebook[c] gather from a 2^b-entry per-channel LUT "
             "(qmatmul_lut)"},
    {"family": "apot", "ops_per_elem": 2.0, "unit": "shift_adds",
     "note": "planned: additive powers-of-two (1909.13144), "
             "multiplier-free shift/add dequant"},
)


def _token_kv_bytes(meta: Dict, cfg) -> Tuple[Optional[int], Optional[int]]:
    """(quantized, dense-kv16) per-token KV bytes across all layers: the
    engine-exact value of the snapshot meta where it has one, else the
    models-layer formula."""
    got = meta.get("token_kv_bytes")
    dense = kv_cache.token_kv_bytes(cfg, 16)
    return (got if got is not None
            else kv_cache.token_kv_bytes(cfg, meta.get("kv_bits", 16)),
            dense)


def attribution(metrics: Dict) -> Dict:
    """Achieved vs theoretical cost per phase from a metrics snapshot.

    Requires ``meta.arch`` (and honors ``meta.smoke``, default True) to
    rebuild the ArchConfig the run used; w_bits/a_bits/kv_bits/dist in
    meta select the cost model.  Returns {meta, theory, phases, dequant}.
    """
    meta = metrics.get("meta", {})
    arch = meta.get("arch")
    if not arch:
        raise ValueError("metrics meta has no 'arch' — snapshot not "
                         "produced by Engine.metrics_snapshot()?")
    # config_meta stores cfg.name, which is "<arch>_smoke" for smoke
    # configs; registry keys are the full-config names
    is_smoke = arch.endswith("_smoke")
    base = arch[:-len("_smoke")] if is_smoke else arch
    is_smoke = bool(meta.get("smoke", is_smoke))
    cfg = cb.get_smoke(base) if is_smoke else cb.get(base)
    w_bits = int(meta.get("w_bits", 16))
    a_bits = int(meta.get("a_bits", 32))
    b_w, b_a = min(w_bits, 16), min(a_bits, 16)
    mb = bops.lm_bops(cfg, b_w, b_a)
    mb16 = bops.lm_bops(cfg, 16, 16)
    weight_bytes = mb.model_size_bits / 8.0
    n_weight_elems = sum(l.n_params for l in mb.layers)
    kv_tok_bytes, kv_tok_bytes_dense = _token_kv_bytes(meta, cfg)

    c = metrics.get("counters", {})
    h = metrics.get("histograms", {})

    def hsum(name):
        return float(h.get(name, {}).get("sum", 0.0))

    def hcount(name):
        return int(h.get(name, {}).get("count", 0))

    phases = []
    # (phase, wall seconds, tokens produced, full weight passes)
    specs = (
        ("prefill", hsum("prefill_call_s") + hsum("prefill_chunk_s"),
         int(c.get("prefill_tokens", 0)),
         hcount("prefill_call_s") + hcount("prefill_chunk_s")),
        ("decode", hsum("decode_step_s"), int(c.get("tokens_decoded", 0)),
         hcount("decode_step_s")),
    )
    for phase, t, tokens, passes in specs:
        if t <= 0.0 or tokens <= 0:
            continue
        tok_s = tokens / t
        row = {
            "phase": phase, "time_s": round(t, 4), "tokens": tokens,
            "weight_passes": passes, "tok_s": round(tok_s, 1),
            # achieved = theoretical per-token cost x measured rate
            "achieved_gbops_s": round(mb.total_bops * tok_s / 1e9, 4),
            # each pass streams every (quantized) weight byte from HBM
            "weight_rd_gb_s": round(weight_bytes * passes / t / 1e9, 6),
        }
        if kv_tok_bytes:
            # every produced token writes its KV row across all layers
            row["kv_wr_gb_s"] = round(tokens * kv_tok_bytes / t / 1e9, 6)
            if phase == "decode" and c.get("kv_rows_attended"):
                # paged decode gathers kv_rows_attended full rows/step-sum
                row["kv_rd_gb_s"] = round(
                    c["kv_rows_attended"] * kv_tok_bytes / t / 1e9, 6)
        row["hbm_rd_wr_gb_s"] = round(
            row["weight_rd_gb_s"] + row.get("kv_rd_gb_s", 0.0)
            + row.get("kv_wr_gb_s", 0.0), 6)
        phases.append(row)

    dist = meta.get("dist", meta.get("w_dist", "gaussian"))
    dequant = []
    decode = next((p for p in phases if p["phase"] == "decode"), None)
    for fam in DEQUANT_FAMILIES:
        entry = dict(fam)
        entry["active"] = (w_bits < 16 and fam["family"] == dist)
        if decode and entry["active"]:
            # every weight element is decoded once per pass
            entry["achieved_gops_s"] = round(
                n_weight_elems * fam["ops_per_elem"]
                * decode["weight_passes"] / decode["time_s"] / 1e9, 2)
        dequant.append(entry)

    theory = {
        "arch": arch, "w_bits": w_bits, "a_bits": a_bits,
        "kv_bits": int(meta.get("kv_bits", 16)), "dist": dist,
        "bops_per_token_g": round(mb.total_bops / 1e9, 3),
        "bops_per_token_g_w16": round(mb16.total_bops / 1e9, 3),
        "weight_bytes_mb": round(weight_bytes / 1e6, 2),
        "weight_bytes_mb_16": round(mb16.model_size_bits / 8 / 1e6, 2),
        "token_kv_bytes": kv_tok_bytes,
        "token_kv_bytes_dense16": kv_tok_bytes_dense,
    }
    return {"meta": meta, "theory": theory, "phases": phases,
            "dequant": dequant}


def format_attribution(att: Dict) -> str:
    """Human-readable table of an ``attribution()`` result."""
    t = att["theory"]
    lines = [
        f"cost attribution — {t['arch']} "
        f"(W{t['w_bits']}/A{t['a_bits']}/kv{t['kv_bits']}, {t['dist']})",
        f"  theory: {t['bops_per_token_g']} GBOPs/tok "
        f"(w16 baseline {t['bops_per_token_g_w16']}), "
        f"weights {t['weight_bytes_mb']} MB "
        f"(16-bit {t['weight_bytes_mb_16']} MB)"
        + (f", KV {t['token_kv_bytes']} B/tok "
           f"(dense {t['token_kv_bytes_dense16']})"
           if t.get("token_kv_bytes") else ""),
        "",
        f"  {'phase':<8} {'time_s':>8} {'tokens':>8} {'tok/s':>9} "
        f"{'GBOPs/s':>9} {'W rd GB/s':>10} {'KV rd':>8} {'KV wr':>8} "
        f"{'HBM GB/s':>9}",
    ]
    for p in att["phases"]:
        lines.append(
            f"  {p['phase']:<8} {p['time_s']:>8.3f} {p['tokens']:>8d} "
            f"{p['tok_s']:>9.1f} {p['achieved_gbops_s']:>9.4g} "
            f"{p['weight_rd_gb_s']:>10.4g} "
            f"{p.get('kv_rd_gb_s', 0.0):>8.4g} "
            f"{p.get('kv_wr_gb_s', 0.0):>8.4g} "
            f"{p['hbm_rd_wr_gb_s']:>9.4g}")
    if not att["phases"]:
        lines.append("  (no phase recorded any traffic)")
    lines.append("")
    lines.append("  dequant path per code family (per weight element):")
    for fam in att["dequant"]:
        mark = "*" if fam["active"] else " "
        ach = (f"  -> {fam['achieved_gops_s']} Gops/s achieved"
               if "achieved_gops_s" in fam else "")
        lines.append(f"  {mark} {fam['family']:<10} "
                     f"{fam['ops_per_elem']:>5.1f} {fam['unit']:<11} "
                     f"{fam['note']}{ach}")
    lines.append("  (* = family active in this run)")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def _load(path: str) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.traceview")
    p.add_argument("--metrics", default=None,
                   help="metrics snapshot JSON (launch/serve.py "
                        "--metrics-out)")
    p.add_argument("--trace", default=None,
                   help="Chrome-trace JSON (launch/serve.py --trace-out)")
    p.add_argument("--require-nonzero", default=None, metavar="NAMES",
                   help="comma list of counters/histograms that must "
                        "have recorded (CI smoke contract)")
    p.add_argument("--no-attribution", action="store_true",
                   help="skip the cost-attribution pass (validate only)")
    p.add_argument("--format", choices=("text", "json"), default="text")
    args = p.parse_args(argv)
    if not args.metrics and not args.trace:
        p.error("nothing to do: pass --metrics and/or --trace")

    problems: List[str] = []
    out: Dict = {}

    if args.trace:
        trace = _load(args.trace)
        problems += [f"trace: {m}" for m in validate_chrome_trace(trace)]
        out["trace"] = trace_summary(trace)

    if args.metrics:
        metrics = _load(args.metrics)
        if args.require_nonzero:
            names = [n.strip() for n in args.require_nonzero.split(",")
                     if n.strip()]
            problems += [f"metrics: {m}"
                         for m in require_nonzero(metrics, names)]
        if not args.no_attribution:
            try:
                out["attribution"] = attribution(metrics)
            except ValueError as e:
                problems.append(f"attribution: {e}")

    if args.format == "json":
        print(json.dumps({"problems": problems, **out}, indent=2,
                         sort_keys=True))
    else:
        if "trace" in out:
            ts = out["trace"]
            print(f"trace: {ts['spans']} spans + {ts['instants']} "
                  f"instants over {ts['lanes']} lanes, "
                  f"{ts['wall_ms']} ms wall, {ts['dropped']} dropped")
            for name, n in ts["by_name"].items():
                print(f"    {name:<16} {n}")
        if "attribution" in out:
            print(format_attribution(out["attribution"]))
        for m in problems:
            print(f"PROBLEM: {m}", file=sys.stderr)
    if problems:
        return 1
    if args.format == "text":
        print("traceview: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
