"""The port's analysis CLI: run the passes, diff against the checked-in
baseline.

    # on the card (the kernel audit launches the CUDA kernels)
    PYTHONPATH=src python -m repro_torch.analysis.check \
        --only lint,kernel,compile,mc --format json \
        --baseline analysis_baseline_torch.json
    # on the CPU (no kernel pass)
    PYTHONPATH=src python -m repro_torch.analysis.check \
        --only lint,compile,mc --device cpu \
        --baseline analysis_baseline_torch.json

Passes: ``lint`` (``analysis/lint.py``), ``kernel`` (``analysis/
kernel_audit.py``: needs the card, raises without one), ``compile``
(``analysis/compile_audit.py``: byte accounting, at published widths too on
the card, and the step-shape budget), ``mc`` (``analysis/modelcheck.py``:
opt in, as the JAX package's CLI).  ``bench`` reads the port's benchmark
JSON, which does not exist yet: asking for it raises.

Exit codes: 0 = clean vs baseline, 1 = new findings (or growth with
--assert-no-growth), 2 = internal error (an unknown pass).
``--write-baseline`` refreshes the baseline file (review the diff: the
baseline may only shrink or hold).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List

from repro_torch.analysis import compile_audit, kernel_audit, lint
from repro_torch.analysis.findings import (Finding, compare_baseline,
                                           findings_to_json, load_baseline)

PASSES = ("lint", "kernel", "compile", "bench", "mc")
# mc exhausts a bounded state space (seconds, not ms) — opt in via
# --mc or --only mc; everything else runs by default
DEFAULT_PASSES = ("lint", "kernel", "compile")


def run_passes(only: List[str], kv_bits: List[int],
               with_engine: bool, device="cuda", mc_depth=None,
               mc_budget_s: float = 60.0, mc_corpus_dir=None):
    import torch
    findings: List[Finding] = []
    info = {}
    if "bench" in only:
        raise RuntimeError(
            "the bench pass reads the port's benchmark JSON, which the port "
            "does not have yet (ROADMAP.md, Queue 1 item 1: the port's "
            "benchmark); run the other passes")
    if "lint" in only:
        findings.extend(lint.run_lint())
        info["lint_rules"] = sorted(lint.RULES)
    if "kernel" in only:
        fs, i = kernel_audit.run_kernel_audit(device=device)
        findings.extend(fs)
        info.update(i)
    if "compile" in only:
        fs, i = compile_audit.run_compile_audit(
            tuple(kv_bits), with_engine=with_engine, device=device,
            full=torch.device(device).type == "cuda")
        findings.extend(fs)
        info.update(i)
    if "mc" in only:
        # imported here: the default passes stay importable without
        # dragging the serving stack in
        from repro_torch.analysis import modelcheck
        fs, stats = modelcheck.run_mc(depth=mc_depth, budget_s=mc_budget_s,
                                      corpus_dir=mc_corpus_dir)
        findings.extend(fs)
        info["mc"] = stats
    return findings, info


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.analysis.check")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--baseline", default=None,
                   help="baseline JSON: only findings NOT in it fail")
    p.add_argument("--write-baseline", default=None, metavar="PATH",
                   help="write current findings as the new baseline")
    p.add_argument("--only", default=",".join(DEFAULT_PASSES),
                   help=f"comma list of passes to run ({','.join(PASSES)}; "
                        f"default {','.join(DEFAULT_PASSES)})")
    p.add_argument("--device", default="cuda",
                   help="where the engine-driven passes and the kernel "
                        "audit run (default cuda; the kernel pass needs it)")
    p.add_argument("--kv-bits", default="16,8,4",
                   help="kv_bits matrix of the step-shape budget")
    p.add_argument("--skip-engine", action="store_true",
                   help="skip the engine-driven step-shape budget "
                        "(byte accounting only; faster)")
    p.add_argument("--mc", action="store_true",
                   help="also run the bounded model-check pass "
                        "(analysis/modelcheck.py)")
    p.add_argument("--mc-depth", type=int, default=None,
                   help="override every universe's DFS depth bound")
    p.add_argument("--mc-budget-s", type=float, default=60.0,
                   help="wall-clock budget shared by all mc universes")
    p.add_argument("--mc-corpus-dir", default="tests/data/mc_corpus",
                   help="where shrunk counterexample traces are written")
    p.add_argument("--assert-no-growth", action="store_true",
                   help="also fail if the finding count exceeds the "
                        "baseline count (baseline shrinks-or-holds)")
    args = p.parse_args(argv)

    only = [s.strip() for s in args.only.split(",") if s.strip()]
    if args.mc and "mc" not in only:
        only.append("mc")
    bad = [s for s in only if s not in PASSES]
    if bad:
        print(f"unknown pass(es): {bad}", file=sys.stderr)
        return 2
    kv_bits = [int(s) for s in args.kv_bits.split(",") if s.strip()]

    findings, info = run_passes(only, kv_bits,
                                with_engine=not args.skip_engine,
                                device=args.device, mc_depth=args.mc_depth,
                                mc_budget_s=args.mc_budget_s,
                                mc_corpus_dir=args.mc_corpus_dir)

    baseline = load_baseline(args.baseline) if args.baseline else None
    new, fixed = compare_baseline(findings, baseline)

    if args.write_baseline:
        with open(args.write_baseline, "w") as fh:
            json.dump(findings_to_json(findings), fh, indent=2,
                      sort_keys=True)
            fh.write("\n")

    grew = (args.assert_no_growth and baseline is not None
            and len(findings) > len(baseline))
    ok = not new and not grew

    if args.format == "json":
        out = findings_to_json(findings)
        out["summary"] = {
            "passes": only,
            "total": len(findings),
            "new": [f.key for f in new],
            "fixed_vs_baseline": fixed,
            "baseline_total": len(baseline) if baseline is not None
            else None,
            "ok": ok,
        }
        out["info"] = info
        json.dump(out, sys.stdout, indent=2, default=str)
        print()
    else:
        for f in sorted(findings, key=lambda f: f.key):
            mark = "NEW " if f in new else "     "
            loc = f"{f.path}:{f.line}" if f.line else f.path
            print(f"{mark}{f.rule:16s} {loc}\n      {f.message}")
        for st in info.get("mc", []):
            print(f"[check] mc {st['universe']}: depth={st['depth']} "
                  f"states={st['states']} transitions={st['transitions']} "
                  f"invariant_checks={st['invariant_checks']} "
                  f"exhausted={st['exhausted']} "
                  f"({st['elapsed_s']:.1f}s)")
        print(f"[check] passes={','.join(only)} findings="
              f"{len(findings)} new={len(new)} "
              f"fixed_vs_baseline={len(fixed)}")
        if grew:
            print(f"[check] FAIL: {len(findings)} findings > baseline "
                  f"{len(baseline)} (shrinks-or-holds violated)")
        if fixed:
            print("[check] baseline entries no longer firing "
                  f"({len(fixed)}): refresh with --write-baseline to "
                  "shrink the baseline")

    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
