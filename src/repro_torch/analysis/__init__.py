"""The port's analysis subsystem: static and audit passes over the serving
stack and the CUDA kernels, and the viewers of its artifacts.

  * ``lint``          — stdlib-``ast`` rules for the repo's hazards that
                        apply to PyTorch code (UQ105, UQ106, UQ109).
  * ``compile_audit`` — byte accounting of the paged pool against the
                        scheduler's admission currency, and the step-shape
                        budget of the engine's decode / prefill calls.
  * ``kernel_audit``  — coverage, out-of-bounds writes, shared memory and
                        occupancy, and launches of every CUDA kernel of
                        ``kernels/csrc`` (on the card).
  * ``modelcheck``    — bounded model checking of the paged scheduler, its
                        counterexamples replayed on the port's engine.
  * ``traceview``     — the engine's metrics snapshot and Chrome trace
                        validated, and the BOPs cost model set against the
                        measured phase times.

Findings are machine-readable (``Finding`` -> JSON) and diffed against a
checked-in baseline (``analysis_baseline_torch.json``): only *new*
findings fail, so the baseline can only shrink or hold.

    PYTHONPATH=src python -m repro_torch.analysis.check \
        --only lint,compile,mc --device cpu \
        --baseline analysis_baseline_torch.json
"""

from repro_torch.analysis.findings import (Finding, compare_baseline,
                                           load_baseline)

__all__ = ["Finding", "compare_baseline", "load_baseline"]
