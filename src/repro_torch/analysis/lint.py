"""AST lint pass over the port: the repo's hazard rules that apply to
PyTorch code (stdlib ``ast``).

The JAX package's lint (its ``analysis/lint.py``) carries ten rules; seven
read JAX tracing, ``jax.jit`` or Pallas and have nothing to read here
(ROADMAP.md, "Not ported, by design").  The three that fit the port,
retargeted at its paths:

  UQ105  int4 packing (``<< 4`` + bitwise or) without a low-nibble mask
         in the same function — a code >= 16 bleeds into its neighbour's
         nibble.
  UQ106  ``torch``, ``jax`` or ``repro`` imports in the port's declared
         host-only modules (the scheduler, the prefix cache and the
         telemetry are pure Python: they run inside the engine's host loop,
         are pinned against the JAX package's copies on the CPU, and must
         never build device tensors).
  UQ109  ``assert`` as invariant enforcement — anywhere in the scheduler /
         prefix-cache hot paths (the paged-KV safety invariants the model
         checker exhausts must survive ``python -O``), or on a tensor value
         in ``kernels/`` / ``models/`` (a host sync per call, and ``-O``
         strips the check).  Raise instead, or route host-side invariants
         through ``Scheduler.check_invariants()``.

Suppress a finding with ``# uniqcheck: ignore[UQ105]`` (or a bare
``# uniqcheck: ignore``) on the flagged line.  Finding identity is
``rule:path:stripped-source-line`` — stable under unrelated edits.

``run_lint`` walks ``src/repro_torch/``, ``chip_smoke.py``, ``tools/`` and
the port's examples (``examples/*_torch.py``).
"""

from __future__ import annotations

import ast
import os
import re
from typing import List, Optional

from repro_torch.analysis.findings import Finding

RULES = {
    "UQ105": "int4 pack (<< 4 | or) without a low-nibble mask",
    "UQ106": "torch / jax / repro import in a host-only module",
    "UQ109": "assert used for invariant enforcement (stripped under -O)",
}

# -- rule scopes (path prefixes are repo-relative, '/'-separated) ----------
TENSOR_SCOPE = ("src/repro_torch/kernels/", "src/repro_torch/models/")
HOST_ONLY = ("src/repro_torch/serve/scheduler.py",
             "src/repro_torch/serve/prefix_cache.py",
             "src/repro_torch/serve/telemetry.py")
HOST_FORBIDDEN = ("torch", "jax", "repro")
# hot-path state machines whose invariants the model checker
# (analysis/modelcheck.py) exhausts: enforcement must survive `python -O`
ASSERT_HOT_PATHS = ("src/repro_torch/serve/scheduler.py",
                    "src/repro_torch/serve/prefix_cache.py")

# torch calls that return host values (safe in an assert: shape plumbing)
HOST_SAFE_CALLS = frozenset({
    "torch.is_tensor", "torch.is_floating_point", "torch.is_complex",
    "torch.device", "torch.dtype", "torch.finfo", "torch.iinfo",
    "torch.Size", "torch.cuda.is_available", "torch.cuda.device_count",
    "torch.get_default_dtype", "torch.is_grad_enabled",
})
# tensor methods that read a value (a host sync) when asserted on
TENSOR_READS = frozenset({"all", "any", "item", "equal", "allclose",
                          "isfinite", "isnan"})

_SUPPRESS = re.compile(r"#\s*uniqcheck:\s*ignore(?:\[([A-Z0-9, ]+)\])?")


def _dotted(node: ast.AST) -> Optional[str]:
    """Attribute/Name chain -> dotted string ("torch.cuda.is_available"),
    or None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _line_detail(lines: List[str], lineno: int) -> str:
    if 1 <= lineno <= len(lines):
        return re.sub(r"\s+", " ", lines[lineno - 1].strip())
    return f"L{lineno}"


def _suppressed(lines: List[str], lineno: int, rule: str) -> bool:
    if not (1 <= lineno <= len(lines)):
        return False
    m = _SUPPRESS.search(lines[lineno - 1])
    if not m:
        return False
    return m.group(1) is None or rule in {
        r.strip() for r in m.group(1).split(",")}


def _in_scope(relpath: str, prefixes) -> bool:
    return any(relpath.startswith(p) for p in prefixes)


def _finding(findings, lines, relpath, rule, node, message):
    if _suppressed(lines, node.lineno, rule):
        return
    findings.append(Finding(rule=rule, path=relpath,
                            detail=_line_detail(lines, node.lineno),
                            message=message, line=node.lineno))


# -- UQ105 ------------------------------------------------------------------

def _check_int4_mask(tree, lines, relpath, findings):
    for node in ast.walk(tree):
        if not isinstance(node, ast.FunctionDef):
            continue
        shifts, has_or, has_mask = [], False, False
        for sub in ast.walk(node):
            if isinstance(sub, ast.BinOp):
                if isinstance(sub.op, ast.LShift) \
                        and isinstance(sub.right, ast.Constant) \
                        and sub.right.value == 4:
                    shifts.append(sub)
                elif isinstance(sub.op, ast.BitOr):
                    has_or = True
                elif isinstance(sub.op, ast.BitAnd):
                    for side in (sub.left, sub.right):
                        if isinstance(side, ast.Constant) \
                                and side.value == 0x0F:
                            has_mask = True
        if shifts and has_or and not has_mask:
            _finding(findings, lines, relpath, "UQ105", shifts[0],
                     f"{node.name}: packs nibbles (`<< 4` + `|`) without "
                     "an `& 0x0F` low-nibble mask — codes >= 16 bleed "
                     "into the neighbor nibble")


# -- UQ106 ------------------------------------------------------------------

def _check_host_purity(tree, lines, relpath, findings):
    if relpath not in HOST_ONLY:
        return
    for node in ast.walk(tree):
        mods = []
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            mods = [node.module]
        for mod in mods:
            if mod.split(".")[0] in HOST_FORBIDDEN:
                _finding(findings, lines, relpath, "UQ106", node,
                         f"host-only module imports `{mod}`: the "
                         "scheduler/prefix cache/telemetry run inside the "
                         "engine's host loop as pure Python and must never "
                         "build device tensors")


# -- UQ109 ------------------------------------------------------------------

def _reads_tensor(node: ast.AST) -> bool:
    """Whether an expression calls into torch (other than a host-value
    helper) or reads a tensor's value (``.all()``, ``.item()``, ...)."""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        name = _dotted(sub.func)
        if name and name.startswith("torch.") \
                and name not in HOST_SAFE_CALLS:
            return True
        if isinstance(sub.func, ast.Attribute) \
                and sub.func.attr in TENSOR_READS:
            return True
    return False


def _check_assert_enforcement(tree, lines, relpath, findings):
    hot = relpath in ASSERT_HOT_PATHS
    tensor = _in_scope(relpath, TENSOR_SCOPE)
    if not (hot or tensor):
        return
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assert):
            continue
        if hot:
            _finding(findings, lines, relpath, "UQ109", node,
                     "`assert` enforces a scheduler/prefix-cache "
                     "invariant but is stripped under `python -O` — "
                     "raise, or route it through "
                     "Scheduler.check_invariants() so the model "
                     "checker and production both see it")
        elif _reads_tensor(node.test):
            _finding(findings, lines, relpath, "UQ109", node,
                     "`assert` on a tensor value: a host sync on every "
                     "call, and `python -O` strips the check — raise, or "
                     "use torch._assert_async for a device-side check")


# -- driver -----------------------------------------------------------------

_CHECKS = (_check_int4_mask, _check_host_purity, _check_assert_enforcement)


def lint_source(source: str, relpath: str) -> List[Finding]:
    """Lint one file's source under its repo-relative path (rule scopes
    key off the path, so tests can target a rule by choosing it)."""
    tree = ast.parse(source)
    lines = source.splitlines()
    findings: List[Finding] = []
    for check in _CHECKS:
        check(tree, lines, relpath, findings)
    return findings


def repo_root() -> str:
    """The checkout's root, given this file at
    src/repro_torch/analysis/lint.py."""
    return os.path.abspath(os.path.join(os.path.dirname(__file__),
                                        *[os.pardir] * 3))


def iter_python_files(root: str):
    """(full path, repo-relative path) of every file ``run_lint`` reads."""
    def rel(full):
        return os.path.relpath(full, root).replace(os.sep, "/")
    for top in (os.path.join("src", "repro_torch"), "tools"):
        base = os.path.join(root, top)
        if not os.path.isdir(base):
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__", ".git"))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    full = os.path.join(dirpath, fn)
                    yield full, rel(full)
    smoke = os.path.join(root, "chip_smoke.py")
    if os.path.isfile(smoke):
        yield smoke, rel(smoke)
    examples = os.path.join(root, "examples")
    if os.path.isdir(examples):
        for fn in sorted(os.listdir(examples)):
            if fn.endswith("_torch.py"):
                full = os.path.join(examples, fn)
                yield full, rel(full)


def run_lint(root: Optional[str] = None) -> List[Finding]:
    root = root or repo_root()
    findings: List[Finding] = []
    for full, rel in iter_python_files(root):
        with open(full) as fh:
            src = fh.read()
        try:
            findings.extend(lint_source(src, rel))
        except SyntaxError as e:      # pragma: no cover - broken file
            findings.append(Finding(rule="UQ100", path=rel,
                                    detail=f"syntax:{e.lineno}",
                                    message=f"unparseable: {e}",
                                    line=e.lineno or 0))
    return findings
