"""Finding records + baseline diffing for the port's analysis passes.

A finding's identity (``key``) deliberately excludes line numbers: keys
are ``rule:path:detail`` where ``detail`` is a stable content anchor (the
stripped source line for lint findings, the contract instance for audit
findings), so unrelated edits that shift code down a file do not churn
the baseline.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str           # e.g. "UQ101" or "AUDIT-SHARDING"
    path: str           # repo-relative file path, or a logical target like
                        #   "paged_attn[kv4]" for kernel/compile audits
    detail: str         # stable content anchor (identity, not prose)
    message: str        # human explanation
    line: int = 0       # best-effort source line (display only, not identity)

    @property
    def key(self) -> str:
        return f"{self.rule}:{self.path}:{self.detail}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "detail": self.detail,
                "message": self.message, "line": self.line}

    @classmethod
    def from_dict(cls, d: dict) -> "Finding":
        return cls(rule=d["rule"], path=d["path"], detail=d["detail"],
                   message=d.get("message", ""), line=int(d.get("line", 0)))


def findings_to_json(findings: List[Finding]) -> dict:
    return {"version": 1,
            "findings": [f.to_dict() for f in sorted(findings,
                                                     key=lambda f: f.key)]}


def load_baseline(path: str) -> Dict[str, dict]:
    """Baseline file -> {finding key: finding dict}."""
    with open(path) as fh:
        data = json.load(fh)
    out = {}
    for d in data.get("findings", []):
        f = Finding.from_dict(d)
        out[f.key] = d
    return out


def compare_baseline(findings: List[Finding],
                     baseline: Optional[Dict[str, dict]]
                     ) -> Tuple[List[Finding], List[str]]:
    """-> (new findings not in baseline, baseline keys no longer firing)."""
    if baseline is None:
        return list(findings), []
    current = {f.key for f in findings}
    new = [f for f in findings if f.key not in baseline]
    fixed = [k for k in baseline if k not in current]
    return new, fixed
