"""Structured diagnostics of the plan checker (the port's copy of
``galvatron_tpu/analysis/diagnostics.py``, its ``GTA0xx`` codes).

Every failure class has a STABLE code, so CI can gate on specific codes and
both packages report a bad plan with the same ones. Codes are append-only: a
retired rule keeps its number. The JAX package's linter and collective
auditor codes (``GTL…``, ``GTC…``) belong to passes the port does not have
yet (ROADMAP.md §1.12).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

ERROR = "error"
WARN = "warn"

# code → (summary, default severity)
CODES = {
    # --- plan checker (GTA0xx) ---
    "GTA001": ("unknown key in strategy/config JSON (typo'd fields silently no-op)", WARN),
    "GTA002": ("field fails to decode/validate (bad degree, dp_type, enum value)", ERROR),
    "GTA003": ("world size not a power of two, or pp does not divide it", ERROR),
    "GTA004": ("parallel-degree product exceeds the per-stage mesh extent", ERROR),
    "GTA005": ("pp_division malformed (length, sum vs layer count, empty stage)", ERROR),
    "GTA006": ("plan layer count disagrees with the model's total layers", ERROR),
    "GTA007": ("attention heads not divisible by the tp (or a2a cp) degree", ERROR),
    "GTA008": ("vocab size not divisible by vocab_tp", ERROR),
    "GTA009": ("global batch not divisible by chunks × the layer's dp extent", ERROR),
    "GTA010": ("sequence length not divisible by the sp/cp shard degree", ERROR),
    "GTA011": ("interleaved-schedule (vpp) constraint violated", ERROR),
    "GTA012": ("known XLA SPMD CHECK-crash cell: pp>1 × 1F1B × tp>1 × sp=0 × vocab_tp>1", ERROR),
    "GTA013": ("stage-stack seam: layers at the same stage position disagree (pp>1)", ERROR),
    "GTA014": ("expert-parallel degree invalid for the model's expert count", ERROR),
    "GTA015": ("cost-model memory estimate exceeds the device budget", ERROR),
    "GTA016": ("abstract sharding pass: annotated dim unsharded or spec invalid", WARN),
    "GTA017": ("checkpoint topology/plan fingerprint does not match the live mesh", ERROR),
    "GTA018": ("tp_overlap (collective-matmul) set on a layer with tp == 1", ERROR),
}


@dataclass(frozen=True)
class Diagnostic:
    """One finding: stable code + provenance + a one-line fix hint."""

    code: str
    message: str  # one-line statement of the defect
    hint: str = ""  # one-line fix hint naming the offending field
    field: str = ""  # JSON field / config attribute (e.g. "tp_sizes_enc[3]")
    source: Optional[str] = None  # file path when checking a file
    line: int = 0  # 1-based source line (linter findings)
    severity: str = ""  # defaulted from CODES when empty

    def __post_init__(self):
        if self.code not in CODES:
            raise ValueError(f"unregistered diagnostic code {self.code!r}")
        if not self.severity:
            object.__setattr__(self, "severity", CODES[self.code][1])

    def render(self) -> str:
        where = ""
        if self.source:
            where = f"{self.source}:{self.line}: " if self.line else f"{self.source}: "
        fld = f" [{self.field}]" if self.field else ""
        hint = f"\n    hint: {self.hint}" if self.hint else ""
        return f"{where}{self.code} {self.severity}: {self.message}{fld}{hint}"


def errors(diags: List[Diagnostic]) -> List[Diagnostic]:
    return [d for d in diags if d.severity == ERROR]


def warnings(diags: List[Diagnostic]) -> List[Diagnostic]:
    return [d for d in diags if d.severity == WARN]


def format_report(diags: List[Diagnostic], clean: str = "plan OK") -> str:
    if not diags:
        return clean
    lines = [d.render() for d in diags]
    ne, nw = len(errors(diags)), len(warnings(diags))
    lines.append(f"{ne} error(s), {nw} warning(s)")
    return "\n".join(lines)
