"""Static analysis over the port's codified disciplines.

The port's counterpart of ``stoke_tpu/analysis``. Two halves behind one
CLI (``scripts/stoke_lint_torch.py``) and one facade hook
(``Stoke.audit()``):

- :mod:`stoke_tpu_torch.analysis.invariants`: the torch-free, AST-based
  invariant linter (append-only wire formats, config-knob status-rule
  coverage, nullable-JSONL discipline, banned imports and host fetches).
  Loadable by FILE, so the CLI never imports torch.
- :mod:`stoke_tpu_torch.analysis.program`: the program auditor over what
  the step and serve programs' first runs dispatched (in-place state,
  hidden host round-trips, recompile hazards, replication and collective
  accounting, serve-cost drift).
"""

from stoke_tpu_torch.analysis.invariants import (
    Finding,
    check_banned_apis,
    check_config_coverage,
    check_jsonl_schema,
    check_wire_formats,
    run_invariant_lints,
)
from stoke_tpu_torch.analysis.program import (
    AuditReport,
    ProgramFacts,
    ProgramSpec,
    TraceRecorder,
    audit_program_specs,
    program_signature,
)

__all__ = [
    "AuditReport",
    "Finding",
    "ProgramFacts",
    "ProgramSpec",
    "TraceRecorder",
    "audit_program_specs",
    "check_banned_apis",
    "check_config_coverage",
    "check_jsonl_schema",
    "check_wire_formats",
    "program_signature",
    "run_invariant_lints",
]
