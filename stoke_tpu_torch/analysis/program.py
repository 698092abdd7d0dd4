"""Program auditor: static analysis over the port's recorded programs.

The port's counterpart of ``stoke_tpu/analysis/program.py``. The port has
no lowered program; what it has is the ops a program dispatches at its
first run of a signature, recorded by :class:`TraceRecorder` (a
``TorchDispatchMode``) at the engines' dispatch funnels
(``StepEngine._observed``, ``ServingEngine._observed``) as the program's
:class:`ProgramFacts`: its op count, what its ops wrote of the declared
state, its host round-trips and its collectives. Each recording becomes
a :class:`ProgramSpec`: the program's name, its facts, the abstract
arguments (shape, dtype and device of each tensor argument, other leaves
by value; no live tensor is kept), and the state the engine declares
updated in place (the counterpart of ``donate_argnums``: the parameters,
the optimizer state, the gradient buffers and, under fp16, the loss
scaler). Auditing reads the recorded facts and dispatches nothing.

Rules (ids and remedies are the JAX auditor's):

- ``audit-donation``: declared in-place state that no mutating op of the
  trace writes, or that the program replaces with a new tensor (a state
  update that copies doubles the memory the engine budgets, and a
  captured window would go on reading the old storage). A gradient
  buffer the program releases (``zero_grad(set_to_none=True)``) is
  neither.
- ``audit-deserialized``: kept as an id and never fires. The port
  dispatches nothing through a loaded executable: a program is eager
  PyTorch or the replay of a CUDA graph captured in the same process, and
  a kernel library holds no state of the run.
- ``audit-hidden-transfer``: ``_local_scalar_dense`` (``.item()``,
  ``int(t)``) of a tensor on the card, a copy between the host and the
  card, or an op whose output shape depends on the data on the card
  (``nonzero``, ``masked_select``, ``unique``, a boolean-mask index),
  which syncs, inside a program. A serve program's uploads of its inputs
  and its last read back to the host (the tokens) are the program's
  arguments and result, as the JAX engine's ``device_put`` and
  ``np.asarray`` are. On the CPU there is no card to wait for, so nothing
  there is a transfer.
- ``audit-weak-type``: Python-number program arguments (each new value is
  a new signature: a new first run, trace and cost card), and floats baked
  into a captured window that changed (the learning rates; each change
  recaptures the window).
- ``audit-recompile-churn``: distinct signatures of a program (and a
  window's captures) above the churn threshold, or at the 1024-entry memo
  cap, beyond which first runs are no longer recorded.
- ``audit-replicated-bytes``: a parameter above the byte threshold held
  whole on every rank of a model or expert group larger than 1 (a
  gathered placement's whole copy is the forward's transient, not state,
  and is not counted).
- ``audit-comm-bytes``: an apply-family trace whose gradient transport
  accounts bytes on the wire but which holds no ``c10d`` op, or ``c10d``
  ops in an apply-family trace that no exchange of the engine accounts
  (no ladder, transport or model split).
- ``audit-cost-drift`` / ``audit-memory-drift``: a serve program's cost
  card (FLOPs and bytes counted at its first run,
  :func:`stoke_tpu_torch.telemetry.attribution.counting`) or its measured
  memory against the committed manifests
  (``analysis/manifests/program_costs.json`` / ``program_memory.json``,
  pinned from the port's own CPU counts by ``scripts/stoke_lint_torch.py
  --programs --update-costs``), in both directions; a changed geometry is
  a note. The CPU has no allocator peaks, so there the memory gate notes
  itself unchecked.

Program findings use a ``<trace:NAME>`` pseudo-file and line 0.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from stoke_tpu_torch.analysis.invariants import Finding

#: step programs whose apply boundary runs the gradient exchange
APPLY_FAMILY = ("apply", "fused", "window", "multi")

#: every rule id the auditor has (``audit-deserialized`` never fires here;
#: see the module docstring)
AUDIT_RULES = (
    "audit-donation", "audit-deserialized", "audit-hidden-transfer",
    "audit-weak-type", "audit-recompile-churn", "audit-replicated-bytes",
    "audit-comm-bytes", "audit-cost-drift", "audit-memory-drift",
)

#: shape-signature count above which a program is churn-flagged
DEFAULT_CHURN_THRESHOLD = 32

#: replicated-tensor byte floor for the sharding audit (64 MiB)
DEFAULT_REPLICATED_BYTES = 64 << 20

#: relative cost deviation above which audit-cost-drift fires (the
#: manifest's "tolerance" overrides; the port's count is deterministic for
#: a fixed program, so the slack absorbs op-decomposition changes across
#: torch versions)
DEFAULT_COST_TOLERANCE = 0.05

#: relative memory deviation above which audit-memory-drift fires
DEFAULT_MEM_TOLERANCE = 0.25

#: ops whose output shape depends on the data: on a card they sync
SYNCING_OPS = frozenset({
    "aten::nonzero", "aten::masked_select", "aten::unique",
    "aten::_unique", "aten::_unique2", "aten::unique_dim",
    "aten::unique_consecutive", "aten::nonzero_numpy",
})
#: ops that copy a tensor (between devices when its ends differ)
COPY_OPS = frozenset({
    "aten::_to_copy", "aten::copy_", "aten::_copy_from",
    "aten::_copy_from_and_resize", "aten::to",
})

# --------------------------------------------------------------------------- #
# recording
# --------------------------------------------------------------------------- #


_DTYPE_NAMES: Dict[torch.dtype, str] = {}


def _dtype_name(dtype: torch.dtype) -> str:
    name = _DTYPE_NAMES.get(dtype)
    if name is None:
        name = _DTYPE_NAMES[dtype] = str(dtype).replace("torch.", "")
    return name


@dataclass
class ProgramFacts:
    """What the rules read of a recorded program: its op count, the
    declared state its in-place ops wrote (by name), its host round-trips
    in order (``(op index, op, kind)``, kind ``"d2h"``, ``"h2d"`` or
    ``"sync"``) and its collectives. The recorder gathers them while the
    program runs."""

    ops: int = 0
    written: frozenset = frozenset()
    transfers: Tuple[Tuple[int, str, str], ...] = ()
    collectives: int = 0


class TraceRecorder(TorchDispatchMode):
    """Records the ops dispatched inside it as the program's
    :class:`ProgramFacts` (:attr:`facts`).

    Only the ops that write (the schema's write annotations), copy, sync
    or communicate are looked into; any other op costs a dictionary lookup
    beyond the dispatch mode's own cost. :meth:`declare` names a program's
    declared in-place state before it runs; the recorder knows it by its
    storage and keeps no tensor alive. ``host`` names the device types
    that are the host (the CPU; a test may name another so that CPU
    tensors stand for the card's)."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # the port compiles nothing inside a program, so the dispatch
        # method runs without the compiler's guard frame around each op
        return False

    def __init__(self, program: str, host: Sequence[str] = ("cpu",)):
        super().__init__()
        self.program = program
        self._host = frozenset(host)
        # id(op overload) -> (written positions, written names, kind)
        self._kinds: Dict[int, tuple] = {}
        # declared state: storage address -> name
        self._state: Dict[int, str] = {}
        self._n = 0
        self._written: set = set()
        self._transfers: List[Tuple[int, str, str]] = []
        self._collectives = 0

    def declare(self, name: str, t: torch.Tensor) -> None:
        """Name a declared in-place state tensor."""
        self._state[t.untyped_storage()._cdata] = name

    def _on_card(self, t: torch.Tensor) -> bool:
        return t.device.type not in self._host

    def _kind(self, func) -> tuple:
        """``(written positions, written names, kind)`` of ``func``: its
        schema's write annotations (c10d's in-place collectives carry
        none, and their first argument, the tensors they fill, is
        written), and what else the rules look for in it: ``"copy"``,
        ``"scalar"`` (``_local_scalar_dense``), ``"sync"`` (a
        data-dependent shape), ``"index"``, ``"c10d"`` or None."""
        got = self._kinds.get(id(func))
        if got is None:
            schema = func._schema
            name, args = schema.name, schema.arguments
            pos = {i for i, a in enumerate(args)
                   if a.alias_info is not None and a.alias_info.is_write}
            c10d = name.startswith(("c10d::", "_c10d_functional::"))
            if c10d and name.startswith("c10d::") and name.endswith("_"):
                pos.add(0)
            kind = ("copy" if name in COPY_OPS else
                    "scalar" if name == "aten::_local_scalar_dense" else
                    "sync" if name in SYNCING_OPS else
                    "index" if name == "aten::index" else
                    "c10d" if c10d else None)
            got = self._kinds[id(func)] = (
                frozenset(pos), frozenset(args[i].name for i in pos), kind)
        return got

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        pos, names, kind = self._kinds.get(id(func)) or self._kind(func)
        if pos:
            for i in pos:
                if i < len(args):
                    self._note_written(args[i])
            for k in names.intersection(kwargs):
                self._note_written(kwargs[k])
        if kind is not None:
            self._note(func, kind, pos, args, kwargs, out)
        self._n += 1
        return out

    def _note_written(self, v) -> None:
        if isinstance(v, torch.Tensor):
            name = self._state.get(v.untyped_storage()._cdata)
            if name is not None:
                self._written.add(name)
        elif isinstance(v, (list, tuple)):
            for x in v:
                self._note_written(x)

    def _note(self, func, kind: str, pos, args, kwargs, out) -> None:
        """A host round-trip or a collective: a copy whose ends are on the
        host and on the card (``d2h`` or ``h2d`` by where it writes),
        ``_local_scalar_dense`` of a tensor on the card (``d2h``), a
        data-dependent shape or a boolean-mask index on the card
        (``sync``)."""
        if kind == "c10d":
            self._collectives += 1
            return
        if kind == "copy":
            ends = [t for t in (*args, out) if isinstance(t, torch.Tensor)]
            on_card = [self._on_card(t) for t in ends]
            if not any(on_card) or all(on_card):
                return
            dst = [t for i, t in enumerate(args)
                   if i in pos and isinstance(t, torch.Tensor)] or ends[-1:]
            hit = "h2d" if self._on_card(dst[0]) else "d2h"
        else:
            tensors = _tensors(args) + _tensors(kwargs.values())
            card = [self._on_card(t) for t in tensors]
            if kind == "scalar":
                hit = "d2h" if any(card) else None
            elif kind == "sync":
                hit = "sync" if any(card) else None
            else:  # a boolean-mask index on the card
                hit = "sync" if any(t.dtype == torch.bool and c for t, c in
                                    zip(tensors[1:], card[1:])) else None
        if hit is not None:
            self._transfers.append((self._n, func._schema.name, hit))

    @property
    def facts(self) -> ProgramFacts:
        return ProgramFacts(ops=self._n, written=frozenset(self._written),
                            transfers=tuple(self._transfers),
                            collectives=self._collectives)


def _tensors(values) -> List[torch.Tensor]:
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out += _tensors(v)
    return out


def program_signature(tree) -> Tuple[tuple, Tuple[str, ...]]:
    """A dispatch's arguments -> (abstract arguments, weak-leaf notes):
    each tensor leaf as ``(shape, dtype, device)``, other leaves by value,
    and a note for each Python number among them (bools aside)."""
    abstract, weak = [], []
    for i, leaf in enumerate(tree_leaves(tree)):
        if isinstance(leaf, torch.Tensor):
            abstract.append((tuple(leaf.shape), _dtype_name(leaf.dtype),
                             str(leaf.device)))
            continue
        if isinstance(leaf, (int, float, complex)) and \
                not isinstance(leaf, bool):
            weak.append(f"leaf {i}: raw Python {type(leaf).__name__} "
                        f"argument")
        abstract.append(leaf)
    return tuple(abstract), tuple(weak)


# --------------------------------------------------------------------------- #
# specs and reports
# --------------------------------------------------------------------------- #


@dataclass
class StateEntry:
    """One declared in-place state tensor of a program: its name (``param:
    <name>``, ``opt:<name>/<key>``, ``grad:<name>``, ``scaler:<key>``), its
    bytes, whether a model split cuts it, and what the program left in its
    place (``kept``, ``released`` or ``replaced``)."""

    name: str
    nbytes: int
    cut: bool = False
    after: str = "kept"


@dataclass
class ProgramSpec:
    """One recorded step or serve program: everything the auditor needs,
    and no live tensor."""

    program: str
    #: what the rules read, gathered while the program ran
    facts: ProgramFacts = field(default_factory=ProgramFacts)
    abstract_args: Tuple[Any, ...] = ()
    state: Tuple[StateEntry, ...] = ()
    #: Python-number arguments, and baked floats of a recaptured window
    weak_leaves: Tuple[str, ...] = ()
    #: where the spec came from ("engine" / "serve")
    source: str = "engine"
    #: the first run's cost count (``flops``, ``bytes accessed``), serve
    #: programs
    cost: Optional[Dict[str, float]] = None
    #: the first run's measured memory (``temp_bytes``, ``peak_bytes``),
    #: where the card measured it
    memory: Optional[Dict[str, float]] = None
    #: sizes of the model and expert groups the program ran under
    group_sizes: Dict[str, int] = field(default_factory=dict)
    #: whether an exchange of the engine (ladder, transport, model split)
    #: accounts collectives
    exchange: bool = False


@dataclass
class AuditReport:
    """The program-audit result: findings plus the audited inventory (so
    "zero findings" is distinguishable from "nothing was audited")."""

    findings: List[Finding] = field(default_factory=list)
    programs: List[str] = field(default_factory=list)
    notes: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings

    def format(self) -> str:
        head = (
            f"program audit: {len(self.programs)} program(s), "
            f"{len(self.findings)} finding(s)"
        )
        lines = [head] + [f.format() for f in self.findings]
        lines += [f"note: {n}" for n in self.notes]
        return "\n".join(lines)


# --------------------------------------------------------------------------- #
# manifest entries
# --------------------------------------------------------------------------- #


def cost_signature(abstract_args: tuple) -> str:
    """Stable digest of a spec's argument geometry (shapes and dtypes of
    every tensor argument, in order), pinned beside the manifests'
    numbers so a changed geometry reads as "not comparable"."""
    leaves = [(tuple(a[0]), a[1]) for a in abstract_args
              if isinstance(a, tuple) and len(a) == 3
              and isinstance(a[0], tuple)]
    return hashlib.sha256(repr(leaves).encode()).hexdigest()[:16]


def spec_cost_entry(spec: ProgramSpec) -> Optional[Dict[str, Any]]:
    """One cost-manifest entry for a serve spec: its first run's cost card
    and the geometry signature; None without a count."""
    cost = spec.cost
    if not cost or float(cost.get("flops", 0.0) or 0.0) <= 0:
        return None
    nbytes = cost.get("bytes accessed")
    return {
        "sig": cost_signature(spec.abstract_args),
        "flops": float(cost["flops"]),
        "bytes_accessed": float(nbytes) if nbytes else None,
    }


def spec_memory_entry(spec: ProgramSpec) -> Optional[Dict[str, Any]]:
    """One memory-manifest entry for a serve spec: its first run's
    measured temp and peak bytes (a card's allocator statistics); None
    where nothing was measured (the CPU)."""
    mem = spec.memory
    if not mem or float(mem.get("peak_bytes", 0.0) or 0.0) <= 0:
        return None
    return {
        "sig": cost_signature(spec.abstract_args),
        "temp_bytes": float(mem.get("temp_bytes", 0.0) or 0.0),
        "peak_bytes": float(mem["peak_bytes"]),
    }


def _rel_dev(measured: float, pinned: float) -> float:
    return abs(measured - pinned) / max(abs(pinned), 1e-12)


def _where(program: str) -> str:
    return f"<trace:{program}>"


def _audit_drift(specs: Sequence[ProgramSpec], report: AuditReport,
                 manifest: Dict[str, Any], tolerance: float, *, rule: str,
                 entry_of, fields: Tuple[str, ...], what: str,
                 update_flag: str, manifest_name: str) -> None:
    """The drift gates: serve specs' entries against a committed
    manifest, both directions (golden-file semantics)."""
    pinned = manifest.get("programs", {}) or {}
    seen = set()
    for spec in specs:
        if spec.source != "serve" or spec.program in seen:
            continue
        seen.add(spec.program)
        entry = entry_of(spec)
        if entry is None:
            report.notes.append(
                f"{rule} not checked for {spec.program!r}: no {what} was "
                f"measured at its first run")
            continue
        pin = pinned.get(spec.program)
        if pin is None:
            report.findings.append(Finding(
                rule=rule, file=_where(spec.program), line=0,
                message=(
                    f"serve program {spec.program!r} has no pinned entry "
                    f"in the {manifest_name} manifest — its {what} "
                    f"regressions would be invisible to CI"),
                remedy=(
                    f"pin it: scripts/stoke_lint_torch.py --programs "
                    f"{update_flag} rewrites analysis/manifests/"
                    f"{manifest_name}.json from the live engines"),
            ))
            continue
        if pin.get("sig") != entry["sig"]:
            report.notes.append(
                f"{rule} not checked for {spec.program!r}: argument "
                f"geometry changed (sig {entry['sig']} vs pinned "
                f"{pin.get('sig')}) — re-pin with "
                f"scripts/stoke_lint_torch.py --programs {update_flag}")
            continue
        for name in fields:
            measured, pinned_v = entry.get(name), pin.get(name)
            if pinned_v is None or measured is None:
                continue
            dev = _rel_dev(measured, pinned_v)
            if dev <= tolerance:
                continue
            direction = "grew" if measured > pinned_v else "shrank"
            report.findings.append(Finding(
                rule=rule, file=_where(spec.program), line=0,
                message=(
                    f"serve program {spec.program!r} {name} {direction} "
                    f"{dev:.1%} vs the pinned manifest ({measured:.0f} vs "
                    f"{pinned_v:.0f}, tolerance {tolerance:.0%}) at "
                    f"UNCHANGED argument geometry — a refactor changed "
                    f"this program's {what} per dispatch"),
                remedy=(
                    f"if the change is intentional, re-pin with "
                    f"scripts/stoke_lint_torch.py --programs "
                    f"{update_flag}; otherwise find the op the refactor "
                    f"added or dropped (compare the recorded trace with "
                    f"the last good commit's)"),
            ))


# --------------------------------------------------------------------------- #
# the audit
# --------------------------------------------------------------------------- #


def _audit_one(spec: ProgramSpec, findings: List[Finding], *,
               transport_active: bool, comm_bytes: Optional[Dict[str, Any]],
               exchange_active: Optional[bool],
               replicated_bytes_threshold: int) -> None:
    where = _where(spec.program)
    if spec.weak_leaves:
        findings.append(Finding(
            rule="audit-weak-type", file=where, line=0,
            message=(
                f"program {spec.program!r} takes Python numbers or bakes "
                f"floats that changed ({'; '.join(spec.weak_leaves)}) — "
                f"each new value is a new signature (a new first run, "
                f"trace and cost card), and a changed float baked into a "
                f"captured window recaptures it"),
            remedy=(
                "pass scalars as tensors (torch.tensor(v, dtype=..., "
                "device=...)) or keep them constant for the run"),
        ))
    facts = spec.facts

    # --- donation integrity ---------------------------------------- #
    for entry in spec.state:
        grad = entry.name.startswith("grad:")
        if entry.after == "replaced":
            why = "replaced with a new tensor"
        elif not grad and entry.after == "kept" \
                and entry.name not in facts.written:
            why = "written by no mutating op"
        else:
            continue
        findings.append(Finding(
            rule="audit-donation", file=where, line=0,
            message=(
                f"program {spec.program!r} declares {entry.name} updated "
                f"in place, but the trace shows it {why} — the 'in-place' "
                f"state update is a copy, so device memory is double-"
                f"booked and a captured window would read stale storage"),
            remedy=(
                "update the state with in-place ops (copy_, the "
                "optimizer's foreach updates) on the tensor the engine "
                "holds, or stop declaring it in the engine's in-place "
                "state"),
        ))

    # --- hidden host round-trips ------------------------------------ #
    transfers = list(facts.transfers)
    if spec.source == "serve":
        # the uploads are the program's arguments and the last read back
        # is its result (the tokens)
        last_d2h = max((i for i, _, k in transfers if k == "d2h"),
                       default=None)
        transfers = [(i, op, k) for i, op, k in transfers
                     if k != "h2d" and i != last_d2h]
    if transfers:
        _, op, kind = transfers[0]
        findings.append(Finding(
            rule="audit-hidden-transfer", file=where, line=0,
            message=(
                f"program {spec.program!r} holds {len(transfers)} host "
                f"round-trip(s), the first {op} ({kind}) — every "
                f"dispatch waits for the card to drain, which serializes "
                f"the host and the card and cannot be captured in a CUDA "
                f"graph"),
            remedy=(
                "keep the value on the device (fetch it with the sentinel "
                "row at the telemetry cadence); move true host work "
                "outside the step program"),
        ))

    # --- sharding: big parameters whole on every rank ----------------- #
    groups = {a: n for a, n in spec.group_sizes.items() if n > 1}
    if groups:
        flagged = 0
        for entry in sorted(spec.state, key=lambda e: -e.nbytes):
            if not entry.name.startswith("param:") or entry.cut:
                continue
            if entry.nbytes <= replicated_bytes_threshold:
                break
            findings.append(Finding(
                rule="audit-replicated-bytes", file=where, line=0,
                message=(
                    f"program {spec.program!r} keeps {entry.name} "
                    f"({entry.nbytes / 2**20:.1f} MiB) whole on every "
                    f"rank of its {groups} group(s) "
                    f"(> {replicated_bytes_threshold / 2**20:.0f} MiB "
                    f"threshold) — every device holds a full copy"),
                remedy=(
                    "give the parameter a placement (partition rules) or "
                    "raise the audit threshold if the replication is "
                    "intentional"),
            ))
            flagged += 1
            if flagged >= 4:  # bound the noise per program
                break

    # --- collectives vs the exchange's accounting -------------------- #
    if spec.program in APPLY_FAMILY:
        has_collective = facts.collectives > 0
        onwire = (comm_bytes or {}).get("onwire", 0) or 0
        accounted = spec.exchange if exchange_active is None \
            else exchange_active
        if transport_active and onwire > 0 and not has_collective:
            findings.append(Finding(
                rule="audit-comm-bytes", file=where, line=0,
                message=(
                    f"the gradient transport accounts {onwire} bytes-on-"
                    f"wire per step but program {spec.program!r} holds no "
                    f"c10d collective — bytes_per_step has drifted from "
                    f"the program"),
                remedy=(
                    "re-derive GradTransport.bytes_per_step from the "
                    "schedule the program runs (parallel/collectives.py), "
                    "or fix the transport wiring"),
            ))
        elif has_collective and not (transport_active or accounted):
            findings.append(Finding(
                rule="audit-comm-bytes", file=where, line=0,
                message=(
                    f"program {spec.program!r} runs c10d collectives but "
                    f"no exchange of the engine (ladder, transport, model "
                    f"split) accounts them — this traffic is invisible to "
                    f"the bytes-on-wire accounting"),
                remedy=(
                    "route the collectives through the ladder or the "
                    "GradTransport layer (parallel/collectives.py) so "
                    "their bytes are accounted"),
            ))


def audit_program_specs(
    specs: Sequence[ProgramSpec],
    *,
    transport_active: bool = False,
    comm_bytes: Optional[Dict[str, Any]] = None,
    exchange_active: Optional[bool] = None,
    shape_sig_counts: Optional[Dict[str, int]] = None,
    churn_threshold: int = DEFAULT_CHURN_THRESHOLD,
    memo_cap: int = 1024,
    replicated_bytes_threshold: int = DEFAULT_REPLICATED_BYTES,
    cost_manifest: Optional[Dict[str, Any]] = None,
    cost_tolerance: Optional[float] = None,
    mem_manifest: Optional[Dict[str, Any]] = None,
    mem_tolerance: Optional[float] = None,
) -> AuditReport:
    """Audit every recorded program spec: a walk over the traces, with no
    dispatch (``Stoke.audit()`` holds ``dispatch_count`` and the kernels'
    launch counts equal across it). ``exchange_active`` overrides each
    spec's own record of whether an exchange accounts its collectives.
    ``cost_manifest`` / ``mem_manifest`` arm the drift gates with the
    parsed committed manifests (``*_tolerance`` override theirs)."""
    report = AuditReport()
    for spec in specs:
        report.programs.append(spec.program)
        _audit_one(spec, report.findings, transport_active=transport_active,
                   comm_bytes=comm_bytes, exchange_active=exchange_active,
                   replicated_bytes_threshold=replicated_bytes_threshold)
    if shape_sig_counts is None:
        report.notes.append(
            "audit-recompile-churn not checked: no signature counts were "
            "given")
    for program, count in (shape_sig_counts or {}).items():
        if count >= memo_cap:
            msg = (f"program {program!r} hit the {memo_cap}-entry "
                   f"signature memo cap — first runs are no longer "
                   f"recorded or keyed for it")
        elif count > churn_threshold:
            msg = (f"program {program!r} has run {count} distinct input "
                   f"signatures (churn threshold {churn_threshold}) — each "
                   f"is a new first run (trace, cost card, a window's "
                   f"capture)")
        else:
            continue
        report.findings.append(Finding(
            rule="audit-recompile-churn", file=_where(program), line=0,
            message=msg,
            remedy=(
                "bucket/pad inputs to a bounded shape ladder (the serve "
                "prefill_pad_multiple discipline) so the signature count "
                "stays finite"),
        ))
    if cost_manifest is not None:
        tol = (cost_tolerance if cost_tolerance is not None else float(
            cost_manifest.get("tolerance", DEFAULT_COST_TOLERANCE)))
        _audit_drift(specs, report, cost_manifest, tol,
                     rule="audit-cost-drift", entry_of=spec_cost_entry,
                     fields=("flops", "bytes_accessed"), what="cost",
                     update_flag="--update-costs",
                     manifest_name="program_costs")
    elif any(spec.source == "serve" for spec in specs):
        report.notes.append(
            "audit-cost-drift not checked: no program-cost manifest "
            "supplied (scripts/stoke_lint_torch.py --programs passes the "
            "committed analysis/manifests/program_costs.json)")
    if mem_manifest is not None:
        tol = (mem_tolerance if mem_tolerance is not None else float(
            mem_manifest.get("tolerance", DEFAULT_MEM_TOLERANCE)))
        _audit_drift(specs, report, mem_manifest, tol,
                     rule="audit-memory-drift", entry_of=spec_memory_entry,
                     fields=("temp_bytes", "peak_bytes"), what="memory",
                     update_flag="--update-mem",
                     manifest_name="program_memory")
    elif any(spec.source == "serve" for spec in specs):
        report.notes.append(
            "audit-memory-drift not checked: no program-memory manifest "
            "supplied")
    return report
