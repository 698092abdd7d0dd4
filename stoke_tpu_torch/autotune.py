"""Telemetry-driven autotuner of the port: the search half.

The port's counterpart of ``stoke_tpu/autotune.py``: the same trial-driver
search loop, pruning, scoring and ledger format, over the knobs the port
exposes:

- ``batch`` / ``steps_per_dispatch``: the throughput levers (the
  per-device batch, and the optimizer steps one ``train_steps`` call
  replays as CUDA graphs);
- ``comm_dtype``: the gradient transport's wire format.

``--workload serve_decode`` of ``scripts/autotune_torch.py`` sweeps
``batch``, the decode batch of the paged kernels.

Closed without a port, with the reason:

- ``xla_flags``: eager PyTorch has no compiler flags to sweep;
- ``flash_block_q`` / ``flash_block_k``: the flash kernels' tiles are
  fixed by the ``wgmma`` instruction shape and the shared-memory budget
  of their pipeline, not a launch parameter;
- ``decode_block_h`` / ``verify_block_h``: the CUDA kernels' heads are a
  grid dimension, one block a head;
- ``decode_pages_per_block`` / ``verify_pages_per_block``: the paged
  kernels walk a context in tiles of 64 positions; ``ServeConfig``
  accepts the knobs with no effect, since no measurement has shown a
  tile that serves faster end to end.

Each trial is scored on the attribution's own metrics (MFU x goodput
fraction, throughput as the fallback), and the baseline's bound
classification prunes the search: a memory-bound baseline does not sweep
compute knobs, a host-bound one sweeps dispatch amortization first.

Deliberately **torch-free**: the search loop, knob catalog, pruning,
scoring and ledger are host logic, so ``scripts/autotune_torch.py`` runs
one subprocess a trial and its parent never touches a card. Winners
persist in a ledger of ``bench.py``'s layout under
``autotune/<metric>`` with their provenance (config key, measured MFU and
goodput, trial count); the JAX module's ``read_winner`` reads it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

#: knob name -> which resource it primarily moves.  The pruning logic keys
#: on this: a bound classification names the scarce resource, and knobs
#: that cannot relieve it are not worth trial budget.
KNOB_KIND: Dict[str, str] = {
    "batch": "memory",
    "steps_per_dispatch": "host",
    "comm_dtype": "comm",
}

#: bound classification -> knob kinds worth sweeping, in priority order.
#: Derived from the roofline semantics of the attribution monitor:
#: - memory-bound: compute knobs cannot help ("memory-bound => don't
#:   sweep compute flags"); blocking/batch shape the HBM
#:   traffic, and dispatch amortization is cheap to try.
#: - compute-bound: compute knobs and batch (tensor-core tiling) first.
#: - comm-bound: wire format first, then compute flags (overlap).
#: - host-bound: dispatch amortization dominates everything.
#: - None (no attribution data): sweep everything.
BOUND_KNOB_KINDS: Dict[Optional[str], Tuple[str, ...]] = {
    "memory": ("memory", "host"),
    "compute": ("compute", "memory", "host"),
    "comm": ("comm", "compute", "host"),
    "host": ("host", "compute", "memory", "comm"),
    None: ("compute", "memory", "host", "comm"),
}

@dataclass(frozen=True)
class TrialSpec:
    """One point in the knob space.  ``None`` means "leave the workload's
    default" — only non-default knobs enter the config key, so a spec's
    identity is exactly what it overrides."""

    batch: Optional[int] = None
    steps_per_dispatch: Optional[int] = None
    comm_dtype: Optional[str] = None

    def config_key(self) -> str:
        """Canonical, process-stable identity of this configuration (the
        provenance key the ledger winner records)."""
        parts = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None or v == "":
                continue
            parts.append(f"{f.name}={v}")
        return "|".join(parts) or "baseline"

    def to_dict(self) -> Dict[str, Any]:
        return {
            f.name: getattr(self, f.name) for f in dataclasses.fields(self)
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrialSpec":
        # knobs the port does not have (a JAX record's xla_flags or block
        # knobs) are left out
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in (d or {}).items() if k in names})

    def with_knob(self, knob: str, value) -> "TrialSpec":
        return dataclasses.replace(self, **{knob: value})


@dataclass
class TrialResult:
    """One measured trial.  ``mfu``/``goodput_fraction``/``bound`` come
    from the attribution vertical (None when the trial ran without it);
    ``value`` is the workload throughput (imgs/sec, tokens/sec, ...)."""

    spec: TrialSpec
    value: float = 0.0
    unit: str = "imgs/sec/chip"
    mfu: Optional[float] = None
    goodput_fraction: Optional[float] = None
    bound: Optional[str] = None
    wall_s: Optional[float] = None
    ok: bool = True
    error: Optional[str] = None

    def score(self, basis: Optional[str] = None) -> float:
        """Trial ordering: under the ``"mfu"`` basis, MFU weighted by
        the goodput fraction (per-window MFU already folds in wasted
        wall clock, but a trial that spends its windows compiling or
        starving must not win on a lucky productive window); under
        ``"value"``, raw throughput.  ``basis=None`` uses the trial's
        own basis (MFU when measured).  Failed trials sort below
        everything.  The two bases are incomparable units (MFU in 0..1,
        throughput in thousands) — :func:`greedy_search` fixes ONE basis
        per sweep and passes it here, so a trial that cannot report the
        sweep's basis is disqualified (-inf) instead of silently
        competing in the wrong unit."""
        if not self.ok:
            return -math.inf
        b = basis or ("mfu" if self.mfu is not None else "value")
        if b == "mfu":
            if self.mfu is None:
                return -math.inf  # incomparable: history, never winner
            g = (
                self.goodput_fraction
                if self.goodput_fraction is not None
                else 1.0
            )
            return self.mfu * g
        return self.value

    def to_dict(self) -> Dict[str, Any]:
        out = dataclasses.asdict(self)
        out["spec"] = self.spec.to_dict()
        out["config_key"] = self.spec.config_key()
        out["score"] = None if not self.ok else self.score()
        return out


def knobs_for_bound(
    bound: Optional[str],
    space: Dict[str, Sequence[Any]],
) -> List[str]:
    """Prune + order the knob space by the baseline's bound
    classification (pure function — unit-tested on synthetic bounds).

    Returns the knob names worth sweeping, highest-leverage first: knobs
    whose kind is not in ``BOUND_KNOB_KINDS[bound]`` are dropped (e.g.
    compute flags under a memory bound), the rest sort by their kind's
    priority for that bound.  Unknown bounds degrade to the unpruned
    ordering — never silently to an empty sweep.
    """
    kinds = BOUND_KNOB_KINDS.get(bound, BOUND_KNOB_KINDS[None])
    rank = {k: i for i, k in enumerate(kinds)}
    out = [
        k for k in space
        if KNOB_KIND.get(k, "compute") in rank
    ]
    out.sort(key=lambda k: rank[KNOB_KIND.get(k, "compute")])
    return out


@dataclass
class SearchOutcome:
    best: TrialResult
    history: List[TrialResult] = field(default_factory=list)
    pruned_knobs: List[str] = field(default_factory=list)
    trials: int = 0


def greedy_search(
    measure: Callable[[TrialSpec], TrialResult],
    base: TrialSpec,
    space: Dict[str, Sequence[Any]],
    *,
    max_trials: int = 16,
    log: Optional[Callable[[str], None]] = None,
) -> SearchOutcome:
    """Bound-pruned greedy coordinate search.

    1. Measure the baseline; its ``bound`` classification prunes + orders
       the knob space (:func:`knobs_for_bound`).
    2. Sweep each surviving knob in priority order, one candidate value
       per trial, carrying the best spec found so far (coordinate
       ascent); duplicate configurations (by config key) are never
       re-measured.
    3. Stop at ``max_trials`` total measurements (baseline included).

    ``measure`` may return ``ok=False`` results (a failed trial is
    recorded in history but can never become the winner) — trial failure
    is data, not an exception.

    Scoring basis is fixed ONCE per sweep, by the first ok trial: MFU x
    goodput when it reported an MFU, raw throughput otherwise.  Under
    the MFU basis a trial whose attribution data went missing scores as
    disqualified rather than falling back to throughput — the two bases
    are incomparable units, and a lost-telemetry trial scoring thousands
    against honest 0..1 scores would always "win".
    """
    say = log or (lambda _msg: None)
    basis: Optional[str] = None

    def _note_basis(r: TrialResult) -> None:
        nonlocal basis
        if basis is None and r.ok:
            basis = "mfu" if r.mfu is not None else "value"

    def _score(r: TrialResult) -> float:
        return r.score(basis)

    best = measure(base)
    history = [best]
    seen = {base.config_key()}
    _note_basis(best)
    bound = best.bound
    knobs = knobs_for_bound(bound, space)
    pruned = [k for k in space if k not in knobs]
    say(
        f"baseline score={_score(best):.6g} basis={basis or 'n/a'} "
        f"bound={bound or 'n/a'} sweep={knobs} pruned={pruned}"
    )
    for knob in knobs:
        for value in space[knob]:
            if len(history) >= max_trials:
                say(f"trial budget exhausted ({max_trials})")
                return SearchOutcome(best, history, pruned, len(history))
            cand = (best.spec if best.ok else base).with_knob(knob, value)
            key = cand.config_key()
            if key in seen:
                continue
            seen.add(key)
            res = measure(cand)
            history.append(res)
            _note_basis(res)
            say(
                f"trial {len(history)}/{max_trials} {key!r}: "
                + (
                    f"score={_score(res):.6g}"
                    if res.ok
                    else f"FAILED ({res.error})"
                )
            )
            if _score(res) > _score(best):
                best = res
                say(f"  -> new best")
    return SearchOutcome(best, history, pruned, len(history))


# --------------------------------------------------------------------------- #
# ledger persistence (winners with provenance)
# --------------------------------------------------------------------------- #


def winner_metric(base_metric: str) -> str:
    """Ledger key the winner for ``base_metric`` persists under (distinct
    namespace: a tuned-search winner is provenance for replay, never a
    substitute for the exact-configuration headline record)."""
    return f"autotune/{base_metric}"


def load_ledger(path: str) -> Dict[str, Any]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def persist_winner(
    path: str,
    base_metric: str,
    outcome: SearchOutcome,
    *,
    backend: str = "unknown",
    source: str = "scripts/autotune_torch.py",
    extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Record a search winner in the ledger with full provenance.

    The record carries everything a replay needs (the spec and its config
    key, in the JAX ledger's layout) and everything a reader needs to
    trust it (measured value/MFU/goodput, trial count, pruned knobs,
    date, backend).  Atomic write (tmp + rename), merging with whatever
    else the ledger holds.
    """
    best = outcome.best
    record = {
        "value": round(float(best.value), 1),
        "unit": best.unit,
        "mfu": None if best.mfu is None else round(best.mfu, 6),
        "goodput_fraction": (
            None
            if best.goodput_fraction is None
            else round(best.goodput_fraction, 4)
        ),
        "bound": best.bound,
        "config_key": best.spec.config_key(),
        "spec": best.spec.to_dict(),
        "trials": outcome.trials,
        "pruned_knobs": list(outcome.pruned_knobs),
        "date": time.strftime("%Y-%m-%d"),
        "source": source,
        "backend": backend,
        **(extra or {}),
    }
    ledger = load_ledger(path)
    ledger[winner_metric(base_metric)] = record
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(ledger, f, indent=2)
        f.write("\n")
    os.replace(tmp, path)
    return record


def read_winner(path: str, base_metric: str) -> Optional[Dict[str, Any]]:
    """The persisted winner for ``base_metric`` (None when no search has
    run)."""
    return load_ledger(path).get(winner_metric(base_metric))
