"""The per-layer numerics observatory: module statistics, NaN provenance
and quantization-error attribution (the port's counterpart of
``stoke_tpu/telemetry/numerics.py``).

Three signal families over one grouping, the JAX package's:

1. **Per-group gradient, parameter and update statistics.** The groups
   are the top-level entries of the JAX params tree (``layer_0``,
   ``tok_emb``, ``lm_head``, ...), in its flatten order, from
   :func:`stoke_tpu_torch.convert.jax_param_layout`
   (:func:`module_groups`). ``StepEngine._apply`` packs raw sums (the
   gradients' sum of squares, largest magnitude and count of non-finite
   elements, the updated parameters' and the update's sums of squares)
   into one ``[n_groups, N_NUMERICS_STATS]`` fp32 matrix on the device,
   beside the health sentinel row and from the same taps: the unscaled,
   post-transport, pre-clip gradients and the copy of the parameters
   taken before the step. A window replayed from a CUDA graph yields its
   matrix too. Raw sums ride the wire so the rows recombine to the global
   grad norm (``norm^2 = sum_g grad_sumsq_g``).
2. **NaN / Inf provenance.** The first offending group and field of a
   matrix (:func:`provenance_of`), surfaced through the health detectors
   (:class:`NumericsProvenanceDetector`), the JSONL block and the
   post-mortem bundles (``numerics.json``).
3. **Quantization-error attribution.** The error-feedback residual of a
   gradient transport by group (:func:`wire_residual_group_norms`), and
   the int8 serving weights' dequantization error by group
   (:func:`quant_error_by_group`).

Host-side everything here is the JAX module's logic; only the grouping
(the port's modules mapped to the JAX tree) and the residual's layout
(one padded buffer a bucket in both transports, so the replicated one is
grouped exactly by slices) are the port's own.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from stoke_tpu_torch.telemetry.health import (
    Detector,
    _RunningStats,
    jax_leaf_order,
    leaf_path_names,
)

#: group-stats matrix column layout (the JAX package's wire format; never
#: reorder, only append)
NUMERICS_STATS = (
    "grad_sumsq",      # sum of g^2 over the group's gradient elements
    "grad_absmax",     # max |g| over the group
    "grad_nonfinite",  # count of non-finite gradient ELEMENTS in the group
    "param_sumsq",     # sum of p^2 over the group's UPDATED parameters
    "update_sumsq",    # sum of (p_new - p_old)^2 over the group
)
NUMERICS_INDEX = {name: i for i, name in enumerate(NUMERICS_STATS)}
N_NUMERICS_STATS = len(NUMERICS_STATS)

#: warnings the monitor emits itself before degrading to record-only
_MAX_PROVENANCE_WARNINGS = 5

#: provenance events kept for the summary and numerics.json
_RECENT_PROVENANCE_MAX = 64


class ModuleGroup(NamedTuple):
    """One top-level entry of the JAX params tree: its name, the indices of
    its leaves in the JAX flatten order, each leaf's element count, and
    the same leaves as indices into the engine's parameter list."""

    name: str
    leaf_indices: Tuple[int, ...]
    leaf_elems: Tuple[int, ...]
    param_indices: Tuple[int, ...] = ()

    @property
    def n_elems(self) -> int:
        return int(sum(self.leaf_elems))


def _sanitize(name: str) -> str:
    """Group names become gauge-name segments and JSONL keys."""
    return "".join(c if (c.isalnum() or c in "_-.") else "_" for c in name)


def module_groups(module: nn.Module,
                  params: Optional[Sequence[torch.Tensor]] = None
                  ) -> List[ModuleGroup]:
    """The module's trainable parameters grouped by the first entry of
    their JAX path (flax's top-level module name), groups in order of
    first appearance in the JAX flatten order. ``params`` (default: the
    module's trainable parameters) is the engine's list, which
    ``param_indices`` index."""
    if params is None:
        params = [p for p in module.parameters() if p.requires_grad]
    paths = leaf_path_names(module, params)
    order: List[str] = []
    members: Dict[str, List[int]] = {}
    for j, (i, path) in enumerate(zip(jax_leaf_order(module, params),
                                      paths)):
        name = _sanitize(path.split("/", 1)[0]) if path else "params"
        if name not in members:
            order.append(name)
            members[name] = []
        members[name].append((j, i))
    return [
        ModuleGroup(name, tuple(j for j, _ in members[name]),
                    tuple(int(params[i].numel()) for _, i in members[name]),
                    tuple(i for _, i in members[name]))
        for name in order
    ]


def unpack_group_stats(row, groups: List[ModuleGroup]
                       ) -> Dict[str, Dict[str, float]]:
    """Host-side view of one ``[n_groups, n_stats]`` matrix as
    ``{group_name: {report_field: value}}`` (rms from the wire sums)."""
    m = np.asarray(row, np.float64).reshape(len(groups), N_NUMERICS_STATS)
    out: Dict[str, Dict[str, float]] = {}
    for g, group in enumerate(groups):
        n = max(group.n_elems, 1)
        out[group.name] = {
            "grad_rms": float(np.sqrt(m[g, NUMERICS_INDEX["grad_sumsq"]] / n)),
            "grad_absmax": float(m[g, NUMERICS_INDEX["grad_absmax"]]),
            "nonfinite": float(m[g, NUMERICS_INDEX["grad_nonfinite"]]),
            "param_rms": float(
                np.sqrt(m[g, NUMERICS_INDEX["param_sumsq"]] / n)),
            "update_rms": float(
                np.sqrt(m[g, NUMERICS_INDEX["update_sumsq"]] / n)),
        }
    return out


def provenance_of(row, groups: List[ModuleGroup]
                  ) -> Optional[Dict[str, Any]]:
    """First offending (group, field) of one stats matrix, or None when
    every value is finite: ``grad`` (a non-finite gradient element, or a
    non-finite sum), then ``param``, then ``update``."""
    m = np.asarray(row, np.float64).reshape(len(groups), N_NUMERICS_STATS)
    for g, group in enumerate(groups):
        if (m[g, NUMERICS_INDEX["grad_nonfinite"]] > 0
                or not np.isfinite(m[g, NUMERICS_INDEX["grad_sumsq"]])):
            field = "grad"
        elif not np.isfinite(m[g, NUMERICS_INDEX["param_sumsq"]]):
            field = "param"
        elif not np.isfinite(m[g, NUMERICS_INDEX["update_sumsq"]]):
            field = "update"
        else:
            continue
        return {"group": g, "name": group.name, "field": field,
                "nonfinite_elems": float(
                    m[g, NUMERICS_INDEX["grad_nonfinite"]])}
    return None


# --------------------------------------------------------------------------- #
# quantization-error attribution (wire and serving weights)
# --------------------------------------------------------------------------- #


@torch.no_grad()
def wire_residual_group_norms(transport, comm_state: Optional[Dict[str, Any]],
                              groups: List[ModuleGroup],
                              sizes: Sequence[int]
                              ) -> Optional[Dict[str, float]]:
    """Per-group norm of the error-feedback residual: the quantization
    error a transport carries per layer. ``sizes`` are the leaves' element
    counts in the JAX order (the transport's layout).

    The port keeps the residual as one padded fp32 buffer a bucket. The
    replicated transport holds whole buckets, so each leaf's slice is
    exact; the sharded one holds 1/W of each bucket a rank, whose norm^2
    (summed over the ranks) is spread over the bucket's leaves by element
    share, as the JAX package spreads its sharded residual. None without
    a residual."""
    residual = (comm_state or {}).get("residual")
    if not residual:
        return None
    layout = transport._layout(list(sizes))
    leaf_group = {j: g.name for g in groups for j in g.leaf_indices}
    group_sq = {g.name: 0.0 for g in groups}
    if transport.layout_kind == "sharded":
        sq = torch.stack([r.float().pow(2).sum() for r in residual])
        if transport.world > 1:
            import torch.distributed as dist

            dist.all_reduce(sq, group=transport.group)
        sq = sq.cpu().numpy()
        for b, (indices, elems, _) in enumerate(layout.buckets):
            total = float(elems) or 1.0
            for j in indices:
                group_sq[leaf_group[j]] += float(sq[b]) * sizes[j] / total
    else:
        parts = []
        for b, (indices, _, _) in enumerate(layout.buckets):
            off = 0
            for j in indices:
                parts.append((j, residual[b][off:off + sizes[j]]))
                off += sizes[j]
        sq = torch.stack([p.float().pow(2).sum() for _, p in parts]).cpu()
        for (j, _), v in zip(parts, sq.tolist()):
            group_sq[leaf_group[j]] += v
    return {name: float(np.sqrt(v)) for name, v in group_sq.items()}


def quant_error_by_group(errors_by_path: Dict[str, Dict[str, float]],
                         groups: List[ModuleGroup],
                         paths: List[str]) -> Dict[str, Dict[str, float]]:
    """Fold per-leaf dequantization errors (``serving.quant.
    quantization_error``, by JAX path) into per-group worst cases: the
    largest relative rms and absolute error over the group's quantized
    leaves. ``paths`` are the leaves' JAX paths in the flatten order."""
    path_group: Dict[str, str] = {}
    for g in groups:
        for i in g.leaf_indices:
            if i < len(paths):
                path_group[paths[i]] = g.name
    out: Dict[str, Dict[str, float]] = {}
    for path, err in errors_by_path.items():
        name = path_group.get(path)
        if name is None:
            name = path.split("/", 1)[0]
        slot = out.setdefault(
            name, {"rel_rms": 0.0, "abs_err_max": 0.0, "leaves": 0})
        slot["rel_rms"] = max(slot["rel_rms"], float(err["rel_rms"]))
        slot["abs_err_max"] = max(slot["abs_err_max"],
                                  float(err["abs_err_max"]))
        slot["leaves"] += 1
    return out


def max_quant_error(by_group: Dict[str, Dict[str, float]]
                    ) -> Tuple[Optional[str], Optional[float]]:
    """``(group_name, rel_rms)`` of the worst-quantized group."""
    if not by_group:
        return None, None
    name = max(by_group, key=lambda k: by_group[k]["rel_rms"])
    return name, by_group[name]["rel_rms"]


# --------------------------------------------------------------------------- #
# the monitor
# --------------------------------------------------------------------------- #


class NumericsMonitor:
    """The host side of the observatory: unpacks the matrices the engine
    computed, derives provenance, publishes ``numerics/*`` gauges, builds
    the per-group JSONL block and ranks the groups for the summary (the
    JAX package's ``NumericsMonitor``)."""

    def __init__(self, cfg, registry, groups: List[ModuleGroup], *,
                 rank: int = 0):
        self.cfg = cfg
        self.registry = registry
        self.groups = list(groups)
        self.rank = int(rank)
        self.windows = 0
        self.last_step: Optional[int] = None
        self.last_per_group: Optional[Dict[str, Dict[str, float]]] = None
        self.last_provenance: Optional[Dict[str, Any]] = None
        self.wire_err: Optional[Dict[str, float]] = None
        self.quant_err: Optional[Dict[str, Dict[str, float]]] = None
        self._pending_provenance: List[Dict[str, Any]] = []
        self._provenance_events: List[Dict[str, Any]] = []
        self._warnings = 0
        self._grad_stats: Dict[str, _RunningStats] = {
            g.name: _RunningStats(alpha=0.1) for g in self.groups
        }
        registry.counter("numerics/windows_total",
                         help="group-stats matrices observed")
        registry.counter("numerics/provenance_total",
                         help="non-finite per-layer provenance events")

    def observe_window(self, first_step: int, rows) -> None:
        """Consume the matrices of one call (``[window, n_groups,
        n_stats]``, or one ``[n_groups, n_stats]``): provenance per row,
        the noise statistics, the latest per-group view."""
        rows = np.asarray(rows, np.float64)
        if rows.ndim == 2:
            rows = rows[None]
        for i in range(rows.shape[0]):
            step = int(first_step + i)
            self.windows += 1
            self.registry.counter("numerics/windows_total").inc()
            prov = provenance_of(rows[i], self.groups)
            if prov is not None:
                prov = {**prov, "step": step}
                self.registry.counter("numerics/provenance_total").inc()
                self._provenance_events.append(prov)
                del self._provenance_events[:-_RECENT_PROVENANCE_MAX]
                self.last_provenance = prov
                self._pending_provenance.append(prov)
                del self._pending_provenance[:-_RECENT_PROVENANCE_MAX]
                self._self_apply(prov)
            per_group = unpack_group_stats(rows[i], self.groups)
            for name, stats in per_group.items():
                if np.isfinite(stats["grad_rms"]):
                    self._grad_stats[name].update(stats["grad_rms"])
            self.last_step = step
            self.last_per_group = per_group
        self._publish_gauges()

    def _publish_gauges(self) -> None:
        if self.last_per_group is None:
            return
        g = self.registry.gauge
        for name, stats in self.last_per_group.items():
            g(f"numerics/{name}/grad_rms").set(stats["grad_rms"])
            g(f"numerics/{name}/update_rms").set(stats["update_rms"])
            g(f"numerics/{name}/nonfinite").set(stats["nonfinite"])
        if self.wire_err is not None:
            for name, v in self.wire_err.items():
                g(f"numerics/{name}/wire_residual_norm").set(v)
        prov = self.last_provenance
        g("numerics/provenance_group").set(
            float(prov["group"]) if prov is not None else -1.0)

    def _self_apply(self, prov: Dict[str, Any]) -> None:
        """Warn (bounded) when no health detector will drain the event."""
        if self.cfg.provenance_action == "record":
            return
        if self._warnings >= _MAX_PROVENANCE_WARNINGS:
            return
        self._warnings += 1
        warnings.warn(f"Stoke -- numerics: {describe_provenance(prov)}")

    def consume_provenance(self) -> Optional[Dict[str, Any]]:
        """Pop the oldest pending provenance event (FIFO, one a health
        observation)."""
        if not self._pending_provenance:
            return None
        return self._pending_provenance.pop(0)

    def observe_wire(self, group_norms: Optional[Dict[str, float]]) -> None:
        if group_norms is None:
            return
        self.wire_err = dict(group_norms)

    def set_quant_errors(self, by_group: Dict[str, Dict[str, float]]
                         ) -> None:
        self.quant_err = dict(by_group)
        g = self.registry.gauge
        for name, err in by_group.items():
            g(f"numerics/{name}/quant_err_rel_rms").set(err["rel_rms"])

    def event_fields(self) -> Dict[str, Any]:
        """The ``numerics/*`` block of one JSONL step event."""
        per_group = None
        if self.cfg.per_group_jsonl:
            per_group = {name: dict(stats) for name, stats in
                         (self.last_per_group or {}).items()}
            if self.wire_err is not None:
                for name, v in self.wire_err.items():
                    per_group.setdefault(name, {})["wire_err"] = v
            if self.quant_err is not None:
                for name, err in self.quant_err.items():
                    per_group.setdefault(name, {})["quant_err"] = (
                        err["rel_rms"])
            per_group = per_group or None
        prov = self.last_provenance
        q_layer, q_max = (max_quant_error(self.quant_err)
                          if self.quant_err is not None else (None, None))
        return {
            "numerics/groups": len(self.groups),
            "numerics/per_group": per_group,
            "numerics/provenance_group": (None if prov is None
                                          else prov["group"]),
            "numerics/provenance_name": (None if prov is None
                                         else prov["name"]),
            "numerics/provenance_field": (None if prov is None
                                          else prov["field"]),
            "numerics/quant_err_max": q_max,
            "numerics/quant_err_group": q_layer,
        }

    def grad_noise(self) -> Dict[str, float]:
        """Per-group gradient noise: the running coefficient of variation
        of the group's grad rms."""
        out = {}
        for name, stats in self._grad_stats.items():
            if stats.mean is None or stats.mean <= 0:
                out[name] = 0.0
            else:
                out[name] = float((stats.var ** 0.5) / stats.mean)
        return out

    def snapshot(self) -> Dict[str, Any]:
        """The bundle's ``numerics.json``."""
        return {
            "rank": self.rank,
            "step": self.last_step,
            "windows": self.windows,
            "groups": [g.name for g in self.groups],
            "group_elems": {g.name: g.n_elems for g in self.groups},
            "per_group": self.last_per_group,
            "grad_noise": self.grad_noise(),
            "wire_err": self.wire_err,
            "quant_err": self.quant_err,
            "provenance": self.last_provenance,
            "provenance_events": list(self._provenance_events),
        }

    def summary(self) -> Dict[str, Any]:
        """``Stoke.numerics_summary()``: groups ranked by gradient noise,
        quantization error and wire error, with the latest statistics."""
        top_k = max(int(self.cfg.top_k), 1)
        by_noise = sorted(self.grad_noise().items(), key=lambda kv: kv[1],
                          reverse=True)[:top_k]
        by_quant: List[Tuple[str, float]] = []
        if self.quant_err:
            by_quant = sorted(((n, e["rel_rms"])
                               for n, e in self.quant_err.items()),
                              key=lambda kv: kv[1], reverse=True)[:top_k]
        by_wire: List[Tuple[str, float]] = []
        if self.wire_err:
            by_wire = sorted(self.wire_err.items(), key=lambda kv: kv[1],
                             reverse=True)[:top_k]
        out = self.snapshot()
        out["top_grad_noise"] = [{"group": n, "noise": v}
                                 for n, v in by_noise]
        out["top_quant_err"] = [{"group": n, "rel_rms": v}
                                for n, v in by_quant]
        out["top_wire_err"] = [{"group": n, "residual_norm": v}
                               for n, v in by_wire]
        out["provenance_total"] = int(
            self.registry.counter("numerics/provenance_total").value)
        return out


def describe_provenance(prov: Dict[str, Any]) -> str:
    n = prov.get("nonfinite_elems") or 0
    detail = f" ({int(n)} non-finite gradient elements)" if n else ""
    return (
        f"non-finite {prov['field']} values first appear in module group "
        f"{prov['name']!r} (index {prov['group']}) at step "
        f"{prov.get('step', '?')}{detail}"
    )


class NumericsProvenanceDetector(Detector):
    """A fresh provenance event surfaces as a ``numerics_provenance``
    anomaly (action ``NumericsConfig.provenance_action``), stamped with
    the step the non-finite value appeared at."""

    name = "numerics_provenance"

    def __init__(self, monitor: NumericsMonitor, action: str = "warn"):
        super().__init__(action)
        self.monitor = monitor
        # the health pipeline warns; the monitor's own fallback would
        # report twice
        monitor._warnings = _MAX_PROVENANCE_WARNINGS

    def check(self, step, sentinels, ctx):
        event = self.monitor.consume_provenance()
        if event is None:
            return None
        anomaly = self._fire(
            int(event.get("step", step)),
            f"numerics provenance: {describe_provenance(event)}",
            value=float(event["group"]),
        )
        anomaly.context = dict(event)
        return anomaly
