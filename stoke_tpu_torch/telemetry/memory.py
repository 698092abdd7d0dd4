"""The device-memory observatory: a per-subsystem ledger, the OOM
pre-flight and per-program peaks (the port's counterpart of
``stoke_tpu/telemetry/memory.py``).

- **Resident ledger**: the device bytes of each subsystem, read from the
  tensors the run holds (each storage counted once): ``params`` (the
  model's parameters and buffers, a sharding tier's slices, and the
  accumulated gradients while a window is open), ``opt_state`` (the
  optimizer's state on the device: 0 for what the host or disk tier
  keeps, plus the host tier's streaming buffer), ``transport`` (the
  error-feedback residual), ``kv_cache`` (a serving engine's page pool)
  and ``snapshot`` (in-flight staged snapshots, and the copy of the
  parameters the engine keeps between steps for the sentinels' and the
  numerics' update norms, or fp16's skip; the JAX package's program keeps
  that copy as an XLA temporary). ``resident`` is their exact sum.
- **Program peaks**: XLA's ``memory_analysis`` has no counterpart before
  a run, so the port measures a program at its first run of a signature:
  the caching allocator's peak (``torch.cuda.reset_peak_memory_stats``
  first, so a caller reading its own peak must read it before) above the
  bytes allocated when it started is its ``temp_bytes``; a captured
  window adds its graph pool (the allocator's reserved bytes the capture
  took). On the CPU there is no allocator to read: no program peaks,
  ``temp_peak_bytes`` None (the JAX package reports XLA's numbers there).
- **OOM pre-flight**: predicted peak = resident + the largest program
  temp, against the device's capacity (``torch.cuda.mem_get_info``
  through :func:`~stoke_tpu_torch.telemetry.collectors.hbm_stats`, or
  ``MemoryConfig.capacity_bytes``); warns naming the largest components.
- **Reconciliation**: ``mem/unattributed_bytes`` = the allocator's bytes
  in use minus the ledger (None on the CPU).
- **Serve headroom**: ``serve/mem_headroom_bytes``, the KV pool's free
  bytes minus the worst-case blocks to completion of every request in
  flight (the serving engine computes it).

The ``mem/*`` block is the JAX package's wire format.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

from stoke_tpu_torch.telemetry.collectors import hbm_stats

#: the ``mem/*`` JSONL field block
MEM_FIELDS = (
    "mem/params_bytes",
    "mem/opt_state_bytes",
    "mem/transport_bytes",
    "mem/kv_cache_bytes",
    "mem/snapshot_bytes",
    "mem/resident_bytes",
    "mem/temp_peak_bytes",
    "mem/predicted_peak_bytes",
    "mem/capacity_bytes",
    "mem/headroom_bytes",
    "mem/unattributed_bytes",
)

#: the ledger's components, in emission order; ``resident`` is their sum
LEDGER_COMPONENTS: Tuple[str, ...] = (
    "params", "opt_state", "transport", "kv_cache", "snapshot",
)

#: the remedy the pre-flight names for each component
_COMPONENT_REMEDIES = {
    "params": "shard the parameters (fsdp=True) or serve quantized "
              "weights (ServeConfig.quant)",
    "opt_state": "shard the optimizer state (oss / sddp / fsdp) or offload "
                 "it (OffloadOptimizerConfig, OffloadDiskConfig)",
    "transport": "use the sharded transport (CommConfig shard_updates: "
                 "the residual drops to 1/world per device)",
    "kv_cache": "lower ServeConfig.kv_blocks / max_seqs / max_seq_len",
    "snapshot": "stage fewer saves at once or checkpoint less often",
}


def tensors_resident_bytes(tensors: Iterable[Any],
                           device: Optional[torch.device] = None) -> int:
    """Device bytes of the tensors among ``tensors`` (``None`` and other
    leaves skipped) that live on ``device`` (any non-CPU device by
    default; the CPU itself when ``device`` is the CPU), each storage
    counted once: views and tied weights share one."""
    seen = set()
    total = 0
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            continue
        if device is not None:
            # "cuda" holds the tensors of "cuda:0"
            if t.device.type != device.type or (
                    device.index is not None
                    and t.device.index != device.index):
                continue
        elif t.device.type == "cpu":
            continue
        storage = t.untyped_storage()
        key = (storage.data_ptr(), t.device)
        if storage.nbytes() == 0 or key in seen:
            continue
        seen.add(key)
        total += storage.nbytes()
    return int(total)


class MemoryObservatory:
    """The device-memory ledger of one run (a ``Stoke`` or a serving
    engine). Owners register components as zero-argument byte callables
    (:meth:`set_component`) and run each program's first call under
    :meth:`measure`; the telemetry reads :meth:`event_fields` and
    :meth:`refresh_gauges`, ``Stoke.memory_summary`` and
    ``ServingEngine.summary()`` read :meth:`summary`."""

    def __init__(self, cfg, registry, device: Optional[torch.device] = None):
        self.cfg = cfg
        self.registry = registry
        self.device = torch.device(device) if device is not None else None
        self._components: Dict[str, Callable[[], int]] = {}
        #: per-program memory cards (program -> dict)
        self.program_mem: Dict[str, Dict[str, float]] = {}
        self._seen: set = set()
        self._serve_headroom: Optional[float] = None
        self._capacity: Optional[int] = None
        #: pre-flight verdicts by context ("build" / "serve")
        self.preflights: Dict[str, Dict[str, Any]] = {}

    @property
    def _cuda(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    # ------------------------------ ledger ------------------------------ #

    def set_component(self, name: str, fn: Callable[[], int]) -> None:
        if name not in LEDGER_COMPONENTS:
            raise ValueError(
                f"unknown memory-ledger component {name!r} "
                f"(known: {LEDGER_COMPONENTS})"
            )
        self._components[name] = fn

    def ledger(self) -> Dict[str, Optional[int]]:
        """Bytes per registered component (None for unregistered ones)
        and ``resident``, their exact sum."""
        out: Dict[str, Optional[int]] = {}
        resident = 0
        for name in LEDGER_COMPONENTS:
            fn = self._components.get(name)
            if fn is None:
                out[name] = None
                continue
            try:
                nbytes = int(fn())
            except Exception:
                # a component racing its owner (a snapshot resolving) must
                # not kill the telemetry: 0 this window
                nbytes = 0
            out[name] = nbytes
            resident += nbytes
        out["resident"] = resident
        return out

    def resident_bytes(self) -> int:
        return self.ledger()["resident"]

    # ------------------------- program peaks ---------------------------- #

    def wants(self, program: str, sig) -> bool:
        """Whether the next run of ``(program, sig)`` is its first
        (measured by :meth:`measure`)."""
        return (self.cfg.program_peaks and self._cuda
                and (program, sig) not in self._seen)

    @contextlib.contextmanager
    def measure(self, program: str, sig):
        """Run the block as one call of ``(program, sig)``; its first run
        on the card records the program's memory card: ``argument_bytes``
        (allocated when it started), ``peak_bytes`` (the allocator's peak
        during it), ``temp_bytes`` (the peak above the start) and
        ``output_bytes`` (what it left allocated)."""
        if not self.wants(program, sig):
            yield
            return
        self._seen.add((program, sig))
        torch.cuda.synchronize(self.device)
        before = torch.cuda.memory_allocated(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        yield
        torch.cuda.synchronize(self.device)
        peak = torch.cuda.max_memory_allocated(self.device)
        after = torch.cuda.memory_allocated(self.device)
        self.program_mem[program] = {
            "argument_bytes": float(before),
            "output_bytes": float(max(after - before, 0)),
            "temp_bytes": float(max(peak - before, 0)),
            "alias_bytes": 0.0,
            "generated_code_bytes": 0.0,
            "peak_bytes": float(peak),
        }

    def note_graph_pool(self, program: str, nbytes: int) -> None:
        """A captured window's graph pool (the reserved bytes its capture
        took), kept with the program's card."""
        card = self.program_mem.setdefault(program, {})
        card["graph_pool_bytes"] = float(nbytes)

    def temp_peak_bytes(self) -> Optional[float]:
        """The largest temp over the measured programs (they never run at
        once: the max, not the sum)."""
        temps = [m.get("temp_bytes") for m in self.program_mem.values()
                 if m.get("temp_bytes") is not None]
        return max(temps) if temps else None

    # --------------------------- capacity ------------------------------- #

    def _stats(self) -> Optional[Dict[str, int]]:
        return hbm_stats(self.device) if self._cuda else None

    def capacity_bytes(self, stats: Optional[Dict[str, int]] = None
                       ) -> Optional[int]:
        """``MemoryConfig.capacity_bytes``, else the card's total memory
        (read once: it does not change), else None (the CPU)."""
        if self.cfg.capacity_bytes is not None:
            return int(self.cfg.capacity_bytes)
        if self._capacity is None:
            stats = stats if stats is not None else self._stats()
            if stats and stats.get("bytes_limit"):
                self._capacity = int(stats["bytes_limit"])
        return self._capacity

    def predicted_peak_bytes(self) -> int:
        return int(self.resident_bytes() + (self.temp_peak_bytes() or 0))

    def headroom_bytes(self) -> Optional[int]:
        cap = self.capacity_bytes()
        if cap is None:
            return None
        return int(cap - self.predicted_peak_bytes())

    def unattributed_bytes(self, resident: Optional[int] = None,
                           stats: Optional[Dict[str, int]] = None
                           ) -> Optional[int]:
        """The allocator's bytes in use minus the ledger (None on the
        CPU)."""
        stats = stats if stats is not None else self._stats()
        if not stats or stats.get("bytes_in_use") is None:
            return None
        if resident is None:
            resident = self.resident_bytes()
        return int(stats["bytes_in_use"] - resident)

    # --------------------------- pre-flight ----------------------------- #

    def preflight(self, context: str = "build") -> Dict[str, Any]:
        """Predicted peak against capacity before the first dispatch; warns
        naming the largest components and their remedies when it crosses
        ``oom_margin_frac`` of capacity."""
        ledger = self.ledger()
        resident = ledger["resident"]
        temp = self.temp_peak_bytes()
        predicted = int(resident + (temp or 0))
        capacity = self.capacity_bytes()
        contributors = sorted(
            ((name, nbytes) for name, nbytes in ledger.items()
             if name in LEDGER_COMPONENTS and nbytes),
            key=lambda kv: kv[1], reverse=True)
        verdict: Dict[str, Any] = {
            "context": context, "fired": False, "resident_bytes": resident,
            "temp_peak_bytes": temp, "predicted_peak_bytes": predicted,
            "capacity_bytes": capacity, "contributors": contributors,
        }
        if (self.cfg.preflight and capacity is not None
                and predicted > self.cfg.oom_margin_frac * capacity):
            verdict["fired"] = True
            top = "; ".join(
                f"{name}={nbytes / 2**20:.1f} MiB "
                f"(remedy: {_COMPONENT_REMEDIES[name]})"
                for name, nbytes in contributors[:3]
            ) or "no ledgered components"
            warnings.warn(
                f"Stoke -- OOM pre-flight at {context}: predicted peak "
                f"{predicted / 2**20:.1f} MiB (resident "
                f"{resident / 2**20:.1f} MiB + program temp "
                f"{(temp or 0) / 2**20:.1f} MiB) exceeds "
                f"{self.cfg.oom_margin_frac:.0%} of the "
                f"{capacity / 2**20:.1f} MiB device capacity.  Largest "
                f"contributors: {top}"
            )
        self.preflights[context] = verdict
        return verdict

    # ------------------------- serve headroom --------------------------- #

    def note_serve_headroom(self, headroom_bytes: Optional[float]) -> None:
        self._serve_headroom = headroom_bytes

    def serve_event_fields(self) -> Dict[str, Any]:
        return {"serve/mem_headroom_bytes": self._serve_headroom}

    # ------------------------------ outputs ----------------------------- #

    def refresh_gauges(self, fields: Optional[Dict[str, Any]] = None
                       ) -> None:
        """Publish ``fields`` (default: :meth:`event_fields`) and the serve
        headroom as gauges."""
        reg = self.registry
        if fields is None:
            fields = self.event_fields()
        for name, v in fields.items():
            if v is not None:
                reg.gauge(name).set(v)
        if self._serve_headroom is not None:
            reg.gauge("serve/mem_headroom_bytes").set(self._serve_headroom)

    def event_fields(self) -> Dict[str, Any]:
        """The ``mem/*`` block of one step event, from one read of the
        ledger and one of the allocator."""
        ledger = self.ledger()
        resident = ledger["resident"]
        temp = self.temp_peak_bytes()
        predicted = int(resident + (temp or 0))
        stats = self._stats()
        capacity = self.capacity_bytes(stats)
        return {
            "mem/params_bytes": ledger["params"],
            "mem/opt_state_bytes": ledger["opt_state"],
            "mem/transport_bytes": ledger["transport"],
            "mem/kv_cache_bytes": ledger["kv_cache"],
            "mem/snapshot_bytes": ledger["snapshot"],
            "mem/resident_bytes": resident,
            "mem/temp_peak_bytes": temp,
            "mem/predicted_peak_bytes": predicted,
            "mem/capacity_bytes": capacity,
            "mem/headroom_bytes": (None if capacity is None
                                   else int(capacity - predicted)),
            "mem/unattributed_bytes": self.unattributed_bytes(resident,
                                                              stats),
        }

    def summary(self) -> Dict[str, Any]:
        """Components ranked by bytes, the resident total, the program
        cards and the pre-flight verdicts."""
        ledger = self.ledger()
        ranked = sorted(
            ((name, nbytes) for name, nbytes in ledger.items()
             if name in LEDGER_COMPONENTS and nbytes is not None),
            key=lambda kv: kv[1], reverse=True)
        return {
            "active": True,
            "components": {name: nbytes for name, nbytes in ranked},
            "resident_bytes": ledger["resident"],
            "temp_peak_bytes": self.temp_peak_bytes(),
            "predicted_peak_bytes": self.predicted_peak_bytes(),
            "capacity_bytes": self.capacity_bytes(),
            "headroom_bytes": self.headroom_bytes(),
            "unattributed_bytes": self.unattributed_bytes(),
            "serve_headroom_bytes": self._serve_headroom,
            "programs": {program: dict(stats) for program, stats
                         in sorted(self.program_mem.items())},
            "preflights": dict(self.preflights),
        }
