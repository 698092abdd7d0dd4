"""Probe of ``chip_smoke.py``'s fleet / ops plane and sequence-parallel
phases on a CUDA card.

Run from the root of a checkout:
``python3 scripts/port_probe_seqpar.py [PHASE ...]``, each PHASE one of
``fleet_ops`` and ``train_seqpar`` (the smoke's phases, both by default),
``thread_profile`` and ``ring_trace``. Builds ``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu`` and ``csrc/paged_decode.cu`` and prints the card and
each phase's line. Exits nonzero if a phase fails.

- ``fleet_ops``: GPT-base bf16 without and with the fleet monitor and the
  ops plane, bit for bit, every endpoint scraped, a /profile capture and
  the serve trace behind the plane.
- ``train_seqpar``: ring, zigzag and Ulysses at world 1 bit for bit
  against flash attention, and S=4 virtual ring shards of L=4096 against
  one flash call.
- ``thread_profile``: a ``torch.profiler`` capture started, slept through
  and stopped on another thread (the JAX plane's way) while this thread
  trains GPT-base: which of the flash kernels and of the training
  thread's operators its trace holds.
- ``ring_trace``: one warmed pass of the virtual ring, the zigzag ring
  and the whole-sequence flash call under ``torch.profiler``: the
  kernels' busy time (the union of their intervals) against the pass's
  host time, and the launches the pass made.
"""
import json
import os
import sys
import tempfile
import threading
import time

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from stoke_tpu_torch import ops  # noqa: E402
from stoke_tpu_torch.ops import _build  # noqa: E402


def _trace_events(prof) -> list:
    """The chrome trace's events of a stopped profiler."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def thread_profile(ops) -> dict:
    """GPT-base bf16 eager ``train_step``s on this thread while another
    thread runs ``AttributionMonitor.manual_capture(1.0)`` without a step
    driver: the profiler started there, a sleep, the stop and export. The
    trace's count of each flash kernel's name and whether it holds the
    training thread's operators."""
    from stoke_tpu_torch.configs import AttributionConfig
    from stoke_tpu_torch.telemetry.attribution import AttributionMonitor
    from stoke_tpu_torch.telemetry.registry import MetricsRegistry

    with tempfile.TemporaryDirectory() as d:
        mon = AttributionMonitor(
            AttributionConfig(**cs.OBS_PEAKS, auto_capture=False,
                              max_captures=1),
            MetricsRegistry(), trace_dir=d, cuda=True)
        s = cs.stoke_for(cs.gpt_base("flash"), "bf16", cs.TRAIN_BATCH,
                         seed=cs.SEED)
        batches = cs.window_batches(4)
        for i in range(2):   # warm
            float(s.train_step(batches[i], batches[i]))
        got = {}
        t = threading.Thread(
            target=lambda: got.update(mon.manual_capture(1.0)), daemon=True)
        steps, t0 = 0, time.perf_counter()
        t.start()
        while t.is_alive() and steps < 200:
            b = batches[steps % len(batches)]
            float(s.train_step(b, b))
            steps += 1
        t.join(60)
        path = os.path.join(str(got.get("trace_dir")),
                            "stoke.rank0.pt.trace.json")
        events = []
        if os.path.exists(path):
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        names = [e.get("name", "") for e in events]
        main_tid = threading.get_native_id()
        out = {"capture": got, "steps": steps,
               "seconds": time.perf_counter() - t0,
               "kernels": {k: sum(k in n for n in names)
                           for k in cs.WGMMA_KERNELS},
               "gpu_kernels": sum(e.get("cat") == "kernel" for e in events),
               "training_thread_ops": sum(
                   e.get("cat") == "cpu_op" and e.get("tid") == main_tid
                   for e in events),
               "cpu_ops": sum(e.get("cat") == "cpu_op" for e in events),
               "events": len(events)}
        del s
    torch.cuda.empty_cache()
    return out


def _busy_ms(events) -> float:
    """The union of the kernels' intervals, in ms."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "kernel")
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3


def ring_trace(ops) -> dict:
    """One warmed pass of each of the virtual ring, the virtual zigzag
    ring and the whole-sequence flash call under ``torch.profiler`` (CPU
    and CUDA): the kernels' busy ms, the pass's host ms under the profiler
    and without it, the device's idle share and the kernel launches."""
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 19)
    out = {}
    for name in ("ring", "zigzag", "whole_flash"):
        inp = cs.virtual_ring_inputs(gen, name == "zigzag")
        run = ((lambda: cs.whole_flash_pass(ops, inp))
               if name == "whole_flash" else
               (lambda: cs.virtual_ring_pass(inp)))
        run()
        plain_ms = cs.timed_ms(run)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            traced_ms = cs.timed_ms(run)
        events = _trace_events(prof)
        busy = _busy_ms(events)
        out[name] = {"host_ms": plain_ms, "host_ms_profiled": traced_ms,
                     "kernel_busy_ms": busy,
                     "idle_share": 1.0 - busy / traced_ms,
                     "kernels": sum(e.get("cat") == "kernel"
                                    for e in events),
                     "flash_kernels": {k: sum(k in e.get("name", "")
                                              for e in events)
                                       for k in cs.WGMMA_KERNELS}}
    return out


PROBES = {"thread_profile": thread_profile, "ring_trace": ring_trace}


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    print(json.dumps({"build": _build.build(["flash_fwd", "flash_bwd",
                                              "paged_decode"])}),
          flush=True)
    for name in sys.argv[1:] or ["fleet_ops", "train_seqpar"]:
        fn = PROBES.get(name) or getattr(cs, name)
        print(json.dumps({"probe": name, **fn(ops), "card": smi},
                         default=str), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
