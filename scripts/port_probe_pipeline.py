"""Probe of ``chip_smoke.py``'s pipeline-parallel phase on a CUDA card.

Run from the root of a checkout:
``python3 scripts/port_probe_pipeline.py [PHASE ...]``, each PHASE one of
``train_pipeline`` (the smoke's phase, the default), ``train_tp_ep``
(the tensor- and expert-parallel phase alone, whose runs' peaks are the
rise above the allocation at each run's start) and ``pipe_trace``.
Builds ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` and prints the card
and each phase's line. Exits nonzero if a phase fails.

- ``train_pipeline``: PipelinedLM at GPT-base width bf16, GPipe and
  circular with remat, at world 1 under ``pipeline_parallel_rules`` on a
  (data=1, stage=1) mesh bit for bit against the run without; S = 2 and 4
  virtual stages against the unsplit stack in fp32 and bf16; step ms
  eager and replayed, the peak's rise, the schedules' ticks.
- ``pipe_trace``: PipelinedLM GPipe at GPT-base width (bf16, B=8,
  L=1024, M=4) after two warm steps: one profiled eager ``train_step``
  and one profiled replayed one-step window (``chip_smoke.profile_step``:
  device ms by kernel, busy share), each step's device ms by class
  (GEMMs, softmax, the rest).
"""
import re
import json
import sys
import time

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from stoke_tpu_torch import ops  # noqa: E402
from stoke_tpu_torch.ops import _build  # noqa: E402


#: kernel name patterns of each class, the first match wins
CLASSES = (("gemm", r"gemm|xmma|cutlass|sm90_|nvjet"),
           ("softmax", r"softmax"))


def by_class(profile: dict) -> dict:
    """The profile's device ms by kernel class (its top rows)."""
    out = {name: 0.0 for name, _ in CLASSES}
    out["rest"] = 0.0
    for row in profile.get("top", []):
        name = next((c for c, rx in CLASSES
                     if re.search(rx, row["name"], re.I)), "rest")
        out[name] += row["ms"]
    return out


def pipe_trace(ops) -> dict:
    batches = cs.window_batches(4)
    s = cs.stoke_for(cs.pipelined_lm(), "bf16", cs.TRAIN_BATCH,
                     seed=cs.SEED)
    for i in range(2):
        float(s.train_step(batches[i], batches[i]))
    eager = cs.profile_step(
        lambda: float(s.train_step(batches[2], batches[2])))
    one = batches[3:4]
    for _ in range(2):  # the eager window, then the capture
        s.train_steps(one, one)
    replay = cs.profile_step(lambda: s.train_steps(one, one))
    out = {}
    for name, prof in (("eager", eager), ("replay", replay)):
        out[name] = {k: prof.get(k) for k in (
            "wall_ms", "device_ms", "device_busy_share", "kernels",
            "launches", "top")}
        out[name]["top12_ms_by_class"] = by_class(prof)
    out["windows_captured"] = len(s._engine._windows)
    del s
    return out


PROBES = {"pipe_trace": pipe_trace}


def main() -> int:
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    print(json.dumps({"build": _build.build(["flash_fwd", "flash_bwd"])}),
          flush=True)
    for name in sys.argv[1:] or ["train_pipeline"]:
        out = (cs.train_pipeline(ops, t0) if name == "train_pipeline"
               else (PROBES.get(name) or getattr(cs, name))(ops))
        print(json.dumps({"probe": name, **out, "card": smi}, default=str),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
