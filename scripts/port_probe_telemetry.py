"""Probe of ``chip_smoke.py``'s telemetry phase on a CUDA card.

Run from the root of a checkout:
``python3 scripts/port_probe_telemetry.py``.
Builds ``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu`` and
``csrc/paged_decode.cu`` and runs ``chip_smoke.train_telemetry`` (GPT-base
bf16 with and without the telemetry, trace, health and profiler configs,
eager and in replayed windows; a NaN at a known step; ``profile_trace``;
the traced serve drive), printing the card and the phase's line. Exits
nonzero if the phase fails.
"""
import json
import sys

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from stoke_tpu_torch import ops  # noqa: E402
from stoke_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    print(json.dumps({"build": _build.build(["flash_fwd", "flash_bwd",
                                              "paged_decode"])}), flush=True)
    print(json.dumps({**cs.train_telemetry(ops), "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
