"""Probe of ``chip_smoke.py``'s resilience and offload phases on a CUDA
card.

Run from the root of a checkout:
``python3 scripts/port_probe_resilience.py [train_resilience] [offload]``
(both by default). Builds ``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``
and ``csrc/quant.cu`` and runs the phases (GPT-base bf16: preemption,
emergency saves and verified resume in process and under the restart
supervisor, corrupt and partial tags, the staged snapshot and the async
save's stall, the elastic resume of a CPU world-2 tag; the optimizer
state's offload tiers), printing the card and each phase's line. Exits
nonzero if a phase fails.
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
                                              "quant"])}), flush=True)
    for name in sys.argv[1:] or ["train_resilience", "offload"]:
        print(json.dumps({**getattr(cs, name)(ops), "card": smi}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
