"""Probe of ``chip_smoke.py``'s rematerialization and observatory phases
on a CUDA card.

Run from the root of a checkout:
``python3 scripts/port_probe_remat.py [train_remat] [observatories]``
(both by default). Builds ``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``,
``csrc/paged_decode.cu`` and ``csrc/paged_verify.cu`` and runs the phases
(GPT-base bf16 without and with ``remat=True``, bit for bit, with step ms
and peak device bytes, the engine's remat policies and the untied head;
the attribution, memory and numerics observatories against the same run
without them, and the serve and speculative traces with cost cards and
SLO targets), printing the card and each phase's line. Exits nonzero if
a phase fails.
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
                                              "paged_decode",
                                              "paged_verify"])}),
          flush=True)
    for name in sys.argv[1:] or ["train_remat", "observatories"]:
        print(json.dumps({**getattr(cs, name)(ops), "card": smi},
                         default=str), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
