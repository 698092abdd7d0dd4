"""Probe of ``chip_smoke.py``'s data-parallel phase on a CUDA card.

Run from the root of a checkout: ``python3 scripts/port_probe_dp.py``.
Builds ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` and runs
``chip_smoke.train_dp`` in a one-process NCCL group (GPT-base fp32 parity
per tier, GPT-base bf16 at full width per tier eagerly and replayed,
ResNet-50 from the dp_oss_sddp flags), printing its line. Exits nonzero
if the phase fails.
"""
import json
import sys

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from stoke_tpu_torch import ops  # noqa: E402
from stoke_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("port_probe_dp: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    print(json.dumps({"build": _build.build(["flash_fwd", "flash_bwd"])}),
          flush=True)
    print(json.dumps(cs.train_dp(ops)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
