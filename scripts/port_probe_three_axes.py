"""Probe of ``chip_smoke.py``'s three-axis phase on a CUDA card.

Run from the root of a checkout:
``python3 scripts/port_probe_three_axes.py``. Builds
``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu`` and ``csrc/quant.cu``,
prints the card and the phase's line, and exits nonzero if it fails.

``train_three_axes``: GPT-base-MoE top-1 bf16 under the Megatron and
expert rules on a (1, 1, 1) ``("data", "model", "expert")`` mesh with
fsdp and the int8 ``rs_ag`` transport, bit for bit against the 1-D data
mesh, eager and replayed, then its sharded emergency tag resumed bit for
bit; GPT-base under ``("data", "seq", "model")``, PipelinedLM under
``("data", "stage", "model")`` with a gathered qkv level and GPT-base
with two gathered placements, each bit for bit against the run without
the third axis; one GPT-base-MoE block over 2 x 2 virtual (model,
expert) ranks in fp32 and bf16; step ms eager and replayed, the peak's
rise, the tag's bytes, save and load ms.
"""
import json
import sys
import time

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from stoke_tpu_torch import ops  # noqa: E402
from stoke_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    print(json.dumps({"build": _build.build(
        ["flash_fwd", "flash_bwd", "quant"])}), flush=True)
    out = cs.train_three_axes(ops)
    print(json.dumps({"probe": "train_three_axes", **out, "card": smi,
                      "seconds_total": time.perf_counter() - t0},
                     default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
