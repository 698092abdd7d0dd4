"""Probe of ``chip_smoke.py``'s second-axis phase on a CUDA card.

Run from the root of a checkout:
``python3 scripts/port_probe_second_axis.py``. Builds
``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu`` and ``csrc/quant.cu``,
prints the card and the phase's line, and exits nonzero if it fails.

``train_second_axis``: GPT-base bf16 with the chunked head under oss, sddp
and fsdp with an int8 ``rs_ag`` transport on a (data=1, seq=1) mesh bit
for bit against the 1-D data mesh; GPT-base under the Megatron rules on a
(data=1, model=1) mesh with fsdp, an int8 transport and the sharded
format, resumed from an emergency save bit for bit; the chunked head over
2 and 4 virtual sequence shards and the transport's layout over 2 virtual
model ranks at GPT-base's widths; step ms eager and replayed, the peak's
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
    out = cs.train_second_axis(ops)
    print(json.dumps({"probe": "train_second_axis", **out, "card": smi,
                      "seconds_total": time.perf_counter() - t0},
                     default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
