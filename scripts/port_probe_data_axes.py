"""Probe of ``chip_smoke.py``'s data-axes phase on a CUDA card.

Run from the root of a checkout:
``python3 scripts/port_probe_data_axes.py``. Builds ``csrc/flash_fwd.cu``
and ``csrc/flash_bwd.cu``, prints the card and the phase's line, and exits
nonzero if it fails.

``train_data_axes``: GPT-base bf16 under the 2-D rules (the Megatron set
with each kernel's other dim on the data axis) on a (1, 1) ``("data",
"model")`` mesh, bit for bit against the Megatron rules alone, eager and
replayed, then its sharded emergency tag resumed bit for bit; GPT-base
under ``("data", "seq")`` with ``pos_emb`` on seq and PipelinedLM under
``("data", "stage")`` with the embedding on stage, each bit for bit
against the run without that rule; one GPT-base block over 2 x 2
virtual (data, model) ranks in fp32 and bf16; step ms eager and
replayed, the peak's rise, the tag's bytes, save and load ms.
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
    print(json.dumps({"build": _build.build(["flash_fwd", "flash_bwd"])}),
          flush=True)
    out = cs.train_data_axes(ops)
    print(json.dumps({"probe": "train_data_axes", **out, "card": smi,
                      "seconds_total": time.perf_counter() - t0},
                     default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
