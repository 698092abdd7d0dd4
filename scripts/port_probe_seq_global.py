"""Probe of ``chip_smoke.py``'s global-view phase on a CUDA card.

Run from the root of a checkout:
``python3 scripts/port_probe_seq_global.py``. Builds
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``, prints the card and the
phase's line, and exits nonzero if it fails.

``train_seq_global``: GPT-base bf16 on a (data=1, seq=1) mesh without
``shard_seq_dim`` (the global view) through ring, zigzag and Ulysses,
3 eager steps, a window and 2 replays, bit for bit against flash
attention; then every block's attention through the global view's
boundary over 4 virtual shards in one process, one forward and backward
against one flash call over the whole sequence.
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
    out = cs.train_seq_global(ops)
    print(json.dumps({"probe": "train_seq_global", **out, "card": smi,
                      "seconds_total": time.perf_counter() - t0},
                     default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
