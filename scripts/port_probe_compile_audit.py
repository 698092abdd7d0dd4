"""Probe of ``chip_smoke.py``'s compile-cache and audit phase on a CUDA
card.

Run from the root of a checkout:
``python3 scripts/port_probe_compile_audit.py``. Builds the five sources
(one ``nvcc`` each, all at once), prints the card and the phase's line,
and exits nonzero if it fails.

``compile_audit``: the compile cache across two processes and within one,
GPT-base bf16 trained bit for bit with and without ``CompileConfig``,
``Stoke.audit()`` of that build and its serving engine (no findings, no
dispatch), a loss calling ``.item()`` firing ``audit-hidden-transfer``,
and the ``serve_decode`` sweep over the decode batch.
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
    print(json.dumps({"build": _build.build()}), flush=True)
    out = cs.compile_audit(ops)
    print(json.dumps({"probe": "compile_audit", **out, "card": smi,
                      "seconds_total": time.perf_counter() - t0},
                     default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
