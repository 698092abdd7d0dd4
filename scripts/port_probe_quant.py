"""Probe of ``chip_smoke.py``'s int8 phases on a CUDA card.

Run from the root of a checkout:

    python3 scripts/port_probe_quant.py [kernels] [train_comm] [serve_quant]
        [checkpoint_dp]

Builds ``csrc/quant.cu`` (and the attention kernels the phases run),
prints ptxas's report of the quantize pair, then runs the named phases of
``chip_smoke`` (default: all four), printing each phase's line: the
quantize and dequantize kernels against their plain versions
(``check_quant``), the gradient transports under every tier in a
one-process NCCL group (``train_comm``), int8 and bf16 serving weights
(``serve_quant``) and the checkpoints across the tiers and formats
(``checkpoint_dp``). Exits nonzero if a phase fails.
"""
import json
import sys

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from stoke_tpu_torch import ops  # noqa: E402
from stoke_tpu_torch.ops import _build  # noqa: E402

PHASES = ("kernels", "train_comm", "serve_quant", "checkpoint_dp")


def main() -> int:
    if not torch.cuda.is_available():
        print("port_probe_quant: no CUDA device", file=sys.stderr)
        return 1
    phases = sys.argv[1:] or PHASES
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        print(f"port_probe_quant: unknown phases {unknown}; valid: "
              f"{list(PHASES)}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    sources = ["quant"] + ([] if phases == ["kernels"] else
                           ["flash_fwd", "flash_bwd", "paged_decode"])
    print(json.dumps({"build": _build.build(sources),
                      "quant_ptxas": [
                          ln.strip() for ln in
                          (_build.build_log("quant") or "").splitlines()
                          if "registers" in ln or "spill" in ln
                          or "Function properties" in ln]}), flush=True)
    if "kernels" in phases:
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
        print(json.dumps({"phase": "kernels",
                          "quant": cs.check_quant(ops, gen, flush)}),
              flush=True)
        del flush
        torch.cuda.empty_cache()
    for name in ("train_comm", "serve_quant", "checkpoint_dp"):
        if name in phases:
            print(json.dumps(getattr(cs, name)(ops)), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
