"""Probe of the tensor-core flash kernels on a CUDA card.

Run from the root of a checkout:
``python3 scripts/port_probe_flash_tc.py [--dtype {bf16,fp16,fp32}]``.
Builds ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``, prints ptxas's
registers and spills, then runs ``chip_smoke.py``'s kernels-phase cases in
the chosen dtype (bf16, the default, and fp16: the ``wgmma`` kernels;
fp32: the 3xTF32 ``mma.sync`` ones): the forward at the prefill shapes
(``FWD_SERVE_CASES``; not fp16, which serving does not use) and at the
training shapes (``FWD_BF16_CASES``, ``FWD_FP16_CASES`` or
``FWD_FP32_CASES``), then that dtype's ``BWD_CASES`` or
``BWD_FP16_CASES``; each held against its plain version at the same
tolerances and timed beside SDPA. Exits nonzero at the first case out of
tolerance.
"""
import argparse
import json
import sys

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from stoke_tpu_torch import ops  # noqa: E402
from stoke_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dtype", choices=("bf16", "fp16", "fp32"),
                        default="bf16",
                        help="the forward and backward cases to run")
    dtype = {"bf16": cs.BF16, "fp16": cs.FP16,
             "fp32": cs.FP32}[parser.parse_args().dtype]
    seconds = _build.build(["flash_fwd", "flash_bwd"])
    print(json.dumps({"build": seconds}), flush=True)
    for n in ("flash_fwd", "flash_bwd"):
        log = _build.build_log(n) or ""
        print(json.dumps({n: [ln.strip()[:160] for ln in log.splitlines()
                              if "Function properties" in ln
                              or "registers" in ln or "spill" in ln]}),
              flush=True)
    kernels = (cs.WGMMA_KERNELS + cs.FWD_TF32X3_KERNELS
               + cs.TF32X3_KERNELS)
    print(json.dumps({"ptxas": {
        **cs.ptxas_usage(_build.build_log("flash_fwd") or "", kernels),
        **cs.ptxas_usage(_build.build_log("flash_bwd") or "", kernels)}}),
        flush=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    for L, plen in cs.FWD_SERVE_CASES if dtype != cs.FP16 else ():
        print(json.dumps(cs.flash_fwd_serve_case(ops, gen, flush, L, plen,
                                                 dtype)), flush=True)
    fwd_cases = {cs.FP32: cs.FWD_FP32_CASES, cs.BF16: cs.FWD_BF16_CASES,
                 cs.FP16: cs.FWD_FP16_CASES}[dtype]
    for case in fwd_cases:
        print(json.dumps(cs.flash_fwd_case(ops, gen, flush, *case,
                                           dtype=dtype)), flush=True)
    for case in cs.BWD_CASES + cs.BWD_FP16_CASES:
        if case[1] == dtype:
            print(json.dumps(cs.flash_bwd_case(ops, gen, flush, *case)),
                  flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
