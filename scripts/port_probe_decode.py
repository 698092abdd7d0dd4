"""Probe of the paged-decode kernels on a CUDA card.

Run from the root of a checkout: ``python3 scripts/port_probe_decode.py``
(or, to time another checkout's kernels, from that checkout's root with
this script's path). Builds that checkout's ``csrc/paged_decode.cu`` and
prints ptxas's registers and spills of its kernels, then runs
``check_decode`` of the ``chip_smoke.py`` beside this script on the
checkout's ops: at ``DECODE_CASES`` (B=8 slots, H=12, 16-token pages,
32-entry tables; fp32 and bf16 pools, D=128, bf16 queries, a slot at
context 512, a slot at context 0) it holds
``paged_decode_attention_pallas`` against ``paged_decode_attention`` and
times it two ways: ``ms``, CUDA events around each call after a write
that evicts the L2 cache; ``graph_ms``, 50 calls replayed from one CUDA
graph between one event pair (L2 warm). Then, on fresh inputs of each
case's shapes, each CUDA kernel's device ms per call under
``torch.profiler`` (L2 evicted before each call). Last, ``serve`` of the
same ``chip_smoke.py`` on the checkout's package: GPT-base serving 16
requests through the decode kernels, checked, then profiled for the
decode kernels' device ms per launch (``decode_ms_per_launch``) and the
card's busy share. Prints the card's name and power limit last. Uses only
the package's public API, so it runs on any checkout of the port.
"""
import importlib.util
import json
import re
import sys
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, ".")
from stoke_tpu_torch import ops  # noqa: E402
from stoke_tpu_torch.ops import _build  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


def kernel_ms(fn, flush, calls=20):
    """Device ms per call of each CUDA kernel ``fn`` launches."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    return {re.search(r"paged_decode\w*", e.key).group(0):
            e.self_device_time_total / calls / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "paged_decode" in e.key}


def main():
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.main
    torch.backends.cudnn.allow_tf32 = False
    seconds = _build.build(["paged_decode"])
    # paged_decode_kernel: the one-block-a-slot kernel of older checkouts
    print(json.dumps({"build": seconds, "ptxas": smoke.ptxas_usage(
        _build.build_log("paged_decode") or "",
        ("paged_decode_kernel",) + smoke.DECODE_KERNELS)}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    rows = smoke.check_decode(ops, gen, flush)
    for row, (pool, q_dtype, D, last, first) in zip(rows, smoke.DECODE_CASES):
        args = smoke.decode_inputs(gen, pool, D, q_dtype, last, first)
        row["kernel_ms"] = kernel_ms(
            lambda: ops.paged_decode_attention_pallas(*args), flush)
        print(json.dumps(row), flush=True)
    del flush
    served = smoke.serve(ops)
    print(json.dumps({k: served[k] for k in (
        "tokens_per_s", "tpot_p50_s", "decode_steps", "launches",
        "streams_equal_plain")} | {k: served["profile"].get(k) for k in (
            "decode_ms_per_launch", "device_busy_share", "decode_kernels")}),
        flush=True)
    print(smoke.nvidia_smi_line(), flush=True)


if __name__ == "__main__":
    main()
