"""Probe of the paged-verify kernels and the sampler on a CUDA card.

Run from the root of a checkout: ``python3 scripts/port_probe_verify.py``
(or, to time another checkout's kernels, from that checkout's root with
this script's path). Builds the port's kernels, then at the speculative
serve shapes of ``chip_smoke.VERIFY_CASES`` (B=8 slots, H=12, 16-token
pages, 32-entry tables; fp32 and bf16 pools, D=128, S=16, bf16 queries, a
slot at position 511) holds ``paged_verify_attention_pallas`` against
``paged_verify_attention`` and times it three ways: ``ms``, CUDA events
around each call after a write that evicts the L2 cache; ``graph_ms``, 50
calls replayed from one CUDA graph between one event pair (L2 warm); and
each CUDA kernel's device ms per call under ``torch.profiler`` (L2
evicted before each call). Then checks that the sampler's threefry bits,
Gumbel values, targets and key stack on the card equal the CPU's, and
times the sampler. Uses only the package's public ops, so it runs on any
checkout of the port.
"""
import json
import re
import subprocess
import sys

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, ".")
from stoke_tpu_torch import ops  # noqa: E402
from stoke_tpu_torch.ops import _build  # noqa: E402
from stoke_tpu_torch.serving import sampling as S  # noqa: E402

FP32, BF16 = torch.float32, torch.bfloat16
HEADS = 12
# (pool dtype, q dtype, D, S, last slot's context), as chip_smoke's
CASES = ((FP32, FP32, 64, 5, 509), (BF16, FP32, 64, 5, 509),
         (FP32, FP32, 128, 5, 509), (FP32, FP32, 64, 16, 511),
         (BF16, BF16, 64, 5, 511))


def inputs(gen, pool_dtype, D, Sq, q_dtype, last_ctx):
    """``chip_smoke.verify_inputs``: slot 0 idle on an all-scratch table,
    the others at contexts 17 to ``last_ctx``, positions clamped to 511."""
    B, BS, MB = 8, 16, 32
    NB = B * MB + 1
    ctx = [0, 17, 64, 129, 250, 333, 480, last_ctx]
    positions = torch.tensor(
        [[s if b == 0 else min(c + s, MB * BS - 1) for s in range(Sq)]
         for b, c in enumerate(ctx)], dtype=torch.int32, device="cuda")
    perm = torch.randperm(NB - 1, generator=gen, device="cuda").to(
        torch.int32) + 1
    tables = torch.zeros(B, MB, dtype=torch.int32, device="cuda")
    for b in range(1, B):
        n = -(-int(positions[b].max() + 1) // BS)
        tables[b, :n] = perm[b * MB: b * MB + n]
    q = torch.randn(B, HEADS, Sq, D, generator=gen, device="cuda").to(q_dtype)
    kp, vp = (torch.randn(NB, BS, HEADS, D, generator=gen,
                          device="cuda").to(pool_dtype) for _ in range(2))
    return q, kp, vp, tables, positions


def time_ms(fn, iters, flush):
    for _ in range(3):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for s, e in ev:
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / iters


def graph_ms(fn, n=50):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def kernel_ms(fn, flush, calls=20):
    """Device ms per call of each CUDA kernel ``fn`` launches."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    return {re.search(r"paged_verify\w*", e.key).group(0):
            e.self_device_time_total / calls / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "paged_verify" in e.key}


def main():
    print(json.dumps({"build": _build.build()}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    for pool_dtype, q_dtype, D, Sq, last in CASES:
        args = inputs(gen, pool_dtype, D, Sq, q_dtype, last)
        out = ops.paged_verify_attention_pallas(*args)
        ref = ops.paged_verify_attention(*args)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        atol = 1e-4 if pool_dtype == q_dtype == FP32 else ops.FWD_ATOL_BF16
        if not (torch.isfinite(out).all() and err <= atol):
            raise AssertionError(f"verify {pool_dtype} {q_dtype} D={D} "
                                 f"S={Sq}: max |kernel - plain| {err}")

        def fn():
            return ops.paged_verify_attention_pallas(*args)

        print(json.dumps({
            "pool": str(pool_dtype)[6:], "q": str(q_dtype)[6:], "D": D,
            "S": Sq, "last_ctx": last, "max_abs_err": err,
            "ms": time_ms(fn, 100, flush), "graph_ms": graph_ms(fn),
            "kernel_ms": kernel_ms(fn, flush)}), flush=True)
    # sampler bits on the card equal the CPU's
    kd = np.stack([S.initial_key_data(i) for i in range(8)])
    c_cpu, s_cpu = S.split_key_data(S.key_data_to_device(kd))
    c_gpu, s_gpu = S.split_key_data(S.key_data_to_device(kd, "cuda"))
    bits_eq = torch.equal(S.random_bits(s_cpu, 50257),
                          S.random_bits(s_gpu, 50257).cpu())
    g_err = float((S.gumbel(s_cpu, 50257)
                   - S.gumbel(s_gpu, 50257).cpu()).abs().max())
    logits = torch.randn(8, 5, 50257) * 3
    kn = (torch.full((8,), 0.8), torch.full((8,), 50, dtype=torch.int32),
          torch.full((8,), 0.95))
    t_cpu, st_cpu = S.speculative_sample_tokens(
        logits, S.key_data_to_device(kd), *kn)
    t_gpu, st_gpu = S.speculative_sample_tokens(
        logits.cuda(), S.key_data_to_device(kd, "cuda"),
        *(x.cuda() for x in kn))
    # the sampler's card time from host key data, as the engine holds it
    knobs = tuple(x.cuda() for x in kn)
    dev_logits = logits.cuda()
    print(json.dumps({
        "bits_equal": bits_eq, "gumbel_max_diff": g_err,
        "targets_equal": torch.equal(t_cpu, t_gpu.cpu()),
        "keys_equal": torch.equal(st_cpu, st_gpu.cpu()),
        "sampler_ms": time_ms(lambda: S.speculative_sample_tokens(
            dev_logits, kd, *knobs), 20, flush)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
