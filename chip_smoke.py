#!/usr/bin/env python3
"""Drive the PyTorch port (``stoke_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits nonzero:

1. device: the card's name and power limit (``nvidia-smi``); TF32 is
   switched off for matmuls and cuDNN so float32 means float32.
2. build: compile the port's CUDA kernels from ``stoke_tpu_torch/csrc``.
3. kernels: each kernel against its plain PyTorch version at the serve
   path's shapes, with its time, the plain version's, the least time the
   card could take (``bound_ms``) and a PyTorch library call's where one
   computes the same function.
4. serve: GPT-base at full width (seeded random weights, fp32) behind
   ``ServingEngine`` with the flash prefill and paged-decode kernels;
   16 requests submitted in three waves; launch counts checked against
   the layers and steps; greedy streams held against the same engine on
   the plain attention path.

The two lines before the last are the kernels' summary and the card's
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): device memory bytes/s, and
# FLOP/s for the type the kernels' work is in (fp32 outside the tensor
# cores; bf16 on the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

FP32_ATOL = 1e-4  # kernel and plain version sum in different orders
SEED = 0
N_LAYERS, HEADS, HEAD_DIM = 12, 12, 64  # GPT "base"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"{torch.cuda.get_device_name(0)}, power.limit unknown ({e})"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` calls, each timed
    by CUDA events after a write that evicts the L2 cache (a serve step
    finds the previous layer's pages cold)."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def bound_ms(n_bytes: float, flops: float, dtype) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# --------------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------- #


def check_flash(ops, gen, flush) -> list:
    """Flash forward at the prefill shapes: B=1, H=12, D=64, causal with a
    prompt-padding key mask, L in {64, 320, 512}, fp32 and bf16. The L=64
    cases also mask key 0, which leaves query row 0 fully masked (LSE
    sentinel check)."""
    cases = []
    dev = torch.device("cuda")
    for L, plen in ((64, 41), (320, 301), (512, 400)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (
                torch.randn(1, HEADS, L, HEAD_DIM, generator=gen,
                            device=dev).to(dtype)
                for _ in range(3)
            )
            mask = (torch.arange(L, device=dev) < plen).to(torch.int32)[None]
            sentinel = L == 64
            if sentinel:
                mask[0, 0] = 0
            out, lse = ops.flash_attention(q, k, v, mask, causal=True,
                                           return_lse=True)
            ref_out, ref_lse = ops.flash_attention_plain(q, k, v, mask, True)
            torch.cuda.synchronize()
            atol = FP32_ATOL if dtype == torch.float32 else ops.FWD_ATOL_BF16
            err = max(max_err(out, ref_out), max_err(lse, ref_lse))
            if not (torch.isfinite(out).all() and err <= atol):
                raise AssertionError(
                    f"flash_fwd L={L} {dtype}: max |kernel - plain| {err} "
                    f"> {atol}"
                )
            if sentinel and not (
                bool((lse[:, :, 0] == ops.NEG_INF).all())
                and bool((out[:, :, 0] == 0).all())
            ):
                raise AssertionError("flash_fwd: fully masked row 0 is not "
                                     "O == 0, LSE == -1e30")
            # SDPA needs one boolean mask for causal and padding together
            allow = torch.tril(torch.ones(L, L, dtype=torch.bool, device=dev))
            allow = (allow & (mask[:, None, None, :] > 0))
            ms = time_ms(lambda: ops.flash_attention(q, k, v, mask,
                                                     causal=True), 50, flush)
            plain_ms = time_ms(
                lambda: ops.flash_attention_plain(q, k, v, mask, True), 20,
                flush)
            library_ms = time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=allow), 50, flush)
            # work this mask needs: row i attends keys j <= i with j valid
            keys = mask[0].cumsum(0).float()
            pairs = HEADS * float(keys.sum())
            flops = 4.0 * HEAD_DIM * pairs
            esize = q.element_size()
            n_bytes = (4 * L * HEADS * HEAD_DIM * esize  # q, k, v, o
                       + 4 * L + 4 * HEADS * L)          # mask, lse
            b_ms, b_by = bound_ms(n_bytes, flops, dtype)
            cases.append({
                "L": L, "prompt_len": plen, "dtype": str(dtype)[6:],
                "max_abs_err": err, "atol": atol, "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": b_ms, "bound_by": b_by,
            })
    return cases


def decode_inputs(gen, pool_dtype):
    """Decode inputs at the serve path's shapes: B=8 slots, H=12, D=64,
    16-token pages, 32-entry tables over the engine's pool of 8*32+1
    blocks; contexts mixed from 1 to 512, slot 0 inactive (context 1 on
    an all-scratch table), unused entries on scratch block 0."""
    dev = torch.device("cuda")
    B, BS, MB = 8, 16, 32
    NB = B * MB + 1
    ctx = torch.tensor([1, 17, 64, 129, 250, 333, 480, 512],
                       dtype=torch.int32, device=dev)
    perm = torch.randperm(NB - 1, generator=gen, device=dev).to(torch.int32) + 1
    tables = torch.zeros(B, MB, dtype=torch.int32, device=dev)
    for b in range(1, B):
        n = -(-int(ctx[b]) // BS)
        tables[b, :n] = perm[b * MB : b * MB + n]
    q = torch.randn(B, HEADS, 1, HEAD_DIM, generator=gen, device=dev)
    k_pages = torch.randn(NB, BS, HEADS, HEAD_DIM, generator=gen,
                          device=dev).to(pool_dtype)
    v_pages = torch.randn(NB, BS, HEADS, HEAD_DIM, generator=gen,
                          device=dev).to(pool_dtype)
    return q, k_pages, v_pages, tables, ctx


def check_decode(ops, gen, flush) -> list:
    cases = []
    for pool_dtype in (torch.float32, torch.bfloat16):
        q, kp, vp, tables, ctx = decode_inputs(gen, pool_dtype)
        out = ops.paged_decode_attention_pallas(q, kp, vp, tables, ctx)
        ref = ops.paged_decode_attention(q, kp, vp, tables, ctx)
        torch.cuda.synchronize()
        atol = FP32_ATOL if pool_dtype == torch.float32 else ops.FWD_ATOL_BF16
        err = max_err(out, ref)
        if not (torch.isfinite(out).all() and err <= atol):
            raise AssertionError(
                f"paged_decode pool {pool_dtype}: max |kernel - plain| "
                f"{err} > {atol}"
            )
        ms = time_ms(lambda: ops.paged_decode_attention_pallas(
            q, kp, vp, tables, ctx), 100, flush)
        plain_ms = time_ms(lambda: ops.paged_decode_attention(
            q, kp, vp, tables, ctx), 20, flush)
        tokens = float(ctx.sum())
        n_bytes = (2 * tokens * HEADS * HEAD_DIM * kp.element_size()
                   + 2 * q.numel() * q.element_size()
                   + tables.numel() * 4 + ctx.numel() * 4)
        flops = 4.0 * HEAD_DIM * HEADS * tokens
        b_ms, b_by = bound_ms(n_bytes, flops, torch.float32)
        cases.append({
            "B": q.shape[0], "pool_dtype": str(pool_dtype)[6:],
            "context_lens": [int(c) for c in ctx], "max_abs_err": err,
            "atol": atol, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        })
    return cases


# --------------------------------------------------------------------------- #
# phase 4: serve GPT-base through the kernels
# --------------------------------------------------------------------------- #


SERVE = dict(max_seqs=8, kv_block_size=16, max_seq_len=512,
             prefill_pad_multiple=64, max_new_tokens=32)


def drive(engine, prompts) -> tuple:
    """Submit ``prompts`` in three waves (8 up front, 4 after 4 steps, 4
    after 12) and run until drained. Returns (streams, wall seconds)."""
    t0 = time.perf_counter()
    rids = [engine.submit(p) for p in prompts[:8]]
    for _ in range(4):
        engine.step()
    rids += [engine.submit(p) for p in prompts[8:12]]
    for _ in range(8):
        engine.step()
    rids += [engine.submit(p) for p in prompts[12:]]
    engine.run()
    wall = time.perf_counter() - t0
    return [list(engine.result(r).tokens) for r in rids], wall


def top2_gap(model, prompt, prefix) -> float:
    """Top-1 minus top-2 logit of the next token after prompt + prefix, by
    the model's full-sequence forward (dense attention)."""
    ids = torch.tensor([list(prompt) + list(prefix)], device="cuda")
    with torch.inference_mode():
        logits = model(ids)[0, -1].float()
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def serve(ops) -> dict:
    from stoke_tpu_torch.configs import ServeConfig
    from stoke_tpu_torch.models.gpt import GPT
    from stoke_tpu_torch.serving import ServingEngine

    model = GPT(size_name="base", device="cuda")
    model.init_weights(SEED)
    weights = model.state_dict()
    rng = np.random.default_rng(SEED)
    lens = rng.integers(16, 401, size=16)
    prompts = [rng.integers(0, model.vocab_size, size=int(n)) for n in lens]
    kern_cfg = ServeConfig(attention="flash", decode_kernel="pallas", **SERVE)
    plain_cfg = ServeConfig(attention="dense", decode_kernel="reference",
                            **SERVE)

    # warm the allocator and the matmul libraries outside the measured run
    ServingEngine(model, weights, kern_cfg).generate([prompts[0][:16]], 2)

    engine = ServingEngine(model, weights, kern_cfg)
    ops.reset_launches()
    streams, wall = drive(engine, prompts)
    launches = dict(ops.LAUNCHES)
    summary = engine.summary()
    steps, prefills = summary["decode_steps"], summary["prefills"]
    if not all(launches.values()):
        raise AssertionError(f"a kernel was never launched: {launches}")
    if launches["paged_decode"] != N_LAYERS * steps:
        raise AssertionError(
            f"paged_decode launched {launches['paged_decode']} times, "
            f"expected {N_LAYERS} x {steps} decode steps"
        )
    if launches["flash_fwd"] != N_LAYERS * prefills:
        raise AssertionError(
            f"flash_fwd launched {launches['flash_fwd']} times, expected "
            f"{N_LAYERS} x {prefills} prefills"
        )
    if [len(s) for s in streams] != [SERVE["max_new_tokens"]] * 16:
        raise AssertionError(f"stream lengths {[len(s) for s in streams]}")

    plain = ServingEngine(model, weights, plain_cfg)
    plain_streams, plain_wall = drive(plain, prompts)
    diverged = []
    for i, (a, b) in enumerate(zip(streams, plain_streams)):
        if a == b:
            continue
        j = next(t for t, (x, y) in enumerate(zip(a, b)) if x != y)
        gap = top2_gap(model, prompts[i], a[:j])
        diverged.append({"request": i, "token": j, "top2_gap": gap})
        if gap > 1e-3:
            raise AssertionError(
                f"request {i} diverges from the plain path at token {j} "
                f"with top-2 logit gap {gap} > 1e-3"
            )
    return {
        "phase": "serve", "model": "GPT-base (12 x 768, 12 heads, ff 3072, "
        "vocab 50257), fp32, seeded random weights",
        "requests": 16, "prompt_lens": [int(n) for n in lens],
        "tokens_out": summary["tokens_out"], "wall_s": wall,
        "tokens_per_s": summary["tokens_out"] / wall,
        "ttft_p50_s": summary["ttft_p50_s"],
        "ttft_p99_s": summary["ttft_p99_s"],
        "tpot_p50_s": summary["tpot_p50_s"],
        "tpot_p99_s": summary["tpot_p99_s"],
        "decode_steps": steps, "prefills": prefills, "launches": launches,
        "plain_path_wall_s": plain_wall,
        "streams_equal_plain": 16 - len(diverged), "diverged": diverged,
    }


# --------------------------------------------------------------------------- #
# main
# --------------------------------------------------------------------------- #


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    try:
        from stoke_tpu_torch import ops
        from stoke_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run from the root of a stoke_tpu checkout ({e})",
              file=sys.stderr)
        return 1

    smi = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    seconds = _build.build()
    ptxas = {n: [ln.strip() for ln in (_build.build_log(n) or "").splitlines()
                 if "registers" in ln or "spill" in ln]
             for n in _build.SOURCES}
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas})

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    flash = check_flash(ops, gen, flush)
    decode = check_decode(ops, gen, flush)
    emit({"phase": "kernels", "card": smi, "flash_fwd": flash,
          "paged_decode": decode})

    served = serve(ops)
    emit(served)

    def row(name, cases, c, replaces):
        return {
            "name": name, "route": "cuda",
            "source": f"stoke_tpu_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": served["launches"][name],
            "max_abs_err": max(x["max_abs_err"] for x in cases),
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"],
        }

    flash_main = next(c for c in flash if c["L"] == 512
                      and c["dtype"] == "float32")
    emit({"kernels": [
        row("flash_fwd", flash, flash_main,
            "stoke_tpu/ops/flash_attention.py:70"),
        row("paged_decode", decode, decode[0],
            "stoke_tpu/ops/flash_attention.py:581"),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
