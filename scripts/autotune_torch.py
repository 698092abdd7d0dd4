"""Telemetry-driven autotune sweep of the port: search the exposed knobs,
score on MFU + goodput (throughput as the fallback), persist the winner.

The port's counterpart of ``scripts/autotune.py``. The parent process
imports neither torch nor jax: the search loop
(``stoke_tpu_torch/autotune.py``, loaded by file) drives one subprocess a
trial, which builds its run with the telemetry and attribution on,
measures throughput by delta timing and reports ``value`` / ``mfu`` /
``goodput_fraction`` / ``bound`` as one JSON line. The baseline's bound
prunes the knob space.

Workloads:

- ``gpt``: GPT-base (GPT-tiny with ``--smoke``) causal-LM training in bf16
  through ``Stoke.train_steps``; knobs ``batch``, ``steps_per_dispatch``
  and, with ``--comm-dtypes``, ``comm_dtype`` (every trial then under
  ``distributed="dp"``);
- ``resnet``: ResNet-50 bf16 on CIFAR-shaped data (BasicNN with
  ``--smoke``), the same knobs;
- ``serve_decode``: the paged decode kernel (the verify kernel with
  ``--spec-k``) alone at GPT-base's serve geometry, knob ``batch``: the
  slots a decode step attends for.

Winners go to ``--ledger`` (default
``build/stoke_tpu_torch/autotune.json``, git-ignored) under
``autotune/<metric>``, in the JAX ledger's layout; smoke winners carry a
``_smoke`` suffix. It never writes ``BENCH_RESULTS.json``.

Usage:
    python scripts/autotune_torch.py --smoke            # CPU flow check
    python scripts/autotune_torch.py --workload gpt --trials 8
    python scripts/autotune_torch.py --workload serve_decode --batches 8,16,32
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _load_autotune_module():
    """Load ``stoke_tpu_torch/autotune.py`` by FILE: the package's
    ``__init__`` imports torch, which the parent never does."""
    spec = importlib.util.spec_from_file_location(
        "_stoke_torch_autotune_standalone",
        os.path.join(REPO, "stoke_tpu_torch", "autotune.py"))
    mod = importlib.util.module_from_spec(spec)
    # dataclass field-type resolution looks the module up in sys.modules
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


_autotune = _load_autotune_module()
TrialResult = _autotune.TrialResult
TrialSpec = _autotune.TrialSpec
greedy_search = _autotune.greedy_search
persist_winner = _autotune.persist_winner

LEDGER_DEFAULT = os.path.join(REPO, "build", "stoke_tpu_torch",
                              "autotune.json")
GPT_METRIC = "gpt_base_bf16_train_tokens_per_s"
RESNET_METRIC = "cifar10_resnet50_bf16_train_throughput"
SMOKE_METRICS = {"gpt": "gpt_tiny_train_tokens_per_s",
                 "resnet": "cifar10_basicnn_train_throughput"}
SERVE_DECODE_METRIC = "serve_paged_decode_tokens_per_s"
#: the serve geometry of the serve_decode trials: GPT-base's heads and
#: head dim, a full decode batch (the baseline), 16-token KV blocks
SERVE_GEOMETRY = {"batch": 16, "heads": 12, "head_dim": 64,
                  "kv_block_size": 16}


def _parse_int_list(text: str) -> list:
    return [int(v) for v in text.split(",") if v.strip()]


# --------------------------------------------------------------------------- #
# trial worker (its own process)
# --------------------------------------------------------------------------- #


def _run_trial(payload: dict) -> dict:
    """Measure ONE trial inside the subprocess the driver spawned."""
    import torch

    spec = TrialSpec.from_dict(payload["spec"])
    out = {"trial": True, "config_key": spec.config_key(),
           "on_accelerator": torch.cuda.is_available(), "ok": True}
    if payload["workload"] == "serve_decode":
        return {**out, **measure_serve_decode(spec, payload)}
    return {**out, **_measure_train(spec, payload)}


def _measure_train(spec, payload: dict) -> dict:
    import torch

    from stoke_tpu_torch import Stoke, StokeOptimizer
    from stoke_tpu_torch.configs import (AttributionConfig, CommConfig,
                                         TelemetryConfig)
    from stoke_tpu_torch.telemetry.events import read_step_events

    smoke, workload = payload["smoke"], payload["workload"]
    cuda = torch.cuda.is_available()
    device = "cuda" if cuda else "cpu"
    seg = spec.steps_per_dispatch or (2 if smoke else 10)
    gen = torch.Generator().manual_seed(0)
    if workload == "gpt":
        from stoke_tpu_torch.models.gpt import GPT, causal_lm_loss
        from stoke_tpu_torch.ops.flash_attention import make_flash_attention

        batch = spec.batch or (2 if smoke else 8)
        seq, vocab = (64, 257) if smoke else (1024, 50257)
        model = GPT(vocab_size=vocab, size_name="tiny" if smoke else "base",
                    max_len=seq, dropout_rate=0.0,
                    attention_fn=make_flash_attention(causal=True),
                    attention_is_causal=True, device=device)
        model.init_weights(0)
        loss = causal_lm_loss
        xs = torch.randint(0, vocab, (seg, batch, seq), generator=gen)
        ys = xs
        per_step = batch * seq
        unit = "tokens/sec"
    else:
        from stoke_tpu_torch.models import BasicNN, ResNet50

        batch = spec.batch or (8 if smoke else 256)
        model = (BasicNN(device=device) if smoke else
                 ResNet50(num_classes=10, cifar_stem=True, device=device))
        loss = torch.nn.functional.cross_entropy
        xs = torch.randn((seg, batch, 3, 32, 32), generator=gen)
        ys = torch.randint(0, 10, (seg, batch), generator=gen)
        per_step = batch
        unit = "imgs/sec/chip"
    obs_dir = tempfile.mkdtemp(prefix="stoke-autotune-obs-")
    configs = [
        TelemetryConfig(output_dir=obs_dir, log_every_n_steps=1,
                        prometheus=False, tensorboard=False,
                        sample_device_time=False),
        AttributionConfig(peak_tflops=float(payload["peak_tflops"])),
    ]
    if spec.comm_dtype:
        configs.append(CommConfig(dtype=spec.comm_dtype))
    stoke = Stoke(
        model, StokeOptimizer(torch.optim.AdamW, lr=1e-4), loss,
        batch_size_per_device=batch, device=device,
        distributed="dp" if payload.get("dp") or spec.comm_dtype else None,
        precision=None if (smoke or not cuda) else "bf16",
        configs=configs, verbose=False)
    xs, ys = xs.to(device), ys.to(device)

    def timed(n):
        t0 = time.perf_counter()
        last = None
        for _ in range(n):
            last = stoke.train_steps(xs, ys)
        float(last.float().mean())  # one fetch: the work is done
        return time.perf_counter() - t0

    for _ in range(int(payload["warmup"])):
        stoke.train_steps(xs, ys)
    timed(1)
    steps = int(payload["steps"])
    t1 = timed(steps)
    t2 = timed(2 * steps)
    dt = max(t2 - t1, 1e-9)
    goodput = stoke.goodput or {}
    stoke.close_telemetry()
    bound = None
    try:
        for rec in reversed(read_step_events(
                os.path.join(obs_dir, "steps.jsonl"))):
            if rec.get("bound") is not None:
                bound = rec["bound"]
                break
    except Exception:
        pass
    return {"value": round(per_step * seg * steps / dt, 1), "unit": unit,
            "mfu": goodput.get("mfu"),
            "goodput_fraction": goodput.get("goodput_fraction"),
            "bound": bound, "wall_s": round(dt, 4), "batch": batch,
            "steps_per_dispatch": seg}


def measure_serve_decode(spec, payload: dict) -> dict:
    """The paged decode kernel's steady-state time at the spec's batch
    over a full synthetic pool (the verify kernel's, ``spec_k`` in the
    payload, at ``S = k + 1`` query rows a slot), replayed from a CUDA
    graph on the card; the CPU runs the plain version on a toy pool (flow
    check only). Scored as tokens (candidate positions) a second."""
    import numpy as np
    import torch

    from stoke_tpu_torch.ops.flash_attention import (
        paged_decode_attention_pallas, paged_verify_attention_pallas)

    cuda = torch.cuda.is_available()
    device = "cuda" if cuda else "cpu"
    g = SERVE_GEOMETRY
    B, H, D, BS = ((2, 2, 64, 16) if not cuda else
                   (g["batch"], g["heads"], g["head_dim"],
                    g["kv_block_size"]))
    B = int(spec.batch or B)
    BS = int(payload.get("kv_block_size") or BS)
    L = int(payload["seq_len"]) if cuda else 64
    MB = -(-L // BS)
    NB = B * MB + 1
    gen = torch.Generator().manual_seed(0)
    dt_kv = torch.bfloat16 if cuda else torch.float32
    pool = lambda: torch.randn((NB, BS, H, D), generator=gen).to(  # noqa
        device=device, dtype=dt_kv)
    kp, vp = pool(), pool()
    tables = torch.arange(1, B * MB + 1, dtype=torch.int32,
                          device=device).view(B, MB)
    ctx = np.linspace(L // 2, L, B).astype(np.int32)
    spec_k = payload.get("spec_k")
    if spec_k is not None:
        S = int(spec_k) + 1
        pos = torch.tensor(np.stack([np.arange(c - S, c) for c in ctx]),
                           dtype=torch.int32, device=device)
        q = torch.randn((B, H, S, D), generator=gen).to(device=device,
                                                         dtype=dt_kv)
        call = lambda: paged_verify_attention_pallas(  # noqa: E731
            q, kp, vp, tables, pos)
        per_dispatch = B * S
    else:
        lens = torch.tensor(ctx, dtype=torch.int32, device=device)
        q = torch.randn((B, H, 1, D), generator=gen).to(device=device,
                                                         dtype=dt_kv)
        call = lambda: paged_decode_attention_pallas(  # noqa: E731
            q, kp, vp, tables, lens)
        per_dispatch = B
    steps = int(payload["steps"])
    for _ in range(max(int(payload["warmup"]), 1)):
        call()
    if cuda:
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(steps):
                call()
        graph.replay()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.replay()
        torch.cuda.synchronize()
    else:
        t0 = time.perf_counter()
        for _ in range(steps):
            call()
    dt = max(time.perf_counter() - t0, 1e-9)
    return {"value": round(per_dispatch * steps / dt, 1),
            "unit": "tokens/sec", "mfu": None, "goodput_fraction": None,
            "bound": "memory", "wall_s": round(dt, 6),
            "graph_ms": round(dt / steps * 1e3, 6)}


# --------------------------------------------------------------------------- #
# driver (torch-free)
# --------------------------------------------------------------------------- #


def _subprocess_measure(payload_base: dict, timeout: int, verbose: bool,
                        require_accel: bool = False):
    """The measure() callable the search loop drives: one fresh
    subprocess a trial."""

    def measure(spec) -> TrialResult:
        payload = {**payload_base, "spec": spec.to_dict()}
        try:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 "--_trial", json.dumps(payload)],
                capture_output=True, text=True, timeout=timeout,
                env={**os.environ,
                     "PYTHONPATH": REPO + os.pathsep
                     + os.environ.get("PYTHONPATH", "")})
        except subprocess.TimeoutExpired:
            return TrialResult(spec, ok=False,
                               error=f"trial timed out after {timeout}s")
        line = next((ln for ln in reversed(proc.stdout.strip().splitlines())
                     if ln.startswith("{")), None)
        if proc.returncode != 0 or line is None:
            err = (proc.stderr or "no output").strip().splitlines()
            return TrialResult(spec, ok=False, error=(
                err[-1][:200] if err else "trial produced no JSON"))
        rec = json.loads(line)
        if verbose:
            print(json.dumps(rec), flush=True)
        if not rec.get("ok", False):
            return TrialResult(spec, ok=False,
                               error=rec.get("error", "trial failed"))
        if require_accel and rec.get("on_accelerator") is False:
            return TrialResult(
                spec, ok=False,
                error="trial ran on the CPU; refusing to score a CPU run "
                "in an on-card sweep")
        return TrialResult(
            spec, value=float(rec.get("value", 0.0)),
            unit=rec.get("unit", "tokens/sec"), mfu=rec.get("mfu"),
            goodput_fraction=rec.get("goodput_fraction"),
            bound=rec.get("bound"), wall_s=rec.get("wall_s"))

    return measure


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--_trial", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--smoke", action="store_true",
                    help="CPU flow check: tiny models and knob spaces, "
                    "the winner under a _smoke metric")
    ap.add_argument("--workload", choices=["gpt", "resnet", "serve_decode"],
                    default="gpt")
    ap.add_argument("--trials", type=int, default=8,
                    help="total trial budget (baseline included)")
    ap.add_argument("--steps", type=int, default=None,
                    help="timed dispatches a trial")
    ap.add_argument("--warmup", type=int, default=None)
    ap.add_argument("--batches", default=None,
                    help="comma-separated batch candidates")
    ap.add_argument("--segs", default=None,
                    help="comma-separated steps_per_dispatch candidates")
    ap.add_argument("--comm-dtypes", default=None,
                    help="comma-separated wire dtypes to sweep (bf16,int8);"
                    " every trial then runs under distributed='dp'")
    ap.add_argument("--kv-block-size", type=int, default=None)
    ap.add_argument("--spec-k", type=int, default=None,
                    help="serve_decode: sweep the verify kernel at S = k + "
                    "1 query rows; the winner persists under a _spec_k<k> "
                    "metric")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="serve_decode: cached context length")
    ap.add_argument("--peak-tflops", type=float, default=None,
                    help="MFU denominator (default 989, the H100 SXM's "
                    "dense bf16; smoke 1e-3)")
    ap.add_argument("--ledger", default=LEDGER_DEFAULT,
                    help="ledger the winner persists into")
    ap.add_argument("--trial-timeout", type=int, default=900)
    ap.add_argument("--no-persist", action="store_true")
    args = ap.parse_args(argv)

    if args._trial is not None:
        payload = json.loads(args._trial)
        try:
            rec = _run_trial(payload)
        except Exception as e:  # the driver scores failures, not tracebacks
            rec = {"trial": True, "ok": False,
                   "config_key": TrialSpec.from_dict(
                       payload.get("spec", {})).config_key(),
                   "error": f"{type(e).__name__}: {e}"[:300]}
        print(json.dumps(rec), flush=True)
        return 0 if rec.get("ok") else 1

    smoke = args.smoke
    if args.workload == "serve_decode":
        metric = SERVE_DECODE_METRIC
        if args.spec_k is not None:
            metric += f"_spec_k{args.spec_k}"
        b0 = 2 if smoke else SERVE_GEOMETRY["batch"]
        space = {"batch": _parse_int_list(
            args.batches or ("2,4,8" if smoke else "8,16,32"))}
        base = TrialSpec(batch=b0)
    else:
        metric = (SMOKE_METRICS[args.workload] if smoke else
                  GPT_METRIC if args.workload == "gpt" else RESNET_METRIC)
        defaults = {("gpt", True): ([2, 4], [2, 4], 2, 2),
                    ("gpt", False): ([4, 8, 16], [10, 25], 8, 10),
                    ("resnet", True): ([16, 32], [4, 8], 8, 2),
                    ("resnet", False): ([128, 256, 512], [10, 25], 256, 10)}
        batches, segs, b0, s0 = defaults[(args.workload, smoke)]
        space = {
            "batch": _parse_int_list(args.batches) if args.batches
            else batches,
            "steps_per_dispatch": _parse_int_list(args.segs) if args.segs
            else segs,
        }
        if args.comm_dtypes:
            space["comm_dtype"] = [d for d in args.comm_dtypes.split(",")
                                   if d.strip()]
        # the baseline states the workload defaults, so candidates that
        # restate them are not measured twice
        base = TrialSpec(batch=b0, steps_per_dispatch=s0)
    if smoke:
        metric += "_smoke"
    payload_base = {
        "workload": args.workload,
        "smoke": smoke,
        "steps": args.steps or (2 if smoke else 10),
        "warmup": args.warmup if args.warmup is not None else 1,
        "peak_tflops": (args.peak_tflops if args.peak_tflops is not None
                        else (1e-3 if smoke else 989.0)),
        "seq_len": args.seq_len or 2048,
        "kv_block_size": args.kv_block_size,
        "spec_k": args.spec_k,
        # dp for EVERY trial of a comm sweep, so the wire format is
        # measured against a dp baseline
        "dp": "comm_dtype" in space,
    }
    measure = _subprocess_measure(payload_base, args.trial_timeout,
                                  verbose=True, require_accel=not smoke)
    outcome = greedy_search(measure, base, space, max_trials=args.trials,
                            log=lambda m: print(f"autotune: {m}",
                                                flush=True))
    best = outcome.best
    summary = {"autotune": "ok" if best.ok else "FAILED", "metric": metric,
               "trials": outcome.trials,
               "pruned_knobs": outcome.pruned_knobs,
               "winner": best.to_dict()}
    if best.ok and not args.no_persist:
        os.makedirs(os.path.dirname(os.path.abspath(args.ledger)),
                    exist_ok=True)
        record = persist_winner(
            args.ledger, metric, outcome,
            backend="cpu" if smoke else "cuda",
            extra={"workload": args.workload})
        summary["persisted"] = {"ledger": args.ledger,
                                "key": f"autotune/{metric}",
                                "config_key": record["config_key"]}
    print(json.dumps(summary), flush=True)
    return 0 if best.ok else 1


if __name__ == "__main__":
    sys.exit(main())
