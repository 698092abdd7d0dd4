"""A worker for the port's supervised-restart tests: a small deterministic
training run on the CPU that resumes on restart and records its loss
trajectory and final weights.

Run it under ``python -m stoke_tpu_torch.supervise`` with
``STOKE_CHAOS=kill_at_step=K,kill_mode=sigkill`` (or ``kill_during_save``)
to drive the kill, restart and resume loop; run it clean for the
uninterrupted reference. The batches come from a fixed seed and are
indexed by optimizer step, so a resumed attempt replays exactly the steps
the killed one never finished.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

IN, OUT = 8, 4


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True,
                    help="workdir: checkpoints, trajectory, final weights")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--save-every", type=int, default=None,
                    help="periodic saves under <root>/auto every N steps")
    ap.add_argument("--staged", action="store_true",
                    help="the periodic saves async and staged")
    args = ap.parse_args()

    import torch

    from stoke_tpu_torch import (
        CheckpointConfig,
        ResilienceConfig,
        Stoke,
        StokeOptimizer,
    )

    configs = [ResilienceConfig(save_path=os.path.join(args.root, "ckpts"))]
    if args.save_every:
        configs.append(CheckpointConfig(
            async_save=args.staged, offload_staging=args.staged,
            save_every_n_steps=args.save_every,
            auto_path=os.path.join(args.root, "auto")))
    model = torch.nn.Linear(IN, OUT, bias=False)
    with torch.no_grad():
        model.weight.fill_(0.1)
    stoke = Stoke(model, StokeOptimizer(torch.optim.SGD, lr=0.05),
                  lambda o, y: ((o - y) ** 2).mean(),
                  batch_size_per_device=32, device="cpu", configs=configs)
    stoke.resume()

    rng = np.random.default_rng(7)
    W = rng.normal(size=(IN, OUT)).astype(np.float32)
    batches = []
    for _ in range(args.steps):
        x = rng.normal(size=(32, IN)).astype(np.float32)
        batches.append((x, (x @ W).astype(np.float32)))

    attempt = int(os.environ.get("STOKE_RESTART_ATTEMPT", "0") or 0)
    start = stoke.optimizer_steps  # 0 fresh; K after a resume
    with open(os.path.join(args.root, "trajectory.jsonl"), "a") as f:
        for i in range(start, args.steps):
            x, y = batches[i]
            report = stoke.train_step(torch.from_numpy(x),
                                      torch.from_numpy(y))
            f.write(json.dumps({"step": stoke.optimizer_steps,
                                "loss": float(report),
                                "attempt": attempt}) + "\n")
            f.flush()
    stoke.wait_for_checkpoint()
    np.save(os.path.join(args.root, "final_w.npy"),
            stoke.model_access.weight.detach().numpy())
    stoke.close_telemetry()
    return 0


if __name__ == "__main__":
    sys.exit(main())
