"""One rank of a fleet world of the port, for ``tests/test_torch_fleet.py``.

Spawned twice by the test; each process joins a gloo group through a file
store and trains a small model by ``Stoke`` with a ``FleetConfig`` (an
exchange every step, rebalancing on) over ``Stoke.DataLoader`` and a
``BucketedDistributedSampler``, rank 1's dataset slowed by a planted read
delay. It writes what it saw to ``{out_dir}/rank{r}.pt`` (a traceback
instead when it raised). It imports torch and the port only: no JAX.
"""

from __future__ import annotations

import json
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

N_ROWS, BATCH, STEPS, FEATURES = 256, 8, 14, 4
#: seconds rank 1 takes to read one row
SLOW_READ_S = 0.003


class IdRows:
    """Rows that carry their own index; reads on the slow rank sleep."""

    def __init__(self, slow: bool):
        self.slow = slow

    def __len__(self):
        return N_ROWS

    def __getitem__(self, i):
        if self.slow:
            time.sleep(SLOW_READ_S)
        return np.full((FEATURES,), i, np.float32), np.float32(i)


def fleet(inputs, rank, world, out_dir) -> dict:
    from stoke_tpu_torch import Stoke, StokeOptimizer
    from stoke_tpu_torch.configs import FleetConfig, TelemetryConfig
    from stoke_tpu_torch.data import BucketedDistributedSampler

    tdir = os.path.join(out_dir, "telemetry")
    s = Stoke(nn.Linear(FEATURES, 1), StokeOptimizer(torch.optim.SGD,
                                                     lr=1e-4),
              lambda out, y: ((out[:, 0] - y) ** 2).mean(),
              batch_size_per_device=BATCH, device="cpu", distributed="dp",
              configs=[TelemetryConfig(output_dir=tdir, log_every_n_steps=1,
                                       jsonl_all_ranks=True,
                                       prometheus=False, tensorboard=False,
                                       sample_device_time=False),
                       FleetConfig(window_steps=1, straggler_rel_frac=0.2,
                                   straggler_windows=2,
                                   straggler_action="record",
                                   rebalance=True, rebalance_rows=2,
                                   rebalance_max_frac=0.5)])
    data = IdRows(slow=rank == 1)
    sampler = BucketedDistributedSampler(
        data, buckets=1, batch_size=BATCH, sorted_idx=list(range(N_ROWS)),
        num_replicas=world, rank=rank, seed=5)
    plan = sampler.global_batches()
    loader = s.DataLoader(data, sampler=sampler)
    got, matrices, shares = [], [], []
    for step, (x, y) in enumerate(loader):
        if step == STEPS:
            break
        s.train_step(x, y)
        got.append(y.numpy().astype(np.int64).tolist())
        matrices.append(None if s.fleet.last_matrix is None
                        else s.fleet.last_matrix.copy())
        shares.append(list(loader._rebalancer.shares))
    rb = loader._rebalancer
    summary = s.fleet_summary
    s.close_telemetry()
    with open(os.path.join(tdir, f"steps.rank{rank}.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return {"batches": got, "plan": [p[rank] for p in plan[:len(got)]],
            "matrices": matrices, "shares": shares, "shifts": rb.shifts,
            "rows_moved": rb.rows_moved, "final_shares": rb.shares,
            "summary": summary, "records": records}


def run(rank: int, world: int, store: str, out_dir: str, inputs) -> None:
    """The entry point of one spawned rank (the port's explicit
    rendezvous at the file store)."""
    from stoke_tpu_torch.configs import DistributedInitConfig
    from stoke_tpu_torch.parallel import initialize_distributed

    torch.set_num_threads(1)
    out = {}
    try:
        initialize_distributed(DistributedInitConfig(
            coordinator_address=f"file://{store}", num_processes=world,
            process_id=rank), torch.device("cpu"))
        out["fleet"] = fleet(inputs, rank, world,
                             os.path.join(out_dir, f"r{rank}"))
        dist.destroy_process_group()
    except BaseException:
        out = {"error": traceback.format_exc()}
    torch.save(out, f"{out_dir}/rank{rank}.pt")
    if "error" in out:
        raise SystemExit(1)
