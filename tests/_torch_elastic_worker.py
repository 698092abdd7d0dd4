"""One rank of a data-parallel world of the port, for
``tests/test_torch_elastic.py``: preemption across processes and elastic
resume.

Spawned by the test at world 2 (the saves) and then at world 1 (the
resumes); each process joins a gloo group through a file store, runs the
scenarios of its world in order and writes what it saw to
``{out_dir}/rank{r}.pt`` (a traceback instead when a scenario raised).
The tags live under ``inputs["root"]``, shared by the two worlds. It
imports torch and the port only: no JAX.
"""

from __future__ import annotations

import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

import _torch_dp_worker as dpw

#: the int8 sharded transport of the elastic case: one bucket of the
#: MLP's 768 elements, padded to a multiple of world x 160 (960 at world
#: 2, 800 at world 1)
COMM = dict(dtype="int8", shard_updates=True, bucket_mb=0.004,
            chunk_elems=160)
STEPS = 6


def _stoke(inputs, world, tag, **res):
    from stoke_tpu_torch.configs import CommConfig, ResilienceConfig

    return dpw.mlp_stoke(inputs, world, tier="sddp", extra=[
        CommConfig(**COMM),
        ResilienceConfig(save_path=os.path.join(inputs["root"], tag),
                         exit_on_preempt=False, **res)])


def _step(s, batch, rank, world) -> float:
    x, y = batch
    return float(s.train_step(dpw.rows(x, rank, world),
                              dpw.rows(y, rank, world)))


def _state(s) -> dict:
    from _torch_io_worker import whole_state

    return whole_state(s)


def elastic_save(inputs, rank, world) -> dict:
    """World 2: three steps, a preemption noticed on rank 1 only (the
    boundary's all-reduce makes every rank drain at the same step), the
    emergency save at step 4."""
    from stoke_tpu_torch.resilience import PreemptedError

    s = _stoke(inputs, world, "elastic")
    batches = dpw.mlp_data(STEPS)
    losses = [_step(s, b, rank, world) for b in batches[:3]]
    if rank == 1:
        s.resilience.request_preemption("test")
    try:
        _step(s, batches[3], rank, world)
        raise AssertionError("no preemption at the boundary")
    except PreemptedError as e:
        step, tag_dir = e.step, e.tag_dir
    out = {"losses": losses, "step": step, "tag_dir": tag_dir,
           "signal": s.resilience.preempt_signal,
           "state": _state(s), "layout": s._comm_layout(),
           "summary": s.resilience_summary}
    s.close_telemetry()
    return out


def pick_broadcast(inputs, rank, world) -> dict:
    """World 2: two saves under the emergency root, the newest corrupted
    by rank 0 after both landed; a resume at world 2 restores the older
    one on every rank, quarantined once (by rank 0)."""
    from stoke_tpu_torch.resilience import corrupt_checkpoint

    s = _stoke(inputs, world, "pick")
    root = s.resilience.cfg.save_path
    batches = dpw.mlp_data(STEPS)
    _step(s, batches[0], rank, world)
    s.save(root, name="emergency")
    _step(s, batches[1], rank, world)
    newest = s.save(root, name="emergency")
    s.close_telemetry()
    dist.barrier()
    if rank == 0:
        corrupt_checkpoint(newest)
    dist.barrier()
    r = _stoke(inputs, world, "pick")
    ok = r.resume()
    out = {"resumed": ok, "step": r.optimizer_steps,
           "summary": r.resilience_summary, "state": _state(r)}
    r.close_telemetry()
    return out


def elastic_resume(inputs, rank, world) -> dict:
    """World 1: the world-2 emergency tag resumed onto another world and
    padding, then two more steps (the transport runs on the remapped
    residual)."""
    s = _stoke(inputs, world, "elastic")
    ok = s.resume()
    out = {"resumed": ok, "step": s.optimizer_steps, "state": _state(s),
           "residual": [r.detach().clone().numpy()
                        for r in s._engine.comm_state["residual"]],
           "layout": s._comm_layout(), "summary": s.resilience_summary,
           "events": s.resilience.event_fields()}
    batches = dpw.mlp_data(STEPS)
    out["losses"] = [_step(s, b, rank, world) for b in batches[4:]]
    s.close_telemetry()
    return out


SCENARIOS = {2: (elastic_save, pick_broadcast), 1: (elastic_resume,)}


def run(rank: int, world: int, store: str, out_dir: str, inputs) -> None:
    """The entry point of one spawned rank."""
    from stoke_tpu_torch.configs import DistributedInitConfig
    from stoke_tpu_torch.parallel import initialize_distributed

    torch.set_num_threads(1)
    np.seterr(all="ignore")
    out = {}
    try:
        initialize_distributed(DistributedInitConfig(
            coordinator_address=f"file://{store}", num_processes=world,
            process_id=rank), torch.device("cpu"))
        for scenario in SCENARIOS[world]:
            out[scenario.__name__] = scenario(inputs, rank, world)
        dist.destroy_process_group()
    except BaseException:
        out = {"error": traceback.format_exc()}
    torch.save(out, f"{out_dir}/rank{rank}.pt")
    if "error" in out:
        raise SystemExit(1)
