"""Probe of ``chip_smoke.py``'s tensor- and expert-parallel phase on a
CUDA card.

Run from the root of a checkout:
``python3 scripts/port_probe_tp_ep.py [PHASE ...]``, each PHASE one of
``train_tp_ep`` (the smoke's phase, the default), ``moe_trace`` and
``moe_aux``.
Builds ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` and prints the card
and each phase's line. Exits nonzero if a phase fails.

- ``train_tp_ep``: GPT-base bf16 under ``gpt_tensor_parallel_rules`` at
  world 1 bit for bit against the run without rules; one block split
  over 2 and 4 virtual model ranks; GPT-base-MoE top-1 and top-2 eager
  and replayed, under ``moe_expert_parallel_rules`` bit for bit; its
  experts split over 2 and 4 virtual expert ranks; step ms, peak memory
  and the MoE FFN's routing against its products.
- ``moe_trace``: one profiled eager ``train_step`` of GPT-base-MoE top-1
  beside GPT-base's: each step's kernel time by class (flash, GEMMs,
  the rest) and its busy share.
- ``moe_aux``: nine eager steps of GPT-base-MoE on one batch: each step's
  loss, each MoE block's aux loss and its router's logits.
"""
import json
import sys

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from stoke_tpu_torch import ops  # noqa: E402
from stoke_tpu_torch.ops import _build  # noqa: E402


def moe_trace(ops) -> dict:
    """A profiled eager step of GPT-base-MoE (top-1) and of GPT-base
    after two warm steps each: device ms by kernel class and busy share
    (``chip_smoke.profile_step``)."""
    import re

    out = {}
    batches = cs.window_batches(3)
    for name, make in (("gpt", lambda: cs.gpt_base("flash")),
                       ("moe1", lambda: cs.moe_base(1))):
        s = cs.stoke_for(make(), "bf16", cs.TRAIN_BATCH, seed=cs.SEED)
        for i in range(2):
            float(s.train_step(batches[i], batches[i]))
        prof = cs.profile_step(
            lambda: float(s.train_step(batches[2], batches[2])))
        top = prof.get("top", [])
        gemm = sum(r["ms"] for r in top if re.search(
            r"gemm|xmma|cutlass|sm90_|nvjet", r["name"], re.I))
        out[name] = {"wall_ms": prof["wall_ms"],
                     "device_ms": prof["device_ms"],
                     "device_busy_share": prof.get("device_busy_share"),
                     "attention_kernels_ms": prof.get(
                         "attention_kernels_ms"),
                     "gemm_ms_of_top12": gemm, "top": top}
        del s
        torch.cuda.empty_cache()
    return out


def moe_aux(ops) -> dict:
    """GPT-base-MoE (top-1) bf16, nine eager ``train_step``s on one
    batch: each step's loss, each MoE block's aux loss, and its router's
    logits (their std) and mean top probability in that step's forward
    (forward hooks on the routers)."""
    model = cs.moe_base(1)
    seen = []

    def hook(mod, inp, out):
        lg = out.detach().float()
        seen.append([float(lg.std()),
                     float(lg.softmax(-1).amax(-1).mean())])

    for block in model.layers:
        if hasattr(block, "moe"):
            block.moe.router.register_forward_hook(hook)
    s = cs.stoke_for(model, "bf16", cs.TRAIN_BATCH, seed=cs.SEED)
    b = cs.window_batches(1)[0]
    steps = []
    for _ in range(9):
        seen.clear()
        loss = float(s.train_step(b, b))
        steps.append({"loss": loss, "router_std_top_p": list(seen),
                      "aux": [float(v["moe"]["aux_loss"])
                              for v in s.aux_losses.values()]})
    del s
    return {"steps": steps}


PROBES = {"moe_trace": moe_trace, "moe_aux": moe_aux}


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    print(json.dumps({"build": _build.build(["flash_fwd", "flash_bwd"])}),
          flush=True)
    for name in sys.argv[1:] or ["train_tp_ep"]:
        fn = PROBES.get(name) or getattr(cs, name)
        print(json.dumps({"probe": name, **fn(ops), "card": smi},
                         default=str), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
