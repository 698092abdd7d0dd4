"""GPT-base bf16 training of this checkout against another checkout's, bit
for bit, on a CUDA card.

Run from the root of a checkout, with another checkout (for example the
parent commit unpacked by ``git archive``) at OTHER:
``python3 scripts/port_clip_norm_parity.py OTHER``.

Each tree trains GPT-base bf16 at full width (``chip_smoke.gpt_base("flash")``
under ``chip_smoke.stoke_for``: AdamW, clip norm 1.0) from the same seed
over the same batches: EAGER eager ``train_step`` calls, then one
``train_steps`` call of WINDOW steps (a captured window). Each run is a
process of its own that imports only its tree, in the order other, this,
this, other. Prints each run's losses and a digest of its final
parameters, then one JSON line saying whether the trees agree bit for
bit. Exits nonzero if a tree's two runs disagree with each other (the
comparison would then mean nothing) or a run fails.
"""
import json
import os
import subprocess
import sys

EAGER, WINDOW = 6, 4

_RUN = """
import hashlib, json, sys
sys.path.insert(0, {root!r})
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as cs
from stoke_tpu_torch.ops import _build
_build.build(["flash_fwd", "flash_bwd"])
s = cs.stoke_for(cs.gpt_base("flash"), "bf16", cs.TRAIN_BATCH)
batches = cs.window_batches({eager} + {window})
losses = [float(s.train_step(b, b)) for b in batches[:{eager}]]
w = batches[{eager}:]
losses += s.train_steps(w, w)[:, 0].tolist()
h = hashlib.sha256()
for p in s.model_access.parameters():
    h.update(p.detach().cpu().numpy().tobytes())
print(json.dumps({{"losses": losses, "params_sha256": h.hexdigest()}}))
"""


def run(root: str) -> dict:
    """One training run of the tree at ``root`` in a fresh process."""
    code = _RUN.format(root=os.path.abspath(root), eager=EAGER,
                       window=WINDOW)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=os.path.abspath(root), timeout=600)
    if p.returncode != 0:
        raise RuntimeError(f"run of {root} failed:\n{p.stderr[-4000:]}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def main() -> int:
    other, this = sys.argv[1], "."
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(smi, flush=True)
    runs = []
    for name, root in (("other", other), ("this", this), ("this", this),
                       ("other", other)):
        out = run(root)
        runs.append((name, out))
        print(json.dumps({"tree": name, **out}), flush=True)
    by = {}
    for name, out in runs:
        by.setdefault(name, []).append(out)
    stable = all(a == b for a, b in by.values())
    a, b = by["this"][0], by["other"][0]
    diff = [abs(x - y) / abs(y) for x, y in zip(a["losses"], b["losses"])]
    print(json.dumps({
        "card": smi, "eager_steps": EAGER, "window_steps": WINDOW,
        "each_tree_repeatable": stable,
        "losses_bit_equal": a["losses"] == b["losses"],
        "params_bit_equal": a["params_sha256"] == b["params_sha256"],
        "loss_max_rel_diff": max(diff),
    }), flush=True)
    return 0 if stable else 1


if __name__ == "__main__":
    sys.exit(main())
