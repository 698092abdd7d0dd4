"""stoke_lint_torch: the port's codified disciplines as a CLI.

The port's counterpart of ``scripts/stoke_lint.py``. One command, two
halves:

- **Invariant linter** (default): the torch-free AST rules over the port's
  tree: append-only wire formats against the committed manifest,
  config-knob status-rule coverage against the waiver file,
  nullable-JSONL schema discipline, and the banned-API rules (the JAX
  stack anywhere in the port, module-scope torch in the torch-free
  modules, this script included, and per-dispatch host fetches in the
  engines' step paths).
- **Program auditor** (``--programs``): builds a tiny live ``Stoke`` on
  the CPU in a SUBPROCESS, drives the four step APIs plus three serving
  engines, and runs ``Stoke.audit()`` over their recorded program traces,
  with the serve-cost drift gate against the committed
  ``stoke_tpu_torch/analysis/manifests/program_costs.json``.

Usage:

    python scripts/stoke_lint_torch.py               # lint; exit 1 on findings
    python scripts/stoke_lint_torch.py --json        # machine-readable findings
    python scripts/stoke_lint_torch.py --programs    # + the program audit (subprocess)
    python scripts/stoke_lint_torch.py --programs --update-costs  # re-pin costs

Exit codes: 0 clean, 1 findings, 2 usage/internal error.

This process imports neither torch nor jax: the linter is loaded from
``stoke_tpu_torch/analysis/invariants.py`` by FILE (the package's
``__init__`` imports torch), and the program audit runs in a subprocess
pinned to the CPU. The linter's own banned-API rule enforces this on this
very file.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_HERE)
_INVARIANTS = os.path.join("stoke_tpu_torch", "analysis", "invariants.py")
#: the committed manifests the drift gates compare against
_COST_MANIFEST = os.path.join(
    "stoke_tpu_torch", "analysis", "manifests", "program_costs.json")
_MEM_MANIFEST = os.path.join(
    "stoke_tpu_torch", "analysis", "manifests", "program_memory.json")


def _load_invariants(repo_root: str):
    """Load the linter by FILE (never through the package, which imports
    torch)."""
    path = os.path.join(repo_root, _INVARIANTS)
    if not os.path.exists(path):
        path = os.path.join(_REPO, _INVARIANTS)
    spec = importlib.util.spec_from_file_location(
        "_stoke_torch_analysis_invariants", path)
    mod = importlib.util.module_from_spec(spec)
    # dataclass field-type resolution looks the module up in sys.modules
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


#: the subprocess body of --programs: a tiny GPT through the four step
#: APIs and three serving engines on the CPU, audited, one JSON line out
_PROGRAM_WORKER = r"""
import json, os
import torch
torch.set_num_threads(1)
from stoke_tpu_torch import Stoke, StokeOptimizer
from stoke_tpu_torch.configs import ServeConfig
from stoke_tpu_torch.models.gpt import GPT, causal_lm_loss
from stoke_tpu_torch.ops.flash_attention import make_flash_attention
from stoke_tpu_torch.serving import ServingEngine
from stoke_tpu_torch.analysis.program import (
    audit_program_specs, spec_cost_entry, spec_memory_entry)


def gpt():
    m = GPT(vocab_size=257, size_name="tiny", max_len=128, dropout_rate=0.0,
            attention_fn=make_flash_attention(causal=True),
            attention_is_causal=True)
    m.init_weights(0)
    return m


def mk(**kw):
    return Stoke(gpt(), StokeOptimizer(torch.optim.AdamW, lr=3e-3),
                 causal_lm_loss, batch_size_per_device=2, device="cpu",
                 verbose=False, **kw)


g = torch.Generator().manual_seed(0)
x = torch.randint(0, 257, (2, 16), generator=g)
s = mk()
s.train_step(x, x)                                        # fused
out = s.model(x); s.backward(s.loss(out, x)); s.step()    # accum + apply
s2 = mk(grad_accum=2)
xs = torch.stack([x, x])
s2.train_step_window(xs, xs)                              # window
s2.train_steps(torch.cat([xs, xs]), torch.cat([xs, xs]))

model = gpt()
base = dict(max_seqs=2, kv_block_size=8, max_seq_len=64, max_new_tokens=4,
            prefill_pad_multiple=16, attention="flash",
            decode_kernel="pallas")
eng = ServingEngine(model, model.state_dict(), ServeConfig(**base),
                    device="cpu")
eng.submit([5, 6, 7])
eng.run()
spec_eng = ServingEngine(model, model.state_dict(), ServeConfig(
    **base, prefill_chunk_tokens=16, sampling=True, speculative_k=3),
    device="cpu")
spec_eng.submit([5, 9, 3] * 7)
spec_eng.run()
chunk_eng = ServingEngine(model, model.state_dict(), ServeConfig(
    **base, prefill_chunk_tokens=16), device="cpu")
chunk_eng.submit([5, 9, 3] * 7)
chunk_eng.run()

def manifest(var):
    path = os.environ.get(var)
    if not path:
        return None
    with open(path) as fh:
        return json.load(fh)

cost_manifest = manifest("STOKE_COST_MANIFEST")
mem_manifest = manifest("STOKE_MEM_MANIFEST")
findings, programs, notes, costs, mems = [], [], [], {}, {}
for st, serve_eng in ((s, eng), (s2, spec_eng)):
    before = st.dispatch_count
    rep = st.audit(serve=serve_eng, cost_manifest=cost_manifest,
                   mem_manifest=mem_manifest)
    assert st.dispatch_count == before, "audit dispatched a program"
    findings += [f.to_dict() for f in rep.findings]
    programs += rep.programs
    notes += rep.notes
rep = audit_program_specs(chunk_eng.audit_specs(),
                          cost_manifest=cost_manifest,
                          mem_manifest=mem_manifest)
findings += [f.to_dict() for f in rep.findings]
programs += rep.programs
deduped, seen = [], set()
for f in findings:
    key = (f["rule"], f["file"], f["message"])
    if key not in seen:
        seen.add(key)
        deduped.append(f)
for serve_eng in (eng, spec_eng, chunk_eng):
    for spec in serve_eng.audit_specs():
        entry = spec_cost_entry(spec)
        if entry is not None:
            costs.setdefault(spec.program, entry)
        entry = spec_memory_entry(spec)
        if entry is not None:
            mems.setdefault(spec.program, entry)
print(json.dumps({"programs": programs, "findings": deduped,
                  "notes": notes, "costs": costs, "mems": mems}))
"""


def run_program_audit(repo_root: str, cost_manifest_path=None,
                      mem_manifest_path=None) -> dict:
    """Spawn the program audit on the CPU; returns the worker's JSON
    payload. Each manifest path defaults to the committed one; "" disarms
    its gate."""
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    for var, given, default in (
            ("STOKE_COST_MANIFEST", cost_manifest_path, _COST_MANIFEST),
            ("STOKE_MEM_MANIFEST", mem_manifest_path, _MEM_MANIFEST)):
        if given is None:
            path = os.path.join(repo_root, default)
            given = path if os.path.exists(path) else ""
        if given:
            env[var] = os.path.abspath(given)
        else:
            env.pop(var, None)
    proc = subprocess.run([sys.executable, "-c", _PROGRAM_WORKER],
                          capture_output=True, text=True, env=env,
                          cwd=repo_root)
    if proc.returncode != 0:
        raise RuntimeError(
            f"program-audit worker failed (exit {proc.returncode}):\n"
            f"{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _pin(path: str, comment, tolerance: float, programs: dict) -> None:
    manifest = {"_comment": comment, "tolerance": tolerance,
                "programs": dict(sorted(programs.items()))}
    with open(path, "w") as fh:
        json.dump(manifest, fh, indent=2)
        fh.write("\n")


COST_COMMENT = [
    "Serve-program cost manifest of the port: the audit-cost-drift gate",
    "compares each serve program's cost card (FLOPs and bytes counted at",
    "its first run on the CPU, GPT-tiny engines of",
    "scripts/stoke_lint_torch.py --programs) against these pins at",
    "matching argument-geometry signature. Deviations beyond the",
    "tolerance fail in BOTH directions (golden-file semantics).",
    "Regenerate after an INTENTIONAL cost change with:",
    "  python scripts/stoke_lint_torch.py --programs --update-costs",
]
MEM_COMMENT = [
    "Serve-program memory manifest of the port: the audit-memory-drift",
    "gate compares a serve program's measured temp and peak bytes against",
    "these pins. The CPU has no allocator peaks, so the CPU audit notes",
    "the gate unchecked and nothing is pinned from it. Regenerate on a",
    "card with:",
    "  python scripts/stoke_lint_torch.py --programs --update-mem",
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="stoke_tpu_torch invariant linter + program auditor")
    ap.add_argument("--repo-root", default=_REPO,
                    help="tree to lint (default: this script's repo)")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON object instead of text lines")
    ap.add_argument("--programs", action="store_true",
                    help="also run the program audit (CPU subprocess)")
    ap.add_argument("--cost-manifest", default=None, metavar="PATH",
                    help="program-cost manifest of the audit-cost-drift "
                    "gate (default: the committed one; '' disarms it)")
    ap.add_argument("--update-costs", action="store_true",
                    help="with --programs: rewrite the committed "
                    "program-cost manifest from the live engines")
    ap.add_argument("--mem-manifest", default=None, metavar="PATH",
                    help="program-memory manifest of the "
                    "audit-memory-drift gate (default: the committed one)")
    ap.add_argument("--update-mem", action="store_true",
                    help="with --programs: rewrite the committed "
                    "program-memory manifest from the live engines")
    args = ap.parse_args(argv)
    repo_root = os.path.abspath(args.repo_root)
    if not os.path.isdir(repo_root):
        print(f"stoke_lint_torch: no such directory {repo_root!r}",
              file=sys.stderr)
        return 2
    for flag in ("update_costs", "update_mem"):
        if getattr(args, flag) and not args.programs:
            print(f"stoke_lint_torch: --{flag.replace('_', '-')} requires "
                  f"--programs", file=sys.stderr)
            return 2

    inv = _load_invariants(repo_root)
    findings = [f.to_dict() for f in inv.run_invariant_lints(repo_root)]
    programs = []
    if args.programs:
        try:
            payload = run_program_audit(
                repo_root,
                # an update pass measures; it does not judge against the
                # pins it replaces
                cost_manifest_path="" if args.update_costs
                else args.cost_manifest,
                mem_manifest_path="" if args.update_mem
                else args.mem_manifest)
        except Exception as e:
            print(f"stoke_lint_torch: {e}", file=sys.stderr)
            return 2
        findings += payload["findings"]
        programs = payload["programs"]
        if args.update_costs:
            path = os.path.join(repo_root, _COST_MANIFEST)
            _pin(path, COST_COMMENT, 0.05, payload["costs"])
            print(f"stoke_lint_torch: pinned {len(payload['costs'])} "
                  f"program cost(s) -> {path}")
        if args.update_mem:
            path = os.path.join(repo_root, _MEM_MANIFEST)
            _pin(path, MEM_COMMENT, 0.25, payload["mems"])
            print(f"stoke_lint_torch: pinned {len(payload['mems'])} "
                  f"program memory entr(y/ies) -> {path}")
    if args.json:
        print(json.dumps({"version": inv.LINT_VERSION,
                          "findings": findings,
                          "programs_audited": programs}))
    else:
        for f in findings:
            print(f"{f['file']}:{f['line']}: [{f['rule']}] {f['message']} "
                  f"— remedy: {f['remedy']}")
        tail = (f", {len(programs)} program(s) audited" if args.programs
                else "")
        print(f"stoke_lint_torch: {len(findings)} finding(s){tail}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
