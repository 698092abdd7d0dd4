"""Each training phase's first-step ms and peak memory, from the output of
``chip_smoke.py`` runs, side by side.

A program's first run is the one the engines count, measure and record
(cost cards, the memory observatory, the program auditor's recorder), so
a change to what a first run does shows here first. For every phase line
of each run file: each step-time list's first entry (keys ending in
``step_ms``, ``eager_ms`` or ``window_ms``: the phase's first step or
window of that run) and each peak reading (keys holding ``peak`` or
``max_memory_allocated``, or ending in ``peak_gb``). One row a key, one
column a run, and the largest difference between the columns' means when
``--groups`` splits the runs in two (``parent,change`` by file name).

Usage:
    python scripts/chip_smoke_first_runs.py ab_out/run*.out
    python scripts/chip_smoke_first_runs.py --json ab_out/run*.out
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

FIRST = re.compile(r"(step_ms|eager_ms|window_ms)$")
PEAK = re.compile(r"(peak|max_memory_allocated)")


def readings(path: str) -> dict:
    """``{(phase, key): value}`` of one run's output."""
    out = {}

    def walk(phase, obj, keys):
        if isinstance(obj, dict):
            for k, v in obj.items():
                walk(phase, v, keys + [str(k)])
            return
        leaf = keys[-1] if keys else ""
        name = "/".join(keys)
        if isinstance(obj, list):
            if obj and all(isinstance(x, (int, float)) for x in obj):
                if FIRST.search(leaf):
                    out[(phase, name + "[0]")] = float(obj[0])
                return
            for i, v in enumerate(obj):
                walk(phase, v, keys + [str(i)])
            return
        if isinstance(obj, (int, float)) and not isinstance(obj, bool) \
                and PEAK.search(leaf) and "flops" not in leaf \
                and "predicted" not in leaf:
            out[(phase, name)] = float(obj)

    with open(path) as f:
        for line in f:
            if line.startswith('{"phase"'):
                rec = json.loads(line)
                walk(rec["phase"], rec, [])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("runs", nargs="+")
    ap.add_argument("--groups", default="parent,change",
                    help="two substrings of the file names that split the "
                    "runs (default parent,change)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    runs = {os.path.basename(p): readings(p) for p in args.runs}
    names = list(runs)
    groups = args.groups.split(",")
    keys = sorted({k for r in runs.values() for k in r})
    rows = []
    for key in keys:
        vals = {n: runs[n].get(key) for n in names}
        means = []
        for g in groups:
            got = [v for n, v in vals.items() if g in n and v is not None]
            means.append(sum(got) / len(got) if got else None)
        diff = (means[1] - means[0] if len(means) == 2
                and None not in means else None)
        rows.append({"phase": key[0], "key": key[1], "runs": vals,
                     "means": dict(zip(groups, means)), "diff": diff})
    if args.json:
        print(json.dumps(rows))
        return 0
    print("phase\tkey\t" + "\t".join(names) + "\tdiff")
    for r in rows:
        cells = ["" if v is None else f"{v:.6g}" for v in r["runs"].values()]
        diff = "" if r["diff"] is None else f"{r['diff']:+.6g}"
        print(f"{r['phase']}\t{r['key']}\t" + "\t".join(cells) + f"\t{diff}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
