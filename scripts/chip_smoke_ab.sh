#!/bin/bash
# chip_smoke.py of two checkouts on one card in one command, in the order
# A, B, B, A, each run timed; each run's output under OUT_DIR.
#
# Unpack the two trees first, into directories .gitignore lists:
#   mkdir -p build/ta_parent build/ta_change
#   git archive <parent commit> | tar -x -C build/ta_parent
#   git add -A && git archive $(git write-tree) | tar -x -C build/ta_change
# then, on the machine with the card, from the root of the repo:
#   bash scripts/chip_smoke_ab.sh [OUT_DIR]   (default: ab_out)
cd "$(dirname "$0")/.."
out="${1:-ab_out}"
mkdir -p "$out"
out="$(cd "$out" && pwd)"
i=0
for who in parent change change parent; do
  i=$((i + 1))
  t0=$(date +%s.%N)
  (cd "build/ta_$who" && python3 chip_smoke.py \
      > "$out/run$i.$who.out" 2> "$out/run$i.$who.err")
  rc=$?
  t1=$(date +%s.%N)
  echo "run$i $who rc=$rc seconds=$(python3 -c "print($t1 - $t0)")"
  tail -n 1 "$out/run$i.$who.out"
done
