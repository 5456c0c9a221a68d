"""The port's bench from two checkouts on one card, in turns.

    python -m infinisst_tpu_torch.tools.ab_bench A_DIR B_DIR \\
        --runs "--speculative --spec-resid-scale 0 --spec-no-guard" \\
               "--mode serve --speculative"

For each argument set, ``python -m infinisst_tpu_torch.bench`` with
those arguments from checkout A, then B, B, A, each in its own process
from the checkout's root (so each builds its own kernels into its own
``build/``).  Prints each run's JSON line and its headline numbers
(stream: ``value`` RTF, ``rtf_p95``, ``accept_rate``; serve: tok/s and
``slot_chunk_p99_ms``), one summary line per set, then the card's name
and power limit.  Compare checkouts only within one such call: two calls
may land on different cards.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import subprocess
import sys

HEADLINE = ("value", "rtf_median", "rtf_p95", "slot_chunk_p99_ms",
            "accept_rate", "rounds", "guard_fallback")


def run(tree: str, args: list) -> dict:
    """One bench run from ``tree``: its JSON line (None if it failed)."""
    cmd = [sys.executable, "-m", "infinisst_tpu_torch.bench"] + args
    out = subprocess.run(cmd, cwd=tree, capture_output=True, text=True,
                         timeout=1200)
    if out.returncode != 0:
        print(out.stderr[-3000:], file=sys.stderr, flush=True)
        return None
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("a_dir")
    ap.add_argument("b_dir")
    ap.add_argument("--runs", nargs="+", required=True,
                    help="bench argument sets, one string each")
    args = ap.parse_args(argv)
    trees = {"A": os.path.abspath(args.a_dir),
             "B": os.path.abspath(args.b_dir)}
    failed = False
    for spec in args.runs:
        bench_args = shlex.split(spec)
        got = []
        for name in ("A", "B", "B", "A"):
            res = run(trees[name], bench_args)
            failed |= res is None
            head = {k: res[k] for k in HEADLINE if res and k in res}
            got.append((name, head))
            print(f"[ab] {spec} | {name}: {json.dumps(res)}", flush=True)
        print(f"[ab] {spec} | A B B A: "
              f"{[(n, h.get('value')) for n, h in got]} "
              f"{json.dumps(got)}", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
