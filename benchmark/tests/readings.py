"""Readings of the numbers a cell compares, for setting its limits.

    python3 -m benchmark.tests.readings --workload <cell> --program port|control \
        --seeds 1,2,3 [--seconds 4] [--fault half_batch] [--out build/readings.jsonl]

Runs the cell once per seed in this one process (set-up, a short window at
the cell's own load, the comparison) on the card, with the program or with
the control (the reference in the next lower precision in its place), and
appends each run's result line, with its seed and program, to ``--out``.
With ``--fault`` the program runs with that fault (``faults.py``) planted
underneath.  The lower reading of a number is the largest the sound program
gives over a dozen seeds or more; the upper the smallest the control, or a
fault of a training cell, gives.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time
from pathlib import Path

from benchmark.tests import faults

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program", choices=("port", "control"), default="port")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    ap.add_argument("--out", default="build/readings.jsonl")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness.main import keep_out_jax

    keep_out_jax()
    import torch

    from benchmark.harness import main as harness, spec

    if not torch.cuda.is_available():
        print("error: readings are taken on the card", file=sys.stderr)
        return 3
    cell = spec.resolve(ROOT, args.workload)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        buf = io.StringIO()
        fault = (faults.FAULTS[args.fault](cell.traffic["runner"]) if args.fault
                 else contextlib.nullcontext())
        with fault:
            rc = harness.run_cell(ROOT, cell, seed, args.seconds, False, "cuda",
                                  time.perf_counter(), program=args.program, out=buf)
        line = json.loads(buf.getvalue().strip().splitlines()[-1]) if rc == 0 else None
        rec = {"workload": args.workload, "program": args.program, "fault": args.fault,
               "seed": seed,
               "rc": rc, "checks": line and line["checks"],
               "attempted": line and line["attempted"]}
        print(json.dumps(rec), flush=True)
        with out.open("a") as f:
            f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
