#!/usr/bin/env python3
"""The bf16 spatial cross-attention kernel of two trees of psg_tpu_torch,
timed in turns on one card.

    python3 scripts/torch_spatial_ab.py OTHER_TREE [--json PATH]

OTHER_TREE is an unpacked earlier commit (``git archive``).  Each run is a
process of its own that imports ``psg_tpu_torch`` from one tree, builds that
tree's ``csrc/spatial_xattn.cu`` and times its ``fused_spatial_xattn`` on
``chip_smoke.py``'s bf16 spatial cases (this tree's cases, inputs and
device timing: CUDA-graph replay of 30 calls over inputs rotated past the
L2, median of 5 replays).  The order is other, this, this, other.  Prints
one JSON line per run, then the card's name and power limit.  Needs one
CUDA card; imports no JAX.
"""

import argparse
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def worker(tree: Path):
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    from psg_tpu_torch.ops import cuda_build, spatial_xattn

    if not Path(spatial_xattn.__file__).resolve().is_relative_to(tree.resolve()):
        raise SystemExit(f"psg_tpu_torch came from {spatial_xattn.__file__}, not {tree}")
    build = cuda_build.build_all([spatial_xattn.KERNEL])["spatial_xattn"]
    times = {}
    for case in smoke.spatial_cases(torch.bfloat16):
        n_sets = max(2, min(8, math.ceil(2 * smoke.L2_BYTES / case["bytes"])))
        sets = [case["make"](17 * i) for i in range(n_sets)]
        times[case["name"]] = smoke.device_ms(case["kernel"], sets, 30)
        del sets
        torch.cuda.empty_cache()
    print(json.dumps({"tree": str(tree), "build_s": build["seconds"],
                      "kernel_ms": times}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", type=Path, help="the other tree's root")
    ap.add_argument("--json", help="also write the runs here")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker)
    runs = []
    for tree in (args.other, ROOT, ROOT, args.other):
        out = subprocess.run([sys.executable, __file__, str(args.other), "--worker",
                              str(tree)], capture_output=True, text=True, check=True)
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps({"card": card, "runs": runs}, indent=1))
    print(card, flush=True)


if __name__ == "__main__":
    main()
