#!/usr/bin/env python3
"""A kernel of two trees of psg_tpu_torch, timed in turns on one card.

    python3 scripts/torch_kernel_ab.py OTHER_TREE [--kernel spatial|flash]
        [--dtype bfloat16|float32] [--json PATH]

OTHER_TREE is an unpacked earlier commit (``git archive``).  Each run is a
process of its own that imports ``psg_tpu_torch`` from one tree, builds that
tree's kernel library and times its wrapper on ``chip_smoke.py``'s phase-2
cases of that kernel (this tree's cases, inputs and device timing: CUDA-graph
replay of 30 calls over inputs rotated past the L2, median of 5 replays):
``fused_spatial_xattn`` on the spatial cases, or ``flash_sdpa`` on the flash
cases (a forward that takes no gradient); for flash, a tree whose forward
can write the row logsumexp is also timed with it (``lse_kernel_ms``, the
forward that training runs).  The order is other, this, this, other.  Prints
one JSON line per run, then the card's name and power limit.  Needs one
CUDA card; imports no JAX.
"""

import argparse
import importlib.util
import inspect
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _time_cases(smoke, cases, fn=None):
    times = {}
    for case in cases:
        n_sets = max(2, min(8, math.ceil(2 * smoke.L2_BYTES / case["bytes"])))
        sets = [case["make"](17 * i) for i in range(n_sets)]
        times[case["name"]] = smoke.device_ms(fn(sets[0]) if fn else case["kernel"], sets, 30)
        del sets
    return times


def worker(tree: Path, kernel: str, dtype_name: str):
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    from psg_tpu_torch.ops import cuda_build, flash_attention, spatial_xattn

    module = spatial_xattn if kernel == "spatial" else flash_attention
    if not Path(module.__file__).resolve().is_relative_to(tree.resolve()):
        raise SystemExit(f"psg_tpu_torch came from {module.__file__}, not {tree}")
    dtype = getattr(torch, dtype_name)
    build = cuda_build.build_all([module.KERNEL])[module.KERNEL.name]
    out = {"tree": str(tree), "kernel": kernel, "dtype": dtype_name,
           "build_s": build["seconds"]}
    if kernel == "spatial":
        out["kernel_ms"] = _time_cases(smoke, smoke.spatial_cases(dtype))
    else:
        fa = flash_attention
        cases = smoke.flash_cases(dtype)
        out["kernel_ms"] = _time_cases(smoke, cases)
        if "lse" in inspect.signature(fa._launch).parameters:
            def with_lse(_args):
                def fn(q, k, v, bias):
                    return fa._launch(q, k, v, fa._key_bias(bias, q.shape[0], k.shape[2]),
                                      q.shape[-1] ** -0.5, lse=True)
                return fn
            out["lse_kernel_ms"] = _time_cases(smoke, cases, with_lse)
        del cases
    torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", type=Path, help="the other tree's root")
    ap.add_argument("--kernel", choices=("spatial", "flash"), default="spatial")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--json", help="also write the runs here")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker, args.kernel, args.dtype)
    runs = []
    for tree in (args.other, ROOT, ROOT, args.other):
        out = subprocess.run([sys.executable, __file__, str(args.other), "--worker",
                              str(tree), "--kernel", args.kernel, "--dtype", args.dtype],
                             capture_output=True, text=True, check=True)
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
