"""One run of one cell: set-up, the measured window, the comparison with the
reference, and the result line.

Every cell-specific piece is found by name: the runner named by the traffic
file's ``runner`` key (``benchmark/runners/<runner>.py``), and one reader
``benchmark/metrics/<metric>.py`` for each metric the cell reports.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

from benchmark.harness import spec as spec_

FORBIDDEN = ("jax", "jaxlib", "flax", "psg_tpu")


def keep_out_jax() -> None:
    """Keep the libraries the port uses from loading JAX in this process:
    ``transformers`` and its kin read ``USE_FLAX``/``USE_JAX``; TensorBoard,
    which the trainers log through, imports TensorFlow where it is installed,
    and TensorFlow imports JAX, so TensorFlow is marked absent and TensorBoard
    takes its own stub.  Call before the port is imported."""
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.modules.setdefault("tensorflow", None)


def parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules():
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, compared
    whole (``psg_tpu_torch`` is not ``psg_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def reader(root, name: str):
    path = Path(root) / "benchmark" / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def runner(cell):
    return importlib.import_module(f"benchmark.runners.{cell.traffic['runner']}")


class Context:
    """What a metric reader reads: the set-up time, the runner's run (its
    measured window's records and host spans, its traced window's spans,
    its model FLOPs) and the traced window's reduced trace (``None``
    without ``--trace 1``)."""

    def __init__(self, run, setup_seconds, trace):
        self.run = run
        self.setup_seconds = setup_seconds
        self.trace = trace


def run_cell(root, cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             program: str = "port", out=sys.stdout, err=sys.stderr) -> int:
    """Set up, measure, compare and print one run; returns the exit code.
    ``device`` is ``cuda`` for a measured run; the CPU serves the tests'
    rehearsals.  ``program``: ``port`` serves the cell, ``control`` puts
    the reference in lower precision in its place."""
    import torch

    from benchmark.harness.trace import Tracer

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    print(f"set-up before the runner (s): {time.perf_counter() - t_start:.2f}", file=err)
    run = runner(cell).Run(root, cell, seed, device, program=program, trace=trace)
    print(f"weights: random, {run.n_params} parameters, drawn on {device} from seed "
          f"{seed}", file=err)
    if cuda:
        torch.cuda.synchronize()
    setup_seconds = time.perf_counter() - t_start
    # the measured window, with the profiler off; a traced run (``--trace
    # 1``) then runs a shorter window of the same traffic under it, since
    # the profiler slows the host: host times and rates are read from the
    # first window, device times from the second
    run.window(seconds, host_spans=trace)
    reduced = None
    if trace:
        tracer = Tracer() if cuda else None
        run.traced(min(seconds, float(cell.traffic.get("trace_seconds", seconds))), tracer)
        reduced = tracer.reduced if tracer is not None else None
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    run.release_program()
    checks = run.check()
    ctx = Context(run, setup_seconds, reduced)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(root, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    bad = forbidden_modules()
    if bad:
        print(f"error: modules loaded that the benchmark may not load: {bad}", file=err)
        return 4
    correct = run.failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": bool(correct), "attempted": int(run.attempted),
              "failed": int(run.failed), "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                         "count": cell.chips, "memory_peak_bytes": int(memory_peak)}}
    if reduced is not None:
        result["device"]["busy_s"] = reduced.busy_s
        result["device"]["window_s"] = reduced.window_s
        result["breakdown"] = {"device_ops": reduced.top_device_ops(10),
                               "idle_gaps": reduced.idle_gaps(10)}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0


def main(argv, root, t_start) -> int:
    args = parse(argv)
    cell = spec_.resolve(root, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"error: the cell needs {cell.chips} CUDA device(s), found {have}",
              file=sys.stderr)
        return 3
    return run_cell(root, cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
