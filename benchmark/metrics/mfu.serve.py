"""Percent of the H100's bf16 peak: model FLOPs of the requests completed in
the measured window (counted from the reference's shapes) over the window's
seconds times 989 TFLOP/s."""

from benchmark.harness.peaks import FLOPS


def read(ctx):
    run = ctx.run
    if not getattr(run, "records", None) or run.window_s <= 0:
        return None
    done = len(run.records) * run.flops_per_request
    return 100.0 * done / (run.window_s * FLOPS["bfloat16"])
