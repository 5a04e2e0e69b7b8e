"""Percent of the H100's bf16 peak: model FLOPs of the optimizer steps
completed in the measured window (the reference's forward, the input
gradients upstream of a trained leaf and the trained leaves' weight
gradients, counted on the meta device) over the window's seconds times
989 TFLOP/s."""

from benchmark.harness.peaks import FLOPS


def read(ctx):
    run = ctx.run
    if not getattr(run, "steps", 0) or run.window_s <= 0:
        return None
    return 100.0 * run.steps * run.flops_per_step / (run.window_s * FLOPS["bfloat16"])
