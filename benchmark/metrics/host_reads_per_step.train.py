"""Deliberate device-to-host reads a step, as the program counts them
(``host_reads`` of ``psg_tpu_torch.utils.profiling``), over every optimizer
step the program made in the run: the checked first steps and the steps of
both windows.  ``None`` for a program that keeps no such counter."""

from benchmark.runners.training import CHECKED_STEPS


def read(ctx):
    run = ctx.run
    if getattr(run, "program", None) != "port":
        return None
    try:
        from psg_tpu_torch.utils.profiling import HOST_READS, counts
    except ImportError:
        return None
    reads = counts().get(HOST_READS)
    steps = CHECKED_STEPS + run.steps + run.traced_steps
    if reads is None or not steps:
        return None
    return reads / steps
