"""Percent of the H100's roofline reached by the attention calls (forward and
backward) in the traced window: the least time of every call, from its
operations and bytes (``benchmark/counters``), over the device time
launched inside the calls' ranges."""

from benchmark.harness.kernels import roofline_share


def read(ctx):
    return roofline_share(getattr(ctx.run, "spans", None), ctx.trace, "attn")
