"""Host CUDA API calls that reached the device (a kernel, copy or
set; a CUDA graph's replay counts once), on any thread, over the traced
window's optimizer steps: everything a step launches, its batch, forward,
backward, optimizer and EMA."""

from benchmark.harness.launches import calls_in
from benchmark.harness.trace import WINDOW


def read(ctx):
    steps = getattr(ctx.run, "traced_steps", 0)
    if ctx.trace is None or not steps:
        return None
    return calls_in(ctx.trace, WINDOW) / steps
