"""Percent of the time that no operation runs on the device, with the
profiler off: 1 - (device busy time per request, the union of kernel, copy
and set intervals over the traced window's requests) x (requests a second in
the measured window).  The traced window alone would read the profiler's
own slowing of the host as idle time."""


def read(ctx):
    run = ctx.run
    done, traced = run.units()
    if ctx.trace is None or not traced or not done or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / traced * done / run.window_s)
