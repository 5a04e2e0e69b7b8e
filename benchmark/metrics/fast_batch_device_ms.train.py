"""Device milliseconds a step of the kernels launched inside the fast
path's ``_fast_batch`` (the minibatch draw, gather and augmentation on the
device), in the traced window."""


def read(ctx):
    spans = getattr(ctx.run, "spans", None)
    if ctx.trace is None or spans is None or not spans.calls.get("fast_batch"):
        return None
    return 1e3 * ctx.trace.device_s_in("bench.fast_batch") / len(spans.calls["fast_batch"])
