"""Device milliseconds of the kernels launched inside the UNet's ranges over
its evaluations, in the traced window."""


def read(ctx):
    spans = getattr(ctx.run, "spans", None)
    if ctx.trace is None or spans is None or not spans.calls.get("unet"):
        return None
    return 1e3 * ctx.trace.device_s_in("bench.unet") / len(spans.calls["unet"])
