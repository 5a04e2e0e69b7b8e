"""Device milliseconds a step of the kernels launched inside the trainer's
``sd_wrapper_apply`` (the SD UNet wrapper's forward: text and pooled
projections, the UNet; its backward runs after the range has closed), in
the traced window."""


def read(ctx):
    spans = getattr(ctx.run, "spans", None)
    if ctx.trace is None or spans is None or not spans.calls.get("grads"):
        return None
    if not spans.calls.get("sdunet"):
        return None
    return 1e3 * ctx.trace.device_s_in("bench.sdunet") / len(spans.calls["grads"])
