"""Device milliseconds a step of the kernels launched inside the trainer's
``_apply_update`` (clip, skip, AdamW, EMA), in the traced window."""


def read(ctx):
    spans = getattr(ctx.run, "spans", None)
    if ctx.trace is None or spans is None or not spans.calls.get("optimizer"):
        return None
    return 1e3 * ctx.trace.device_s_in("bench.optimizer") / len(spans.calls["optimizer"])
