"""Percent of the SD UNet wrapper's forward device time (``bench.sdunet``)
launched inside its Transformer2D applies (``bench.sdunet.transformer``),
in the traced window: the share of the forward that the transformer stacks
take."""


def read(ctx):
    spans = getattr(ctx.run, "spans", None)
    if ctx.trace is None or spans is None or not spans.calls.get("sdunet.transformer"):
        return None
    whole = ctx.trace.device_s_in("bench.sdunet")
    if whole <= 0.0:
        return None
    return 100.0 * ctx.trace.device_s_in("bench.sdunet.transformer") / whole
