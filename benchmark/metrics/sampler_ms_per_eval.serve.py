"""Host milliseconds of the sampler calls (each ending in a device
synchronize) over the UNet evaluations they made, in the measured window
(the profiler off)."""


def read(ctx):
    spans = getattr(ctx.run, "host_spans", None)
    if spans is None or not spans.calls.get("unet"):
        return None
    return 1e3 * spans.host_s["sampler"] / len(spans.calls["unet"])
