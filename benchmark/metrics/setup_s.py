"""Seconds from process start to the first timed request or step: loading,
weights, data, kernel builds or loads, warm-up."""


def read(ctx):
    return ctx.setup_seconds
