"""Samples of all optimizer steps completed in the window over the window's
seconds; the window ends in a device synchronize."""


def read(ctx):
    run = ctx.run
    if not getattr(run, "steps", 0) or run.window_s <= 0:
        return None
    return run.steps * run.batch_size / run.window_s
