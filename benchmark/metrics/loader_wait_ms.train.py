"""Host milliseconds a step that the step loop waits on the trainer loader's
``next()``, in the measured window (the profiler off)."""


def read(ctx):
    run = ctx.run
    if not getattr(run, "steps", 0) or not hasattr(run, "loader_wait_s"):
        return None
    return 1e3 * run.loader_wait_s / run.steps
