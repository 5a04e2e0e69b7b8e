"""Host CUDA API calls that reached the device (a kernel, copy or
set; a CUDA graph's replay counts once) inside the sampler's ranges, over
the UNet evaluations the traffic gives the traced window's requests (steps
times passes, the restart passes included), so that a replayed step still
counts as its evaluations."""

from benchmark.harness.launches import calls_in


def read(ctx):
    run = ctx.run
    requests = getattr(run, "traced_requests", 0)
    if ctx.trace is None or not requests:
        return None
    recipe = run.recipe
    evals = requests * (1 + int(recipe["restarts"])) * int(recipe["steps"])
    return calls_in(ctx.trace, "bench.sampler") / evals
