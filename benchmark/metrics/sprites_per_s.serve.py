"""Sprites of the requests completed in the measured window over the
window's seconds.  A per-layer reading, like ``request_p50_s.serve``: it
swings with the host's speed, and a ``--trace 1`` run's sampler
synchronizes lower it a little."""


def read(ctx):
    run = ctx.run
    if not getattr(run, "records", None) or run.window_s <= 0:
        return None
    return len(run.records) * int(run.recipe.get("sprites_per_request", 1)) / run.window_s
