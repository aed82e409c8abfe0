"""Share of the engine's slots holding a live sequence, over the window's
rounds (``ServingEngine.stats()["mean_occupancy"]``, window part)."""


def read(ctx):
    return None if not ctx.rounds else 100.0 * ctx.occupancy
