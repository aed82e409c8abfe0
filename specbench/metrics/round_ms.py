"""Window seconds per fused round (admissions between rounds included)."""


def read(ctx):
    return 1e3 * ctx.window_s / ctx.rounds if ctx.rounds else None
