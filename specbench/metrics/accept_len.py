"""Mean drafts accepted per live slot verified in the window
(``stats()["accept_hist"]``, window part)."""


def read(ctx):
    n = sum(ctx.accept_hist)
    return (sum(i * h for i, h in enumerate(ctx.accept_hist)) / n
            if n else None)
