"""Parser, plan cache and planner time a statement: the server's
statement less its execute span (session bookkeeping included), as a
mean over the window's statements."""


def read(ctx):
    pairs = ctx["server"]
    if not pairs:
        return None
    return sum(stmt - ex for stmt, ex, _lat in pairs) / len(pairs) * 1e3
