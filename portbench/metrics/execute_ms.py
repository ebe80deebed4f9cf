"""Executor and copr time a statement: the session's `execute` span
(executor open, all chunks, close), as a mean over the window's
statements."""


def read(ctx):
    pairs = ctx["server"]
    if not pairs:
        return None
    return sum(ex for _stmt, ex, _lat in pairs) / len(pairs) * 1e3
