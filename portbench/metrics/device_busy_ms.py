"""Device busy time a statement: the union of kernel and copy intervals
in the traced window over the statements it held."""


def read(ctx):
    tr, n = ctx["trace"], len(ctx["stmts"])
    if tr is None or not n or not tr.busy_s:
        return None
    return tr.busy_s / n * 1e3
