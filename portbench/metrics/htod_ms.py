"""Host-to-device copy time a statement: the traced window's
`Memcpy HtoD` intervals over the statements it held, in ms."""


def read(ctx):
    tr, n = ctx["trace"], len(ctx["stmts"])
    if tr is None or not n or not tr.busy_s:
        return None
    return sum(v for k, v in tr.by_op.items()
               if k.startswith("Memcpy HtoD")) / n * 1e3
