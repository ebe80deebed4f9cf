"""MPP exchanges a statement: the program's
tidb_tpu_mpp_exchange_total, summed over its types, over the window."""


def read(ctx):
    n = sum(v for k, v in ctx["delta"].items()
            if k.startswith("mpp_exchange."))
    if not n or not ctx["stmts"]:
        return None
    return n / len(ctx["stmts"])
