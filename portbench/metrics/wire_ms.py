"""Wire server time a statement: the client's latency less the server's
statement (the harness's timer around the outermost Session.execute), as
a mean over the window's statements."""


def read(ctx):
    pairs = ctx["server"]
    if not pairs:
        return None
    return sum(lat - stmt for stmt, _ex, lat in pairs) / len(pairs) * 1e3
