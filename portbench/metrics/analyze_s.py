"""Seconds of ANALYZE over the tables the cell reads: the statistics a
table's first statement builds (stats/analyze.py), run in set-up."""


def read(ctx):
    a = ctx["analyze_s"]
    return sum(a.values()) if a else None
