"""The 95th percentile of the served statement's latency on the clients'
clocks, over every statement of the window."""
import numpy as np


def read(ctx):
    lat = [s["lat_ms"] for s in ctx["stmts"]]
    return float(np.percentile(lat, 95)) if lat else None
