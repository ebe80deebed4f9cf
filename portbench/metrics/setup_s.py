"""Seconds from the interpreter's start to the barrier that opens the
window: imports, the device's context, generation, bulk load, ANALYZE,
server start, client spawn and warm-up."""


def read(ctx):
    return ctx["setup_s"]
