"""Statements completed in the window, from every stream, over the
window's seconds: a statement started before the close and ended after
it does not count."""


def read(ctx):
    return ctx["completed"] / ctx["seconds"]
