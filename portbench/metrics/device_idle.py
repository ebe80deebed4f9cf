"""The device's idle share of the traced window, in percent."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.busy_s or not tr.window_s:
        return None
    return (1.0 - tr.busy_s / tr.window_s) * 100.0
