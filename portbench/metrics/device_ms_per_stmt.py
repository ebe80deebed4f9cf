"""Card time a statement: the device's busy time over the window (the
union of kernel and copy intervals, recorded from the device alone in
an untraced run) over the statements the window started, in ms."""
from .device_busy_ms import read  # noqa: F401  (the same reading)
