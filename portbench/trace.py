"""torch.profiler over the window of a traced run, reduced to what the
result line carries: the device's busy seconds (the union of kernel and
copy intervals, as `bench/profile_tpch.py:_busy_us` takes it), the
device operations that took most time, and the longest idle gaps of the
device, each named by the innermost host operation of the server's
threads that was running at the gap's middle ("host:python" where none
was: the interpreter, or NumPy, between torch operations).

With `host=False` it records the device's activity alone, as the untraced
run does for an end-to-end metric read from the device: no host
operation is recorded, so the server's threads run as they do untraced,
and the idle gaps are left unnamed."""
from __future__ import annotations

import re
import time

NAME_CHARS = 64


def short(name: str) -> str:
    """A kernel's name cut to its head: template arguments and
    parameter lists dropped, at most NAME_CHARS characters."""
    if name.startswith(("Memcpy", "Memset")):
        return name[:NAME_CHARS]
    name = re.sub(r"^void ", "", name)
    out, depth = [], 0
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    head = "".join(out).strip() or name
    # the functor or implementation that tells one instance of a
    # template kernel from another
    tail = name[len(head):]
    found = re.findall(r"\w*Functor\w*", tail) or [
        w for w in re.findall(r"\w+_kernel_impl\w*|\w+_kernel_cuda", tail)
        if not w.startswith("gpu_kernel_impl")]
    head = head.replace("at::native::", "")
    return (f"{head}[{found[0]}]" if found else head)[:NAME_CHARS]


class Trace:
    """A torch.profiler session over the device's activity and, with
    `host`, every thread's host operations. `stop()` ends and reduces it:
    `busy_s`, `window_s`, `device_ops`, `by_op` (every operation's
    seconds by name), `idle_gaps`, `events`, `reduce_s`."""

    def __init__(self, device="cuda", host=True):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.cuda = device != "cpu"
        self.host = host
        acts = [ProfilerActivity.CPU] if host else []
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        try:
            cfg = torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True)
        except (AttributeError, TypeError):
            cfg = None
        self._prof = profile(activities=acts, experimental_config=cfg)

    def _sync(self):
        if self.cuda:
            import torch
            torch.cuda.synchronize()

    def start(self):
        self._sync()
        self._prof.__enter__()
        self._t = time.perf_counter()
        return self

    def stop(self):
        self._sync()
        self.window_s = time.perf_counter() - self._t
        self._prof.__exit__(None, None, None)
        t = time.perf_counter()
        from torch.autograd import DeviceType
        dev, host = [], []
        for e in self._prof.profiler.kineto_results.events():
            s = e.start_ns()
            iv = (s, s + e.duration_ns(), e.name())
            if e.device_type() == DeviceType.CUDA:
                dev.append(iv)
            elif self.host:
                host.append(iv)
        reduce_events(self, dev, host)
        self.reduce_s = time.perf_counter() - t
        return self


def reduce_events(tr, dev, host):
    """Fill `tr` from (start ns, end ns, name) of device and host
    events."""
    tr.events = len(dev)
    merged = []
    for s, e, _n in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    tr.busy_s = sum(e - s for s, e in merged) / 1e9
    by = {}
    for s, e, name in dev:
        k = short(name)
        by[k] = by.get(k, 0.0) + (e - s) / 1e9
    tr.by_op = by
    tr.device_ops = sorted(([n, v] for n, v in by.items()),
                           key=lambda kv: -kv[1])[:10]
    gaps = sorted(([merged[i][1], merged[i + 1][0]]
                   for i in range(len(merged) - 1)),
                  key=lambda g: g[0] - g[1])[:10]
    host.sort()
    tr.idle_gaps = []
    if not tr.host:
        return
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        best = None
        for s, e, name in host:
            if s > mid:
                break
            if e >= mid and (best is None or e - s < best[0]):
                best = (e - s, name)
        tr.idle_gaps.append(["host:" + (short(best[1]) if best
                                        else "python"), (g1 - g0) / 1e9])
