"""The metrics registry's recording cost a statement, in both packages
in one process: tests/test_metrics.py's `select 1` loop (1,000
statements) through the reference's TestKit and the port's CPU TestKit,
with `metrics.REGISTRY.enabled` on and off, in interleaved rounds that
alternate the packages and the order of on and off. Prints each
package's min and median loop time on and off, then the calls that
only a recording statement makes (cProfile, on minus off, per
statement). test_torch_metrics.py::test_recording_overhead_under_5_percent
reads what this shows: both packages make the same recording calls.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_recording_cost.py [rounds]
"""
import cProfile
import os
import pstats
import sys
import time

N = 1000


def loop(tk):
    t0 = time.perf_counter()
    for _ in range(N):
        tk.must_exec("select 1")
    return time.perf_counter() - t0


def calls(tk, m, enabled):
    m.REGISTRY.enabled = enabled
    pr = cProfile.Profile()
    pr.enable()
    loop(tk)
    pr.disable()
    m.REGISTRY.enabled = True
    return {f"{os.path.basename(k[0])}:{k[2]}": v[1]
            for k, v in pstats.Stats(pr).stats.items()}


def main(rounds=8):
    os.environ.setdefault("TIDB_TPU_LOCKRANK", "1")
    from tidb_tpu.testkit import TestKit as RefKit
    from tidb_tpu.utils import metrics as ref_metrics
    from tidb_tpu_torch.testkit import TestKit as PortKit
    from tidb_tpu_torch.utils import metrics as port_metrics
    kits = {"reference": (RefKit(), ref_metrics),
            "port": (PortKit(device="cpu"), port_metrics)}
    for tk, _m in kits.values():
        for _ in range(300):            # warm plan/AST caches
            tk.must_exec("select 1")
    res = {k: {True: [], False: []} for k in kits}
    for r in range(rounds):
        names = list(kits) if r % 2 == 0 else list(kits)[::-1]
        for name in names:
            tk, m = kits[name]
            for en in ((False, True) if r % 4 < 2 else (True, False)):
                m.REGISTRY.enabled = en
                try:
                    res[name][en].append(loop(tk))
                finally:
                    m.REGISTRY.enabled = True
    for name in kits:
        on, off = sorted(res[name][True]), sorted(res[name][False])
        print(f"{name}: min on {on[0]:.4f} s off {off[0]:.4f} s "
              f"({(on[0] - off[0]) / N * 1e6:.1f} us/stmt); median on "
              f"{on[len(on) // 2]:.4f} s off {off[len(off) // 2]:.4f} s")
    for name, (tk, m) in kits.items():
        a, b = calls(tk, m, True), calls(tk, m, False)
        extra = {k: (a.get(k, 0) - b.get(k, 0)) / N
                 for k in set(a) | set(b) if a.get(k, 0) != b.get(k, 0)}
        print(f"{name}: calls a statement on "
              f"{sum(a.values()) / N:.1f} off {sum(b.values()) / N:.1f}; "
              f"recording only: {sum(extra.values()):.1f}",
              sorted(extra.items(), key=lambda x: -x[1])[:8])


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
