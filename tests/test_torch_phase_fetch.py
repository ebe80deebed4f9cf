"""Device->host materialization accounting (utils/phase.py with the
port's fetch seam utils/fetch.py): every blocking wait on the card is
counted as a sync, device->host copies as fetches and fetch_bytes.

The twin of tests/test_phase_fetch.py on tidb_tpu_torch. Where it
differs: the reference counts jax scalar conversions through its phase
hooks; the port counts at its one fetch seam, where a CPU tensor is read
in place (no wait, nothing counted) and a CUDA tensor pays one counted
sync. So the first case drives the seam with a CPU tensor (nothing
counted) and with a prefetch ticket over a stand-in event (one sync per
ticket, however many members are read); the card's own counts are in
the cuda-marked case."""
import numpy as np
import pytest
import torch

import tidb_tpu_torch.utils.phase as ph
from tidb_tpu_torch.utils import fetch


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import device_guard, metrics, phase
    metrics.reset_all()
    device_guard.reset()
    phase.reset()
    yield


class _Event:
    """A recorded CUDA event's stand-in: synchronize() counts."""

    def __init__(self):
        self.waits = 0

    def synchronize(self):
        self.waits += 1


def test_scalar_sync_and_fetch_counters():
    ph.reset()
    x = torch.arange(1024)
    # a CPU tensor is read in place: no wait, nothing counted
    assert int(fetch.host_array(x)[0]) == 0
    assert fetch.host_int(x.sum()) == 1024 * 1023 // 2
    assert np.asarray(fetch.host_array(x)).shape == (1024,)
    assert ph.current().get("syncs", 0) == 0
    # a prefetched tree: one wait for all its members
    ev = _Event()
    ticket = fetch._Ticket(ev)
    a = fetch._Fetched(torch.arange(4), ticket)
    b = fetch._Fetched(torch.arange(4) * 2, ticket)
    assert fetch.host_array(a).tolist() == [0, 1, 2, 3]
    assert fetch.host_array(b).tolist() == [0, 2, 4, 6]
    # a second ticket is a second wait
    c = fetch._Fetched(torch.ones(2), fetch._Ticket(ev))
    assert fetch.host_array(c).tolist() == [1.0, 1.0]
    s = ph.current()
    assert ev.waits == 2
    assert s.get("syncs") == 2 and s.get("sync_s", 0) >= 0
    ph.reset()
    assert ph.current() == {}


def test_nested_statements_accumulate():
    ph.reset()
    ph.stmt_enter()
    ph.add("dispatch_s", 0.5)
    ph.stmt_enter()          # internal SQL must not clobber
    ph.add("dispatch_s", 0.25)
    ph.stmt_leave()
    ph.stmt_leave()
    assert ph.current()["dispatch_s"] == 0.75


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="needs a CUDA device")
def test_scalar_sync_and_fetch_counters_on_card():
    """The card's half: an un-prefetched CUDA tensor pays its own sync
    and fetch; a prefetched tree pays one sync for all its members."""
    ph.reset()
    x = torch.arange(1024, device="cuda")
    assert fetch.host_int(x.sum()) == 1024 * 1023 // 2
    s = ph.current()
    assert s.get("syncs") == 1 and s.get("fetches") == 1
    assert s.get("fetch_bytes") == 8
    ph.reset()
    tree = fetch.prefetch({"a": x, "b": [x * 2, x[:3]]})
    assert fetch.host_array(tree["b"][1]).tolist() == [0, 1, 2]
    assert int(fetch.host_array(tree["a"])[5]) == 5
    s = ph.current()
    assert s.get("syncs") == 1 and s.get("fetches") == 3
    assert s.get("fetch_bytes") == (1024 + 1024 + 3) * 8
