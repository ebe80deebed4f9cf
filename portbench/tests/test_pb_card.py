"""A short run of each cell on the card at SF0.01 (the `cuda` marker;
skipped without a card)."""
import pytest

from portbench import run
from portbench.tests.conftest import MPP_SESSION, SF, bench


@pytest.mark.cuda
@pytest.mark.parametrize("workload,patch", [
    ("tpch_sf1.scan", {}), ("tpch_sf1.join", {}),
    ("tpch_sf1_mpp4.join", {"session": MPP_SESSION})])
def test_cell_on_card(workload, patch):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    res, code = run.run_cell(workload, 21, 2.0, True, device="cuda",
                             bench=bench(),
                             config_patch=dict(patch, scale_factor=SF))
    assert code == 0 and res["correct"]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
