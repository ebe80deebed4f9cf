"""tidb_tpu_torch.ops.scan_kernels against tidb_tpu.ops' Pallas kernels
(interpret mode on the CPU, as tests/test_ops.py runs them) and a numpy
int64 oracle. On the CPU the wrappers run their plain PyTorch versions;
the CUDA kernels are held to those versions on the card in
test_torch_cuda.py. All comparisons are exact: the functions are int64
sums."""
import numpy as np
import pytest
import torch

from tidb_tpu.ops import masked_sums as jax_masked_sums
from tidb_tpu.ops import dense_group_sums as jax_dense_group_sums
from tidb_tpu_torch.ops import scan_kernels as sk


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import metrics, phase, device_guard
    metrics.reset_all()
    device_guard.reset()
    phase.reset()
    sk.reset_launches()
    yield


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# (n, k, mask density, value range): test_ops.py's shapes plus ragged n,
# an empty mask, negatives and k in {1, 7}
MASKED_CASES = [
    (20000, 1, 0.3, (0, 1000)),
    (20000, 7, 0.3, (-500, 500)),
    (8192, 1, 0.0, (0, 8192)),
    (8191, 7, 0.5, (-(1 << 20), 1 << 20)),
    (1, 1, 1.0, (-7, -6)),
    (12289, 7, 0.9, (-3, 3)),
]


@pytest.mark.parametrize("n,k,density,rng_vals", MASKED_CASES)
def test_masked_sums_matches_pallas(n, k, density, rng_vals):
    rng = np.random.default_rng(n + k)
    cols = [rng.integers(*rng_vals, n) for _ in range(k)]
    mask = rng.random(n) < density
    want_s, want_c = jax_masked_sums(cols, mask, interpret=True)
    got_s, got_c = sk.masked_sums([_t(c) for c in cols], _t(mask))
    assert got_s.dtype == torch.int64 and got_s.shape == (k,)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert int(got_c) == int(want_c) == int(mask.sum())
    for j, c in enumerate(cols):
        assert int(got_s[j]) == int(c[mask].sum())


# (n, k, nslots): inside the JAX kernel's float32-exact range
GROUP_CASES = [(30000, 2, 12), (8192, 1, 1), (9001, 7, 12), (16384, 7, 64),
               (5000, 1, 64)]


@pytest.mark.parametrize("n,k,nslots", GROUP_CASES)
def test_dense_group_sums_matches_pallas(n, k, nslots):
    rng = np.random.default_rng(n * 3 + nslots)
    slots = rng.integers(0, nslots, n)
    vals = [rng.integers(0, 300, n) for _ in range(k)]
    valid = rng.random(n) < 0.8
    want_s, want_c = jax_dense_group_sums(vals, slots, nslots, valid,
                                          interpret=True)
    got_s, got_c = sk.dense_group_sums([_t(v) for v in vals], _t(slots),
                                       nslots, _t(valid))
    assert got_s.shape == (k, nslots) and got_c.shape == (nslots,)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


def _group_oracle(vals, slots, nslots, valid):
    live = valid & (slots >= 0) & (slots < nslots)
    sums = np.zeros((len(vals), nslots), dtype=np.int64)
    for j, v in enumerate(vals):
        np.add.at(sums[j], slots[live], v[live])
    cnts = np.bincount(slots[live], minlength=nslots).astype(np.int64)
    return sums, cnts


@pytest.mark.parametrize("nslots", [1, 12, 64])
def test_dense_group_sums_exact_beyond_2_24(nslots):
    """Q1's charge column is ~1e11 per row: past the JAX kernel's
    float32 exactness (a fact of the reference), the port is exact."""
    rng = np.random.default_rng(nslots)
    n = 8192
    vals = [rng.integers(-(1 << 40), 1 << 40, n),
            rng.integers(10 ** 10, 2 * 10 ** 11, n)]
    slots = rng.integers(-1, nslots + 2, n)
    valid = rng.random(n) < 0.7
    want_s, want_c = _group_oracle(vals, slots, nslots, valid)
    got_s, got_c = sk.dense_group_sums([_t(v) for v in vals], _t(slots),
                                       nslots, _t(valid))
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    jax_s, _ = jax_dense_group_sums(vals, np.clip(slots, 0, nslots - 1),
                                    nslots, valid & (slots >= 0) &
                                    (slots < nslots), interpret=True)
    assert not np.array_equal(np.asarray(jax_s), want_s)


def test_wrappers_raise_on_bad_inputs():
    n = 16
    ok_col = torch.zeros(n, dtype=torch.int64)
    ok_mask = torch.ones(n, dtype=torch.bool)
    with pytest.raises(TypeError):
        sk.masked_sums([ok_col.to(torch.int32)], ok_mask)
    with pytest.raises(TypeError):
        sk.masked_sums([ok_col], ok_mask.to(torch.int64))
    with pytest.raises(ValueError):
        sk.masked_sums([ok_col[:8]], ok_mask)
    with pytest.raises(ValueError):
        sk.masked_sums([ok_col] * (sk.MAX_COLS + 1), ok_mask)
    with pytest.raises(ValueError):
        sk.masked_sums([ok_col.to("meta")], ok_mask.to("meta"))
    with pytest.raises(TypeError):
        sk.dense_group_sums([ok_col.double()], ok_col, 4, ok_mask)
    with pytest.raises(ValueError):
        sk.dense_group_sums([ok_col], ok_col, sk.MAX_SLOTS + 1, ok_mask)
    with pytest.raises(TypeError):
        sk.dense_group_sums([ok_col], ok_col.to(torch.int32), 4, ok_mask)
    assert sk.COUNTS["masked_sums"] == 0 == sk.COUNTS["dense_group_sums"]
