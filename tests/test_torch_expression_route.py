"""The port's device rule (tidb_tpu_torch/expression/torch_ns.py
device_form) against the reference's route, and the namespace forms the
new op families need.

- Every op name the reference lets into a device fragment (its registry
  less _HOST_ONLY: 168 names) is device-safe in the port too and runs
  on the device in at least one case of tests/torch_builtin_cases.py.
- For every case, the rule routes the shape to the device exactly when
  the reference's jit trace of it (jax.make_jaxpr of its jnp EvalCtx)
  succeeds; a declined shape names its reason.
- TorchNS's shifts give numpy's answers for counts of -1, 63, 64 and
  more, uint64 rides as int64 bits, and astype names its dtype."""
import numpy as np
import pytest
import torch

import torch_builtin_cases as T


def _reference_device_safe():
    """The reference's device-safe evaluator names; predict() is its ML
    module's, registered when that module is imported."""
    import tidb_tpu.expression  # noqa: F401  (registers builtins_ext)
    from tidb_tpu.expression import vec as rv
    return {n for n in rv._REGISTRY if n not in rv._HOST_ONLY} - \
        {"predict"}


def test_every_device_safe_op_has_a_device_form_and_a_case():
    """The port lets the reference's 168 op names into a device fragment,
    and each runs on the device in at least one case."""
    from tidb_tpu_torch.expression import vec as pv
    from tidb_tpu_torch.expression.torch_ns import device_form, ops_of
    safe = _reference_device_safe()
    assert len(safe) == 168
    assert {n for n in pv._REGISTRY if n not in pv._HOST_ONLY} - \
        {"predict"} == safe
    on_device = set()
    for name in T.CASES:
        expr = T.port_expr(name)
        if device_form(expr, T.masked_cols()) is None:
            ops_of(expr, on_device)
    assert safe <= on_device, sorted(safe - on_device)


def _traces(name):
    import jax
    import jax.numpy as jnp
    REF = T.ref()
    hc = T._host_cols(REF)
    keys = sorted(hc)
    expr = T.CASES[name][1](REF)

    def body(*arrs):
        cols = {k: (d, nl if hc[k][1] is not None else None, hc[k][2])
                for k, d, nl in zip(keys, arrs[0::2], arrs[1::2])}
        ctx = REF.EvalCtx(jnp, T.N, cols, host=False)
        d, nl, _sd = REF.eval_expr(ctx, expr)
        return (jnp.asarray(0 if isinstance(d, str) else d),
                REF.nulls(ctx, nl))
    args = []
    for k in keys:
        d, nl, _sd = hc[k]
        args += [jnp.asarray(d), jnp.asarray(
            nl if nl is not None else np.zeros(T.N, dtype=bool))]
    try:
        jax.make_jaxpr(body)(*args)
    except Exception:                   # noqa: BLE001
        return False
    return True


def test_committed_results_cover_every_case():
    """tests/torch_builtin_expected.json holds one result for each case
    and no other (each case's check holds its result to the
    reference's)."""
    import json
    with open(T.EXPECTED_PATH) as f:
        assert sorted(json.load(f)) == sorted(T.CASES)


@pytest.mark.parametrize("name", sorted(T.CASES))
def test_rule_routes_as_the_reference_trace(name):
    from tidb_tpu_torch.expression.torch_ns import device_form
    decline = device_form(T.port_expr(name), T.masked_cols())
    assert (decline is None) == _traces(name), (name, decline)
    if decline is not None:
        assert decline.kind == "host_bound", decline
        assert decline.reason.startswith("host-bound shape: "), decline


def test_rule_reasons_name_op_and_argument():
    from tidb_tpu_torch.expression.torch_ns import device_form
    P = T.PORT
    cases = [
        (P.F("cast_char", [T.C(P, "i")], P.s),
         "host-bound shape: cast_char of int"),
        (P.F("hex", [T.C(P, "d")], P.s),
         "host-bound shape: hex of decimal"),
        (P.F("concat", [T.C(P, "s"), T.C(P, "sd")], P.s),
         "host-bound shape: concat of several columns"),
        (P.F("quote", [T.C(P, "s")], P.s),
         "host-bound shape: quote of a nullable value"),
        (P.F("unix_timestamp", [T.C(P, "sd")], P.i),
         "host-bound shape: unix_timestamp of text"),
    ]
    for expr, want in cases:
        assert device_form(expr) == ("host_bound", want)
    assert device_form(P.F("rand", [], P.f)) == ("unsafe",
                                                 "no device form: rand")
    # a column bound without a NULL mask: QUOTE runs on the device
    assert device_form(P.F("quote", [T.C(P, "s")], P.s),
                       lambda idx: False) is None


def test_shifts_give_numpy_answers():
    from tidb_tpu_torch.expression.torch_ns import TorchNS
    xp = TorchNS("cpu")
    a = np.array([1, -1, 5, T.I64_MIN, T.I64_MAX, -8, 3], dtype=np.int64)
    b = np.array([64, -1, 63, 1, 65, 100, -64], dtype=np.int64)
    for fn in ("left_shift", "right_shift"):
        got = getattr(xp, fn)(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_array_equal(got.numpy(), getattr(np, fn)(a, b))
        got = getattr(xp, fn)(torch.from_numpy(a), 64)
        np.testing.assert_array_equal(got.numpy(), getattr(np, fn)(a, 64))


def test_uint64_rides_as_int64_bits():
    from tidb_tpu_torch.expression.torch_ns import TorchNS, torch_dtype
    xp = TorchNS("cpu")
    assert xp.uint64((1 << 64) - 1) == -1
    assert xp.uint64(1 << 63) == T.I64_MIN
    assert torch_dtype(xp.uint64) == torch.int64
    assert torch_dtype(np.uint64) == torch.int64
    u = np.array([(1 << 64) - 1, 1 << 63, 5], dtype=np.uint64)
    t = xp.asarray(u)
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(t.numpy(), u.view(np.int64))
    assert xp.astype(t > 0, np.int64).dtype == torch.int64
    assert int(xp.asarray(np.uint64((1 << 64) - 1))) == -1
