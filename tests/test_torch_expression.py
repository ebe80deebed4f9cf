"""The port's expression evaluator on its torch namespace (EvalCtx with
xp = TorchNS on the CPU) against the reference's numpy EvalCtx, over
the expressions TPC-H Q1/Q6 evaluate on the device and a sample of
tests/test_expression.py. Each case builds the same expression tree in
both packages (their expression classes are separate) over the same
numpy inputs. Ints and scaled-int decimals must match exactly, floats
to rtol 1e-9, and NULL masks exactly."""
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch


def _pkg(root):
    ex = importlib.import_module(root + ".expression")
    ty = importlib.import_module(root + ".types")
    datum = importlib.import_module(root + ".types.datum")
    dec = importlib.import_module(root + ".types.decimal")
    tt = importlib.import_module(root + ".types.time_types")
    dev = importlib.import_module(root + ".chunk.device")
    vec = importlib.import_module(root + ".expression.vec")
    P = SimpleNamespace(
        Column=ex.Column, Constant=ex.Constant, F=ex.ScalarFunc,
        c=ex.const_from_py, EvalCtx=ex.EvalCtx, eval_expr=ex.eval_expr,
        eval_bool_mask=ex.eval_bool_mask, nulls=vec.materialize_nulls,
        Datum=datum.Datum, Kind=datum.Kind, StringDict=dev.StringDict,
        i=ty.new_bigint_type(), f=ty.new_double_type(),
        d2=ty.new_decimal_type(15, 2), d4=ty.new_decimal_type(15, 4),
        d6=ty.new_decimal_type(15, 6), d20_6=ty.new_decimal_type(20, 6),
        date=ty.new_date_type(), s=ty.new_string_type(),
        parse_date=tt.parse_date)
    P.dec = lambda s, scale: P.Constant(
        value=P.Datum(P.Kind.DECIMAL, dec.dec_to_scaled_int(s, scale),
                      scale), ft=ty.new_decimal_type(15, scale))
    P.date_c = lambda s: P.Constant(value=P.Datum(P.Kind.DATE,
                                                  tt.parse_date(s)),
                                    ft=P.date)
    P.interval = lambda n, unit: P.Constant(
        value=P.Datum(P.Kind.INT, n),
        ft=ty.new_bigint_type().clone(tp="interval_" + unit))
    return P


REF = _pkg("tidb_tpu")
PORT = _pkg("tidb_tpu_torch")

N = 257
_rng = np.random.default_rng(11)
DATA = {
    "price": _rng.integers(90000, 10500000, N),            # decimal(15,2)
    "disc": _rng.integers(0, 11, N),                        # decimal(15,2)
    "tax": _rng.integers(0, 9, N),
    "qty": _rng.integers(1, 51, N) * 100,
    "ship": _rng.integers(REF.parse_date("1992-01-02"),
                          REF.parse_date("1998-12-01"), N),
    "a": _rng.integers(-50, 50, N),
    "b": _rng.integers(-5, 5, N),                           # has zeros
    "x": _rng.normal(0, 100, N),                            # double
    "flag": _rng.integers(0, 3, N).astype(np.int32),        # dict codes
}
NULLS = {"b": _rng.random(N) < 0.2, "x": _rng.random(N) < 0.1}
FLAGS = ["R", "A", "N"]

# column index -> (data key, field type attribute)
COLS = {0: ("price", "d2"), 1: ("disc", "d2"), 2: ("tax", "d2"),
        3: ("qty", "d2"), 4: ("ship", "date"), 5: ("a", "i"),
        6: ("b", "i"), 7: ("x", "f"), 8: ("flag", "s")}


def C(P, idx):
    return P.Column(idx, getattr(P, COLS[idx][1]))


CASES = {
    # ---- what Q6 / Q1 evaluate on the device
    "q6_revenue_decimal_mul": lambda P: P.F("*", [C(P, 0), C(P, 1)], P.d4),
    "q1_one_minus_disc": lambda P: P.F("-", [P.c(1), C(P, 1)], P.d2),
    "q1_charge": lambda P: P.F("*", [
        P.F("*", [C(P, 0), P.F("-", [P.c(1), C(P, 1)], P.d2)], P.d4),
        P.F("+", [P.c(1), C(P, 2)], P.d2)], P.d6),
    "q6_between_decimals": lambda P: P.F("and", [
        P.F(">=", [C(P, 1), P.dec("0.05", 2)], P.i),
        P.F("<=", [C(P, 1), P.dec("0.07", 2)], P.i)], P.i),
    "q6_lt_scaled_decimal": lambda P: P.F("<", [C(P, 3), P.c(24)], P.i),
    "q6_date_range": lambda P: P.F("and", [
        P.F(">=", [C(P, 4), P.date_c("1994-01-01")], P.i),
        P.F("<", [C(P, 4), P.date_c("1995-01-01")], P.i)], P.i),
    "q1_date_le": lambda P: P.F("<=", [C(P, 4), P.date_c("1998-09-02")],
                                P.i),
    "date_add_interval_year": lambda P: P.F(
        "date_add", [C(P, 4), P.interval(1, "year")], P.date),
    "date_sub_interval_day": lambda P: P.F(
        "date_sub", [C(P, 4), P.interval(90, "day")], P.date),
    "date_add_interval_month": lambda P: P.F(
        "date_add", [C(P, 4), P.interval(13, "month")], P.date),
    "dict_char_eq": lambda P: P.F("=", [C(P, 8), P.c("R")], P.i),
    "dict_char_ne": lambda P: P.F("!=", [C(P, 8), P.c("N")], P.i),
    "dict_char_col_eq": lambda P: P.F("=", [C(P, 8), C(P, 8)], P.i),
    # ---- a sample of tests/test_expression.py
    "int_add": lambda P: P.F("+", [C(P, 5), C(P, 6)], P.i),
    "int_mul": lambda P: P.F("*", [C(P, 5), C(P, 6)], P.i),
    "int_neg": lambda P: P.F("unary-", [C(P, 5)], P.i),
    "decimal_arith": lambda P: P.F("*", [
        C(P, 0), P.F("-", [P.dec("1", 2), P.dec("0.06", 2)], P.d2)], P.d4),
    "division_null_on_zero": lambda P: P.F("/", [C(P, 5), C(P, 6)], P.f),
    "decimal_division": lambda P: P.F("/", [C(P, 0), P.c(3)], P.d20_6),
    "intdiv": lambda P: P.F("div", [C(P, 5), C(P, 6)], P.i),
    "mod": lambda P: P.F("%", [C(P, 5), C(P, 6)], P.i),
    "float_mul_const": lambda P: P.F("*", [C(P, 7), P.c(1.5)], P.f),
    "int_plus_float": lambda P: P.F("+", [C(P, 5), C(P, 7)], P.f),
    "and_3vl": lambda P: P.F("and", [C(P, 5), C(P, 6)], P.i),
    "or_3vl": lambda P: P.F("or", [C(P, 5), C(P, 6)], P.i),
    "xor": lambda P: P.F("xor", [C(P, 5), C(P, 6)], P.i),
    "not": lambda P: P.F("not", [C(P, 6)], P.i),
    "cmp_null_prop": lambda P: P.F("=", [C(P, 6), P.c(1)], P.i),
    "isnull": lambda P: P.F("isnull", [C(P, 6)], P.i),
    "isnotnull": lambda P: P.F("isnotnull", [C(P, 7)], P.i),
    "year": lambda P: P.F("year", [C(P, 4)], P.i),
    "month": lambda P: P.F("month", [C(P, 4)], P.i),
    "day": lambda P: P.F("day", [C(P, 4)], P.i),
}


def _cols(P, torch_side):
    sd = P.StringDict()
    sd.encode(np.array(FLAGS, dtype=object))
    out = {}
    for idx, (key, _ft) in COLS.items():
        data, nulls = DATA[key], NULLS.get(key)
        if torch_side:
            data = torch.from_numpy(data.copy())
            nulls = None if nulls is None else torch.from_numpy(nulls.copy())
        out[idx] = (data, nulls, sd if key == "flag" else None)
    return out


def _as_np(v, n):
    if isinstance(v, torch.Tensor):
        v = v.numpy()
    v = np.asarray(v)
    return np.broadcast_to(v, (n,)) if v.ndim == 0 else v


@pytest.mark.parametrize("name", sorted(CASES))
def test_torch_evalctx_matches_numpy(name):
    from tidb_tpu_torch.expression.torch_ns import TorchNS, device_form
    ref_e, port_e = CASES[name](REF), CASES[name](PORT)
    assert device_form(port_e) is None, device_form(port_e)
    ref_ctx = REF.EvalCtx(np, N, _cols(REF, False), host=True)
    port_ctx = PORT.EvalCtx(TorchNS("cpu"), N, _cols(PORT, True),
                            host=False)
    rd, rn, _ = REF.eval_expr(ref_ctx, ref_e)
    pd, pn, _ = PORT.eval_expr(port_ctx, port_e)
    rnm = _as_np(REF.nulls(ref_ctx, rn), N)
    pnm = _as_np(PORT.nulls(port_ctx, pn), N)
    np.testing.assert_array_equal(pnm, rnm)
    rd, pd = _as_np(rd, N), _as_np(pd, N)
    live = ~rnm
    if rd.dtype.kind == "f":
        assert pd.dtype == np.float64
        np.testing.assert_allclose(pd[live], rd[live], rtol=1e-9)
    else:
        assert pd.dtype.kind == rd.dtype.kind, (pd.dtype, rd.dtype)
        np.testing.assert_array_equal(pd[live], rd[live])
    # filter semantics (NULL -> false) agree too
    rm = np.asarray(REF.eval_bool_mask(ref_ctx, ref_e))
    pm = PORT.eval_bool_mask(port_ctx, port_e).numpy()
    np.testing.assert_array_equal(pm, rm)


def test_torch_ns_numpy_forms():
    """The namespace's numpy-isms: dtype mapping, float64 promotion of
    python floats, searchsorted sides, uint64 carried as int64 bits."""
    from tidb_tpu_torch.expression.torch_ns import TorchNS
    xp = TorchNS("cpu")
    a = xp.asarray(np.array([1, 2, 3], dtype=np.int64))
    assert xp.where(a > 1, a, 0.5).dtype == torch.float64
    assert xp.zeros(3, dtype=bool).dtype == torch.bool
    assert xp.asarray(np.arange(3), dtype=np.float64).dtype == torch.float64
    s = xp.asarray(np.array([1, 2, 2, 3]))
    v = xp.asarray(np.array([2]))
    assert int(xp.searchsorted(s, v)[0]) == 1
    assert int(xp.searchsorted(s, v, side="right")[0]) == 3
    assert xp.uint64((1 << 64) - 1) == -1
    assert xp.asarray(np.array([1 << 63], dtype=np.uint64)).dtype == \
        torch.int64
