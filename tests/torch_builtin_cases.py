"""Shared cases of the evaluator's builtin functions for the port's
parity tests (tests/test_torch_expression_{math,dates,strings,bits}.py
and tests/test_torch_expression_route.py).

Each case builds one expression tree in both packages over one set of
seeded numpy columns: ints with INT64_MIN/MAX, unsigned BIGINT bits at
and above 2^63, doubles with halves and negative zero (and a column with
NaN and infinities), decimals with halves, dates over leap days and
year boundaries, datetimes, dictionary-coded strings, JSON text, dates
as text and shift counts of -1, 63, 64 and more; every column but two
carries NULLs. A case runs three ways: the reference's numpy EvalCtx
(host=True), the reference's jnp EvalCtx (host=False) under jax.jit,
which either traces or fails, and the port's EvalCtx over
TorchNS("cpu") (host=False) when the port's rule (torch_ns.device_form)
routes the shape to the device, else over numpy as the port's host twin
does. The rule must route a shape to the device exactly when the
reference's trace succeeds.

The reference's numpy results of every case are committed in
tests/torch_builtin_expected.json, which the CPU tests hold to the
reference and the card's test (tests/test_torch_cuda.py, without jax)
holds the CUDA device forms to. After a change to the cases, write it
anew from the repository root with
`JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_builtin_cases.py`."""
from __future__ import annotations

import importlib
import json
import os
from types import SimpleNamespace

import numpy as np

I64_MIN = -(1 << 63)
I64_MAX = (1 << 63) - 1


def _pkg(root):
    ex = importlib.import_module(root + ".expression")
    ty = importlib.import_module(root + ".types")
    ftm = importlib.import_module(root + ".types.field_type")
    datum = importlib.import_module(root + ".types.datum")
    dec = importlib.import_module(root + ".types.decimal")
    tt = importlib.import_module(root + ".types.time_types")
    dev = importlib.import_module(root + ".chunk.device")
    vec = importlib.import_module(root + ".expression.vec")
    P = SimpleNamespace(
        Column=ex.Column, Constant=ex.Constant,
        F=ex.ScalarFunc, c=ex.const_from_py, EvalCtx=ex.EvalCtx,
        eval_expr=ex.eval_expr, eval_bool_mask=ex.eval_bool_mask,
        nulls=vec.materialize_nulls, Datum=datum.Datum,
        Kind=datum.Kind, StringDict=dev.StringDict,
        i=ty.new_bigint_type(), u=ty.new_bigint_type(unsigned=True),
        f=ty.new_double_type(), d0=ty.new_decimal_type(15, 0),
        d1=ty.new_decimal_type(15, 1), d2=ty.new_decimal_type(15, 2),
        d4=ty.new_decimal_type(15, 4),
        date=ty.new_date_type(), dt=ftm.new_datetime_type(6),
        s=ty.new_string_type(),
        sci=ty.new_string_type(collate="utf8mb4_general_ci"),
        json=ftm._mk("json", ftm.TypeClass.JSON),
        parse_date=tt.parse_date)
    P.dec = lambda s, scale: P.Constant(
        value=P.Datum(P.Kind.DECIMAL, dec.dec_to_scaled_int(s, scale),
                      scale), ft=ty.new_decimal_type(15, scale))
    P.date_c = lambda s: P.Constant(
        value=P.Datum(P.Kind.DATE, tt.parse_date(s)), ft=P.date)
    P.null = P.Constant(value=P.Datum(P.Kind.NULL, None), ft=P.i)
    P.interval = lambda n, unit: P.Constant(
        value=P.Datum(P.Kind.INT, n),
        ft=ty.new_bigint_type().clone(tp="interval_" + unit))
    return P


PORT = _pkg("tidb_tpu_torch")
_REF = []


def ref():
    """The reference package's namespace, imported on first use: the
    card's test (tests/test_torch_cuda.py) runs the cases without jax."""
    if not _REF:
        _REF.append(_pkg("tidb_tpu"))
    return _REF[0]

N = 48
_rng = np.random.default_rng(1313)


def _fill(head, tail):
    head = list(head)
    return np.array(head + list(tail[:N - len(head)]))


_days = lambda s: PORT.parse_date(s)                     # noqa: E731
S_VALS = ["Hello", "  pad me  ", "ABC", "", "ünïcödé", "12.5abc", "-3",
          "lower case", "x,y,z", "hello ", "MiXeD 42", "tab\tend",
          "héllo", "3e2", "zzz", "a'b\\c"]
J_VALS = ['{"a": 1, "b": [1, 2, {"c": "x"}], "s": "txt"}', '[1, 2, 3]',
          '"str"', 'null', 'not json', '3.5', 'true',
          '{"a": {"b": {"c": 1}}}', '[]', '{"k": [1, 2], "a": 7}']
SD_VALS = ["1998-12-01", "2000-02-29", "1999-12-31 23:59:59",
           "2024-02-29 12:00:00.5", "1970-01-01", "2000-01-01 00:00:01"]
HEX_VALS = ["48656C6C6F", "414243", "", "zz", "3132", "C3BC"]
B64_VALS = ["SGVsbG8=", "QUJD", "", "!!notb64", "MTIzNA=="]
DICTS = {"s": S_VALS, "j": J_VALS, "sd": SD_VALS, "hx": HEX_VALS,
         "b64": B64_VALS, "sci": S_VALS, "snn": S_VALS}

_date_head = [_days(s) for s in (
    "2000-02-29", "2024-02-29", "1999-12-31", "2000-01-01", "1970-01-01",
    "1969-12-31", "1900-03-01", "2100-12-31", "1996-12-30", "2004-01-04",
    "2001-12-31", "2018-12-31", "1600-02-29")]
DATA = {
    "i": _fill([I64_MIN, I64_MAX, 0, -1, 1, 7, -7, 100, -100, 1 << 62,
                -(1 << 62), 255, 65535, 12345678901],
               _rng.integers(-100000, 100000, N)).astype(np.int64),
    "i2": _fill([-3, 0, 1, 2, 3, 5, -1, 4], _rng.integers(-4, 9, N))
    .astype(np.int64),
    "u": _fill([-1, I64_MIN, I64_MAX, 0, 1, 42, I64_MIN + 5, -2, 255,
                1 << 40], _rng.integers(0, 1 << 50, N)).astype(np.int64),
    "f": _fill([0.5, 1.5, 2.5, -0.5, -2.5, -0.0, 0.0, 123.456, -987.65,
                1e15, 0.05, 2.675, -1.005, 1e-7, 1.0],
               _rng.normal(0, 100, N)),
    "fz": _fill([np.nan, -0.0, np.inf, -np.inf, 0.0, 1.0, -1.0, 0.25],
                _rng.normal(0, 10, N)),
    "d": _fill([150, -150, 250, -250, 5, -5, 0, 99999999999, 1, -1, 49,
                -51, 10050], _rng.integers(-1000000, 1000000, N))
    .astype(np.int64),
    "d4": _fill([15000, -15050, 25, 5, -5, 0, 99999, 12345],
                _rng.integers(-10 ** 8, 10 ** 8, N)).astype(np.int64),
    "dt": _fill(_date_head, _rng.integers(_days("1992-01-01"),
                                          _days("1998-12-31"), N))
    .astype(np.int64),
    "ts": None,
    "sh": _fill([-1, 0, 1, 63, 64, 65, 100, 3, 62, 2, -64, 32],
                _rng.integers(0, 70, N)).astype(np.int64),
    "yr": _fill([1999, 2000, 2024, 1900, 1970, 2100], _rng.integers(
        1990, 2030, N)).astype(np.int64),
    "per": _fill([199812, 200001, 202402, 197001, 9912, 200012],
                 _rng.integers(1995, 2030, N) * 100 +
                 _rng.integers(1, 13, N)).astype(np.int64),
}
DATA["ts"] = DATA["dt"] * 86_400_000_000 + np.array(
    [0, 86_399_999_999, 43_200_000_000, 1, 3_600_000_000, 59_000_001]
    + list(_rng.integers(0, 86_400_000_000, N - 6)), dtype=np.int64)
for _k, _vals in DICTS.items():
    DATA[_k] = _rng.integers(0, len(_vals), N).astype(np.int32)
    DATA[_k][:len(_vals)] = np.arange(len(_vals))


def _nulls(p):
    m = _rng.random(N) < p
    m[:16] = False                  # the edge values are never NULL
    return m


NULLS = {k: _nulls(0.15) for k in
         ("i", "i2", "u", "f", "fz", "d", "d4", "dt", "ts", "sh", "yr",
          "per", "s", "j", "sd", "hx", "b64", "sci")}
NULLS["i"][20] = NULLS["u"][20] = NULLS["s"][20] = True

# column index -> (data key, field type attribute)
COLS = {0: ("i", "i"), 1: ("i2", "i"), 2: ("u", "u"), 3: ("f", "f"),
        4: ("fz", "f"), 5: ("d", "d2"), 6: ("d4", "d4"), 7: ("dt", "date"),
        8: ("ts", "dt"), 9: ("s", "s"), 10: ("j", "json"), 11: ("sd", "s"),
        12: ("hx", "s"), 13: ("b64", "s"), 14: ("sh", "i"),
        15: ("yr", "i"), 16: ("per", "i"), 17: ("snn", "s"),
        18: ("sci", "sci")}
IDX = {key: idx for idx, (key, _ft) in COLS.items()}


def C(P, key):
    idx = IDX[key]
    return P.Column(idx, getattr(P, COLS[idx][1]))


def _mk_cases():
    """name -> (family, builder(P) -> expr)."""
    cases = {}

    def add(family, name, build):
        assert name not in cases, name
        cases[name] = (family, build)

    def fn(op, ft, *args):
        return lambda P: P.F(op, [a(P) for a in args], getattr(P, ft))

    col = lambda k: lambda P: C(P, k)                   # noqa: E731
    cst = lambda v: lambda P: P.c(v)                    # noqa: E731
    dec = lambda s, sc: lambda P: P.dec(s, sc)          # noqa: E731
    null = lambda P: P.null                             # noqa: E731

    # ---- (a) comparisons and NULL logic (math family)
    m = "math"
    add(m, "nullsafe_eq__int_int", fn("<=>", "i", col("i"), col("i2")))
    add(m, "nullsafe_eq__float_const", fn("<=>", "i", col("f"), cst(1.5)))
    add(m, "nullsafe_eq__int_null", fn("<=>", "i", col("i2"), null))
    add(m, "nullsafe_eq__dict_dict", fn("<=>", "i", col("s"), col("s")))
    add(m, "nullsafe_eq__nan", fn("<=>", "i", col("fz"), col("fz")))
    add(m, "istrue__int", fn("istrue", "i", col("i2")))
    add(m, "istrue__float", fn("istrue", "i", col("f")))
    add(m, "istrue__dict", fn("istrue", "i", col("s")))
    add(m, "isfalse__int", fn("isfalse", "i", col("i2")))
    add(m, "isfalse__const", fn("isfalse", "i", cst(0)))
    add(m, "nullif__int_const", fn("nullif", "i", col("i2"), cst(0)))
    add(m, "nullif__dict_const", fn("nullif", "s", col("s"), cst("ABC")))
    add(m, "nullif__float_float", fn("nullif", "f", col("f"), col("fz")))
    add(m, "greatest__ints", fn("greatest", "i", col("i"), col("i2"),
                                cst(5)))
    add(m, "greatest__float_decimal", fn("greatest", "f", col("f"),
                                         col("d")))
    add(m, "greatest__dates", fn("greatest", "date", col("dt"),
                                 lambda P: P.date_c("1995-06-17")))
    add(m, "least__decimals", fn("least", "d4", col("d"), col("d4"),
                                 dec("-0.5", 2)))
    add(m, "least__ints", fn("least", "i", col("i2"), cst(2)))
    add(m, "interval__int", fn("interval", "i", col("i"), cst(-100),
                               cst(0), cst(100), cst(10000)))
    add(m, "interval__float", fn("interval", "i", col("f"), cst(0),
                                 cst(1.5)))
    # ---- (b) math
    for op in ("abs", "sign"):
        add(m, f"{op}__int", fn(op, "i", col("i2")))
        add(m, f"{op}__float", fn(op, "f" if op == "abs" else "i",
                                  col("f")))
        add(m, f"{op}__decimal", fn(op, "d2" if op == "abs" else "i",
                                    col("d")))
    add(m, "abs__int_edges", fn("abs", "i", col("i")))
    add(m, "abs__nan_inf", fn("abs", "f", col("fz")))
    add(m, "abs__const", fn("abs", "i", cst(-7)))
    for op in ("ceil", "ceiling", "floor"):
        add(m, f"{op}__float", fn(op, "i", col("f")))
        add(m, f"{op}__decimal", fn(op, "i", col("d")))
        add(m, f"{op}__int", fn(op, "i", col("i")))
    add(m, "floor__const", fn("floor", "i", cst(-2.5)))
    add(m, "round__float", fn("round", "f", col("f")))
    add(m, "round__float_1", fn("round", "f", col("f"), cst(1)))
    add(m, "round__float_2", fn("round", "f", col("f"), cst(2)))
    add(m, "round__float_minus1", fn("round", "f", col("f"), cst(-1)))
    add(m, "round__nan_inf_zero", fn("round", "f", col("fz"), cst(1)))
    add(m, "round__decimal_0", fn("round", "d0", col("d")))
    add(m, "round__decimal_1", fn("round", "d1", col("d"), cst(1)))
    add(m, "round__decimal_3", fn("round", "d2", col("d"), cst(3)))
    add(m, "round__decimal4_2", fn("round", "d2", col("d4"), cst(2)))
    add(m, "round__decimal_minus1", fn("round", "d0", col("d"), cst(-1)))
    add(m, "round__int_minus2", fn("round", "i", col("i"), cst(-2)))
    add(m, "round__int_1", fn("round", "i", col("i2"), cst(1)))
    add(m, "truncate__float_1", fn("truncate", "f", col("f"), cst(1)))
    add(m, "truncate__decimal_1", fn("truncate", "d1", col("d"), cst(1)))
    add(m, "truncate__decimal_minus1", fn("truncate", "d0", col("d"),
                                          cst(-1)))
    add(m, "truncate__int_minus1", fn("truncate", "i", col("i2"),
                                      cst(-1)))
    add(m, "truncate__int_2", fn("truncate", "i", col("i"), cst(2)))
    for op in ("sqrt", "exp", "ln", "log", "log2", "log10"):
        add(m, f"{op}__float", fn(op, "f", col("f")))
        add(m, f"{op}__int", fn(op, "f", col("i2")))
        add(m, f"{op}__decimal", fn(op, "f", col("d")))
    add(m, "sqrt__nan_inf", fn("sqrt", "f", col("fz")))
    add(m, "exp__nan_inf", fn("exp", "f", col("fz")))
    add(m, "log__base_x", fn("log", "f", cst(2), col("f")))
    add(m, "log__col_base", fn("log", "f", col("i2"), col("d")))
    for op in ("pow", "power"):
        add(m, f"{op}__float_int", fn(op, "f", col("f"), col("i2")))
        add(m, f"{op}__int_const", fn(op, "f", col("i2"), cst(3)))
    add(m, "pow__decimal_half", fn("pow", "f", col("d"), cst(0.5)))
    add(m, "pi__const", fn("pi", "f"))
    for op in ("sin", "cos", "tan", "asin", "acos", "atan", "cot",
               "degrees", "radians"):
        add(m, f"{op}__float", fn(op, "f", col("f")))
        add(m, f"{op}__int", fn(op, "f", col("i2")))
    add(m, "sin__decimal", fn("sin", "f", col("d")))
    add(m, "degrees__nan_inf", fn("degrees", "f", col("fz")))
    add(m, "atan2__float_int", fn("atan2", "f", col("f"), col("i2")))
    add(m, "atan2__decimal_const", fn("atan2", "f", col("d"), cst(-1.5)))
    # the ops the earlier slices ported, one case each
    add(m, "plus__int", fn("+", "i", col("i2"), cst(3)))
    add(m, "minus__decimal", fn("-", "d2", col("d"), dec("0.05", 2)))
    add(m, "times__float", fn("*", "f", col("f"), col("i2")))
    add(m, "div_true__float", fn("/", "f", col("f"), col("i2")))
    add(m, "intdiv__int", fn("div", "i", col("i2"), cst(2)))
    add(m, "pct__int", fn("%", "i", col("i2"), cst(3)))
    add(m, "mod__int", fn("mod", "i", col("i2"), cst(-3)))
    add(m, "neg__float", fn("unary-", "f", col("f")))
    for op, name in (("=", "eq"), ("!=", "ne"), ("<", "lt"),
                     ("<=", "le"), (">", "gt"), (">=", "ge")):
        add(m, f"{name}__int", fn(op, "i", col("i"), col("i2")))
    add(m, "and__ints", fn("and", "i", col("i2"), col("f")))
    add(m, "or__ints", fn("or", "i", col("i2"), col("f")))
    add(m, "xor__ints", fn("xor", "i", col("i2"), col("f")))
    add(m, "not__int", fn("not", "i", col("i2")))
    add(m, "isnull__int", fn("isnull", "i", col("i2")))
    add(m, "isnotnull__float", fn("isnotnull", "i", col("f")))
    add(m, "in__ints", fn("in", "i", col("i2"), cst(1), cst(3)))
    add(m, "case_when__int", lambda P: P.F("case_when", [
        P.F(">", [C(P, "i2"), P.c(0)], P.i), C(P, "i2"), P.c(-1)], P.i))
    add(m, "if__float", lambda P: P.F("if", [
        P.F(">", [C(P, "f"), P.c(0)], P.i), C(P, "f"), P.c(0.0)], P.f))
    add(m, "ifnull__int", fn("ifnull", "i", col("i2"), cst(9)))
    add(m, "coalesce__float", fn("coalesce", "f", col("f"), col("fz"),
                                 cst(1.0)))

    # ---- (c) casts and (g) bits, uint64 (bits family)
    b = "bits"
    add(b, "cast_signed__float", fn("cast_signed", "i", col("f")))
    add(b, "cast_signed__decimal", fn("cast_signed", "i", col("d")))
    add(b, "cast_signed__dict", fn("cast_signed", "i", col("s")))
    add(b, "cast_signed__uint", fn("cast_signed", "i", col("u")))
    add(b, "cast_signed__const_str", fn("cast_signed", "i", cst("12.6")))
    add(b, "cast_unsigned__int", fn("cast_unsigned", "u", col("i")))
    add(b, "cast_unsigned__dict", fn("cast_unsigned", "u", col("s")))
    add(b, "cast_unsigned__decimal", fn("cast_unsigned", "u", col("d")))
    add(b, "cast_double__int", fn("cast_double", "f", col("i")))
    add(b, "cast_double__uint", fn("cast_double", "f", col("u")))
    add(b, "cast_double__decimal", fn("cast_double", "f", col("d")))
    add(b, "cast_double__dict", fn("cast_double", "f", col("s")))
    add(b, "cast_decimal__int", fn("cast_decimal", "d2", col("i2")))
    add(b, "cast_decimal__float", fn("cast_decimal", "d2", col("f")))
    add(b, "cast_decimal__up", fn("cast_decimal", "d4", col("d")))
    add(b, "cast_decimal__down", fn("cast_decimal", "d2", col("d4")))
    add(b, "cast_decimal__dict", fn("cast_decimal", "d2", col("s")))
    add(b, "cast_char__dict", fn("cast_char", "s", col("s")))
    add(b, "cast_char__int", fn("cast_char", "s", col("i")))
    add(b, "cast_char__date", fn("cast_char", "s", col("dt")))
    add(b, "cast_char__decimal", fn("cast_char", "s", col("d")))
    add(b, "cast_char__float", fn("cast_char", "s", col("f")))
    add(b, "cast_char__const", fn("cast_char", "s", cst(12)))
    add(b, "cast_str_to_date__dict", fn("cast_str_to_date", "date",
                                        col("sd")))
    add(b, "cast_str_to_date__const", fn("cast_str_to_date", "date",
                                         cst("2000-02-29")))
    for op in ("cast_str_to_datetime", "cast_str_to_time"):
        add(b, f"{op}__dict", fn(op, "dt", col("sd")))
        add(b, f"{op}__const", fn(op, "dt", cst("1999-12-31 23:59:59")))
    add(b, "cast_date_to_datetime__date", fn("cast_date_to_datetime",
                                             "dt", col("dt")))
    add(b, "cast_datetime_to_date__datetime", fn("cast_datetime_to_date",
                                                 "date", col("ts")))
    add(b, "bitand__uint_const", fn("&", "u", col("u"), cst(255)))
    add(b, "bitand__int_int", fn("&", "u", col("i"), col("i2")))
    add(b, "bitor__uint_int", fn("|", "u", col("u"), col("i")))
    add(b, "bitxor__int_minus1", fn("^", "u", col("i"), cst(-1)))
    add(b, "bitxor__uint_uint", fn("^", "u", col("u"), col("u")))
    add(b, "shl__int_counts", fn("<<", "u", col("i"), col("sh")))
    add(b, "shl__uint_63", fn("<<", "u", col("u"), cst(63)))
    add(b, "shl__uint_64", fn("<<", "u", col("u"), cst(64)))
    add(b, "shl__one_counts", fn("<<", "u", cst(1), col("sh")))
    add(b, "shl__uint_minus1", fn("<<", "u", col("u"), cst(-1)))
    add(b, "shr__uint_counts", fn(">>", "u", col("u"), col("sh")))
    add(b, "shr__int_60", fn(">>", "u", col("i"), cst(60)))
    add(b, "shr__uint_64", fn(">>", "u", col("u"), cst(64)))
    add(b, "shr__int_minus1", fn(">>", "u", col("i"), cst(-1)))
    add(b, "bitneg__uint", fn("~", "u", col("u")))
    add(b, "bitneg__int", fn("~", "u", col("i")))
    add(b, "bit_count__uint", fn("bit_count", "i", col("u")))
    add(b, "bit_count__int", fn("bit_count", "i", col("i")))
    add(b, "bit_count__const", fn("bit_count", "i", cst(-1)))
    add(b, "bit_count__of_and", lambda P: P.F("bit_count", [
        P.F("&", [C(P, "u"), C(P, "i")], P.u)], P.i))
    add(b, "uint_gt_2p63", fn(">", "i", col("u"), cst(I64_MAX)))
    add(b, "uint_cast_lt", lambda P: P.F("<", [
        P.F("cast_unsigned", [C(P, "i")], P.u), C(P, "u")], P.i))

    # ---- (d) dates
    t = "dates"
    date_args = (("date", col("dt")), ("datetime", col("ts")),
                 ("dict", col("sd")),
                 ("const", cst("1999-12-31")))
    for op in ("quarter", "dayofweek", "weekday", "dayofyear", "week",
               "yearweek", "to_days", "last_day", "date"):
        ft = "date" if op in ("last_day", "date") else "i"
        for kind, a in date_args:
            add(t, f"{op}__{kind}", fn(op, ft, a))
    for op in ("year", "month", "day", "dayofmonth"):
        add(t, f"{op}__datetime", fn(op, "i", col("ts")))
    for op in ("hour", "minute", "second", "microsecond"):
        add(t, f"{op}__datetime", fn(op, "i", col("ts")))
        add(t, f"{op}__date", fn(op, "i", col("dt")))
    add(t, "microsecond__dict", fn("microsecond", "i", col("sd")))
    for unit, a in (("year", col("dt")), ("hour", col("ts")),
                    ("week", col("dt")), ("quarter", col("ts")),
                    ("minute", col("ts")), ("day", col("sd"))):
        add(t, f"extract__{unit}", fn("extract", "i", cst(unit), a))
    add(t, "datediff__date_datetime", fn("datediff", "i", col("dt"),
                                         col("ts")))
    add(t, "datediff__dict_date", fn("datediff", "i", col("sd"),
                                     col("dt")))
    add(t, "datediff__date_const", fn("datediff", "i", col("dt"),
                                      cst("2000-01-01")))
    add(t, "unix_timestamp__date", fn("unix_timestamp", "i", col("dt")))
    add(t, "unix_timestamp__datetime", fn("unix_timestamp", "i",
                                          col("ts")))
    add(t, "unix_timestamp__dict", fn("unix_timestamp", "i", col("sd")))
    add(t, "unix_timestamp__const", fn("unix_timestamp", "i",
                                       cst("2000-01-01 00:00:00")))
    add(t, "from_days__int", lambda P: P.F("from_days", [
        P.F("+", [C(P, "i2"), P.c(730000)], P.i)], P.date))
    add(t, "from_days__to_days", lambda P: P.F("from_days", [
        P.F("to_days", [C(P, "dt")], P.i)], P.date))
    add(t, "makedate__cols", fn("makedate", "date", col("yr"), col("i2")))
    add(t, "makedate__const_day", fn("makedate", "date", col("yr"),
                                     cst(60)))
    add(t, "period_add__cols", fn("period_add", "i", col("per"),
                                  col("i2")))
    add(t, "period_add__const", fn("period_add", "i", col("per"),
                                   cst(13)))
    add(t, "period_diff__cols", fn("period_diff", "i", col("per"),
                                   cst(199901)))
    for unit, a, bb in (("day", col("dt"), col("ts")),
                        ("month", col("ts"), col("dt")),
                        ("year", col("dt"), cst("2000-02-29")),
                        ("quarter", col("dt"), col("ts")),
                        ("second", col("ts"), col("dt")),
                        ("hour", col("sd"), col("ts")),
                        ("week", col("dt"), col("dt"))):
        add(t, f"timestampdiff__{unit}", fn("timestampdiff", "i",
                                            cst(unit), a, bb))
    for unit, n, a in (("hour", col("i2"), col("ts")),
                       ("month", col("i2"), col("dt")),
                       ("year", cst(1), col("dt")),
                       ("quarter", col("i2"), col("ts")),
                       ("day", cst(-1), col("sd"))):
        add(t, f"timestampadd__{unit}", fn("timestampadd", "dt",
                                           cst(unit), n, a))
    add(t, "date_add__day", lambda P: P.F(
        "date_add", [C(P, "dt"), P.interval(30, "day")], P.date))
    add(t, "date_sub__month", lambda P: P.F(
        "date_sub", [C(P, "dt"), P.interval(1, "month")], P.date))
    add(t, "adddate__year", lambda P: P.F(
        "adddate", [C(P, "ts"), P.interval(1, "year")], P.dt))
    add(t, "subdate__hour", lambda P: P.F(
        "subdate", [C(P, "ts"), P.interval(5, "hour")], P.dt))

    # ---- (e) strings and (f) JSON over dictionaries
    s = "strings"
    for op in ("lower", "lcase", "upper", "ucase", "reverse", "ltrim",
               "rtrim", "md5", "sha", "sha1", "soundex", "to_base64",
               "weight_string", "quote"):
        add(s, f"{op}__dict", fn(op, "s", col("s")))
    add(s, "lower__const", fn("lower", "s", cst("AbC")))
    add(s, "quote__dict_no_nulls", fn("quote", "s", col("snn")))
    add(s, "quote__int", fn("quote", "s", col("i2")))
    for op in ("length", "octet_length", "char_length",
               "character_length", "ascii", "ord", "crc32"):
        add(s, f"{op}__dict", fn(op, "i", col("s")))
    add(s, "length__const", fn("length", "i", cst("héllo")))
    add(s, "concat__const_dict_const", fn("concat", "s", cst("<"),
                                          col("s"), cst(">")))
    add(s, "concat__two_dicts", fn("concat", "s", col("s"), col("sd")))
    add(s, "concat__dict_int", fn("concat", "s", col("s"), col("i2")))
    add(s, "concat__consts", fn("concat", "s", cst("a"), cst("b")))
    add(s, "concat__null", fn("concat", "s", col("s"), null))
    add(s, "concat__int_only", fn("concat", "s", col("i2")))
    for op in ("left", "right"):
        add(s, f"{op}__3", fn(op, "s", col("s"), cst(3)))
        add(s, f"{op}__0", fn(op, "s", col("s"), cst(0)))
    add(s, "trim__dict", fn("trim", "s", col("s")))
    add(s, "trim__leading", fn("trim", "s", col("s"), cst(" "),
                               cst("leading")))
    add(s, "trim__trailing_char", fn("trim", "s", col("s"), cst("z"),
                                     cst("trailing")))
    add(s, "replace__dict", fn("replace", "s", col("s"), cst("l"),
                               cst("LL")))
    add(s, "locate__dict", fn("locate", "i", cst("l"), col("s")))
    add(s, "locate__pos", fn("locate", "i", cst("l"), col("s"), cst(4)))
    add(s, "locate__pos0", fn("locate", "i", cst("l"), col("s"), cst(0)))
    add(s, "instr__dict", fn("instr", "i", col("s"), cst("e")))
    add(s, "lpad__dict", fn("lpad", "s", col("s"), cst(6), cst("*-")))
    add(s, "rpad__dict", fn("rpad", "s", col("s"), cst(4), cst(".")))
    add(s, "regexp__dict", fn("regexp", "i", col("s"), cst("^[A-Z]")))
    add(s, "regexp__digits", fn("regexp", "i", col("s"), cst("[0-9]+")))
    add(s, "collkey__ci", fn("_collkey", "sci", col("sci")))
    add(s, "collkey_fold__ci", fn("_collkey_fold", "sci", col("sci")))
    add(s, "collkey__int", fn("_collkey", "i", col("i2")))
    add(s, "minmaxkey__dict", fn("_minmaxkey", "s", col("s")))
    add(s, "char__consts", fn("char", "s", cst(72), cst(105)))
    add(s, "repeat__dict", fn("repeat", "s", col("s"), cst(2)))
    add(s, "space__const", fn("space", "s", cst(3)))
    add(s, "strcmp__dict_const", fn("strcmp", "i", col("s"), cst("MiXeD")))
    add(s, "strcmp__dict_dict", fn("strcmp", "i", col("s"), col("sd")))
    add(s, "field__dict", fn("field", "i", col("s"), cst("ABC"),
                             cst("zzz")))
    add(s, "field__int", fn("field", "i", col("i2"), cst(1), cst(3)))
    add(s, "elt__dict", fn("elt", "s", cst(2), cst("x"), col("s")))
    add(s, "elt__out_of_range", fn("elt", "s", cst(5), col("s")))
    add(s, "sha2__256", fn("sha2", "s", col("s"), cst(256)))
    add(s, "sha2__224", fn("sha2", "s", col("s"), cst(224)))
    add(s, "sha2__bad_bits", fn("sha2", "s", col("s"), cst(7)))
    add(s, "hex__dict", fn("hex", "s", col("s")))
    add(s, "hex__int", fn("hex", "s", col("i2")))
    add(s, "hex__const", fn("hex", "s", cst(255)))
    add(s, "unhex__dict", fn("unhex", "s", col("hx")))
    add(s, "bin__int", fn("bin", "s", col("i2")))
    add(s, "bin__const", fn("bin", "s", cst(5)))
    add(s, "oct__int", fn("oct", "s", col("i2")))
    add(s, "oct__const", fn("oct", "s", cst(64)))
    add(s, "conv__dict", fn("conv", "s", col("hx"), cst(16), cst(10)))
    add(s, "conv__int", fn("conv", "s", col("i2"), cst(10), cst(2)))
    add(s, "conv__const", fn("conv", "s", cst("ff"), cst(16), cst(10)))
    add(s, "format__decimal", fn("format", "s", col("d"), cst(1)))
    add(s, "format__float", fn("format", "s", col("f"), cst(2)))
    add(s, "format__const", fn("format", "s", cst(1234.5), cst(1)))
    add(s, "from_base64__dict", fn("from_base64", "s", col("b64")))
    for op in ("substring", "substr", "mid"):
        add(s, f"{op}__dict", fn(op, "s", col("s"), cst(2), cst(3)))
    add(s, "like__dict", fn("like", "i", col("s"), cst("%l%")))
    add(s, "json_extract__path", fn("json_extract", "json", col("j"),
                                    cst("$.a")))
    add(s, "json_extract__index", fn("json_extract", "json", col("j"),
                                     cst("$[1]")))
    add(s, "json_extract__int", fn("json_extract", "json", col("i2"),
                                   cst("$")))
    add(s, "json_unquote__extract", lambda P: P.F("json_unquote", [
        P.F("json_extract", [C(P, "j"), P.c("$.s")], P.json)], P.s))
    for op, ft in (("json_valid", "i"), ("json_length", "i"),
                   ("json_type", "s"), ("json_keys", "json"),
                   ("json_depth", "i"), ("json_pretty", "s"),
                   ("json_storage_size", "i"), ("json_unquote", "s"),
                   ("json_quote", "json")):
        add(s, f"{op}__dict", fn(op, ft, col("j")))
    add(s, "json_valid__strings", fn("json_valid", "i", col("s")))
    add(s, "json_contains__scalar", fn("json_contains", "i", col("j"),
                                       cst("1")))
    add(s, "json_contains__object", fn("json_contains", "i", col("j"),
                                       cst('{"a": 1}')))
    return cases


CASES = _mk_cases()


def names(fam):
    return sorted(n for n, (f, _b) in CASES.items() if f == fam)


# ---- running a case ---------------------------------------------------

def _host_cols(P):
    out = {}
    for idx, (key, _ft) in COLS.items():
        sd = None
        if key in DICTS:
            sd = P.StringDict()
            sd.encode(np.array(DICTS[key], dtype=object))
        out[idx] = (DATA[key].copy(), None if key == "snn" else
                    NULLS[key].copy(), sd)
    return out


def run_ref_host(name):
    REF = ref()
    ctx = REF.EvalCtx(np, N, _host_cols(REF), host=True)
    return ctx, REF.eval_expr(ctx, CASES[name][1](REF))


def run_ref_jit(name):
    """The reference's device form under jax.jit (x64), as its fragments
    trace it: -> (ok, value or exception)."""
    import jax
    import jax.numpy as jnp
    REF = ref()
    hc = _host_cols(REF)
    keys = sorted(hc)
    expr = CASES[name][1](REF)
    side = {}

    def body(*arrs):
        cols = {}
        for k, (d, nl) in zip(keys, zip(arrs[0::2], arrs[1::2])):
            cols[k] = (d, nl if hc[k][1] is not None else None, hc[k][2])
        ctx = REF.EvalCtx(jnp, N, cols, host=False)
        d, nl, sd = REF.eval_expr(ctx, expr)
        side["sdict"] = sd
        side["str"] = d if isinstance(d, str) else None
        if isinstance(d, str):
            d = 0
        return (jnp.asarray(d), REF.nulls(ctx, nl))

    args = []
    for k in keys:
        d, nl, _sd = hc[k]
        args.append(jnp.asarray(d))
        args.append(jnp.asarray(nl if nl is not None
                                else np.zeros(N, dtype=bool)))
    try:
        d, nl = jax.jit(body)(*args)
    except Exception as exc:            # noqa: BLE001
        return False, exc
    d = side["str"] if side["str"] is not None else np.asarray(d)
    return True, (d, np.asarray(nl), side["sdict"])


def port_cols(device):
    import torch
    out = {}
    for k, (d, nl, sd) in _host_cols(PORT).items():
        out[k] = (torch.from_numpy(d).to(device),
                  None if nl is None else torch.from_numpy(nl).to(device),
                  sd)
    return out


def port_expr(name):
    return CASES[name][1](PORT)


def run_port_device(name, device="cpu"):
    from tidb_tpu_torch.expression.torch_ns import TorchNS
    ctx = PORT.EvalCtx(TorchNS(device), N, port_cols(device), host=False)
    return ctx, PORT.eval_expr(ctx, port_expr(name))


def run_port_host(name):
    ctx = PORT.EvalCtx(np, N, _host_cols(PORT), host=True)
    return ctx, PORT.eval_expr(ctx, port_expr(name))


def _np(v):
    import torch
    if isinstance(v, torch.Tensor):
        return v.cpu().numpy()
    return np.asarray(v)


def normalize(val, nulls):
    """(data, nulls, sdict) -> (values as a length-N numpy array, NULL
    mask): dictionary codes decode to their strings."""
    d, _nl, sd = val
    nm = np.broadcast_to(_np(nulls).astype(bool), (N,)).copy()
    if isinstance(d, str):
        return np.array([d] * N, dtype=object), nm
    arr = np.broadcast_to(_np(d), (N,))
    if sd is not None:
        vals = list(sd.values)
        codes = arr.astype(np.int64)
        out = np.array([vals[c] if not nm[i] and 0 <= c < len(vals)
                        else None for i, c in enumerate(codes)],
                       dtype=object)
        return out, nm
    return arr, nm


def assert_same(name, got, want):
    """got/want: (values, nulls) from normalize. Ints, bools and NULL
    masks exactly; floats to rtol 1e-9 (NaN equal to NaN); strings as
    text."""
    gv, gn = got
    wv, wn = want
    np.testing.assert_array_equal(gn, wn, err_msg=f"{name}: NULL mask")
    live = ~wn
    gv, wv = gv[live], wv[live]
    if wv.dtype == object or gv.dtype == object:
        assert [str(x) for x in gv] == [str(x) for x in wv], \
            (name, list(gv), list(wv))
        return
    if wv.dtype.kind == "f" or gv.dtype.kind == "f":
        assert gv.dtype.kind == wv.dtype.kind == "f", \
            (name, gv.dtype, wv.dtype)
        np.testing.assert_allclose(gv.astype(np.float64),
                                   wv.astype(np.float64), rtol=1e-9,
                                   atol=0, equal_nan=True, err_msg=name)
        return
    assert (gv.dtype.kind == "b") == (wv.dtype.kind == "b"), \
        (name, gv.dtype, wv.dtype)
    np.testing.assert_array_equal(gv.astype(np.int64),
                                  wv.astype(np.int64), err_msg=name)


EXPECTED_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "torch_builtin_expected.json")
_EXPECTED = {}


def ref_values(name):
    """The reference's numpy EvalCtx result of a case, normalized."""
    ctx, hv = run_ref_host(name)
    return normalize(hv, ref().nulls(ctx, hv[1]))


def _encode(vn):
    v, nm = vn
    if v.dtype == object:
        vals = [None if x is None else str(x) for x in v]
    elif v.dtype.kind == "f":
        vals = [float(x) for x in v]
    else:
        vals = [int(x) for x in v]
    return {"dtype": "object" if v.dtype == object else v.dtype.str,
            "values": vals, "nulls": [int(b) for b in nm]}


def expected(name):
    """A case's committed reference result (EXPECTED_PATH) as
    (values, NULL mask), read without the reference package."""
    if not _EXPECTED:
        with open(EXPECTED_PATH) as f:
            _EXPECTED.update(json.load(f))
    e = _EXPECTED[name]
    dt = object if e["dtype"] == "object" else np.dtype(e["dtype"])
    return np.array(e["values"], dtype=dt), np.array(e["nulls"], dtype=bool)


def write_expected():
    """Writes every case's reference result to EXPECTED_PATH, one case
    per line."""
    lines = [json.dumps(name) + ": " + json.dumps(_encode(ref_values(name)))
             for name in sorted(CASES)]
    with open(EXPECTED_PATH, "w") as f:
        f.write("{\n" + ",\n".join(lines) + "\n}\n")


def masked_cols():
    """nullable(col_idx) of the bound columns: every column but "snn"
    carries a NULL mask."""
    masked = {i for i, (k, _f) in COLS.items() if k != "snn"}
    return masked.__contains__


def check_case(name):
    """The three ways of one case, and the route: the reference's jit
    trace (where it succeeds) and the port (device form where its rule
    admits the shape, the numpy host twin where it declines it) agree
    with the reference's numpy EvalCtx; the rule admits the shape
    exactly when the reference's trace succeeds; an admitted shape runs
    on "meta" tensors too, where any read of a value on the host
    raises."""
    from tidb_tpu_torch.expression.torch_ns import device_form
    want = ref_values(name)
    assert_same(name + " (committed)", expected(name), want)
    ok, jv = run_ref_jit(name)
    if ok:
        assert_same(name + " (reference jit)", normalize(jv, jv[1]), want)
    rule = device_form(port_expr(name), masked_cols())
    assert (rule is None) == ok, (name, rule, None if ok else repr(jv))
    if rule is None:
        pctx, pv = run_port_device(name)
        assert_same(name, normalize(pv, PORT.nulls(pctx, pv[1])), want)
        run_port_device(name, "meta")
    else:
        assert rule.kind == "host_bound", rule
        pctx, pv = run_port_host(name)
        assert_same(name + " (host twin)",
                    normalize(pv, PORT.nulls(pctx, pv[1])), want)


if __name__ == "__main__":
    write_expected()
