"""The evaluator ops the fused dimension queries put on the device (IN,
CASE, LIKE, SUBSTRING: TPC-H Q12, Q14, Q19, Q22; IF, IFNULL, COALESCE:
the LEFT materialized dims of Q13 and Q21) on the port's torch
namespace against the reference's numpy EvalCtx, as in
tests/test_torch_expression.py: the same expression tree in both
packages over the same numpy inputs, with NULLs in the columns and the
lists, dictionary-coded strings and empty IN lists. Ints and decimals
must match exactly, NULL masks exactly, and a string result is compared
as the strings its codes decode to."""
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
    dev = importlib.import_module(root + ".chunk.device")
    vec = importlib.import_module(root + ".expression.vec")
    P = SimpleNamespace(
        Column=ex.Column, Constant=ex.Constant, F=ex.ScalarFunc,
        c=ex.const_from_py, EvalCtx=ex.EvalCtx, eval_expr=ex.eval_expr,
        eval_bool_mask=ex.eval_bool_mask, nulls=vec.materialize_nulls,
        Datum=datum.Datum, Kind=datum.Kind, StringDict=dev.StringDict,
        i=ty.new_bigint_type(), d2=ty.new_decimal_type(15, 2),
        d4=ty.new_decimal_type(15, 4), s=ty.new_string_type())
    P.dec = lambda s, scale: P.Constant(
        value=P.Datum(P.Kind.DECIMAL, dec.dec_to_scaled_int(s, scale),
                      scale), ft=ty.new_decimal_type(15, scale))
    P.null = P.Constant(value=P.Datum(P.Kind.NULL, None), ft=P.i)
    return P


REF = _pkg("tidb_tpu")
PORT = _pkg("tidb_tpu_torch")

N = 301
_rng = np.random.default_rng(23)
PHONES = [f"{cc}-{_rng.integers(100, 999)}-{_rng.integers(1000, 9999)}"
          for cc in range(10, 35)]
TYPES = ["PROMO BRUSHED TIN", "STANDARD POLISHED BRASS", "PROMO_X",
         "ECONOMY ANODIZED STEEL", "promo plated", ""]
PRIOS = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
DATA = {
    "a": _rng.integers(-10, 30, N),
    "price": _rng.integers(90000, 10500000, N),        # decimal(15,2)
    "disc": _rng.integers(0, 11, N),
    "phone": _rng.integers(0, len(PHONES), N).astype(np.int32),
    "ptype": _rng.integers(0, len(TYPES), N).astype(np.int32),
    "prio": _rng.integers(0, len(PRIOS), N).astype(np.int32),
}
NULLS = {"a": _rng.random(N) < 0.15, "phone": _rng.random(N) < 0.1,
         "ptype": _rng.random(N) < 0.1, "prio": _rng.random(N) < 0.05}
DICTS = {"phone": PHONES, "ptype": TYPES, "prio": PRIOS}
COLS = {0: ("a", "i"), 1: ("price", "d2"), 2: ("disc", "d2"),
        3: ("phone", "s"), 4: ("ptype", "s"), 5: ("prio", "s")}


def C(P, idx):
    return P.Column(idx, getattr(P, COLS[idx][1]))


def _revenue(P):
    return P.F("*", [C(P, 1), P.F("-", [P.c(1), C(P, 2)], P.d2)],
               P.d4)


CASES = {
    # ---- IN
    "in_ints": lambda P: P.F("in", [C(P, 0), P.c(1), P.c(3), P.c(5)], P.i),
    "in_ints_with_null_in_list": lambda P: P.F(
        "in", [C(P, 0), P.c(2), P.null, P.c(7)], P.i),
    "in_long_int_list": lambda P: P.F(
        "in", [C(P, 0)] + [P.c(v) for v in range(-3, 27, 3)], P.i),
    "in_empty_list": lambda P: P.F("in", [C(P, 0)], P.i),
    "in_dict_strings": lambda P: P.F(
        "in", [C(P, 5), P.c("1-URGENT"), P.c("5-LOW")], P.i),
    "in_dict_strings_none_present": lambda P: P.F(
        "in", [C(P, 5), P.c("9-NEVER")], P.i),
    "in_dict_strings_empty_list": lambda P: P.F("in", [C(P, 5)], P.i),
    "in_decimals": lambda P: P.F(
        "in", [C(P, 2), P.dec("0.05", 2), P.dec("0.07", 2)], P.i),
    # ---- CASE
    "case_q12_high_line": lambda P: P.F("case_when", [
        P.F("or", [P.F("=", [C(P, 5), P.c("1-URGENT")], P.i),
                   P.F("=", [C(P, 5), P.c("2-HIGH")], P.i)], P.i),
        P.c(1), P.c(0)], P.i),
    "case_q14_promo_revenue": lambda P: P.F("case_when", [
        P.F("like", [C(P, 4), P.c("PROMO%")], P.i), _revenue(P),
        P.c(0)], P.d4),
    "case_no_else_is_null": lambda P: P.F("case_when", [
        P.F(">", [C(P, 0), P.c(5)], P.i), C(P, 0)], P.i),
    "case_null_condition_and_value": lambda P: P.F("case_when", [
        P.F("<", [C(P, 0), P.c(0)], P.i), P.c(-1),
        P.F("=", [C(P, 0), P.c(0)], P.i), P.null, C(P, 0)], P.i),
    "case_dict_string_result": lambda P: P.F("case_when", [
        P.F(">", [C(P, 0), P.c(10)], P.i), C(P, 5), P.c("low")], P.s),
    # ---- LIKE
    "like_prefix": lambda P: P.F("like", [C(P, 4), P.c("PROMO%")], P.i),
    "like_underscore_and_escape": lambda P: P.F(
        "like", [C(P, 4), P.c("PROMO\\_%")], P.i),
    "like_infix": lambda P: P.F("like", [C(P, 4), P.c("%AN%S_EE%")], P.i),
    "like_phone_digits": lambda P: P.F("like", [C(P, 3), P.c("1_-%")],
                                       P.i),
    # ---- SUBSTRING
    "substring_q22_country_code": lambda P: P.F(
        "substring", [C(P, 3), P.c(1), P.c(2)], P.s),
    "substring_negative_start": lambda P: P.F(
        "substring", [C(P, 3), P.c(-4)], P.s),
    "substring_past_end": lambda P: P.F(
        "substring", [C(P, 4), P.c(30), P.c(3)], P.s),
    "substring_in_q22": lambda P: P.F("in", [
        P.F("substring", [C(P, 3), P.c(1), P.c(2)], P.s),
        P.c("13"), P.c("31"), P.c("23"), P.c("29"), P.c("30"), P.c("18"),
        P.c("17")], P.i),
    # ---- IF / IFNULL / COALESCE
    "ifnull_int_zero": lambda P: P.F("ifnull", [C(P, 0), P.c(0)], P.i),
    "ifnull_null_fallback": lambda P: P.F("ifnull", [C(P, 0), P.null],
                                          P.i),
    "ifnull_dict_string": lambda P: P.F("ifnull", [C(P, 5), P.c("none")],
                                        P.s),
    "if_int": lambda P: P.F("if", [P.F(">", [C(P, 0), P.c(5)], P.i),
                                   C(P, 0), P.c(-1)], P.i),
    "if_null_condition": lambda P: P.F("if", [
        P.F("=", [C(P, 0), P.c(3)], P.i), P.null, C(P, 0)], P.i),
    "coalesce_int": lambda P: P.F("coalesce", [C(P, 0), P.null, P.c(7)],
                                  P.i),
    # ---- the rank recode around MIN/MAX of a string
    "minmaxkey_dict": lambda P: P.F("_minmaxkey", [C(P, 4)], P.s),
}


def _cols(P, torch_side):
    out = {}
    for idx, (key, _ft) in COLS.items():
        data, nulls = DATA[key], NULLS.get(key)
        sd = None
        if key in DICTS:
            sd = P.StringDict()
            sd.encode(np.array(DICTS[key], dtype=object))
        if torch_side:
            data = torch.from_numpy(data.copy())
            nulls = None if nulls is None else torch.from_numpy(nulls.copy())
        out[idx] = (data, nulls, sd)
    return out


def _as_np(v, n):
    if isinstance(v, torch.Tensor):
        v = v.numpy()
    v = np.asarray(v)
    return np.broadcast_to(v, (n,)) if v.ndim == 0 else v


def _decoded(d, sd, live):
    """String results: the values the codes stand for, at live rows."""
    return [sd.values[int(c)] for c in np.asarray(d)[live]]


@pytest.mark.parametrize("name", sorted(CASES))
def test_torch_op_matches_numpy(name):
    from tidb_tpu_torch.expression.torch_ns import TorchNS, device_form
    ref_e, port_e = CASES[name](REF), CASES[name](PORT)
    assert device_form(port_e) is None, device_form(port_e)
    ref_ctx = REF.EvalCtx(np, N, _cols(REF, False), host=True)
    port_ctx = PORT.EvalCtx(TorchNS("cpu"), N, _cols(PORT, True),
                            host=False)
    rd, rn, rsd = REF.eval_expr(ref_ctx, ref_e)
    pd, pn, psd = PORT.eval_expr(port_ctx, port_e)
    rnm = _as_np(REF.nulls(ref_ctx, rn), N)
    pnm = _as_np(PORT.nulls(port_ctx, pn), N)
    np.testing.assert_array_equal(pnm, rnm)
    live = ~rnm
    rd, pd = _as_np(rd, N), _as_np(pd, N)
    assert (rsd is None) == (psd is None)
    if rsd is not None:
        assert _decoded(pd, psd, live) == _decoded(rd, rsd, live)
    else:
        assert pd.dtype.kind == rd.dtype.kind, (pd.dtype, rd.dtype)
        np.testing.assert_array_equal(pd[live], rd[live])
    # filter semantics (NULL -> false) agree too
    if rsd is None:
        rm = np.asarray(REF.eval_bool_mask(ref_ctx, ref_e))
        pm = PORT.eval_bool_mask(port_ctx, port_e).numpy()
        np.testing.assert_array_equal(pm, rm)


def test_case_without_null_branches_has_no_null_mask():
    """CASE WHEN c THEN x ELSE 0 over non-NULL operands carries no null
    mask, so a sum of it stays a kernel argument (dag_exec._int64_arg)."""
    from tidb_tpu_torch.expression.torch_ns import TorchNS
    e = CASES["case_q12_high_line"](PORT)
    ctx = PORT.EvalCtx(TorchNS("cpu"), N, _cols(PORT, True), host=False)
    d, nl, _ = PORT.eval_expr(ctx, e)
    assert nl is None and d.dtype == torch.int64


def _predict_expr(root, P):
    """predict(m, a, price, disc) with a seeded 3 -> 16 -> 8 -> 1 ReLU
    MLP, bound as each package's rewriter binds it (an MLFunc over a
    ModelHandle)."""
    low = importlib.import_module(root + ".ml.lowering")
    reg = importlib.import_module(root + ".ml.registry")
    models = importlib.import_module(root + ".models")
    ty = importlib.import_module(root + ".types")
    rng = np.random.default_rng(31)
    dims = [3, 16, 8, 1]
    ws = [(rng.standard_normal((a, b)) * 0.5).astype(np.float32)
          for a, b in zip(dims, dims[1:])]
    bs = [rng.standard_normal(b).astype(np.float32) for b in dims[1:]]
    info = models.ModelInfo(id=1, name="m", uri="", kind="mlp",
                            params={"in_dim": 3, "out_dim": 1}, version=1,
                            public=True)
    h = reg.ModelHandle(info, ws, bs)
    return low.MLFunc(op="predict", args=[C(P, 0), C(P, 1), C(P, 2)],
                      ft=ty.new_double_type(), model=h)


def test_torch_predict_matches_numpy():
    """predict() (a device form) over an int, a decimal(15,2) and a
    NULL-bearing column: values within rtol 1e-5 of the numpy EvalCtx's
    (float32 products on both sides), NULL masks exact, and
    `predict(...) > 0` equal away from a zero score."""
    from tidb_tpu_torch.expression.torch_ns import TorchNS, device_form
    ref_e, port_e = _predict_expr("tidb_tpu", REF), \
        _predict_expr("tidb_tpu_torch", PORT)
    assert device_form(port_e) is None, device_form(port_e)
    ref_ctx = REF.EvalCtx(np, N, _cols(REF, False), host=True)
    port_ctx = PORT.EvalCtx(TorchNS("cpu"), N, _cols(PORT, True),
                            host=False)
    rd, rn, _ = REF.eval_expr(ref_ctx, ref_e)
    pd, pn, _ = PORT.eval_expr(port_ctx, port_e)
    rnm = _as_np(REF.nulls(ref_ctx, rn), N)
    np.testing.assert_array_equal(_as_np(PORT.nulls(port_ctx, pn), N), rnm)
    assert rnm.any() and not rnm.all()
    pd = pd.numpy()
    assert pd.dtype == np.float64
    np.testing.assert_allclose(pd[~rnm], np.asarray(rd)[~rnm], rtol=1e-5,
                               atol=0)
    gt = lambda P, e: P.F(">", [e, P.c(0)], P.i)   # noqa: E731
    rm = np.asarray(REF.eval_bool_mask(ref_ctx, gt(REF, ref_e)))
    pm = PORT.eval_bool_mask(port_ctx, gt(PORT, port_e)).numpy()
    away = np.abs(np.asarray(rd)) > 1e-4
    np.testing.assert_array_equal(pm[away], rm[away])
