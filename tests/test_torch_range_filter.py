"""range_filter_sums, the range lowering and the product fold of
tidb_tpu_torch.

The wrapper (on the CPU it runs its plain PyTorch version) against
tidb_tpu.ops.range_filter_sums in interpret mode, as tests/test_ops.py
runs it, and against a numpy oracle for the shapes the JAX entry point
cannot take (it stacks its inputs, so k = 0 or npred = 0 fails there).
Product pairs reach the JAX kernel as their numpy product, a sum
column. All comparisons are exact: the function is int64 sums.

copr/range_lowering.py: for every accepted comparison form the bound
[lo, hi] selects exactly the rows that the expression evaluator's
eval_bool_mask selects, on columns that hold the constant and its
neighbours, the type's extremes and seeded values; every declined form
lowers to None.

copr/dag_exec.py's fold: which aggregate arguments pass as product pairs
(fold_pairs), the same states as the evaluator's route for each, and
Q6 through the port folding its product at SF0.05."""
import numpy as np
import pytest
import torch

from tidb_tpu.ops import range_filter_sums as jax_range_filter_sums
from tidb_tpu.testkit import TestKit as RefKit
from tidb_tpu.bench import tpch as ref_tpch
from tidb_tpu_torch.bench import tpch as port_tpch
from tidb_tpu_torch.copr import dag_exec
from tidb_tpu_torch.copr.range_lowering import (filter_bound,
                                                lower_filters, EMPTY)
from tidb_tpu_torch.expression import EvalCtx, eval_bool_mask
from tidb_tpu_torch.expression.expr import (AggDesc, Column, Constant,
                                            ScalarFunc)
from tidb_tpu_torch.expression.torch_ns import TorchNS
from tidb_tpu_torch.testkit import TestKit as PortKit
from tidb_tpu_torch.ops import scan_kernels as sk
from tidb_tpu_torch.types.datum import Datum, Kind
from tidb_tpu_torch.types.field_type import (
    new_bigint_type, new_date_type, new_datetime_type, new_decimal_type,
    new_double_type, new_int_type, new_string_type, new_null_type)

I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1


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


def _oracle(sum_cols, pred_cols, bounds, valid):
    m = valid.copy()
    for c, (lo, hi) in zip(pred_cols, bounds):
        m &= (c >= lo) & (c <= hi)
    return [int(c[m].sum()) for c in sum_cols], int(m.sum())


def _inputs(n, k, npred, seed):
    """Sum values beyond 2^24 and negative; predicate columns in a small
    domain so each bound keeps part of the rows; the bounds mix a
    seeded range with one-sided ranges at INT64_MIN/MAX."""
    rng = np.random.default_rng(seed)
    sums = [rng.integers(-(1 << 40), 1 << 40, n) for _ in range(k)]
    preds = [rng.integers(-50, 50, n) for _ in range(npred)]
    bounds = []
    for p in range(npred):
        a, b = sorted(int(x) for x in rng.integers(-60, 60, 2))
        bounds.append([(a, b), (I64_MIN, b), (a, I64_MAX)][p % 3])
    valid = rng.random(n) < 0.8
    return sums, preds, bounds, valid


def _run(sums, preds, bounds, valid):
    got_s, got_c = sk.range_filter_sums([_t(c) for c in sums],
                                        [_t(c) for c in preds], bounds,
                                        _t(valid))
    assert got_s.dtype == torch.int64 and got_s.shape == (len(sums),)
    assert got_c.dtype == torch.int64 and got_c.shape == ()
    return [int(x) for x in got_s], int(got_c)


@pytest.mark.parametrize("npred", [1, 2, 3, 4])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 8191, 8193, 20000])
def test_range_filter_sums_matches_pallas(n, k, npred):
    sums, preds, bounds, valid = _inputs(n, k, npred, n * 31 + k * 7 + npred)
    want_s, want_c = jax_range_filter_sums(sums, preds, bounds, valid,
                                           interpret=True)
    got = _run(sums, preds, bounds, valid)
    assert got == ([int(x) for x in np.asarray(want_s)], int(want_c))
    assert got == _oracle(sums, preds, bounds, valid)


@pytest.mark.parametrize("case", ["empty", "full", "extreme_values",
                                  "point"])
def test_range_filter_sums_edge_bounds_match_pallas(case):
    n, k, npred = 8193, 2, 3
    sums, preds, bounds, valid = _inputs(n, k, npred, 5)
    if case == "empty":                 # lo > hi passes no row
        bounds[1] = EMPTY
    elif case == "full":
        bounds = [(I64_MIN, I64_MAX)] * npred
    elif case == "extreme_values":      # values at INT64_MIN/MAX
        preds[0][::3] = I64_MIN
        preds[0][1::3] = I64_MAX
        bounds[0] = (I64_MIN, I64_MAX - 1)
    else:
        bounds = [(7, 7), (I64_MIN, I64_MAX), (-3, 40)]
    want_s, want_c = jax_range_filter_sums(sums, preds, bounds, valid,
                                           interpret=True)
    got = _run(sums, preds, bounds, valid)
    assert got == ([int(x) for x in np.asarray(want_s)], int(want_c))
    assert got == _oracle(sums, preds, bounds, valid)
    if case == "empty":
        assert got == ([0] * k, 0)


@pytest.mark.parametrize("n,k,npred", [(1, 0, 1), (20000, 0, 3),
                                       (8193, 2, 0), (20000, 0, 0),
                                       (4096, 16, 16)])
def test_range_filter_sums_zero_and_wide_shapes(n, k, npred):
    """k = 0 (count(*) under range filters), npred = 0 and the widest
    shape: the JAX entry point cannot stack zero inputs, so a numpy
    oracle holds these."""
    sums, preds, bounds, valid = _inputs(n, k, npred, n + k + npred)
    assert _run(sums, preds, bounds, valid) == \
        _oracle(sums, preds, bounds, valid)


# (name, n, k, npred, pairs): each pair (x, y) names a sum column "s<j>"
# or a predicate column "p<j>"; "w<j>" is a column of values near 2^62,
# whose products wrap int64
PRODUCT_CASES = [
    ("q6_shape", 20000, 0, 3, [("w0", "p1")]),
    ("sum_and_product", 8193, 2, 2, [("s0", "s1"), ("s1", "p0")]),
    ("wrapping_squares", 8191, 1, 1, [("w0", "w0"), ("w1", "w0")]),
    ("operand_is_pred_0", 1, 1, 3, [("p0", "s0")]),
    ("both_operands_preds", 20000, 0, 4, [("p2", "p3"), ("p3", "p2")]),
    ("no_predicates", 8193, 1, 0, [("s0", "w0")]),
    ("widest", 4096, 8, 16, [("s%d" % j, "p%d" % j) for j in range(8)]),
]


@pytest.mark.parametrize("name,n,k,npred,pairs", PRODUCT_CASES,
                         ids=[c[0] for c in PRODUCT_CASES])
def test_range_filter_sums_products_match_pallas(name, n, k, npred, pairs):
    """The sums of wrapped int64 products a * b, after the sum columns,
    equal the JAX kernel's sums of the numpy product columns."""
    sums, preds, bounds, valid = _inputs(n, k, npred, n + 3 * k + npred)
    rng = np.random.default_rng(n + k)
    wide = [rng.integers((1 << 62) - (1 << 20), 1 << 62, n) *
            rng.choice([-1, 1], n) for _ in range(2)]
    arrays = {**{f"s{j}": c for j, c in enumerate(sums)},
              **{f"p{j}": c for j, c in enumerate(preds)},
              **{f"w{j}": c for j, c in enumerate(wide)}}
    tensors = {key: _t(v) for key, v in arrays.items()}
    with np.errstate(over="ignore"):
        prods = [arrays[x] * arrays[y] for x, y in pairs]
    got_s, got_c = sk.range_filter_sums(
        [tensors[f"s{j}"] for j in range(k)],
        [tensors[f"p{j}"] for j in range(npred)], bounds, _t(valid),
        [(tensors[x], tensors[y]) for x, y in pairs])
    assert got_s.shape == (k + len(pairs),)
    got = ([int(x) for x in got_s], int(got_c))
    assert sk.COUNTS["product_pairs"] == len(pairs)
    assert sk.COUNTS["range_filter_sums"] == 0
    with np.errstate(over="ignore"):
        oracle = _oracle(sums + prods, preds, bounds, valid)
        want = oracle
        if npred:
            want_s, want_c = jax_range_filter_sums(sums + prods, preds,
                                                   bounds, valid,
                                                   interpret=True)
            want = ([int(x) for x in np.asarray(want_s)], int(want_c))
    assert got == want == oracle


def test_range_filter_sums_raises_on_bad_inputs():
    n = 16
    col = torch.zeros(n, dtype=torch.int64)
    valid = torch.ones(n, dtype=torch.bool)
    rfs = sk.range_filter_sums
    with pytest.raises(TypeError):
        rfs([col.to(torch.int32)], [col], [(0, 1)], valid)
    with pytest.raises(TypeError):
        rfs([col], [col.double()], [(0, 1)], valid)
    with pytest.raises(TypeError):
        rfs([col], [col], [(0, 1)], valid.to(torch.int64))
    with pytest.raises(ValueError):
        rfs([col], [col[:8]], [(0, 1)], valid)
    with pytest.raises(ValueError):
        rfs([col], [col], [(0, 1)], valid[None, :])
    with pytest.raises(ValueError):
        rfs([col.to("meta")], [col.to("meta")], [(0, 1)], valid.to("meta"))
    with pytest.raises(ValueError):
        rfs([col], [col] * (sk.MAX_PREDS + 1),
            [(0, 1)] * (sk.MAX_PREDS + 1), valid)
    with pytest.raises(ValueError):
        rfs([col] * (sk.MAX_COLS + 1), [col], [(0, 1)], valid)
    with pytest.raises(ValueError):
        rfs([col], [col, col], [(0, 1)], valid)
    with pytest.raises(ValueError):
        rfs([col], [col], [(0, I64_MAX + 1)], valid)
    assert sk.COUNTS["range_filter_sums"] == 0


# ---- the range lowering ------------------------------------------------

DEC152 = new_decimal_type(15, 2)


def _col(ft, idx=0):
    return Column(idx=idx, ft=ft, name=f"x{idx}")


def _int(v):
    return Constant(Datum(Kind.INT, v), new_bigint_type())


def _dec(scaled, scale, prec=38):
    return Constant(Datum(Kind.DECIMAL, scaled, scale),
                    new_decimal_type(prec, scale))


def _date(days):
    return Constant(Datum(Kind.DATE, days), new_date_type())


def _cmp(op, a, b):
    return ScalarFunc(op, [a, b])


def _values(ft, lo, hi, seed):
    """Column values around the bound and the constant, the extremes of
    the column's storage (its type's range where the evaluator rescales
    the column), and seeded values; plus a NULL mask."""
    if ft.tclass.name == "DECIMAL" and 0 < ft.flen <= 18:
        tmin, tmax = -(10 ** ft.flen - 1), 10 ** ft.flen - 1
    elif ft.tp == "int":
        tmin, tmax = ft.int_limits()
    else:
        tmin, tmax = I64_MIN, I64_MAX
    edge = set()
    for b in (lo, hi):
        for d in (-2, -1, 0, 1, 2):
            edge.add(b + d)
    for b in (tmin, tmax):
        for d in (-1, 0, 1):
            edge.add(b + d)
    vals = sorted(v for v in edge if tmin <= v <= tmax)
    rng = np.random.default_rng(seed)
    vals += [int(v) for v in rng.integers(max(tmin, -10 ** 6),
                                          min(tmax, 10 ** 6), 64)]
    data = np.array(vals, dtype=np.int64)
    nulls = np.zeros(len(data), dtype=bool)
    nulls[::5] = True
    return data, nulls


def _assert_bound_matches_evaluator(expr, ft, seed=0):
    b = filter_bound(expr)
    assert b is not None, expr
    idx, lo, hi = b
    assert idx == 0 and I64_MIN <= lo and hi <= I64_MAX
    data, nulls = _values(ft, lo, hi, seed)
    for nl in (None, nulls):
        ctx = EvalCtx(np, len(data), {0: (data, nl, None)}, host=True)
        want = np.asarray(eval_bool_mask(ctx, expr))
        got = (data >= lo) & (data <= hi)
        if nl is not None:
            got &= ~nl
        assert np.array_equal(got, want), (expr, lo, hi)
    return lo, hi


OPS = ["<", "<=", ">", ">=", "="]

ACCEPTED = [
    # (name, column type, constant)
    ("int_col_int_const", new_int_type(), _int(24)),
    ("bigint_col_int_const", new_bigint_type(), _int(-7)),
    ("bigint_col_int64_min", new_bigint_type(), _int(I64_MIN)),
    ("bigint_col_int64_max", new_bigint_type(), _int(I64_MAX)),
    ("date_col_date_const", new_date_type(), _date(9131)),
    ("dec_col_same_scale", DEC152, _dec(7, 2)),
    ("dec_col_int_const", DEC152, _int(24)),             # Q6's quantity
    ("dec_col_lower_scale", DEC152, _dec(-15, 1)),
    ("dec_col_higher_scale", DEC152, _dec(23995, 3)),
    ("dec_col_higher_scale_neg", DEC152, _dec(-1005, 3)),
    ("dec_col_higher_scale_exact", DEC152, _dec(2400, 3)),
    ("int_col_dec_const", new_int_type(), _dec(15, 1)),
    ("int_col_dec_const_neg", new_int_type(), _dec(-2501, 2)),
]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("name,ft,const", ACCEPTED,
                         ids=[a[0] for a in ACCEPTED])
def test_lowering_bound_equals_evaluator(name, ft, const, op):
    _assert_bound_matches_evaluator(_cmp(op, _col(ft), const), ft)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("name,ft,const", ACCEPTED[::3],
                         ids=[a[0] for a in ACCEPTED[::3]])
def test_lowering_constant_on_the_left(name, ft, const, op):
    _assert_bound_matches_evaluator(_cmp(op, const, _col(ft)), ft)


def test_lowering_q6_filters_become_three_ranges():
    """Q6's five filters as the planner hands them to the fragment."""
    ship, disc, qty = _col(new_date_type(), 0), _col(DEC152, 1), \
        _col(DEC152, 2)
    filters = [_cmp(">=", ship, _date(8766)), _cmp("<", ship, _date(9131)),
               _cmp(">=", disc, _dec(5, 2)), _cmp("<=", disc, _dec(7, 2)),
               _cmp("<", qty, _int(24))]
    r = lower_filters(filters)
    assert r.cols == [0, 1, 2]
    assert r.bounds == [(8766, 9130), (5, 7), (I64_MIN, 2399)]
    assert r.lowered == filters and r.rest == []


def test_lowering_between_intersects_and_keeps_the_rest():
    """BETWEEN arrives as >= and <=; several predicates on one column
    intersect; declined filters stay in `rest` in their order."""
    x, s = _col(DEC152, 0), _col(new_string_type(), 1)
    neq = _cmp("!=", x, _int(3))
    sfilter = _cmp("=", s, Constant(Datum(Kind.STRING, "R"),
                                    new_string_type()))
    filters = [_cmp(">=", x, _dec(1005, 3)), neq, _cmp("<=", x, _int(30)),
               sfilter, _cmp("<", _int(20), x)]
    r = lower_filters(filters)
    assert r.cols == [0] and r.bounds == [(2001, 3000)]
    assert r.rest == [neq, sfilter]
    data = np.arange(-5000, 5000, dtype=np.int64)
    ctx = EvalCtx(np, len(data), {0: (data, None, None)}, host=True)
    want = np.ones(len(data), dtype=bool)
    for f in r.lowered:
        want &= np.asarray(eval_bool_mask(ctx, f))
    assert np.array_equal((data >= 2001) & (data <= 3000), want)
    # disjoint ranges on one column leave it empty
    r = lower_filters([_cmp("<", x, _int(1)), _cmp(">", x, _int(2))])
    assert r.bounds[0][0] > r.bounds[0][1]


def test_lowering_stops_at_max_preds():
    filters = [_cmp(">=", _col(new_int_type(), i), _int(i))
               for i in range(sk.MAX_PREDS + 2)]
    r = lower_filters(filters)
    assert len(r.cols) == sk.MAX_PREDS
    assert r.rest == filters[sk.MAX_PREDS:]


def test_lowering_wraps_nothing_at_int64_limits():
    x = _col(new_bigint_type())
    assert filter_bound(_cmp("<", x, _int(I64_MIN)))[1:] == EMPTY
    assert filter_bound(_cmp(">", x, _int(I64_MAX)))[1:] == EMPTY
    assert filter_bound(_cmp("<=", x, _int(I64_MAX)))[1:] == \
        (I64_MIN, I64_MAX)
    assert filter_bound(_cmp(">=", x, _int(I64_MIN)))[1:] == \
        (I64_MIN, I64_MAX)
    # a decimal constant that is not a multiple of the column's unit
    assert filter_bound(_cmp("=", _col(DEC152), _dec(1005, 3)))[1:] == \
        EMPTY


_UINT = new_bigint_type(unsigned=True)
DECLINED = [
    ("ne", _cmp("!=", _col(new_int_type()), _int(3))),
    ("nullsafe_eq", _cmp("<=>", _col(new_int_type()), _int(3))),
    ("in", ScalarFunc("in", [_col(new_int_type()), _int(1), _int(2)])),
    ("or", ScalarFunc("or", [_cmp("<", _col(new_int_type()), _int(1)),
                             _cmp(">", _col(new_int_type()), _int(5))])),
    ("not", ScalarFunc("not", [_cmp("<", _col(new_int_type()), _int(1))])),
    ("expr_side", _cmp("<", ScalarFunc("+", [_col(new_int_type()), _int(1)],
                                       new_bigint_type()), _int(5))),
    ("col_vs_col", _cmp("<", _col(new_int_type()),
                        _col(new_int_type(), 1))),
    ("const_vs_const", _cmp("<", _int(1), _int(2))),
    ("float_col", _cmp("<", _col(new_double_type()), _int(1))),
    ("float_const", _cmp("<", _col(new_int_type()),
                         Constant(Datum(Kind.FLOAT, 1.5),
                                  new_double_type()))),
    ("unsigned_col", _cmp("<", _col(_UINT), _int(1))),
    ("unsigned_const", _cmp("<", _col(new_int_type()),
                            Constant(Datum(Kind.UINT, 1), _UINT))),
    ("string_col", _cmp("=", _col(new_string_type()),
                        Constant(Datum(Kind.STRING, "R"),
                                 new_string_type()))),
    ("string_const", _cmp("<", _col(new_int_type()),
                          Constant(Datum(Kind.STRING, "5"),
                                   new_string_type()))),
    ("datetime_col", _cmp("<", _col(new_datetime_type()),
                          Constant(Datum(Kind.DATETIME, 10 ** 12),
                                   new_datetime_type()))),
    ("date_vs_int", _cmp("<", _col(new_date_type()), _int(9131))),
    ("int_vs_date", _cmp("<", _col(new_int_type()), _date(9131))),
    ("null_const", _cmp("<", _col(new_int_type()),
                        Constant(Datum(Kind.NULL), new_null_type()))),
    ("big_scale_decimal_col", _cmp("<", _col(new_decimal_type(38, 20)),
                                   _int(1))),
    ("rescale_could_wrap", _cmp("<", _col(new_bigint_type()),
                                _dec(15, 1))),
    ("constant_past_int64", _cmp("<", _col(DEC152), _int(I64_MAX))),
]


@pytest.mark.parametrize("name,expr", DECLINED, ids=[d[0] for d in DECLINED])
def test_lowering_declines(name, expr):
    assert filter_bound(expr) is None
    assert lower_filters([expr]) is None


# ---- the product fold (copr/dag_exec.py) --------------------------------

DEC304 = new_decimal_type(30, 4)


def _fold_ctx(n, nullable):
    """An EvalCtx over CPU tensors: 0 price, 1 discount, 2 quantity
    (decimal(15, 2)), 3 shipdate, 4 a double, 5 a bigint; `nullable`:
    the indexes that carry a null mask."""
    rng = np.random.default_rng(n)
    data = {0: rng.integers(90_000, 10_000_000, n),
            1: rng.integers(0, 11, n), 2: rng.integers(100, 5100, n),
            3: rng.integers(8000, 10500, n), 4: rng.random(n) * 100,
            5: rng.integers(-(1 << 40), 1 << 40, n)}
    cols = {}
    for i, d in data.items():
        nl = _t(rng.random(n) < 0.1) if i in nullable else None
        cols[i] = (_t(d), nl, None)
    return EvalCtx(TorchNS("cpu"), n, cols, host=False)


_FOLD_COLS = {0: DEC152, 1: DEC152, 2: DEC152, 3: new_date_type(),
              4: new_double_type(), 5: new_bigint_type()}


def _c(i):
    return _col(_FOLD_COLS[i], i)


def _mul(a, b, ft):
    return ScalarFunc("*", [a, b], ft)


# (name, aggregates, the fold pairs expected, nullable columns)
FOLD_CASES = [
    ("q6", [AggDesc("sum", [_mul(_c(0), _c(1), DEC304)])], [(0, 1)], ()),
    ("q6_with_sum_avg_count",
     [AggDesc("avg", [_mul(_c(1), _c(0), DEC304)]), AggDesc("sum", [_c(2)]),
      AggDesc("count", []), AggDesc("sum", [_mul(_c(5), _c(1),
                                                 new_decimal_type(30, 2))])],
     [(1, 0), None, None, (5, 1)], ()),
    ("rescaled_decimal", [AggDesc("sum", [_mul(_c(0), _c(1), DEC152)])],
     [None], ()),
    ("nullable_operand", [AggDesc("sum", [_mul(_c(0), _c(1), DEC304)])],
     [(0, 1)], (0,)),
    ("float_operand", [AggDesc("sum", [_mul(_c(4), _c(1),
                                            new_double_type())])],
     [None], ()),
    ("expression_operand",
     [AggDesc("sum", [_mul(ScalarFunc("+", [_c(0), _c(1)], DEC152), _c(1),
                           DEC304)])], [None], ()),
    ("count", [AggDesc("count", [_mul(_c(0), _c(1), DEC304)])], [None], ()),
]


@pytest.mark.parametrize("name,aggs,pairs,nullable", FOLD_CASES,
                         ids=[c[0] for c in FOLD_CASES])
def test_fold_rule_gives_the_evaluator_states(name, aggs, pairs, nullable):
    """fold_pairs folds a `*` of two bare int/decimal columns whose
    product needs no rescale (Q6's), and declines a rescaled decimal
    product, a float or expression operand and count; a nullable operand
    declines at run time. Every case gives the states of the evaluator's
    route (compares, then the plain reductions)."""
    n = 5000
    assert dag_exec.fold_pairs(aggs) == pairs
    ranges = lower_filters([_cmp(">=", _c(3), _date(8766)),
                            _cmp("<", _c(2), _int(24))])
    assert ranges.cols == [3, 2] and ranges.rest == []
    ctx = _fold_ctx(n, nullable)
    valid = _t(np.arange(n) % 7 != 0)
    got = dag_exec.dense_agg_states_range(ctx, valid, aggs, ranges, n,
                                          dag_exec.fold_pairs(aggs))
    folded = sum(p is not None for p in pairs) if not nullable else 0
    assert sk.COUNTS["product_pairs"] == folded
    mask = valid
    for f in ranges.lowered:
        mask = mask & eval_bool_mask(ctx, f)
    want = dag_exec._reduce_plain(ctx, mask, aggs, n)
    assert torch.equal(got["present"], want["present"])
    assert len(got["states"]) == len(want["states"])
    for g, w in zip(got["states"], want["states"]):
        assert len(g) == len(w)
        for gt, wt in zip(g, w):
            assert gt.dtype == wt.dtype and torch.equal(gt, wt), (gt, wt)


@pytest.fixture(scope="module")
def q6_kits():
    ref = RefKit()
    ref_tpch.load_tpch(ref, sf=0.05, seed=7)
    port = PortKit(device="cpu")
    port_tpch.load_tpch(port, sf=0.05, seed=7)
    return ref, port


def test_q6_folds_its_product_and_equals_reference(q6_kits):
    """Q6 at SF0.05 through the port: the reference's rows, with the
    product handed to range_filter_sums as a pair."""
    ref, port = q6_kits
    want = ref.must_query(ref_tpch.QUERIES["q6"])._norm()
    assert port.must_query(port_tpch.QUERIES["q6"])._norm() == want
    assert sk.COUNTS["product_pairs"] > 0
    assert port_tpch.q6_oracle(port) == want
