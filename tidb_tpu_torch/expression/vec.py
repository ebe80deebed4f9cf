"""Vectorized expression evaluation over a pluggable array backend.

ONE implementation serves both paths (reference has ~600 builtins with
separate row + vectorized forms, pkg/expression/builtin_*_vec.go):

  * host:   xp = numpy  -> immediate columnar eval (the CPU oracle)
  * device: xp = TorchNS (expression/torch_ns.py) -> tensors on the
    domain's torch device, for the expressions torch_ns.device_form
    admits (the shapes whose reference trace succeeds)

Value representation: (data, nulls, sdict)
  data  : xp array (or python scalar for constants)
  nulls : None | bool scalar | xp bool array  (True = NULL)
  sdict : StringDict when data holds dictionary codes

String strategy (TPU-first): any string function/predicate over a
dict-encoded column is computed ONCE over the dictionary values on host,
then applied on device as a gather through the resulting lookup table.
LIKE/regexp/lower/substr over millions of rows become one table build (size
= #distinct) + one device gather. Dict versions key the kernel cache.

NULL semantics: three-valued logic; comparisons propagate NULL, AND/OR are
Kleene, filters treat NULL as false (eval_bool_mask).
"""
from __future__ import annotations

import re
import threading
import weakref
from collections import OrderedDict

import numpy as np

from ..types.field_type import TypeClass, FieldType
from ..types.datum import Kind
from ..types.time_types import MICROS_PER_DAY, MICROS_PER_SEC
from ..errors import UnknownFunctionError
from .expr import Expression, Column, Constant, ScalarFunc
from ..chunk.device import StringDict

_POW10 = [10 ** i for i in range(19)]


class EvalCtx:
    def __init__(self, xp, n, cols, host=True, float_dtype=None,
                 div_prec_incr=4):
        self.xp = xp
        self.n = n
        self.cols = cols          # idx -> (data, nulls, sdict|None)
        self.host = host
        self.float_dtype = float_dtype or np.float64
        self.div_prec_incr = div_prec_incr

    def full(self, v, dtype=None):
        return self.xp.full(self.n, v, dtype=dtype)


# ---------------- null mask helpers ----------------

def or_nulls(xp, *masks):
    out = None
    for m in masks:
        if m is None:
            continue
        if m is True:
            return True
        if m is False:
            continue
        out = m if out is None else (out | m)
    return out


def materialize_nulls(ctx, nulls):
    if nulls is None or nulls is False:
        return ctx.xp.zeros(ctx.n, dtype=bool)
    if nulls is True:
        return ctx.xp.ones(ctx.n, dtype=bool)
    return nulls


def _not_mask(xp, m):
    if m is None or m is False:
        return None
    if m is True:
        return True
    return ~m


def _astype(xp, a, dtype):
    """a.astype(dtype) on either backend (tensors have no .astype)."""
    if isinstance(a, np.ndarray) or np.isscalar(a):
        return np.asarray(a).astype(dtype)
    return xp.astype(a, dtype)


# ---------------- casting helpers ----------------

def _dataclass_of(ft: FieldType):
    tc = ft.tclass
    if tc == TypeClass.FLOAT:
        return "float"
    if tc == TypeClass.DECIMAL:
        return "decimal"
    if tc in (TypeClass.STRING, TypeClass.JSON, TypeClass.ENUM, TypeClass.SET):
        return "string"
    return "int"   # ints, dates, times map to int64


def _scale_of(ft: FieldType):
    return max(ft.decimal, 0) if ft.tclass == TypeClass.DECIMAL else 0


def _rescale_up(xp, v, k):
    if k <= 0:
        return v
    if k >= len(_POW10):
        # big-decimal scales (>18 digits): exact python-int arithmetic
        # over object arrays (host path only — device-safety gates these)
        if hasattr(v, "astype"):
            v = v.astype(object)
        return v * (10 ** k)
    if hasattr(v, "dtype") and v.dtype == object:
        return v * (10 ** k)
    return v * _POW10[k]


def _rescale_down_round(xp, v, k):
    """Divide scaled int by 10^k, rounding half away from zero."""
    if k <= 0:
        return v
    d = 10 ** k if k >= len(_POW10) else _POW10[k]
    if hasattr(v, "dtype") and v.dtype == object:
        out = np.array([(x + d // 2) // d if x >= 0
                        else -((-x + d // 2) // d) for x in v],
                       dtype=object)
        return out
    h = d // 2
    pos = (v + h) // d
    neg = -((-v + h) // d)
    return xp.where(v >= 0, pos, neg)


def _to_float(ctx, data, ft):
    cls = _dataclass_of(ft)
    xp = ctx.xp
    if cls == "float":
        return xp.asarray(data, dtype=ctx.float_dtype) if not np.isscalar(data) else data
    if cls == "decimal":
        s = _scale_of(ft)
        p = 10 ** s if s >= len(_POW10) else _POW10[s]
        if hasattr(data, "dtype") and data.dtype == object:
            data = np.array([float(x) for x in data])
        return xp.asarray(data, dtype=ctx.float_dtype) / float(p)
    return xp.asarray(data, dtype=ctx.float_dtype) if not np.isscalar(data) \
        else float(data)


def coerce_numeric_pair(ctx, a, aft, b, bft):
    """-> (a', b', cls, scale) with both sides in a common numeric class."""
    ca, cb = _dataclass_of(aft), _dataclass_of(bft)
    xp = ctx.xp
    if "string" in (ca, cb):
        # strings in numeric context -> float (host parse / dict transform
        # happens before this point; here data is already numeric)
        return _to_float(ctx, a, aft), _to_float(ctx, b, bft), "float", 0
    if "float" in (ca, cb):
        return _to_float(ctx, a, aft), _to_float(ctx, b, bft), "float", 0
    if "decimal" in (ca, cb):
        sa, sb = _scale_of(aft), _scale_of(bft)
        s = max(sa, sb)
        return (_rescale_up(xp, a, s - sa), _rescale_up(xp, b, s - sb),
                "decimal", s)
    return a, b, "int", 0


# ---------------- main eval ----------------

def eval_expr(ctx: EvalCtx, expr: Expression):
    if isinstance(expr, Column):
        val = ctx.cols.get(expr.idx)
        if val is None:
            raise KeyError(f"column #{expr.idx} not bound in eval context")
        return val
    if isinstance(expr, Constant):
        return _eval_const(ctx, expr)
    if isinstance(expr, ScalarFunc):
        fn = _REGISTRY.get(expr.op)
        if fn is None:
            raise UnknownFunctionError("FUNCTION %s does not exist", expr.op)
        return fn(ctx, expr)
    raise TypeError(f"cannot eval {type(expr)}")


def _eval_const(ctx, expr: Constant):
    d = expr.value
    if d.is_null:
        return 0, True, None
    if d.kind == Kind.STRING:
        return d.val, None, None     # python str; consumers handle
    if d.kind == Kind.FLOAT:
        return d.val, None, None
    return int(d.val), None, None


def eval_bool_mask(ctx: EvalCtx, expr: Expression):
    """Filter semantics: NULL -> false. Returns xp bool array of length n."""
    data, nulls, _ = eval_expr(ctx, expr)
    xp = ctx.xp
    if np.isscalar(data) or getattr(data, "ndim", 1) == 0:
        base = bool(data) and nulls is not True
        m = ctx.full(base, dtype=bool)
        if nulls is not None and nulls is not True and nulls is not False:
            m = m & ~nulls
        return m
    if data.dtype == object:
        data = np.array([bool(v) for v in data], dtype=bool)
    elif data.dtype != bool:
        data = data != 0
    if nulls is None or nulls is False:
        return data
    if nulls is True:
        return ctx.xp.zeros(ctx.n, dtype=bool)
    return data & ~nulls


# ---------------- op registry ----------------

_REGISTRY = {}


def op(*names):
    def deco(fn):
        for n in names:
            # import-time registration (module-level @op decorators):
            # single-threaded by construction
            # tpulint: disable=shared-state-race
            _REGISTRY[n] = fn
        return fn
    return deco


def is_device_safe(expr: Expression) -> bool:
    """Can this expression run inside a jit kernel? String ops qualify via
    dict tables; only explicitly host-bound ops are excluded. Big
    decimals (precision > 18) live in python-int object arrays — exact,
    host-only (reference MyDecimal semantics; hi/lo limb kernels are the
    device roadmap)."""
    if isinstance(expr, Column):
        ft = expr.ft
        if ft is not None and ft.tclass == TypeClass.DECIMAL and \
                max(ft.decimal, 0) > 18:
            return False
        return True
    if isinstance(expr, Constant):
        return True
    if isinstance(expr, ScalarFunc):
        if expr.op in _HOST_ONLY:
            return False
        if expr.op not in _REGISTRY:
            return False
        ft = expr.ft
        if ft is not None and ft.tclass == TypeClass.DECIMAL and \
                max(ft.decimal, 0) > 18:
            return False       # result scale needs >int64 precision
        return all(is_device_safe(a) for a in expr.args)
    return False


_HOST_ONLY = {"rand", "uuid", "sleep", "user", "database", "version",
              "connection_id", "get_var", "found_rows", "row_count",
              "last_insert_id",
              # vector funcs compute over the distinct-value dictionary on
              # host and gather; the matrix kernels are numpy (MXU offload
              # of the stacked matrix is the ops/ roadmap)
              "vec_cosine_distance", "vec_l2_distance", "vec_l1_distance",
              "vec_negative_inner_product", "vec_inner_product",
              "vec_dims", "vec_l2_norm",
              "vec_from_text", "vec_as_text",
              # row-wise host tail (mixed string/number args)
              "find_in_set", "substring_index", "insert", "inet_aton",
              "inet_ntoa", "is_ipv4", "is_ipv6", "make_set", "export_set",
              "date_format", "str_to_date", "dayname", "monthname",
              "from_unixtime", "time_to_sec", "sec_to_time", "maketime",
              "json_array", "json_object", "json_set", "json_insert",
              "json_replace", "json_remove", "json_merge_patch",
              "json_contains_path", "addtime", "subtime", "timediff",
              "time", "time_format", "weekofyear", "format_bytes"}


# ---------------- string helpers ----------------

def _is_string_val(val, expr):
    data, _, sdict = val
    return sdict is not None or isinstance(data, str) or \
        (hasattr(data, "dtype") and data.dtype == object)


# The host tables of a string op over a dictionary (a LIKE's match per
# value, a compare with a literal, SUBSTRING's code mapping and output
# dictionary) cost a Python loop over every value: 200,000 part names
# for Q9's LIKE. They are cached across statements under an explicit key
# from the caller (the op and its literal arguments: `fn` is a fresh
# closure at every call) with the dictionary's identity and length (a
# dictionary only grows, so a grown one misses; a weak reference keeps
# a new dictionary at a freed one's address from matching), the dtype
# and the device. Bounded by bytes, least recently used first out.
_DICT_TABLE_MAX_BYTES = 1 << 28
_DICT_TABLES: "OrderedDict" = OrderedDict()
_DICT_TABLE_MU = threading.Lock()
# builds / hits / bytes held, read by the tests and the profiler
DICT_TABLE_STATS = {"builds": 0, "hits": 0, "bytes": 0}


def _dict_cached(ctx, sdict, key, build):
    """build() -> (value, host bytes it holds), served from the cache
    when `key` (the op and its literal arguments) is not None."""
    if key is None:
        return build()[0]
    ck = (id(sdict), len(sdict.values), key,
          "host" if ctx.host else str(getattr(ctx.xp, "device", "host")))
    with _DICT_TABLE_MU:
        ent = _DICT_TABLES.get(ck)
        if ent is not None and ent[0]() is sdict:
            _DICT_TABLES.move_to_end(ck)
            DICT_TABLE_STATS["hits"] += 1
            return ent[1]
    val, nb = build()
    with _DICT_TABLE_MU:
        DICT_TABLE_STATS["builds"] += 1
        old = _DICT_TABLES.pop(ck, None)
        if old is not None:
            DICT_TABLE_STATS["bytes"] -= old[2]
        _DICT_TABLES[ck] = (weakref.ref(sdict), val, nb)
        DICT_TABLE_STATS["bytes"] += nb
        while DICT_TABLE_STATS["bytes"] > _DICT_TABLE_MAX_BYTES and \
                len(_DICT_TABLES) > 1:
            _k, (_r, _v, onb) = _DICT_TABLES.popitem(last=False)
            DICT_TABLE_STATS["bytes"] -= onb
    return val


def _dict_table(ctx, sdict: StringDict, fn, dtype, key=None):
    """Host-compute fn over dictionary values -> lookup table (device
    const); cached under `key` (_dict_cached) when the caller gives one."""
    def build():
        # a copy: a concurrent commit may grow the dictionary meanwhile
        vals = list(sdict.values)
        tbl = np.empty(max(len(vals), 1), dtype=dtype)
        for i, s in enumerate(vals):
            tbl[i] = fn(s)
        return (ctx.xp.asarray(tbl) if not ctx.host else tbl), tbl.nbytes
    return _dict_cached(ctx, sdict, None if key is None else
                        ("table", np.dtype(dtype).str) + key, build)


def _dict_transform(ctx, codes, nulls, sdict, fn, key=None):
    """String->string function over a dict column: build output dict on host,
    gather mapping on device. Equal outputs share one code (grouping-safe).
    Cached under `key` (_dict_cached) when the caller gives one."""
    def build():
        out_dict = StringDict()
        vals = list(sdict.values)       # grows under concurrent commits
        mapping = np.empty(max(len(vals), 1), dtype=np.int32)
        for i, s in enumerate(vals):
            mapping[i] = out_dict.encode_one(fn(s))
        mtab = ctx.xp.asarray(mapping) if not ctx.host else mapping
        # the output strings: about 64 bytes each in a list and an index
        return (mtab, out_dict), mapping.nbytes + 64 * len(out_dict.values)
    mtab, out_dict = _dict_cached(ctx, sdict, None if key is None else
                                  ("transform",) + key, build)
    return mtab[codes], nulls, out_dict


def _string_elementwise(ctx, data, fn, dtype=object):
    out = np.empty(len(data), dtype=dtype)
    for i, s in enumerate(data):
        out[i] = fn(s if s is not None else "")
    return out


def _apply_str_fn(ctx, val, fn, out_is_string=True, out_dtype=None,
                  key=None):
    """Apply python str->x over a string value (dict column, object array,
    or scalar). out_dtype picks the non-string result dtype (int64
    default; float fns MUST pass float64 or values truncate). `key`
    names fn by the op and its literal arguments, so the dictionary
    table it builds is cached (_dict_cached)."""
    data, nulls, sdict = val
    if out_dtype is None:
        out_dtype = np.int64
    if isinstance(data, str):
        r = fn(data)
        return (r, nulls, None)
    if sdict is not None:
        if out_is_string:
            return _dict_transform(ctx, data, nulls, sdict, fn, key=key)
        tbl = _dict_table(ctx, sdict, fn, out_dtype, key=key)
        return tbl[data], nulls, None
    # host object array
    if out_is_string:
        return _string_elementwise(ctx, data, fn), nulls, None
    return _string_elementwise(ctx, data, fn, dtype=out_dtype), nulls, None


def _as_str_scalar(val):
    data, nulls, sdict = val
    if isinstance(data, str):
        return data
    return None


# ---------------- arithmetic ----------------

_NUM_PREFIX_RE = re.compile(
    r"^\s*[-+]?(\d+(\.\d*)?|\.\d+)([eE][-+]?\d+)?")


def mysql_str_to_float(s) -> float:
    """MySQL string->number: parse the longest numeric prefix, 0 when
    none ('3abc' -> 3.0, 'abc' -> 0.0, '  8 ' -> 8.0)."""
    if s is None:
        return 0.0
    m = _NUM_PREFIX_RE.match(str(s))
    return float(m.group(0)) if m else 0.0


def _numify(ctx, val, ft):
    """String operand in numeric context -> float (prefix parse).
    Handles scalar constants, object arrays, and dict columns (codes
    must NEVER reach arithmetic as numbers)."""
    if _dataclass_of(ft) != "string":
        return val
    data, nulls, sd = val
    if sd is None and not isinstance(data, str) and \
            not (hasattr(data, "dtype") and data.dtype == object):
        return val                       # already numeric
    out, n2, _ = _apply_str_fn(ctx, val, mysql_str_to_float,
                               out_is_string=False,
                               out_dtype=np.float64, key=("str_to_float",))
    return out, n2, None


def _binary_vals(ctx, expr, numeric=False):
    a = eval_expr(ctx, expr.args[0])
    b = eval_expr(ctx, expr.args[1])
    if numeric:
        a = _numify(ctx, a, expr.args[0].ft)
        b = _numify(ctx, b, expr.args[1].ft)
    return a, b


@op("+", "-")
def op_addsub(ctx, expr):
    (a, an, _), (b, bn, _) = _binary_vals(ctx, expr, numeric=True)
    aft, bft = expr.args[0].ft, expr.args[1].ft
    a2, b2, cls, s = coerce_numeric_pair(ctx, a, aft, b, bft)
    r = a2 + b2 if expr.op == "+" else a2 - b2
    # result ft may demand different scale
    ts = _scale_of(expr.ft)
    if cls == "decimal" and ts != s:
        r = _rescale_up(ctx.xp, r, ts - s) if ts > s else \
            _rescale_down_round(ctx.xp, r, s - ts)
    return r, or_nulls(ctx.xp, an, bn), None


def mul_is_plain_int64(expr):
    """True exactly when op_mul computes the `*` ScalarFunc `expr` as the
    wrapping int64 product a * b of its operands' storage: neither
    operand is float or string, and where one is decimal, the result's
    scale is the sum of theirs (no rescale) and at most 18 (no exact
    python-int product). A fold that multiplies the operands elsewhere
    (the range_filter_sums kernel) holds to this rule."""
    aft, bft = expr.args[0].ft, expr.args[1].ft
    classes = (_dataclass_of(aft), _dataclass_of(bft))
    if "float" in classes or "string" in classes:
        return False
    if "decimal" not in classes:
        return True
    ts = _scale_of(expr.ft)
    return ts <= 18 and ts == _scale_of(aft) + _scale_of(bft)


@op("*")
def op_mul(ctx, expr):
    (a, an, _), (b, bn, _) = _binary_vals(ctx, expr, numeric=True)
    aft, bft = expr.args[0].ft, expr.args[1].ft
    ca, cb = _dataclass_of(aft), _dataclass_of(bft)
    xp = ctx.xp
    if "float" in (ca, cb) or "string" in (ca, cb):
        r = _to_float(ctx, a, aft) * _to_float(ctx, b, bft)
        return r, or_nulls(xp, an, bn), None
    if mul_is_plain_int64(expr):
        return a * b, or_nulls(xp, an, bn), None
    # a decimal product that is rescaled, or whose scale passes int64's
    s = _scale_of(aft) + _scale_of(bft)
    ts = _scale_of(expr.ft)
    if ts > 18 and ctx.host:
        # result scale beyond int64: exact python-int multiply
        # (small-scale int64 operands would silently overflow)
        def _obj(v):
            if hasattr(v, "astype"):
                return v.astype(object)
            return int(v) if not isinstance(v, float) else v
        r = _obj(a) * _obj(b)
    else:
        r = a * b
    if ts != s:
        r = _rescale_up(xp, r, ts - s) if ts > s else \
            _rescale_down_round(xp, r, s - ts)
    return r, or_nulls(xp, an, bn), None


@op("/")
def op_div(ctx, expr):
    """Division -> float result unless expr.ft says decimal (then exact
    scaled arithmetic with div_precision_increment)."""
    (a, an, _), (b, bn, _) = _binary_vals(ctx, expr, numeric=True)
    aft, bft = expr.args[0].ft, expr.args[1].ft
    xp = ctx.xp
    if expr.ft.tclass == TypeClass.DECIMAL:
        ts = _scale_of(expr.ft)
        if ctx.host and ts > 18:
            # big-decimal result: exact python-int long division
            # (host path only; MySQL rounds half away from zero)
            sa, sb = _scale_of(aft), _scale_of(bft)
            av = a if hasattr(a, "__len__") else np.full(ctx.n, a,
                                                         dtype=object)
            bv = b if hasattr(b, "__len__") else np.full(ctx.n, b,
                                                         dtype=object)
            out = np.zeros(ctx.n, dtype=object)
            zmask = np.zeros(ctx.n, dtype=bool)
            mul = 10 ** (ts - sa + sb)
            for i in range(ctx.n):
                bi = int(bv[i])
                if bi == 0:
                    zmask[i] = True
                    continue
                num = int(av[i]) * mul
                q, r = divmod(abs(num), abs(bi))
                if 2 * r >= abs(bi):
                    q += 1
                out[i] = q if (num >= 0) == (bi >= 0) else -q
            return out, or_nulls(xp, an, bn,
                                 zmask if zmask.any() else None), None
        # Compute in float64 and round back to the target scale grid:
        # rescaling the numerator in int64 overflows once
        # |a| * 10^(ts-sa+sb) exceeds 2^63 (e.g. Q14's percentage over
        # SF-scale revenue sums). float64 keeps ~15 significant digits,
        # comfortably above DECIMAL display needs here; the exact integer
        # path remains in AVG finalization (host, python ints).
        fa = _to_float(ctx, a, aft)
        fb = _to_float(ctx, b, bft)
        bz = fb == 0
        q = fa / xp.where(bz, 1.0, fb)
        scaled = q * float(_POW10[ts])
        res = xp.asarray(
            xp.where(scaled >= 0, xp.floor(scaled + 0.5),
                     xp.ceil(scaled - 0.5)), dtype=np.int64)
        return res, or_nulls(xp, an, bn, bz if bz is not False else None), None
    fa, fb = _to_float(ctx, a, aft), _to_float(ctx, b, bft)
    bz = fb == 0
    r = fa / ctx.xp.where(bz, 1.0, fb)
    return r, or_nulls(xp, an, bn, bz), None


@op("div")
def op_intdiv(ctx, expr):
    (a, an, _), (b, bn, _) = _binary_vals(ctx, expr, numeric=True)
    aft, bft = expr.args[0].ft, expr.args[1].ft
    xp = ctx.xp
    a2, b2, cls, s = coerce_numeric_pair(ctx, a, aft, b, bft)
    if cls == "float":
        bz = b2 == 0
        r = xp.asarray(a2 / xp.where(bz, 1.0, b2), dtype=np.int64)
        return r, or_nulls(xp, an, bn, bz), None
    bz = b2 == 0
    den = xp.where(bz, 1, b2)
    q = a2 // den
    # MySQL DIV truncates toward zero
    q = xp.where((xp.sign(a2) * xp.sign(den) < 0) & (a2 % den != 0), q + 1, q)
    return q, or_nulls(xp, an, bn, bz), None


@op("%", "mod")
def op_mod(ctx, expr):
    (a, an, _), (b, bn, _) = _binary_vals(ctx, expr, numeric=True)
    aft, bft = expr.args[0].ft, expr.args[1].ft
    xp = ctx.xp
    a2, b2, cls, s = coerce_numeric_pair(ctx, a, aft, b, bft)
    bz = b2 == 0
    den = xp.where(bz, 1, b2)
    if cls == "float":
        r = a2 - den * xp.trunc(a2 / den)
    else:
        r = a2 - den * xp.where(
            (xp.sign(a2) * xp.sign(den) < 0) & (a2 % den != 0),
            a2 // den + 1, a2 // den)
    return r, or_nulls(xp, an, bn, bz), None


@op("unary-")
def op_neg(ctx, expr):
    a, an, _ = _numify(ctx, eval_expr(ctx, expr.args[0]),
                       expr.args[0].ft)
    return -a, an, None


# ---------------- comparisons ----------------

def _cmp_core(xp, op_name, a, b):
    if op_name == "=":
        return a == b
    if op_name == "!=":
        return a != b
    if op_name == "<":
        return a < b
    if op_name == "<=":
        return a <= b
    if op_name == ">":
        return a > b
    if op_name == ">=":
        return a >= b
    raise ValueError(op_name)


def _pad_fold(s):
    """PAD SPACE normal form (no case fold): every non-binary MySQL
    collation ignores trailing spaces in comparisons — 'a' = 'a  '
    (reference pkg/util/collate/collate.go PadSpace attribute;
    utf8mb4_bin included)."""
    return s.rstrip(" ") if isinstance(s, str) else s


def _is_nopad(ft) -> bool:
    """Only the binary 'collation' (BINARY/VARBINARY/BLOB types or an
    explicit binary collate) compares trailing spaces."""
    if ft is None:
        return False
    if str(getattr(ft, "collate", "")).lower() == "binary":
        return True
    return (getattr(ft, "tp", "") or "").lower() in (
        "binary", "varbinary", "blob", "tinyblob", "mediumblob",
        "longblob")


def _cmp_strings(ctx, expr, op_name, aval, bval):
    xp = ctx.xp
    (a, an, ad), (b, bn, bd) = aval, bval
    aft, bft = expr.args[0].ft, expr.args[1].ft
    ci = _is_ci(aft) or _is_ci(bft)
    nopad = _is_nopad(aft) or _is_nopad(bft)
    # normal-form comparison: the _ci collation's fold (case/accent/
    # pad per its rules — general_ci, unicode_ci, 0900_ai_ci differ),
    # PAD SPACE alone for everything else but binary ('beta ' = 'BETA'
    # under general_ci, 'a ' = 'a' under utf8mb4_bin); ONE definition
    # of each normal form lives in chunk.device / _pad_fold. fold is
    # None only for binary.
    if ci:
        from ..chunk.device import collation_fold
        cn = _coll_arg(aft) or _coll_arg(bft)
        fold = collation_fold(cn)
    else:
        fold = None if nopad else _pad_fold
    if fold is not None:
        if isinstance(a, str) and isinstance(b, str):
            return (_cmp_core(xp, op_name, fold(a), fold(b)),
                    or_nulls(xp, an, bn), None)
        fkey = (ci, nopad, cn if ci else None)
        if isinstance(b, str) and ad is not None:
            tbl = _dict_table(ctx, ad,
                              lambda s: _cmp_core(np, op_name, fold(s),
                                                  fold(b)), np.bool_,
                              key=("cmp_fold", op_name, b) + fkey)
            return tbl[a], or_nulls(xp, an, bn), None
        if isinstance(a, str) and bd is not None:
            flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}
            fop = flip.get(op_name, op_name)
            tbl = _dict_table(ctx, bd,
                              lambda s: _cmp_core(np, fop, fold(s),
                                                  fold(a)), np.bool_,
                              key=("cmp_fold", fop, a) + fkey)
            return tbl[b], or_nulls(xp, an, bn), None
        if ad is not None and bd is not None:
            merged = StringDict()
            ta = np.array([merged.encode_one(fold(v)) for v in ad.values]
                          or [0], dtype=np.int64)
            tb = np.array([merged.encode_one(fold(v)) for v in bd.values]
                          or [0], dtype=np.int64)
            if op_name not in ("=", "!="):
                ranks = merged.ranks()
                ta, tb = ranks[ta], ranks[tb]
            tat = xp.asarray(ta) if not ctx.host else ta
            tbt = xp.asarray(tb) if not ctx.host else tb
            return (_cmp_core(xp, op_name, tat[a], tbt[b]),
                    or_nulls(xp, an, bn), None)
        # object-array host path falls through with folding below
    # scalar const side(s)
    if isinstance(a, str) and isinstance(b, str):
        return _cmp_core(xp, op_name, a, b), or_nulls(xp, an, bn), None
    if isinstance(b, str):
        if ad is not None:
            if op_name in ("=", "!="):
                code = ad.lookup(b)
                r = _cmp_core(xp, op_name, a, code)
                return r, or_nulls(xp, an, bn), None
            tbl = _dict_table(ctx, ad, lambda s: _cmp_core(np, op_name, s, b),
                              np.bool_, key=("cmp", op_name, b))
            return tbl[a], or_nulls(xp, an, bn), None
        fb = fold(b) if fold else b
        r = _string_elementwise(
            ctx, a,
            lambda s: _cmp_core(np, op_name,
                                fold(s) if fold else s, fb),
            dtype=np.bool_)
        return r, or_nulls(xp, an, bn), None
    if isinstance(a, str):
        flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}
        return _cmp_strings(ctx, expr, flip.get(op_name, op_name), bval, aval)
    # column vs column
    if ad is not None and bd is not None:
        if ad is bd:
            if op_name in ("=", "!="):
                return _cmp_core(xp, op_name, a, b), or_nulls(xp, an, bn), None
            ranks = ad.ranks()
            rt = ctx.xp.asarray(ranks) if not ctx.host else ranks
            return _cmp_core(xp, op_name, rt[a], rt[b]), or_nulls(xp, an, bn), None
        # different dicts: merge both into a shared dict on host, then
        # compare merged codes/ranks via device gathers
        merged = StringDict()
        ta = np.array([merged.encode_one(v) for v in ad.values] or [0],
                      dtype=np.int64)
        tb = np.array([merged.encode_one(v) for v in bd.values] or [0],
                      dtype=np.int64)
        if op_name not in ("=", "!="):
            ranks = merged.ranks()
            ta = ranks[ta]
            tb = ranks[tb]
        tat = xp.asarray(ta) if not ctx.host else ta
        tbt = xp.asarray(tb) if not ctx.host else tb
        return _cmp_core(xp, op_name, tat[a], tbt[b]), or_nulls(xp, an, bn), None
    # host object arrays
    out = np.empty(ctx.n, dtype=np.bool_)
    for i in range(ctx.n):
        av, bv = a[i], b[i]
        if fold is not None:
            av, bv = fold(av), fold(bv)
        out[i] = _cmp_core(np, op_name, av, bv)
    return out, or_nulls(xp, an, bn), None


@op("=", "!=", "<", "<=", ">", ">=")
def op_cmp(ctx, expr):
    aval, bval = _binary_vals(ctx, expr)
    if _is_string_val(aval, expr.args[0]) or _is_string_val(bval, expr.args[1]):
        aft, bft = expr.args[0].ft, expr.args[1].ft
        a_is = aft.tclass in (TypeClass.STRING, TypeClass.JSON)
        b_is = bft.tclass in (TypeClass.STRING, TypeClass.JSON)
        if a_is and b_is:
            return _cmp_strings(ctx, expr, expr.op, aval, bval)
        # mixed string/numeric: the string side compares as a NUMBER
        # (prefix parse — dict codes must never reach _cmp_core)
        aval = _numify(ctx, aval, aft)
        bval = _numify(ctx, bval, bft)
    (a, an, _), (b, bn, _) = aval, bval
    a2, b2, _, _ = coerce_numeric_pair(ctx, a, expr.args[0].ft, b,
                                       expr.args[1].ft)
    return _cmp_core(ctx.xp, expr.op, a2, b2), or_nulls(ctx.xp, an, bn), None


@op("<=>")
def op_nullsafe_eq(ctx, expr):
    (a, an, _), (b, bn, _) = _binary_vals(ctx, expr)
    xp = ctx.xp
    anm = materialize_nulls(ctx, an)
    bnm = materialize_nulls(ctx, bn)
    a2, b2, _, _ = coerce_numeric_pair(ctx, a, expr.args[0].ft, b,
                                       expr.args[1].ft)
    eq = (a2 == b2) & ~anm & ~bnm
    both_null = anm & bnm
    return eq | both_null, None, None


# ---------------- logic ----------------

def _truthy(ctx, val, ft):
    data, nulls, sdict = val
    xp = ctx.xp
    if isinstance(data, str):
        try:
            data = float(data)
        except ValueError:
            data = 0.0
    if sdict is not None:
        tbl = _dict_table(ctx, sdict, _str_truthy, np.bool_,
                          key=("truthy",))
        return tbl[data], nulls
    if hasattr(data, "dtype") and data.dtype == object:
        return _string_elementwise(ctx, data, _str_truthy, np.bool_), nulls
    if np.isscalar(data):
        return bool(data), nulls
    if data.dtype == bool:
        return data, nulls
    return data != 0, nulls


def _str_truthy(s):
    try:
        return float(s) != 0
    except (ValueError, TypeError):
        return False


@op("and")
def op_and(ctx, expr):
    av = eval_expr(ctx, expr.args[0])
    bv = eval_expr(ctx, expr.args[1])
    a, an = _truthy(ctx, av, expr.args[0].ft)
    b, bn = _truthy(ctx, bv, expr.args[1].ft)
    xp = ctx.xp
    anm = materialize_nulls(ctx, an)
    bnm = materialize_nulls(ctx, bn)
    at = xp.asarray(a) if np.isscalar(a) else a
    bt = xp.asarray(b) if np.isscalar(b) else b
    val = at & bt & ~anm & ~bnm
    # NULL unless one side is definite FALSE
    a_false = ~anm & ~at
    b_false = ~bnm & ~bt
    nulls = (anm | bnm) & ~a_false & ~b_false
    return val, nulls, None


@op("or")
def op_or(ctx, expr):
    av = eval_expr(ctx, expr.args[0])
    bv = eval_expr(ctx, expr.args[1])
    a, an = _truthy(ctx, av, expr.args[0].ft)
    b, bn = _truthy(ctx, bv, expr.args[1].ft)
    xp = ctx.xp
    anm = materialize_nulls(ctx, an)
    bnm = materialize_nulls(ctx, bn)
    at = xp.asarray(a) if np.isscalar(a) else a
    bt = xp.asarray(b) if np.isscalar(b) else b
    a_true = ~anm & at
    b_true = ~bnm & bt
    val = a_true | b_true
    nulls = (anm | bnm) & ~val
    return val, nulls, None


@op("xor")
def op_xor(ctx, expr):
    av = eval_expr(ctx, expr.args[0])
    bv = eval_expr(ctx, expr.args[1])
    a, an = _truthy(ctx, av, expr.args[0].ft)
    b, bn = _truthy(ctx, bv, expr.args[1].ft)
    xp = ctx.xp
    at = xp.asarray(a) if np.isscalar(a) else a
    bt = xp.asarray(b) if np.isscalar(b) else b
    return at ^ bt, or_nulls(xp, an, bn), None


@op("not")
def op_not(ctx, expr):
    av = eval_expr(ctx, expr.args[0])
    a, an = _truthy(ctx, av, expr.args[0].ft)
    if np.isscalar(a):
        return (not a), an, None
    return ~a, an, None


@op("isnull")
def op_isnull(ctx, expr):
    _, nulls, _ = eval_expr(ctx, expr.args[0])
    return materialize_nulls(ctx, nulls), None, None


@op("isnotnull")
def op_isnotnull(ctx, expr):
    _, nulls, _ = eval_expr(ctx, expr.args[0])
    return ~materialize_nulls(ctx, nulls), None, None


@op("istrue")
def op_istrue(ctx, expr):
    av = eval_expr(ctx, expr.args[0])
    a, an = _truthy(ctx, av, expr.args[0].ft)
    anm = materialize_nulls(ctx, an)
    at = ctx.xp.asarray(a) if np.isscalar(a) else a
    return at & ~anm, None, None


@op("isfalse")
def op_isfalse(ctx, expr):
    av = eval_expr(ctx, expr.args[0])
    a, an = _truthy(ctx, av, expr.args[0].ft)
    anm = materialize_nulls(ctx, an)
    at = ctx.xp.asarray(a) if np.isscalar(a) else a
    return ~at & ~anm, None, None


# ---------------- conditionals ----------------

def _coerce_to_ft(ctx, val, from_ft, to_ft):
    """Convert a value to the target ft's dataclass for WHERE/CASE merging."""
    data, nulls, sdict = val
    tc, fc = _dataclass_of(to_ft), _dataclass_of(from_ft)
    xp = ctx.xp
    if tc == "string":
        return val
    if tc == "float":
        return _to_float(ctx, data, from_ft), nulls, None
    if tc == "decimal":
        if fc == "decimal":
            k = _scale_of(to_ft) - _scale_of(from_ft)
            if k >= 0:
                return _rescale_up(xp, data, k), nulls, None
            return _rescale_down_round(xp, data, -k), nulls, None
        if fc == "int":
            return data * _POW10[_scale_of(to_ft)], nulls, None
        # float -> decimal
        d = data * _POW10[_scale_of(to_ft)]
        return xp.asarray(xp.round(d), dtype=np.int64), nulls, None
    return data, nulls, None


@op("if")
def op_if(ctx, expr):
    cond = eval_bool_mask(ctx, expr.args[0])
    a = _coerce_to_ft(ctx, eval_expr(ctx, expr.args[1]), expr.args[1].ft, expr.ft)
    b = _coerce_to_ft(ctx, eval_expr(ctx, expr.args[2]), expr.args[2].ft, expr.ft)
    return _merge_where(ctx, cond, a, b, expr)


def _merge_where(ctx, cond, a, b, expr):
    xp = ctx.xp
    (ad, an, asd), (bd, bn, bsd) = a, b
    if asd is not None or bsd is not None or isinstance(ad, str) or \
            isinstance(bd, str):
        return _merge_where_strings(ctx, cond, a, b)
    if np.isscalar(ad):
        ad = ctx.full(ad)
    if np.isscalar(bd):
        bd = ctx.full(bd)
    data = xp.where(cond, ad, bd)
    if (an is None or an is False) and (bn is None or bn is False):
        # neither branch is ever NULL: no mask (CASE WHEN c THEN x ELSE 0
        # stays a plain column, which the device's scan kernels take)
        return data, None, None
    nulls = xp.where(cond, materialize_nulls(ctx, an),
                     materialize_nulls(ctx, bn))
    return data, nulls, None


def _merge_where_strings(ctx, cond, a, b):
    (ad, an, asd), (bd, bn, bsd) = a, b
    out = StringDict()
    xp = ctx.xp

    def to_codes(data, sdict):
        if isinstance(data, str):
            return out.encode_one(data)
        if sdict is not None:
            mapping = np.array([out.encode_one(v) for v in sdict.values]
                               or [0], dtype=np.int32)
            mt = xp.asarray(mapping) if not ctx.host else mapping
            return mt[data]
        return out.encode(data.astype(object))

    ac = to_codes(ad, asd)
    bc = to_codes(bd, bsd)
    anm = materialize_nulls(ctx, an)
    bnm = materialize_nulls(ctx, bn)
    if np.isscalar(ac):
        ac = ctx.full(ac, dtype=np.int32)
    if np.isscalar(bc):
        bc = ctx.full(bc, dtype=np.int32)
    return xp.where(cond, ac, bc), xp.where(cond, anm, bnm), out


@op("ifnull")
def op_ifnull(ctx, expr):
    a = eval_expr(ctx, expr.args[0])
    cond = ~materialize_nulls(ctx, a[1])
    av = _coerce_to_ft(ctx, a, expr.args[0].ft, expr.ft)
    b = _coerce_to_ft(ctx, eval_expr(ctx, expr.args[1]), expr.args[1].ft, expr.ft)
    return _merge_where(ctx, cond, av, b, expr)


@op("nullif")
def op_nullif(ctx, expr):
    a = eval_expr(ctx, expr.args[0])
    eq_expr = ScalarFunc("=", [expr.args[0], expr.args[1]], expr.ft)
    eq = eval_bool_mask(ctx, eq_expr)
    nulls = materialize_nulls(ctx, a[1]) | eq
    return a[0], nulls, a[2]


@op("coalesce")
def op_coalesce(ctx, expr):
    result = _coerce_to_ft(ctx, eval_expr(ctx, expr.args[0]),
                           expr.args[0].ft, expr.ft)
    for arg in expr.args[1:]:
        nxt = _coerce_to_ft(ctx, eval_expr(ctx, arg), arg.ft, expr.ft)
        cond = ~materialize_nulls(ctx, result[1])
        result = _merge_where(ctx, cond, result, nxt, expr)
    return result


@op("case_when")
def op_case_when(ctx, expr):
    """args = [cond1, res1, cond2, res2, ..., else_res]."""
    args = expr.args
    has_else = len(args) % 2 == 1
    else_val = (_coerce_to_ft(ctx, eval_expr(ctx, args[-1]), args[-1].ft,
                              expr.ft) if has_else
                else (ctx.full(0), ctx.xp.ones(ctx.n, dtype=bool), None))
    pairs = args[:-1] if has_else else args
    result = else_val
    # evaluate in reverse so first matching WHEN wins
    for i in range(len(pairs) - 2, -1, -2):
        cond = eval_bool_mask(ctx, pairs[i])
        val = _coerce_to_ft(ctx, eval_expr(ctx, pairs[i + 1]),
                            pairs[i + 1].ft, expr.ft)
        result = _merge_where(ctx, cond, val, result, expr)
    return result


def _sorted_membership(ctx, a, table_np):
    """value-in-sorted-table membership: searchsorted + one gather,
    O(n log k) on both backends (device isin would broadcast [n, k])."""
    xp = ctx.xp
    st = np.sort(np.asarray(table_np))
    if len(st) == 0:
        return xp.zeros(ctx.n, dtype=bool)
    stx = xp.asarray(st)
    ai = a.astype(stx.dtype) if hasattr(a, "astype") else a
    idx = xp.searchsorted(stx, ai)
    idx = xp.clip(idx, 0, len(st) - 1)
    return stx[idx] == ai


def _is_int_array(a) -> bool:
    """Is `a` an integer array (numpy) or tensor (torch dtypes have no
    .kind)? Bool is not."""
    dt = getattr(a, "dtype", None)
    if dt is None:
        return False
    kind = getattr(dt, "kind", None)
    if kind is not None:
        return kind in "iu"
    return not (dt.is_floating_point or dt.is_complex) and \
        str(dt) != "torch.bool"


@op("in")
def op_in(ctx, expr):
    """args[0] IN (args[1:]) — constants only on the list side here;
    non-const IN is rewritten to ORs by the planner."""
    av = eval_expr(ctx, expr.args[0])
    a, an, asd = av
    xp = ctx.xp
    aft = expr.args[0].ft
    if asd is not None or (hasattr(a, "dtype") and a.dtype == object):
        # string IN list
        consts = [c.value.val for c in expr.args[1:] if not c.value.is_null]
        if asd is not None:
            codes = np.array([asd.lookup(s) for s in consts] or [-2],
                             dtype=np.int64)
            r = _sorted_membership(ctx, a, codes)
            return r, an, None
        sset = set(consts)
        r = _string_elementwise(ctx, a, lambda s: s in sset, np.bool_)
        return r, an, None
    pairs = []
    any_null = False
    for c in expr.args[1:]:
        if c.value.is_null:
            any_null = True
            continue
        cv, _, _ = _eval_const(ctx, c)
        a2c, cvc, _, _ = coerce_numeric_pair(ctx, a, aft, cv, c.ft)
        pairs.append((a2c, cvc))
    if len(pairs) > 8 and all(np.isscalar(cv) for _, cv in pairs):
        # vectorized membership for long lists (decorrelated IN,
        # Q18-style). NOT xp.isin: on device it lowers to an [n, k]
        # broadcast compare (q2's 781-key list over 917k lanes burned
        # 418ms); sorted table + searchsorted is O(n log k)
        a2c = pairs[0][0]
        table = np.array([cv for _, cv in pairs])
        if table.dtype.kind in "iu" and _is_int_array(a2c):
            r = _sorted_membership(ctx, a2c, table.astype(np.int64))
        else:
            r = xp.isin(a2c, xp.asarray(table))
    else:
        r = xp.zeros(ctx.n, dtype=bool)
        for a2c, cvc in pairs:
            r = r | (a2c == cvc)
    nulls = or_nulls(xp, an)
    if any_null:
        # x IN (.., NULL): false -> NULL
        nm = materialize_nulls(ctx, nulls)
        nulls = nm | ~r
    return r, nulls, None


# ---------------- LIKE / regexp ----------------

def like_to_regex(pattern: str, escape: str = "\\") -> str:
    out = []
    i = 0
    n = len(pattern)
    while i < n:
        c = pattern[i]
        if c == escape and i + 1 < n:
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return "^" + "".join(out) + "$"


def _is_ci(ft) -> bool:
    return ft is not None and str(getattr(ft, "collate", "")).endswith("_ci")


# PAD SPACE case-sensitive collations: trailing spaces are
# insignificant for grouping/joins/ordering, but case still matters
# (MySQL 8: every non-0900, non-binary collation PADs)
_PAD_BIN_COLLATIONS = frozenset((
    "utf8mb4_bin", "utf8_bin", "latin1_bin", "gbk_bin", "gb18030_bin"))


def _needs_fold(ft) -> bool:
    """Does the collation require a canonical-key fold for grouping/
    join/order equality? _ci collations and the PAD-SPACE _bin ones."""
    if ft is None:
        return False
    coll = str(getattr(ft, "collate", "")).lower()
    return coll.endswith("_ci") or coll in _PAD_BIN_COLLATIONS


def _coll_arg(ft):
    """StringDict coll argument for a field type: the collation name
    when it folds (_ci or pad-space _bin), else False (byte order)."""
    return str(ft.collate).lower() if _needs_fold(ft) else False


@op("like")
def op_like(ctx, expr):
    av = eval_expr(ctx, expr.args[0])
    pat = _as_str_scalar(eval_expr(ctx, expr.args[1]))
    if pat is None:
        raise UnknownFunctionError("non-constant LIKE pattern unsupported")
    esc = "\\"
    if len(expr.args) > 2:
        esc = _as_str_scalar(eval_expr(ctx, expr.args[2])) or "\\"
    flags = re.DOTALL | (re.IGNORECASE if _is_ci(expr.args[0].ft) else 0)
    rx = re.compile(like_to_regex(pat, esc), flags)
    return _apply_str_fn(ctx, av, lambda s: rx.match(s) is not None,
                         out_is_string=False, key=("like", pat, esc, flags))


@op("regexp")
def op_regexp(ctx, expr):
    av = eval_expr(ctx, expr.args[0])
    pat = _as_str_scalar(eval_expr(ctx, expr.args[1]))
    if pat is None:
        raise UnknownFunctionError("non-constant REGEXP pattern unsupported")
    rx = re.compile(pat)
    return _apply_str_fn(ctx, av, lambda s: rx.search(s) is not None,
                         out_is_string=False, key=("regexp", pat))


# ---------------- string functions ----------------

@op("_collkey")
def op_collkey(ctx, expr):
    """Collation canonical key (internal; planner-injected around GROUP
    BY / DISTINCT items on _ci columns): dict codes map to the code of
    the FIRST value sharing the utf8mb4_general_ci+PAD normal form, so
    grouping merges case/padding variants and still decodes to an
    original representative (reference pkg/util/collate)."""
    from ..chunk.device import collation_fold
    fold = collation_fold(_coll_arg(expr.args[0].ft) or True)
    d, nl, sd = eval_expr(ctx, expr.args[0])
    if sd is None:
        if isinstance(d, str):
            return fold(d), nl, None
        if hasattr(d, "dtype") and d.dtype == object:
            out = np.array([fold(v) for v in d], dtype=object)
            return out, nl, None
        return d, nl, sd
    t = sd.ci_norm_table(_coll_arg(expr.args[0].ft) or True)
    tt = ctx.xp.asarray(t) if not ctx.host else t
    return tt[d], nl, sd


@op("_collkey_fold")
def op_collkey_fold(ctx, expr):
    """Collation join key (internal; planner-injected around _ci join
    eq keys): values re-encode by NORMAL FORM into a dict of normal
    forms — the hash-join shared-dict translation then matches rows
    across sides regardless of case/padding."""
    d, nl, sd = eval_expr(ctx, expr.args[0])
    if sd is None:
        return op_collkey(ctx, expr)
    codes, fd = sd.ci_fold_codes(_coll_arg(expr.args[0].ft) or True)
    tt = ctx.xp.asarray(codes) if not ctx.host else codes
    return tt[d], nl, fd


@op("_minmaxkey")
def op_minmaxkey(ctx, expr):
    """Rank-ordered recode (internal; planner-injected around MIN/MAX
    string args): dict codes map into a dict whose code order IS the
    collation order, so the agg kernel's numeric min/max computes
    string min/max and the state decodes to the right value. Dict codes
    are otherwise insertion-ordered — numeric min over them is
    first-inserted, not smallest."""
    d, nl, sd = eval_expr(ctx, expr.args[0])
    if sd is None:
        return d, nl, sd          # host object arrays compare by value
    code_map, sorted_dict = sd.rank_codes(_coll_arg(expr.ft))
    tt = ctx.xp.asarray(code_map) if not ctx.host else code_map
    return tt[d], nl, sorted_dict


@op("lower", "lcase")
def op_lower(ctx, expr):
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]), str.lower,
                         key=("lower",))


@op("upper", "ucase")
def op_upper(ctx, expr):
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]), str.upper,
                         key=("upper",))


@op("length", "octet_length")
def op_length(ctx, expr):
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]),
                         lambda s: len(s.encode("utf-8")), out_is_string=False,
                         key=("length",))


@op("char_length", "character_length")
def op_char_length(ctx, expr):
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]), len,
                         out_is_string=False, key=("char_length",))


def _to_str_val(ctx, val, ft):
    """Numeric/temporal operand in STRING context -> its MySQL string
    form (decimal scale, date/time rendering — never raw storage
    ints). String scalars and dict columns pass through."""
    d, nl, sd = val
    if sd is not None or isinstance(d, str):
        return val
    from ..types.decimal import scaled_int_to_str
    from ..types.time_types import days_to_str, micros_to_str

    def fmt(x):
        if x is None:
            return ""
        tc = ft.tclass
        if tc == TypeClass.DECIMAL:
            return scaled_int_to_str(int(x), max(ft.decimal, 0))
        if tc == TypeClass.DATE:
            return days_to_str(int(x))
        if tc in (TypeClass.DATETIME, TypeClass.TIMESTAMP):
            return micros_to_str(int(x), max(ft.decimal, 0))
        if tc == TypeClass.FLOAT or isinstance(x, (float, np.floating)):
            f = float(x)
            return str(int(f)) if f == int(f) and abs(f) < 1e15 \
                else repr(f)
        if tc == TypeClass.UINT or (tc == TypeClass.INT and
                                    ft.unsigned):
            # unsigned storage is int64 bit patterns
            return str(int(x) & 0xFFFFFFFFFFFFFFFF)
        return str(int(x))
    if np.isscalar(d) or getattr(d, "ndim", 1) == 0:
        return fmt(d), nl, None
    arr = np.asarray(d)
    if arr.dtype == object:
        return val
    out = np.array([fmt(x) for x in arr], dtype=object)
    return out, nl, None


def _typed_py_val(ctx, val, ft):
    """Storage values -> MySQL-typed python values (JSON contexts):
    decimals become numbers, temporals become their strings, unsigned
    reinterprets; strings/dicts pass through."""
    d, nl, sd = val
    if sd is not None or isinstance(d, str):
        return val
    tc = ft.tclass

    def conv(x):
        if x is None:
            return None
        if tc == TypeClass.DECIMAL:
            return float(int(x)) / float(_POW10[max(ft.decimal, 0)])
        if tc in (TypeClass.DATE, TypeClass.DATETIME,
                  TypeClass.TIMESTAMP):
            from ..types.decimal import scaled_int_to_str  # noqa: F401
            from ..types.time_types import (days_to_str,
                                            micros_to_str)
            return days_to_str(int(x)) if tc == TypeClass.DATE \
                else micros_to_str(int(x), max(ft.decimal, 0))
        if tc == TypeClass.UINT or (tc == TypeClass.INT and
                                    ft.unsigned):
            return int(x) & 0xFFFFFFFFFFFFFFFF
        return x
    if tc not in (TypeClass.DECIMAL, TypeClass.DATE,
                  TypeClass.DATETIME, TypeClass.TIMESTAMP,
                  TypeClass.UINT) and not (tc == TypeClass.INT and
                                           ft.unsigned):
        return val
    if np.isscalar(d) or getattr(d, "ndim", 1) == 0:
        return conv(d), nl, None
    out = np.array([conv(x) for x in np.asarray(d)], dtype=object)
    return out, nl, None


@op("concat")
def op_concat(ctx, expr):
    vals = [_to_str_val(ctx, eval_expr(ctx, a), a.ft)
            for a in expr.args]
    # a constant-NULL argument nullifies every row (MySQL semantics)
    if any(v[1] is True for v in vals):
        return "", True, None
    # all-scalar fast path
    if all(isinstance(v[0], str) for v in vals):
        return "".join(v[0] for v in vals), or_nulls(ctx.xp, *[v[1] for v in vals]), None
    # single column + scalars: dict transform
    col_is = [i for i, v in enumerate(vals)
              if not isinstance(v[0], str)]
    nulls = or_nulls(ctx.xp, *[v[1] for v in vals])
    if len(col_is) == 1:
        ci = col_is[0]
        pre = "".join(str(vals[i][0]) for i in range(ci))
        post = "".join(str(vals[i][0]) for i in range(ci + 1, len(vals)))
        r = _apply_str_fn(ctx, vals[ci], lambda s: pre + s + post,
                          key=("concat", pre, post))
        return r[0], nulls, r[2]
    # multi-column: host elementwise (device path decodes via copr fallback)
    arrs = []
    for v, a in zip(vals, expr.args):
        d, _, sd = v
        if isinstance(d, str):
            arrs.append(None)
        elif sd is not None:
            arrs.append(sd.decode(np.asarray(d)))
        else:
            arrs.append(d)
    out = np.empty(ctx.n, dtype=object)
    for i in range(ctx.n):
        parts = []
        for v, arr in zip(vals, arrs):
            parts.append(v[0] if arr is None else str(arr[i]))
        out[i] = "".join(parts)
    return out, nulls, None


@op("substring", "substr", "mid")
def op_substring(ctx, expr):
    av = eval_expr(ctx, expr.args[0])
    start = _const_int(ctx, expr.args[1])
    length = _const_int(ctx, expr.args[2]) if len(expr.args) > 2 else None

    def sub(s):
        st = start
        if st > 0:
            st -= 1
        elif st < 0:
            st = len(s) + st
            if st < 0:
                return ""
        if length is None:
            return s[st:]
        return s[st:st + max(length, 0)]
    return _apply_str_fn(ctx, av, sub, key=("substring", start, length))


@op("left")
def op_left(ctx, expr):
    n = _const_int(ctx, expr.args[1])
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]), lambda s: s[:max(n, 0)],
                         key=("left", n))


@op("right")
def op_right(ctx, expr):
    n = _const_int(ctx, expr.args[1])
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]),
                         lambda s: s[-n:] if n > 0 else "", key=("right", n))


@op("trim")
def op_trim(ctx, expr):
    rem = _as_str_scalar(eval_expr(ctx, expr.args[1])) if len(expr.args) > 1 else " "
    mode = _as_str_scalar(eval_expr(ctx, expr.args[2])) if len(expr.args) > 2 else "both"

    def t(s):
        if mode == "leading":
            while s.startswith(rem):
                s = s[len(rem):]
            return s
        if mode == "trailing":
            while s.endswith(rem):
                s = s[:-len(rem)]
            return s
        while s.startswith(rem):
            s = s[len(rem):]
        while s.endswith(rem):
            s = s[:-len(rem)]
        return s
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]), t,
                         key=("trim", rem, mode))


@op("ltrim")
def op_ltrim(ctx, expr):
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]), str.lstrip,
                         key=("ltrim",))


@op("rtrim")
def op_rtrim(ctx, expr):
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]), str.rstrip,
                         key=("rtrim",))


@op("replace")
def op_replace(ctx, expr):
    old = _as_str_scalar(eval_expr(ctx, expr.args[1]))
    new = _as_str_scalar(eval_expr(ctx, expr.args[2]))
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]),
                         lambda s: s.replace(old, new),
                         key=("replace", old, new))


@op("locate", "instr")
def op_locate(ctx, expr):
    if expr.op == "instr":
        sv = eval_expr(ctx, expr.args[0])
        sub = _as_str_scalar(eval_expr(ctx, expr.args[1]))
        pos = 1
    else:
        sub = _as_str_scalar(eval_expr(ctx, expr.args[0]))
        sv = eval_expr(ctx, expr.args[1])
        # LOCATE(substr, str, pos): 1-based; pos < 1 -> 0 (MySQL)
        pos = _const_int(ctx, expr.args[2]) \
            if len(expr.args) > 2 else 1
    if pos < 1:
        data, nulls, _ = sv
        n = len(data) if hasattr(data, "__len__") and \
            not isinstance(data, str) else None
        out = ctx.xp.zeros(n, dtype=np.int64) if n is not None else 0
        return out, nulls, None
    return _apply_str_fn(ctx, sv,
                         lambda s: s.find(sub, pos - 1) + 1,
                         out_is_string=False, key=("locate", sub, pos))


@op("reverse")
def op_reverse(ctx, expr):
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]), lambda s: s[::-1],
                         key=("reverse",))


@op("lpad")
def op_lpad(ctx, expr):
    n = _const_int(ctx, expr.args[1])
    pad = _as_str_scalar(eval_expr(ctx, expr.args[2]))

    def f(s):
        if len(s) >= n:
            return s[:n]
        need = n - len(s)
        p = (pad * need)[:need]
        return p + s
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]), f,
                         key=("lpad", n, pad))


@op("rpad")
def op_rpad(ctx, expr):
    n = _const_int(ctx, expr.args[1])
    pad = _as_str_scalar(eval_expr(ctx, expr.args[2]))

    def f(s):
        if len(s) >= n:
            return s[:n]
        need = n - len(s)
        return s + (pad * need)[:need]
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]), f,
                         key=("rpad", n, pad))


def _const_int(ctx, expr):
    v, _, _ = eval_expr(ctx, expr)
    if not np.isscalar(v):
        raise UnknownFunctionError("expected constant argument")
    return int(v)


# ---------------- math ----------------

@op("abs")
def op_abs(ctx, expr):
    a, an, _ = eval_expr(ctx, expr.args[0])
    return ctx.xp.abs(a), an, None


@op("ceil", "ceiling")
def op_ceil(ctx, expr):
    a, an, _ = eval_expr(ctx, expr.args[0])
    ft = expr.args[0].ft
    xp = ctx.xp
    if _dataclass_of(ft) == "decimal":
        s = _scale_of(ft)
        return -((-a) // _POW10[s]), an, None
    if _dataclass_of(ft) == "float":
        return xp.asarray(xp.ceil(a), dtype=np.int64), an, None
    return a, an, None


@op("floor")
def op_floor(ctx, expr):
    a, an, _ = eval_expr(ctx, expr.args[0])
    ft = expr.args[0].ft
    xp = ctx.xp
    if _dataclass_of(ft) == "decimal":
        return a // _POW10[_scale_of(ft)], an, None
    if _dataclass_of(ft) == "float":
        return xp.asarray(xp.floor(a), dtype=np.int64), an, None
    return a, an, None


@op("round")
def op_round(ctx, expr):
    a, an, _ = eval_expr(ctx, expr.args[0])
    ft = expr.args[0].ft
    d = _const_int(ctx, expr.args[1]) if len(expr.args) > 1 else 0
    xp = ctx.xp
    if _dataclass_of(ft) == "decimal":
        s = _scale_of(ft)
        ts = _scale_of(expr.ft)
        if d >= s:
            r = a
        else:
            r = _rescale_down_round(xp, a, s - d)
            r = _rescale_up(xp, r, s - d)   # back to original scale grid
        # adjust to result scale
        if ts != s:
            r = _rescale_up(xp, r, ts - s) if ts > s else \
                _rescale_down_round(xp, r, s - ts)
        return r, an, None
    if _dataclass_of(ft) == "float":
        m = 10.0 ** d
        return xp.floor(xp.abs(a) * m + 0.5) / m * xp.sign(a), an, None
    if d >= 0:
        return a, an, None
    m = _POW10[-d]
    return _rescale_down_round(xp, a, -d) * m, an, None


@op("truncate")
def op_truncate(ctx, expr):
    a, an, _ = eval_expr(ctx, expr.args[0])
    ft = expr.args[0].ft
    d = _const_int(ctx, expr.args[1])
    xp = ctx.xp
    if _dataclass_of(ft) == "decimal":
        s = _scale_of(ft)
        if d >= s:
            return a, an, None
        # result is declared at scale min(max(d,0), s): truncate at digit
        # d, then re-scale the representation to match
        tgt = min(max(d, 0), s)
        k = _POW10[s - d]
        t = xp.sign(a) * (xp.abs(a) // k)      # value * 10^d
        return t * _POW10[tgt - d], an, None
    if _dataclass_of(ft) == "float":
        m = 10.0 ** d
        return xp.trunc(a * m) / m, an, None
    if d >= 0:
        return a, an, None
    k = _POW10[-d]
    return xp.sign(a) * ((xp.abs(a) // k) * k), an, None


@op("sign")
def op_sign(ctx, expr):
    a, an, _ = eval_expr(ctx, expr.args[0])
    return ctx.xp.asarray(ctx.xp.sign(a), dtype=np.int64), an, None


@op("sqrt")
def op_sqrt(ctx, expr):
    a, an, _ = eval_expr(ctx, expr.args[0])
    f = _to_float(ctx, a, expr.args[0].ft)
    neg = f < 0
    r = ctx.xp.sqrt(ctx.xp.where(neg, 0.0, f))
    return r, or_nulls(ctx.xp, an, neg), None


@op("exp")
def op_exp(ctx, expr):
    a, an, _ = eval_expr(ctx, expr.args[0])
    return ctx.xp.exp(_to_float(ctx, a, expr.args[0].ft)), an, None


@op("ln", "log")
def op_ln(ctx, expr):
    if len(expr.args) == 2:     # log(base, x)
        base, bn, _ = eval_expr(ctx, expr.args[0])
        a, an, _ = eval_expr(ctx, expr.args[1])
        fb = _to_float(ctx, base, expr.args[0].ft)
        fa = _to_float(ctx, a, expr.args[1].ft)
        bad = (fa <= 0) | (fb <= 0)
        r = ctx.xp.log(ctx.xp.where(fa <= 0, 1.0, fa)) / \
            ctx.xp.log(ctx.xp.where(fb <= 0, 2.0, fb))
        return r, or_nulls(ctx.xp, an, bn, bad), None
    a, an, _ = eval_expr(ctx, expr.args[0])
    f = _to_float(ctx, a, expr.args[0].ft)
    bad = f <= 0
    return ctx.xp.log(ctx.xp.where(bad, 1.0, f)), or_nulls(ctx.xp, an, bad), None


@op("log2")
def op_log2(ctx, expr):
    a, an, _ = eval_expr(ctx, expr.args[0])
    f = _to_float(ctx, a, expr.args[0].ft)
    bad = f <= 0
    return ctx.xp.log2(ctx.xp.where(bad, 1.0, f)), or_nulls(ctx.xp, an, bad), None


@op("log10")
def op_log10(ctx, expr):
    a, an, _ = eval_expr(ctx, expr.args[0])
    f = _to_float(ctx, a, expr.args[0].ft)
    bad = f <= 0
    return ctx.xp.log10(ctx.xp.where(bad, 1.0, f)), or_nulls(ctx.xp, an, bad), None


@op("pow", "power")
def op_pow(ctx, expr):
    (a, an, _), (b, bn, _) = _binary_vals(ctx, expr)
    fa = _to_float(ctx, a, expr.args[0].ft)
    fb = _to_float(ctx, b, expr.args[1].ft)
    return fa ** fb, or_nulls(ctx.xp, an, bn), None


@op("greatest")
def op_greatest(ctx, expr):
    return _minmax_n(ctx, expr, is_max=True)


@op("least")
def op_least(ctx, expr):
    return _minmax_n(ctx, expr, is_max=False)


def _minmax_n(ctx, expr, is_max):
    xp = ctx.xp
    result = None
    nulls = None
    for arg in expr.args:
        v = _coerce_to_ft(ctx, eval_expr(ctx, arg), arg.ft, expr.ft)
        d = ctx.full(v[0]) if np.isscalar(v[0]) else v[0]
        nulls = or_nulls(xp, nulls, v[1])
        if result is None:
            result = d
        else:
            result = xp.where(d > result, d, result) if is_max else \
                xp.where(d < result, d, result)
    return result, nulls, None


# ---------------- bit ops ----------------

@op("&")
def op_bitand(ctx, expr):
    (a, an, _), (b, bn, _) = _binary_vals(ctx, expr)
    return a & b, or_nulls(ctx.xp, an, bn), None


@op("|")
def op_bitor(ctx, expr):
    (a, an, _), (b, bn, _) = _binary_vals(ctx, expr)
    return a | b, or_nulls(ctx.xp, an, bn), None


@op("^")
def op_bitxor(ctx, expr):
    (a, an, _), (b, bn, _) = _binary_vals(ctx, expr)
    return a ^ b, or_nulls(ctx.xp, an, bn), None


@op("<<")
def op_shl(ctx, expr):
    (a, an, _), (b, bn, _) = _binary_vals(ctx, expr)
    # numpy's (and XLA's) shift: 0 past 63 or below 0, where C and CUDA
    # leave it undefined
    return ctx.xp.left_shift(a, b), or_nulls(ctx.xp, an, bn), None


@op(">>")
def op_shr(ctx, expr):
    (a, an, _), (b, bn, _) = _binary_vals(ctx, expr)
    return ctx.xp.right_shift(a, b), or_nulls(ctx.xp, an, bn), None


@op("~")
def op_bitneg(ctx, expr):
    a, an, _ = eval_expr(ctx, expr.args[0])
    return ~a, an, None


# ---------------- temporal ----------------

def civil_from_days(xp, z):
    """days-since-epoch -> (y, m, d); Hinnant's algorithm, pure int ops —
    vectorizes on the VPU."""
    z = z + 719468
    era = xp.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = xp.where(mp < 10, mp + 3, mp - 9)
    y = xp.where(m <= 2, y + 1, y)
    return y, m, d


def days_from_civil(xp, y, m, d):
    y = xp.where(m <= 2, y - 1, y)
    era = xp.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    mp = xp.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _days_of(ctx, expr_arg):
    """Evaluate a temporal arg to days-since-epoch."""
    a, an, sd = eval_expr(ctx, expr_arg)
    tc = expr_arg.ft.tclass
    if sd is not None or isinstance(a, str) or \
            (hasattr(a, "dtype") and a.dtype == object):
        from ..types.time_types import parse_date
        r = _apply_str_fn(ctx, (a, an, sd), parse_date, out_is_string=False,
                          key=("parse_date",))
        return r[0], r[1]
    if tc in (TypeClass.DATETIME, TypeClass.TIMESTAMP):
        return a // MICROS_PER_DAY, an
    return a, an


@op("year")
def op_year(ctx, expr):
    days, an = _days_of(ctx, expr.args[0])
    y, m, d = civil_from_days(ctx.xp, days)
    return y, an, None


@op("month")
def op_month(ctx, expr):
    days, an = _days_of(ctx, expr.args[0])
    y, m, d = civil_from_days(ctx.xp, days)
    return m, an, None


@op("day", "dayofmonth")
def op_day(ctx, expr):
    days, an = _days_of(ctx, expr.args[0])
    y, m, d = civil_from_days(ctx.xp, days)
    return d, an, None


@op("quarter")
def op_quarter(ctx, expr):
    days, an = _days_of(ctx, expr.args[0])
    y, m, d = civil_from_days(ctx.xp, days)
    return (m - 1) // 3 + 1, an, None


@op("dayofweek")
def op_dayofweek(ctx, expr):
    days, an = _days_of(ctx, expr.args[0])
    # 1970-01-01 is Thursday; MySQL: 1=Sunday
    return (days + 4) % 7 + 1, an, None


@op("weekday")
def op_weekday(ctx, expr):
    days, an = _days_of(ctx, expr.args[0])
    return (days + 3) % 7, an, None


@op("dayofyear")
def op_dayofyear(ctx, expr):
    days, an = _days_of(ctx, expr.args[0])
    y, m, d = civil_from_days(ctx.xp, days)
    jan1 = days_from_civil(ctx.xp, y, ctx.xp.asarray(1), ctx.xp.asarray(1))
    return days - jan1 + 1, an, None


@op("hour")
def op_hour(ctx, expr):
    a, an, _ = eval_expr(ctx, expr.args[0])
    tc = expr.args[0].ft.tclass
    if tc in (TypeClass.DATETIME, TypeClass.TIMESTAMP):
        a = a % MICROS_PER_DAY
    return a // (3600 * MICROS_PER_SEC), an, None


@op("minute")
def op_minute(ctx, expr):
    a, an, _ = eval_expr(ctx, expr.args[0])
    tc = expr.args[0].ft.tclass
    if tc in (TypeClass.DATETIME, TypeClass.TIMESTAMP):
        a = a % MICROS_PER_DAY
    return (a // (60 * MICROS_PER_SEC)) % 60, an, None


@op("second")
def op_second(ctx, expr):
    a, an, _ = eval_expr(ctx, expr.args[0])
    tc = expr.args[0].ft.tclass
    if tc in (TypeClass.DATETIME, TypeClass.TIMESTAMP):
        a = a % MICROS_PER_DAY
    return (a // MICROS_PER_SEC) % 60, an, None


@op("extract")
def op_extract(ctx, expr):
    unit = expr.args[0].value.val
    inner = ScalarFunc({"year": "year", "month": "month", "day": "day",
                        "quarter": "quarter", "hour": "hour",
                        "minute": "minute", "second": "second",
                        "week": "week"}.get(unit, unit),
                       [expr.args[1]], expr.ft)
    return eval_expr(ctx, inner)


@op("date")
def op_date(ctx, expr):
    days, an = _days_of(ctx, expr.args[0])
    return days, an, None


@op("datediff")
def op_datediff(ctx, expr):
    a, an = _days_of(ctx, expr.args[0])
    b, bn = _days_of(ctx, expr.args[1])
    return a - b, or_nulls(ctx.xp, an, bn), None


@op("date_add", "date_sub", "adddate", "subdate")
def op_date_add(ctx, expr):
    """args: [date_expr, IntervalConst]; interval encoded by the planner as
    a Constant whose ft carries the unit in ft.tp ('interval_day' etc.)."""
    neg = expr.op in ("date_sub", "subdate")
    base = expr.args[0]
    iv = expr.args[1]
    unit = iv.ft.tp.replace("interval_", "")
    n_val, n_nulls, _ = eval_expr(ctx, iv)
    xp = ctx.xp
    tc = base.ft.tclass
    if neg:
        n_val = -n_val
    if unit in ("day", "week"):
        delta_days = n_val * (7 if unit == "week" else 1)
        if tc in (TypeClass.DATETIME, TypeClass.TIMESTAMP):
            a, an, _ = eval_expr(ctx, base)
            return a + delta_days * MICROS_PER_DAY, or_nulls(xp, an, n_nulls), None
        days, an = _days_of(ctx, base)
        return days + delta_days, or_nulls(xp, an, n_nulls), None
    if unit in ("hour", "minute", "second", "microsecond"):
        mult = {"hour": 3600 * MICROS_PER_SEC, "minute": 60 * MICROS_PER_SEC,
                "second": MICROS_PER_SEC, "microsecond": 1}[unit]
        a, an, _ = eval_expr(ctx, base)
        if tc == TypeClass.DATE:
            a = a * MICROS_PER_DAY
        return a + n_val * mult, or_nulls(xp, an, n_nulls), None
    if unit in ("month", "quarter", "year"):
        mmul = {"month": 1, "quarter": 3, "year": 12}[unit]
        if tc in (TypeClass.DATETIME, TypeClass.TIMESTAMP):
            a, an, _ = eval_expr(ctx, base)
            days = a // MICROS_PER_DAY
            tod = a % MICROS_PER_DAY
        else:
            days, an = _days_of(ctx, base)
            tod = None
        y, m, d = civil_from_days(xp, days)
        tot = y * 12 + (m - 1) + n_val * mmul
        ny = tot // 12
        nm = tot % 12 + 1
        # clamp day to month length
        nm_days = _days_in_month(xp, ny, nm)
        nd = xp.minimum(d, nm_days)
        r = days_from_civil(xp, ny, nm, nd)
        if tod is not None:
            r = r * MICROS_PER_DAY + tod
        return r, or_nulls(xp, an, n_nulls), None
    raise UnknownFunctionError("unsupported interval unit %s", unit)


def _days_in_month(xp, y, m):
    base = xp.asarray(np.array([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]))
    leap = (y % 4 == 0) & ((y % 100 != 0) | (y % 400 == 0))
    dim = base[m - 1]
    return xp.where((m == 2) & leap, 29, dim)


@op("week")
def op_week(ctx, expr):
    days, an = _days_of(ctx, expr.args[0])
    y, m, d = civil_from_days(ctx.xp, days)
    jan1 = days_from_civil(ctx.xp, y, ctx.xp.asarray(1), ctx.xp.asarray(1))
    return (days - jan1 + ((jan1 + 4) % 7 + 1)) // 7, an, None


@op("unix_timestamp")
def op_unix_ts(ctx, expr):
    a, an, sd = eval_expr(ctx, expr.args[0])
    tc = expr.args[0].ft.tclass
    if tc == TypeClass.DATE:
        return a * 86400, an, None
    if isinstance(a, str) or sd is not None or \
            (hasattr(a, "dtype") and a.dtype == object):
        from ..types.time_types import parse_datetime, parse_date

        def p(s):
            s = str(s)
            # unparseable -> None (NULL), matching MySQL 8.0
            return (parse_date(s) * 86400 if len(s) == 10
                    else parse_datetime(s) // MICROS_PER_SEC)
        return _rowwise(ctx, expr, p, dtype=np.int64)
    return a // MICROS_PER_SEC, an, None


# ---------------- casts ----------------

@op("cast_signed", "cast_unsigned")
def op_cast_int(ctx, expr):
    a, an, sd = eval_expr(ctx, expr.args[0])
    ft = expr.args[0].ft
    xp = ctx.xp
    if sd is not None or (hasattr(a, "dtype") and a.dtype == object) or \
            isinstance(a, str):
        def p(s):
            # MySQL: numeric prefix, rounded (CAST('123.6' AS
            # SIGNED) -> 124)
            v = mysql_str_to_float(s)
            return int(v + 0.5) if v >= 0 else int(v - 0.5)
        return _apply_str_fn(ctx, (a, an, sd), p, out_is_string=False,
                             key=("cast_int",))
    cls = _dataclass_of(ft)
    if cls == "float":
        return xp.asarray(xp.round(a), dtype=np.int64), an, None
    if cls == "decimal":
        return _rescale_down_round(xp, a, _scale_of(ft)), an, None
    return a, an, None


@op("cast_double")
def op_cast_double(ctx, expr):
    a, an, sd = eval_expr(ctx, expr.args[0])
    ft = expr.args[0].ft
    if sd is not None or (hasattr(a, "dtype") and a.dtype == object) or \
            isinstance(a, str):
        data, nulls, _ = _apply_str_fn(ctx, (a, an, sd),
                                       mysql_str_to_float,
                                       out_is_string=False,
                                       out_dtype=np.float64,
                                       key=("str_to_float",))
        return ctx.xp.asarray(data, dtype=ctx.float_dtype), nulls, None
    return _to_float(ctx, a, ft), an, None


@op("cast_decimal")
def op_cast_decimal(ctx, expr):
    a, an, sd = eval_expr(ctx, expr.args[0])
    ft = expr.args[0].ft
    ts = _scale_of(expr.ft)
    xp = ctx.xp
    if sd is not None or (hasattr(a, "dtype") and a.dtype == object) or \
            isinstance(a, str):
        from ..types.decimal import dec_to_scaled_int

        def p(s):
            try:
                return dec_to_scaled_int(s, ts)
            except Exception:
                return 0
        return _apply_str_fn(ctx, (a, an, sd), p, out_is_string=False,
                             key=("cast_decimal", ts))
    cls = _dataclass_of(ft)
    if cls == "decimal":
        k = ts - _scale_of(ft)
        r = _rescale_up(xp, a, k) if k >= 0 else _rescale_down_round(xp, a, -k)
        return r, an, None
    if cls == "float":
        return xp.asarray(xp.round(a * _POW10[ts]), dtype=np.int64), an, None
    return a * _POW10[ts], an, None


@op("cast_char")
def op_cast_char(ctx, expr):
    a, an, sd = eval_expr(ctx, expr.args[0])
    ft = expr.args[0].ft
    if sd is not None or isinstance(a, str) or \
            (hasattr(a, "dtype") and a.dtype == object):
        return a, an, sd
    # numeric -> string: host path only (data-dependent dictionary)
    from ..types.decimal import scaled_int_to_str
    from ..types.time_types import days_to_str, micros_to_str
    cls = _dataclass_of(ft)
    tc = ft.tclass
    scalar_in = np.isscalar(a) or np.ndim(a) == 0
    a_np = np.atleast_1d(np.asarray(a))
    out = np.empty(len(a_np), dtype=object)
    for i, v in enumerate(a_np):
        if tc == TypeClass.DATE:
            out[i] = days_to_str(int(v))
        elif tc in (TypeClass.DATETIME, TypeClass.TIMESTAMP):
            out[i] = micros_to_str(int(v), max(ft.decimal, 0))
        elif cls == "decimal":
            out[i] = scaled_int_to_str(int(v), _scale_of(ft))
        elif cls == "float":
            out[i] = repr(float(v))
        else:
            out[i] = str(int(v))
    if scalar_in:
        return out[0], an, None
    return out, an, None


@op("cast_str_to_date")
def op_cast_str_to_date(ctx, expr):
    from ..types.time_types import parse_date
    av = eval_expr(ctx, expr.args[0])
    if isinstance(av[0], str):
        return parse_date(av[0]), av[1], None
    return _apply_str_fn(ctx, av, parse_date, out_is_string=False,
                         key=("parse_date",))


@op("cast_str_to_datetime", "cast_str_to_time")
def op_cast_str_to_datetime(ctx, expr):
    from ..types.time_types import parse_datetime
    av = eval_expr(ctx, expr.args[0])
    if isinstance(av[0], str):
        return parse_datetime(av[0]), av[1], None
    return _apply_str_fn(ctx, av, parse_datetime, out_is_string=False,
                         key=("parse_datetime",))


@op("cast_date_to_datetime")
def op_cast_date_to_dt(ctx, expr):
    a, an, _ = eval_expr(ctx, expr.args[0])
    return a * MICROS_PER_DAY, an, None


@op("cast_datetime_to_date")
def op_cast_dt_to_date(ctx, expr):
    a, an, _ = eval_expr(ctx, expr.args[0])
    return a // MICROS_PER_DAY, an, None


# ---------------- more math ----------------

@op("pi")
def op_pi(ctx, expr):
    return float(np.pi), None, None


@op("sin", "cos", "tan", "asin", "acos", "atan", "degrees", "radians")
def op_trig(ctx, expr):
    a, an, _ = eval_expr(ctx, expr.args[0])
    f = _to_float(ctx, a, expr.args[0].ft)
    xp = ctx.xp
    fn = {"sin": xp.sin, "cos": xp.cos, "tan": xp.tan, "asin": xp.arcsin,
          "acos": xp.arccos, "atan": xp.arctan, "degrees": xp.degrees,
          "radians": xp.radians}[expr.op]
    return fn(f), an, None


@op("atan2")
def op_atan2(ctx, expr):
    (a, an, _), (b, bn, _) = _binary_vals(ctx, expr)
    fa = _to_float(ctx, a, expr.args[0].ft)
    fb = _to_float(ctx, b, expr.args[1].ft)
    return ctx.xp.arctan2(fa, fb), or_nulls(ctx.xp, an, bn), None


@op("crc32")
def op_crc32(ctx, expr):
    import zlib
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]),
                         lambda s: zlib.crc32(s.encode()) & 0xFFFFFFFF,
                         out_is_string=False, key=("crc32",))


@op("conv")
def op_conv(ctx, expr):
    frm = _const_int(ctx, expr.args[1])
    to = _const_int(ctx, expr.args[2])

    def f(s):
        try:
            v = int(str(s), frm)
        except ValueError:
            return "0"
        if to == 10:
            return str(v)
        digits = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
        out = ""
        n = abs(v)
        while n:
            out = digits[n % to] + out
            n //= to
        return ("-" if v < 0 else "") + (out or "0")
    val = eval_expr(ctx, expr.args[0])
    aft = expr.args[0].ft
    if aft.tclass != TypeClass.STRING:
        # CONV(255, 10, 16): numeric first arg — floats truncate,
        # decimals unscale from their int storage first
        data, nulls, _sd = val
        if aft.tclass == TypeClass.DECIMAL:
            p = _POW10[_scale_of(aft)]
            conv1 = lambda x: f(int(x) // int(p))       # noqa: E731
        else:
            conv1 = lambda x: f(int(x))                  # noqa: E731
        if np.isscalar(data):
            return conv1(data), nulls, None
        out = np.array([conv1(x) for x in np.asarray(data)],
                       dtype=object)
        return out, nulls, None
    return _apply_str_fn(ctx, val, f, key=("conv", frm, to))


# ---------------- more string/byte functions ----------------

@op("hex")
def op_hex(ctx, expr):
    aft = expr.args[0].ft
    if _dataclass_of(aft) == "string":
        return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]),
                             lambda s: s.encode().hex().upper(), key=("hex",))
    a, an, _ = eval_expr(ctx, expr.args[0])
    return _int_to_str_col(ctx, a, an, lambda v: format(int(v), "X"))


def _int_to_str_col(ctx, a, an, fn):
    if np.isscalar(a):
        return fn(a), an, None
    arr = np.asarray(a)
    out = np.empty(len(arr), dtype=object)
    for i, v in enumerate(arr):
        out[i] = fn(v)
    return out, an, None


@op("unhex")
def op_unhex(ctx, expr):
    def f(s):
        try:
            return bytes.fromhex(s).decode("utf-8", "surrogateescape")
        except ValueError:
            return ""
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]), f, key=("unhex",))


@op("bin")
def op_bin(ctx, expr):
    a, an, _ = eval_expr(ctx, expr.args[0])
    return _int_to_str_col(ctx, a, an, lambda v: format(int(v), "b"))


@op("oct")
def op_oct(ctx, expr):
    a, an, _ = eval_expr(ctx, expr.args[0])
    return _int_to_str_col(ctx, a, an, lambda v: format(int(v), "o"))


@op("ascii", "ord")
def op_ascii(ctx, expr):
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]),
                         lambda s: ord(s[0]) if s else 0, out_is_string=False,
                         key=("ascii",))


@op("char")
def op_char(ctx, expr):
    parts = []
    nulls = None
    for a in expr.args:
        v, an, _ = eval_expr(ctx, a)
        parts.append(v)
        nulls = or_nulls(ctx.xp, nulls, an)
    if all(np.isscalar(p) for p in parts):
        return "".join(chr(int(p) & 0xFF) for p in parts), nulls, None
    raise UnknownFunctionError("CHAR over columns unsupported")


@op("repeat")
def op_repeat(ctx, expr):
    n = _const_int(ctx, expr.args[1])
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]),
                         lambda s: s * max(n, 0), key=("repeat", n))


@op("space")
def op_space(ctx, expr):
    n = _const_int(ctx, expr.args[0])
    return " " * max(n, 0), None, None


@op("strcmp")
def op_strcmp(ctx, expr):
    lt = ScalarFunc("<", expr.args, expr.ft)
    gt = ScalarFunc(">", expr.args, expr.ft)
    lv, ln_, _ = eval_expr(ctx, lt)
    gv, gn, _ = eval_expr(ctx, gt)
    xp = ctx.xp
    lv = xp.asarray(lv) if not np.isscalar(lv) else lv
    r = xp.where(lv, -1, xp.where(xp.asarray(gv), 1, 0)) \
        if not np.isscalar(lv) else (-1 if lv else (1 if gv else 0))
    return r, or_nulls(xp, ln_, gn), None


@op("field")
def op_field(ctx, expr):
    target = eval_expr(ctx, expr.args[0])
    xp = ctx.xp
    result = None
    for i, cand in enumerate(expr.args[1:], start=1):
        eq = ScalarFunc("=", [expr.args[0], cand], expr.ft)
        m = eval_bool_mask(ctx, eq)
        pos = ctx.full(i, dtype=np.int64)
        if result is None:
            result = xp.where(m, pos, 0)
        else:
            result = xp.where((result == 0) & m, pos, result)
    return (result if result is not None else 0), None, None


@op("elt")
def op_elt(ctx, expr):
    idx = _const_int(ctx, expr.args[0])
    if 1 <= idx < len(expr.args):
        return eval_expr(ctx, expr.args[idx])
    return 0, True, None


@op("md5")
def op_md5(ctx, expr):
    import hashlib
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]),
                         lambda s: hashlib.md5(s.encode()).hexdigest(),
                         key=("md5",))


@op("sha1", "sha")
def op_sha1(ctx, expr):
    import hashlib
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]),
                         lambda s: hashlib.sha1(s.encode()).hexdigest(),
                         key=("sha1",))


@op("format")
def op_format(ctx, expr):
    d = _const_int(ctx, expr.args[1]) if len(expr.args) > 1 else 0
    a, an, sd = eval_expr(ctx, expr.args[0])
    ft = expr.args[0].ft
    if _dataclass_of(ft) == "decimal":
        s = _scale_of(ft)

        def f(v):
            x = int(v) / _POW10[s]
            return f"{x:,.{max(d, 0)}f}"
        return _int_to_str_col(ctx, a, an, f)
    return _int_to_str_col(ctx, a, an,
                           lambda v: f"{float(v):,.{max(d, 0)}f}")




# ---------------- JSON (host/dict-table; stored as strings) -------------

def _json_path_get(doc, path):
    import json as _json
    try:
        obj = _json.loads(doc)
    except Exception:
        return None
    if not path.startswith("$"):
        return None
    cur = obj
    import re as _re
    for part in _re.findall(r"\.([A-Za-z_][A-Za-z0-9_]*)|\[(\d+)\]",
                            path[1:]):
        name, idx = part
        try:
            if name:
                cur = cur[name]
            else:
                cur = cur[int(idx)]
        except (KeyError, IndexError, TypeError):
            return None
    return cur


@op("json_extract")
def op_json_extract(ctx, expr):
    import json as _json
    path = _as_str_scalar(eval_expr(ctx, expr.args[1]))
    if path is None:
        raise UnknownFunctionError("non-constant JSON path unsupported")

    def f(s):
        v = _json_path_get(str(s), path)   # numbers are JSON scalars
        return "" if v is None else _json.dumps(v)
    val = _to_str_val(ctx, eval_expr(ctx, expr.args[0]),
                      expr.args[0].ft)
    data, nulls, sd = _apply_str_fn(ctx, val, f, key=("json_extract", path))
    return data, nulls, sd


@op("json_unquote")
def op_json_unquote(ctx, expr):
    def f(s):
        if len(s) >= 2 and s[0] == '"' and s[-1] == '"':
            import json as _json
            try:
                return str(_json.loads(s))
            except Exception:
                return s
        return s
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]), f,
                         key=("json_unquote",))


@op("json_valid")
def op_json_valid(ctx, expr):
    import json as _json

    def f(s):
        try:
            _json.loads(s)
            return 1
        except Exception:
            return 0
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]), f,
                         out_is_string=False, key=("json_valid",))


@op("json_length")
def op_json_length(ctx, expr):
    import json as _json

    def f(s):
        try:
            v = _json.loads(s)
        except Exception:
            return 0
        return len(v) if isinstance(v, (list, dict)) else 1
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]), f,
                         out_is_string=False, key=("json_length",))


# ---------------- VECTOR (reference pkg/types VectorFloat32 +
# expression builtin_vec.go — TiDB VECTOR columns; text-stored like JSON,
# dictionary-deduplicated; distance kernels run vectorized over the
# stacked (distinct x dim) float32 matrix and gather per row) ------------

def vec_text_normalize(s: str, dim: int | None = None,
                       col_name: str = "") -> str:
    """Parse + canonicalize '[1,2,3]'; enforce declared dimension.
    Errors are the conformance-pinned vector ER codes (errors.py):
    malformed text -> 6138, dimension clash -> 6139."""
    import json as _json
    from ..errors import VectorConversionError, VectorDimensionError
    from ..types.field_type import VECTOR_MAX_DIM
    try:
        v = _json.loads(s)
        arr = np.asarray(v, dtype=np.float32)
        assert arr.ndim == 1
        assert np.isfinite(arr).all()
    except Exception:
        raise VectorConversionError(
            "Data cannot be converted to a valid vector: '%s'", s[:64])
    if len(arr) > VECTOR_MAX_DIM:
        raise VectorDimensionError(
            "vector has %d dimensions, exceeding the limit %d",
            len(arr), VECTOR_MAX_DIM)
    if dim and len(arr) != dim:
        raise VectorDimensionError(
            "vector has %d dimensions, expected %d for column '%s'",
            len(arr), dim, col_name)
    return "[" + ",".join(_fmt_vec_f(x) for x in arr.tolist()) + "]"


def _fmt_vec_f(x: float) -> str:
    return str(int(x)) if x == int(x) else repr(x)


def _parse_vec_text(s: str):
    import json as _json
    try:
        return np.asarray(_json.loads(s), dtype=np.float32)
    except Exception:
        return None


def _vec_matrix(sdict):
    """(distinct x dim) float32 matrix for a dict column, cached per dict
    length (dicts are append-only). Invalid/ragged rows -> NaN rows."""
    cache = getattr(sdict, "_vec_cache", None)
    u = len(sdict.values)
    if cache is not None and cache[0] == u:
        return cache[1]
    col = getattr(sdict, "_vecmat_cache", None)
    if u and col is not None and col[1] == u and col[3] == col[2]:
        # the column's parsed table (storage/columnar.py), whose longest
        # value has its declared dimension: the same matrix, so a
        # million-vector dictionary is not parsed a second time
        sdict._vec_cache = (u, col[0])
        return col[0]
    vecs = [_parse_vec_text(s) for s in sdict.values]
    d = max((len(v) for v in vecs if v is not None), default=0)
    mat = np.full((max(u, 1), max(d, 1)), np.nan, dtype=np.float32)
    for i, v in enumerate(vecs):
        if v is not None and len(v) == d:
            mat[i, :len(v)] = v
    sdict._vec_cache = (u, mat)
    return mat


def _vec_dim_of(expr_arg, parsed=None):
    """Definite dimension of a distance operand: a parsed constant's
    length, or a VECTOR(k) column's declared k. None = unknown
    (free-text vector column without a declared dimension)."""
    if parsed is not None:
        return len(parsed)
    ft = getattr(expr_arg, "ft", None)
    if ft is not None and getattr(ft, "is_vector", False) and ft.flen > 0:
        return ft.flen
    return None


def _vec_check_dims(expr, va=None, vb=None):
    """Mismatched DEFINITE dimensions are a statement error (the
    conformance-pinned ER 6139), matching the reference: a declared
    VECTOR(3) column against a 4-dim query must fail cleanly, never
    silently NULL. Unknown dims keep the legacy NULL semantics."""
    da = _vec_dim_of(expr.args[0], va)
    db = _vec_dim_of(expr.args[1], vb)
    if da is not None and db is not None and da != db:
        from ..errors import VectorDimensionError
        raise VectorDimensionError(
            "vectors have different dimensions: %d and %d", da, db)


def _vec_binary(ctx, expr, kernel):
    """Distance between a vector column and a constant (either side), two
    constants, or two columns. kernel(M (u,d), q (d,)) -> float64 (u,)."""
    a = eval_expr(ctx, expr.args[0])
    b = eval_expr(ctx, expr.args[1])
    qa, qb = _as_str_scalar(a), _as_str_scalar(b)
    if qa is not None and qb is not None:
        va, vb = _parse_vec_text(qa), _parse_vec_text(qb)
        _vec_check_dims(expr, va, vb)
        if va is None or vb is None or len(va) != len(vb):
            return 0.0, True, None
        r = float(kernel(va.reshape(1, -1), vb)[0])
        return r, bool(np.isnan(r)), None
    if qa is not None or qb is not None:
        q = _parse_vec_text(qa if qa is not None else qb)
        _vec_check_dims(expr, va=q if qa is not None else None,
                        vb=q if qb is not None else None)
        col = b if qa is not None else a
        data, nulls, sd = col
        if q is None:
            return np.zeros(ctx.n), np.ones(ctx.n, dtype=bool), None
        if sd is not None:
            mat = _vec_matrix(sd)
            codes = np.asarray(data)
            if mat.shape[1] != len(q):
                vals = np.full(len(codes), np.nan)
            elif 4 * len(codes) < len(mat):
                # a few rows of a large dictionary (the vector search's
                # re-rank): the row-wise kernel over their codes only
                uc, inv = np.unique(codes, return_inverse=True)
                vals = kernel(mat[uc], q)[inv.reshape(-1)]
            else:
                vals = kernel(mat, q)[codes]
            nm = np.asarray(materialize_nulls(ctx, nulls))
            return np.nan_to_num(vals), nm | np.isnan(vals), None
        # host object array of strings
        out = np.zeros(ctx.n)
        bad = np.zeros(ctx.n, dtype=bool)
        for i, txt in enumerate(np.asarray(data)):
            v = _parse_vec_text(txt) if txt is not None else None
            if v is None or len(v) != len(q):
                bad[i] = True
            else:
                out[i] = float(kernel(v.reshape(1, -1), q)[0])
        nm = np.asarray(materialize_nulls(ctx, nulls))
        return out, nm | bad, None
    # column vs column: row-wise
    _vec_check_dims(expr)
    da, na, sda = a
    db_, nb, sdb = b

    def row_text(col, i):
        data, _n, sd = col
        c = np.asarray(data)[i]
        return sd.values[int(c)] if sd is not None else c
    out = np.zeros(ctx.n)
    bad = np.zeros(ctx.n, dtype=bool)
    for i in range(ctx.n):
        va = _parse_vec_text(row_text(a, i))
        vb = _parse_vec_text(row_text(b, i))
        if va is None or vb is None or len(va) != len(vb):
            bad[i] = True
        else:
            out[i] = float(kernel(va.reshape(1, -1), vb)[0])
    nm = np.asarray(materialize_nulls(ctx, na)) | \
        np.asarray(materialize_nulls(ctx, nb))
    return out, nm | bad, None


@op("vec_cosine_distance")
def op_vec_cos(ctx, expr):
    def kernel(M, q):
        num = M.astype(np.float64) @ q.astype(np.float64)
        den = np.linalg.norm(M.astype(np.float64), axis=1) * \
            np.linalg.norm(q.astype(np.float64))
        with np.errstate(divide="ignore", invalid="ignore"):
            return 1.0 - num / den     # zero vector -> NaN -> NULL
    return _vec_binary(ctx, expr, kernel)


@op("vec_l2_distance")
def op_vec_l2(ctx, expr):
    def kernel(M, q):
        d = M.astype(np.float64) - q.astype(np.float64)
        return np.sqrt((d * d).sum(axis=1))
    return _vec_binary(ctx, expr, kernel)


@op("vec_l1_distance")
def op_vec_l1(ctx, expr):
    def kernel(M, q):
        return np.abs(M.astype(np.float64) -
                      q.astype(np.float64)).sum(axis=1)
    return _vec_binary(ctx, expr, kernel)


@op("vec_negative_inner_product")
def op_vec_nip(ctx, expr):
    def kernel(M, q):
        return -(M.astype(np.float64) @ q.astype(np.float64))
    return _vec_binary(ctx, expr, kernel)


@op("vec_inner_product")
def op_vec_ip(ctx, expr):
    def kernel(M, q):
        return M.astype(np.float64) @ q.astype(np.float64)
    return _vec_binary(ctx, expr, kernel)


@op("vec_dims")
def op_vec_dims(ctx, expr):
    def f(s):
        v = _parse_vec_text(s)
        return len(v) if v is not None else 0
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]), f,
                         out_is_string=False, key=("vec_dims",))


@op("vec_l2_norm")
def op_vec_l2_norm(ctx, expr):
    a = eval_expr(ctx, expr.args[0])
    data, nulls, sd = a
    if sd is not None:
        mat = _vec_matrix(sd).astype(np.float64)
        tab = np.sqrt((mat * mat).sum(axis=1))
        vals = tab[np.asarray(data)]
        nm = np.asarray(materialize_nulls(ctx, nulls))
        return np.nan_to_num(vals), nm | np.isnan(vals), None

    def f(s):
        v = _parse_vec_text(s)
        return float(np.linalg.norm(v)) if v is not None else 0.0
    out = _string_elementwise(ctx, np.asarray(data), f, dtype=np.float64)
    return out, nulls, None


@op("vec_from_text")
def op_vec_from_text(ctx, expr):
    def f(s):
        return vec_text_normalize(s)
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]), f,
                         key=("vec_from_text",))


@op("vec_as_text")
def op_vec_as_text(ctx, expr):
    return eval_expr(ctx, expr.args[0])


# ---------------- builtin long tail (reference pkg/expression
# builtin_string.go / builtin_time.go / builtin_math.go /
# builtin_miscellaneous.go / builtin_json.go) ----------------------------

def _rows_as_str(ctx, val):
    """Materialize a string value to (object array | scalar str, nulls)."""
    data, nulls, sd = val
    if isinstance(data, str):
        return data, nulls
    if sd is not None:
        return sd.decode(np.asarray(data).astype(np.int64)), nulls
    return np.asarray(data), nulls


def _rowwise(ctx, expr, fn, dtype=object, null_ok=False,
             str_args=False, typed_args=False):
    """Evaluate all args, apply python fn per row on host (tail funcs that
    mix strings and numbers; device offload not worth a kernel).
    null_ok: NULL args reach fn as None instead of nulling the row
    (JSON constructors, QUOTE); the row is NULL only if fn returns
    None. str_args: numeric/temporal args arrive as their MySQL
    string forms (never raw storage ints); typed_args: decimals ->
    floats, temporals -> strings, unsigned reinterpreted (JSON
    value semantics)."""
    vals = [eval_expr(ctx, a) for a in expr.args]
    if str_args:
        vals = [_to_str_val(ctx, v, a.ft)
                for v, a in zip(vals, expr.args)]
    elif typed_args:
        vals = [_typed_py_val(ctx, v, a.ft)
                for v, a in zip(vals, expr.args)]
    mats = []
    arg_nulls = []
    nmask = np.zeros(ctx.n, dtype=bool)
    for (d, nl, sd), a in zip(vals, expr.args):
        if sd is not None:
            mats.append(sd.decode(np.asarray(d).astype(np.int64)))
        elif isinstance(d, (str, int, float)) or d is None:
            mats.append(np.full(ctx.n, d, dtype=object))
        else:
            mats.append(np.asarray(d))
        anm = np.asarray(materialize_nulls(ctx, nl))
        arg_nulls.append(anm)
        nmask |= anm
    out = np.empty(ctx.n, dtype=dtype)
    bad = np.zeros(ctx.n, dtype=bool)
    fill = "" if dtype == object else 0
    for i in range(ctx.n):
        if nmask[i] and not null_ok:
            out[i] = fill
            continue
        try:
            if null_ok:
                r = fn(*(None if arg_nulls[j][i] else mats[j][i]
                         for j in range(len(mats))))
            else:
                r = fn(*(m[i] for m in mats))
        except Exception:               # noqa: BLE001
            r = None
        if r is None:
            bad[i] = True
            out[i] = fill
        else:
            out[i] = r
    nulls = bad if null_ok else (nmask | bad)
    return out, nulls, None


@op("find_in_set")
def op_find_in_set(ctx, expr):
    def f(s, lst):
        parts = str(lst).split(",") if lst != "" else []
        return parts.index(str(s)) + 1 if str(s) in parts else 0
    return _rowwise(ctx, expr, f, dtype=np.int64)


@op("substring_index")
def op_substring_index(ctx, expr):
    def f(s, delim, cnt):
        s, delim, cnt = str(s), str(delim), int(cnt)
        if not delim:
            return ""
        parts = s.split(delim)
        if cnt > 0:
            return delim.join(parts[:cnt])
        if cnt < 0:
            return delim.join(parts[cnt:])
        return ""
    return _rowwise(ctx, expr, f)


@op("insert")
def op_insert_str(ctx, expr):
    def f(s, pos, ln, new):
        s, pos, ln = str(s), int(pos), int(ln)
        if pos < 1 or pos > len(s):
            return s
        return s[:pos - 1] + str(new) + s[pos - 1 + max(ln, 0):]
    return _rowwise(ctx, expr, f)


@op("quote")
def op_quote(ctx, expr):
    def q(s):
        s = str(s).replace("\\", "\\\\").replace("'", "\\'") \
            .replace("\0", "\\0").replace("\x1a", "\\Z")
        return "'" + s + "'"
    val = _to_str_val(ctx, eval_expr(ctx, expr.args[0]),
                      expr.args[0].ft)
    nl = val[1]
    has_null = nl is True or (
        nl is not None and nl is not False and
        bool(np.asarray(materialize_nulls(ctx, nl)).any()))
    if not has_null:
        # fast path: dict columns transform O(distinct), not O(rows)
        return _apply_str_fn(ctx, val, q, key=("quote",))
    return _rowwise(ctx, expr,
                    lambda s: "NULL" if s is None else q(s),
                    null_ok=True, str_args=True)


@op("soundex")
def op_soundex(ctx, expr):
    _SDX = {**{c: d for cs, d in (("BFPV", "1"), ("CGJKQSXZ", "2"),
                                  ("DT", "3"), ("L", "4"), ("MN", "5"),
                                  ("R", "6")) for c in cs}}

    def f(s):
        s = "".join(c for c in str(s).upper() if c.isalpha())
        if not s:
            return ""
        out = s[0]
        prev = _SDX.get(s[0], "")
        for c in s[1:]:
            d = _SDX.get(c, "")
            if d and d != prev:
                out += d
            prev = d
        return (out + "000")[:4]
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]), f,
                         key=("soundex",))


@op("to_base64")
def op_to_base64(ctx, expr):
    import base64

    def f(s):
        return base64.b64encode(str(s).encode()).decode()
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]), f,
                         key=("to_base64",))


@op("from_base64")
def op_from_base64(ctx, expr):
    import base64

    def f(s):
        try:
            return base64.b64decode(str(s)).decode("utf-8", "replace")
        except Exception:               # noqa: BLE001
            return ""
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]), f,
                         key=("from_base64",))


@op("sha2")
def op_sha2(ctx, expr):
    import hashlib
    bits_c = eval_expr(ctx, expr.args[1])[0]
    bits = int(bits_c) if np.isscalar(bits_c) else 256
    algo = {0: "sha256", 224: "sha224", 256: "sha256", 384: "sha384",
            512: "sha512"}.get(bits)

    def f(s):
        if algo is None:
            return ""
        return getattr(hashlib, algo)(str(s).encode()).hexdigest()
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]), f,
                         key=("sha2", algo))


@op("cot")
def op_cot(ctx, expr):
    a, an, _ = eval_expr(ctx, expr.args[0])
    t = ctx.xp.tan(_to_float(ctx, a, expr.args[0].ft))
    return 1.0 / t, an, None


@op("bit_count")
def op_bit_count(ctx, expr):
    a, an, _ = eval_expr(ctx, expr.args[0])
    xp = ctx.xp
    # on the device uint64 rides as int64 bits: every shift below is
    # masked or of a non-negative value, so it is the logical shift
    v = _astype(xp, xp.asarray(a), xp.uint64)
    # SWAR popcount (device-safe: no loops, pure vector arithmetic)
    m1 = xp.uint64(0x5555555555555555)
    m2 = xp.uint64(0x3333333333333333)
    m4 = xp.uint64(0x0F0F0F0F0F0F0F0F)
    v = v - ((v >> xp.uint64(1)) & m1)
    v = (v & m2) + ((v >> xp.uint64(2)) & m2)
    v = (v + (v >> xp.uint64(4))) & m4
    # horizontal byte sum via shift-adds: the classic `v * 0x0101..01`
    # multiply wraps uint64 by design, which numpy reports as an
    # overflow warning on the host path — shift-adds sum the same bytes
    # warning-free on both backends
    v = v + (v >> xp.uint64(8))
    v = v + (v >> xp.uint64(16))
    v = v + (v >> xp.uint64(32))
    return _astype(xp, v & xp.uint64(0x7F), xp.int64), an, None


@op("interval")
def op_interval(ctx, expr):
    n, nn, _ = eval_expr(ctx, expr.args[0])
    xp = ctx.xp
    out = xp.zeros(ctx.n, dtype=xp.int64) if not np.isscalar(n) \
        else np.int64(0)
    for a in expr.args[1:]:
        v, vn, _ = eval_expr(ctx, a)
        out = out + _astype(xp, xp.asarray(n) >= xp.asarray(v), xp.int64)
    return out, nn, None


@op("inet_aton")
def op_inet_aton(ctx, expr):
    def f(s):
        parts = str(s).split(".")
        if not 1 <= len(parts) <= 4 or \
                not all(p.isdigit() and int(p) < 256 for p in parts):
            return None
        v = 0
        for p in parts[:-1]:
            v = (v << 8) | int(p)
        v = (v << (8 * (4 - len(parts) + 1))) | int(parts[-1]) \
            if len(parts) < 4 else (v << 8) | int(parts[-1])
        return v
    return _rowwise(ctx, expr, f, dtype=np.int64)


@op("inet_ntoa")
def op_inet_ntoa(ctx, expr):
    def f(v):
        v = int(v)
        if not 0 <= v <= 0xFFFFFFFF:
            return None
        return ".".join(str((v >> s) & 0xFF) for s in (24, 16, 8, 0))
    return _rowwise(ctx, expr, f)


@op("is_ipv4")
def op_is_ipv4(ctx, expr):
    def f(s):
        parts = str(s).split(".")
        return 1 if len(parts) == 4 and all(
            p.isdigit() and p and int(p) < 256 for p in parts) else 0
    return _rowwise(ctx, expr, f, dtype=np.int64)


@op("is_ipv6")
def op_is_ipv6(ctx, expr):
    import ipaddress

    def f(s):
        try:
            ipaddress.IPv6Address(str(s))
            return 1
        except Exception:               # noqa: BLE001
            return 0
    return _rowwise(ctx, expr, f, dtype=np.int64)


@op("make_set")
def op_make_set(ctx, expr):
    def f(bits, *items):
        bits = int(bits)
        return ",".join(str(it) for i, it in enumerate(items)
                        if it is not None and bits & (1 << i))
    return _rowwise(ctx, expr, f)


@op("export_set")
def op_export_set(ctx, expr):
    def f(bits, on, off, *rest):
        sep = str(rest[0]) if len(rest) >= 1 else ","
        nbits = int(rest[1]) if len(rest) >= 2 else 64
        bits = int(bits)
        return sep.join(str(on) if bits & (1 << i) else str(off)
                        for i in range(min(nbits, 64)))
    return _rowwise(ctx, expr, f)


# ---- temporal tail ----

_MONTH_NAMES = ["January", "February", "March", "April", "May", "June",
                "July", "August", "September", "October", "November",
                "December"]
_DAY_NAMES = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
              "Saturday", "Sunday"]


def _format_datetime_py(micros, fmt):
    from ..types.time_types import days_to_ymd
    micros = int(micros)
    days, rem = divmod(micros, MICROS_PER_DAY)
    y, mo, d = days_to_ymd(days)
    sec, us = divmod(rem, 1_000_000)
    hh, rs = divmod(sec, 3600)
    mi, ss = divmod(rs, 60)
    wd = (days + 3) % 7                  # 0=Monday
    out = []
    i = 0
    while i < len(fmt):
        c = fmt[i]
        if c != "%" or i + 1 >= len(fmt):
            out.append(c)
            i += 1
            continue
        sp = fmt[i + 1]
        i += 2
        if sp == "Y":
            out.append("%04d" % y)
        elif sp == "y":
            out.append("%02d" % (y % 100))
        elif sp == "m":
            out.append("%02d" % mo)
        elif sp == "c":
            out.append(str(mo))
        elif sp == "M":
            out.append(_MONTH_NAMES[mo - 1])
        elif sp == "b":
            out.append(_MONTH_NAMES[mo - 1][:3])
        elif sp == "d":
            out.append("%02d" % d)
        elif sp == "e":
            out.append(str(d))
        elif sp == "H":
            out.append("%02d" % hh)
        elif sp == "k":
            out.append(str(hh))
        elif sp in ("h", "I"):
            out.append("%02d" % (hh % 12 or 12))
        elif sp == "l":
            out.append(str(hh % 12 or 12))
        elif sp == "i":
            out.append("%02d" % mi)
        elif sp in ("S", "s"):
            out.append("%02d" % ss)
        elif sp == "f":
            out.append("%06d" % us)
        elif sp == "p":
            out.append("AM" if hh < 12 else "PM")
        elif sp == "W":
            out.append(_DAY_NAMES[wd])
        elif sp == "a":
            out.append(_DAY_NAMES[wd][:3])
        elif sp == "w":
            out.append(str((wd + 1) % 7))
        elif sp == "j":
            from ..types.time_types import ymd_to_days
            out.append("%03d" % (days - ymd_to_days(y, 1, 1) + 1))
        elif sp == "T":
            out.append("%02d:%02d:%02d" % (hh, mi, ss))
        elif sp == "D":
            sfx = "th" if 11 <= d % 100 <= 13 else \
                {1: "st", 2: "nd", 3: "rd"}.get(d % 10, "th")
            out.append("%d%s" % (d, sfx))
        else:
            out.append(sp)
    return "".join(out)


def _arg_micros(ctx, expr_arg):
    """Temporal arg -> (micros int64, nulls)."""
    a, an, sd = eval_expr(ctx, expr_arg)
    tc = expr_arg.ft.tclass
    if sd is not None or isinstance(a, str) or \
            (hasattr(a, "dtype") and a.dtype == object):
        from ..types.time_types import parse_datetime
        r = _apply_str_fn(ctx, (a, an, sd), parse_datetime,
                          out_is_string=False, key=("parse_datetime",))
        return r[0], r[1]
    if tc == TypeClass.DATE:
        return a * MICROS_PER_DAY, an
    return a, an


@op("date_format")
def op_date_format(ctx, expr):
    fmt = _as_str_scalar(eval_expr(ctx, expr.args[1]))
    if fmt is None:
        raise UnknownFunctionError("non-constant DATE_FORMAT format")
    micros, an = _arg_micros(ctx, expr.args[0])
    if np.isscalar(micros) or getattr(micros, "ndim", 1) == 0:
        return _format_datetime_py(int(micros), fmt), an, None
    arr = np.asarray(micros)
    out = np.empty(len(arr), dtype=object)
    for i, us in enumerate(arr):
        out[i] = _format_datetime_py(us, fmt)
    return out, an, None


@op("str_to_date")
def op_str_to_date(ctx, expr):
    fmt = _as_str_scalar(eval_expr(ctx, expr.args[1]))
    if fmt is None:
        raise UnknownFunctionError("non-constant STR_TO_DATE format")
    import re as _re
    pat, fields = "", []
    i = 0
    while i < len(fmt):
        c = fmt[i]
        if c == "%" and i + 1 < len(fmt):
            sp = fmt[i + 1]
            i += 2
            grp = {"Y": r"(\d{4})", "y": r"(\d{1,2})", "m": r"(\d{1,2})",
                   "c": r"(\d{1,2})", "d": r"(\d{1,2})", "e": r"(\d{1,2})",
                   "H": r"(\d{1,2})", "k": r"(\d{1,2})", "i": r"(\d{1,2})",
                   "s": r"(\d{1,2})", "S": r"(\d{1,2})"}.get(sp)
            if grp is None:
                pat += _re.escape("%" + sp)
            else:
                pat += grp
                fields.append(sp)
        else:
            pat += _re.escape(c)
            i += 1

    def f(s):
        m = _re.match(pat + r"\s*$", str(s))
        if m is None:
            return None
        vals = {"Y": 0, "m": 1, "d": 1, "H": 0, "i": 0, "s": 0}
        for sp, g in zip(fields, m.groups()):
            key = {"y": "Y", "c": "m", "e": "d", "k": "H", "S": "s"}.get(
                sp, sp)
            v = int(g)
            if sp == "y":
                v += 2000 if v < 70 else 1900
            vals[key] = v
        from ..types.time_types import ymd_to_days
        try:
            days = ymd_to_days(vals["Y"], vals["m"], vals["d"])
        except Exception:               # noqa: BLE001
            return None
        if expr.ft.tclass == TypeClass.DATE:
            # date-only format: the result TYPE is DATE (days encoding)
            return days
        return days * MICROS_PER_DAY + \
            (vals["H"] * 3600 + vals["i"] * 60 + vals["s"]) * 1_000_000
    out, nulls, _sd = _rowwise(
        ctx, type("E", (), {"args": [expr.args[0]]})(), f, dtype=np.int64)
    return out, nulls, None


@op("dayname")
def op_dayname(ctx, expr):
    days, an = _days_of(ctx, expr.args[0])
    arr = np.atleast_1d(np.asarray(days)).astype(np.int64)
    tab = np.array(_DAY_NAMES, dtype=object)
    out = tab[(arr + 3) % 7]
    return (out if np.ndim(days) else str(out[0])), an, None


@op("monthname")
def op_monthname(ctx, expr):
    days, an = _days_of(ctx, expr.args[0])
    y, m, d = civil_from_days(
        np, np.atleast_1d(np.asarray(days)).astype(np.int64))
    tab = np.array(_MONTH_NAMES, dtype=object)
    out = tab[np.asarray(m) - 1]
    return (out if np.ndim(days) else str(out[0])), an, None


@op("last_day")
def op_last_day(ctx, expr):
    days, an = _days_of(ctx, expr.args[0])
    xp = ctx.xp
    y, m, d = civil_from_days(xp, days)
    ny = xp.where(m == 12, y + 1, y)
    nm = xp.where(m == 12, 1, m + 1)
    return days_from_civil(xp, ny, nm, xp.asarray(1)) - 1, an, None


@op("to_days")
def op_to_days(ctx, expr):
    days, an = _days_of(ctx, expr.args[0])
    return days + 719528, an, None


@op("from_days")
def op_from_days(ctx, expr):
    a, an, _ = eval_expr(ctx, expr.args[0])
    return a - 719528, an, None


@op("from_unixtime")
def op_from_unixtime(ctx, expr):
    a, an, _ = eval_expr(ctx, expr.args[0])
    micros = (ctx.xp.asarray(a).astype(ctx.xp.float64) *
              1_000_000).astype(ctx.xp.int64) if not np.isscalar(a) \
        else np.int64(float(a) * 1_000_000)
    if len(expr.args) > 1:
        fmt = _as_str_scalar(eval_expr(ctx, expr.args[1]))
        arr = np.atleast_1d(np.asarray(micros))
        out = np.empty(len(arr), dtype=object)
        for i, us in enumerate(arr):
            out[i] = _format_datetime_py(us, fmt)
        return (out if not np.isscalar(a) else out[0]), an, None
    return micros, an, None


@op("microsecond")
def op_microsecond(ctx, expr):
    micros, an = _arg_micros(ctx, expr.args[0])
    return micros % 1_000_000, an, None


@op("yearweek")
def op_yearweek(ctx, expr):
    days, an = _days_of(ctx, expr.args[0])
    xp = ctx.xp
    y, m, d = civil_from_days(xp, days)
    jan1 = days_from_civil(xp, y, xp.asarray(1), xp.asarray(1))
    wk = (days - jan1 + ((jan1 + 4) % 7 + 1)) // 7
    y = xp.where(wk == 0, y - 1, y)
    wk = xp.where(wk == 0, 52, wk)       # roll into prior year (mode 0)
    return y * 100 + wk, an, None


_TSD_UNITS = {"second": 1_000_000, "minute": 60_000_000,
              "hour": 3_600_000_000, "day": MICROS_PER_DAY,
              "week": 7 * MICROS_PER_DAY}


@op("timestampdiff")
def op_timestampdiff(ctx, expr):
    unit = expr.args[0].value.val if hasattr(expr.args[0], "value") else ""
    unit = str(unit).lower()
    a, an = _arg_micros(ctx, expr.args[1])
    b, bn = _arg_micros(ctx, expr.args[2])
    xp = ctx.xp
    nulls = or_nulls(xp, an, bn)
    if unit in _TSD_UNITS:
        return (xp.asarray(b) - xp.asarray(a)) // _TSD_UNITS[unit], \
            nulls, None
    ya, ma, da = civil_from_days(xp, xp.asarray(a) // MICROS_PER_DAY)
    yb, mb, db_ = civil_from_days(xp, xp.asarray(b) // MICROS_PER_DAY)
    months = (yb * 12 + mb) - (ya * 12 + ma)
    # not a full month if b's day-of-month/time is earlier than a's
    ta = xp.asarray(a) % MICROS_PER_DAY + da * MICROS_PER_DAY
    tb = xp.asarray(b) % MICROS_PER_DAY + db_ * MICROS_PER_DAY
    months = months - _astype(xp, (months > 0) & (tb < ta), np.int64) + \
        _astype(xp, (months < 0) & (tb > ta), np.int64)
    if unit == "month":
        return months, nulls, None
    if unit == "quarter":
        return months // 3, nulls, None
    if unit == "year":
        return months // 12, nulls, None
    raise UnknownFunctionError("TIMESTAMPDIFF unit %s", unit)


@op("period_add")
def op_period_add(ctx, expr):
    p, pn, _ = eval_expr(ctx, expr.args[0])
    n, nn, _ = eval_expr(ctx, expr.args[1])
    xp = ctx.xp
    months = (p // 100) * 12 + (p % 100) - 1 + n
    return (months // 12) * 100 + months % 12 + 1, \
        or_nulls(xp, pn, nn), None


@op("period_diff")
def op_period_diff(ctx, expr):
    a, an, _ = eval_expr(ctx, expr.args[0])
    b, bn, _ = eval_expr(ctx, expr.args[1])
    ma = (a // 100) * 12 + a % 100
    mb = (b // 100) * 12 + b % 100
    return ma - mb, or_nulls(ctx.xp, an, bn), None


@op("time_to_sec")
def op_time_to_sec(ctx, expr):
    def f(s):
        s = str(s)
        neg = s.startswith("-")
        parts = s.lstrip("-").split(":")
        try:
            parts = [float(p) for p in parts]
        except ValueError:
            return 0
        while len(parts) < 3:
            parts.insert(0, 0.0)
        sec = int(parts[0] * 3600 + parts[1] * 60 + parts[2])
        return -sec if neg else sec
    return _rowwise(ctx, expr, f, dtype=np.int64)


@op("sec_to_time")
def op_sec_to_time(ctx, expr):
    def f(v):
        v = int(v)
        sign = "-" if v < 0 else ""
        v = abs(v)
        return "%s%02d:%02d:%02d" % (sign, v // 3600, v // 60 % 60, v % 60)
    return _rowwise(ctx, expr, f)


@op("maketime")
def op_maketime(ctx, expr):
    def f(h, m, s):
        return "%02d:%02d:%02d" % (int(h), int(m), int(float(s)))
    return _rowwise(ctx, expr, f)


@op("makedate")
def op_makedate(ctx, expr):
    y, yn, _ = eval_expr(ctx, expr.args[0])
    n, nn, _ = eval_expr(ctx, expr.args[1])
    xp = ctx.xp
    base = days_from_civil(xp, xp.asarray(y), xp.asarray(1), xp.asarray(1))
    out = base + xp.asarray(n) - 1
    return out, or_nulls(xp, yn, nn, xp.asarray(n) < 1), None


# ---- JSON tail ----

def _json_load(s):
    import json as _json
    try:
        return _json.loads(s)
    except Exception:               # noqa: BLE001
        return None


@op("json_type")
def op_json_type(ctx, expr):
    def f(s):
        v = _json_load(s)
        if isinstance(v, bool):
            return "BOOLEAN"
        if v is None and str(s).strip() == "null":
            return "NULL"
        if isinstance(v, dict):
            return "OBJECT"
        if isinstance(v, list):
            return "ARRAY"
        if isinstance(v, int):
            return "INTEGER"
        if isinstance(v, float):
            return "DOUBLE"
        if isinstance(v, str):
            return "STRING"
        return "UNKNOWN"
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]), f,
                         key=("json_type",))


@op("json_keys")
def op_json_keys(ctx, expr):
    import json as _json

    def f(s):
        v = _json_load(s)
        return _json.dumps(list(v.keys())) if isinstance(v, dict) else ""
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]), f,
                         key=("json_keys",))


@op("json_depth")
def op_json_depth(ctx, expr):
    def depth(v):
        if isinstance(v, dict):
            return 1 + max((depth(x) for x in v.values()), default=0)
        if isinstance(v, list):
            return 1 + max((depth(x) for x in v), default=0)
        return 1

    def f(s):
        v = _json_load(s)
        return depth(v) if v is not None or str(s).strip() == "null" else 0
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]), f,
                         out_is_string=False, key=("json_depth",))


@op("json_contains")
def op_json_contains(ctx, expr):
    cand_txt = _as_str_scalar(eval_expr(ctx, expr.args[1]))
    if cand_txt is None:
        raise UnknownFunctionError("non-constant JSON_CONTAINS candidate")
    cand = _json_load(cand_txt)

    def contains(doc, c):
        if isinstance(doc, list):
            if isinstance(c, list):
                return all(contains(doc, x) for x in c)
            return any(contains(x, c) if isinstance(x, (dict, list))
                       else x == c for x in doc)
        if isinstance(doc, dict) and isinstance(c, dict):
            return all(k in doc and (contains(doc[k], v)
                                     if isinstance(v, (dict, list))
                                     else doc[k] == v)
                       for k, v in c.items())
        return doc == c

    def f(s):
        v = _json_load(s)
        return 1 if contains(v, cand) else 0
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]), f,
                         out_is_string=False, key=("json_contains", cand_txt))


@op("json_quote")
def op_json_quote(ctx, expr):
    import json as _json

    def f(s):
        return _json.dumps(str(s))
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]), f,
                         key=("json_quote",))


@op("json_array")
def op_json_array(ctx, expr):
    import json as _json

    def f(*items):
        # SQL NULL embeds as JSON null (MySQL)
        return _json.dumps([_maybe_num(x) if x is not None else None
                            for x in items])
    return _rowwise(ctx, expr, f, null_ok=True, typed_args=True)


@op("json_object")
def op_json_object(ctx, expr):
    import json as _json

    def f(*items):
        if any(items[i] is None for i in range(0, len(items) - 1, 2)):
            return None          # NULL key: error in MySQL -> NULL row
        return _json.dumps({str(items[i]):
                            (_maybe_num(items[i + 1])
                             if items[i + 1] is not None else None)
                            for i in range(0, len(items) - 1, 2)})
    return _rowwise(ctx, expr, f, null_ok=True, typed_args=True)


def _maybe_num(x):
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    return x


def _json_set_path(doc, path, val, mode):
    """mode: set|insert|replace. Supports $.a.b and $[i] paths."""
    import re as _re
    parts = _re.findall(r"\.([A-Za-z_][A-Za-z0-9_]*)|\[(\d+)\]", path[1:])
    cur = doc
    for j, (name, idx) in enumerate(parts):
        last = j == len(parts) - 1
        key = name if name else int(idx)
        if last:
            if isinstance(cur, dict) and name:
                exists = key in cur
                if (mode == "insert" and exists) or \
                        (mode == "replace" and not exists):
                    return
                cur[key] = val
            elif isinstance(cur, list) and not name:
                if key < len(cur):
                    if mode != "insert":
                        cur[key] = val
                elif mode != "replace":
                    cur.append(val)
            return
        nxt = None
        if isinstance(cur, dict) and name:
            nxt = cur.get(key)
            if nxt is None and mode != "replace":
                nxt = cur[key] = {}
        elif isinstance(cur, list) and not name and int(idx) < len(cur):
            nxt = cur[int(idx)]
        if not isinstance(nxt, (dict, list)):
            return
        cur = nxt


def _op_json_modify(ctx, expr, mode):
    import json as _json
    args = expr.args

    def f(s, *pv):
        doc = _json_load(s)
        if doc is None and str(s).strip() != "null":
            return None
        for i in range(0, len(pv) - 1, 2):
            path, val = str(pv[i]), _maybe_num(pv[i + 1])
            if isinstance(val, str):
                v2 = _json_load(val)
                val = v2 if v2 is not None and val.strip().startswith(
                    ("[", "{", '"')) else val
            if not path.startswith("$"):
                return None
            if path == "$":
                if mode != "insert":
                    doc = val
                continue
            _json_set_path(doc, path, val, mode)
        return _json.dumps(doc)
    return _rowwise(ctx, expr, f)


@op("json_set")
def op_json_set(ctx, expr):
    return _op_json_modify(ctx, expr, "set")


@op("json_insert")
def op_json_insert(ctx, expr):
    return _op_json_modify(ctx, expr, "insert")


@op("json_replace")
def op_json_replace(ctx, expr):
    return _op_json_modify(ctx, expr, "replace")


@op("json_remove")
def op_json_remove(ctx, expr):
    import json as _json
    import re as _re

    def f(s, *paths):
        doc = _json_load(s)
        if doc is None:
            return None
        for p in paths:
            p = str(p)
            parts = _re.findall(r"\.([A-Za-z_][A-Za-z0-9_]*)|\[(\d+)\]",
                                p[1:])
            cur = doc
            okpath = True
            for name, idx in parts[:-1]:
                key = name if name else int(idx)
                try:
                    cur = cur[key]
                except Exception:       # noqa: BLE001
                    okpath = False
                    break
            if okpath and parts:
                name, idx = parts[-1]
                try:
                    del cur[name if name else int(idx)]
                except Exception:       # noqa: BLE001
                    pass
        return _json.dumps(doc)
    return _rowwise(ctx, expr, f)


@op("json_merge_patch")
def op_json_merge_patch(ctx, expr):
    import json as _json

    def merge(a, b):
        if not isinstance(b, dict):
            return b
        if not isinstance(a, dict):
            a = {}
        out = dict(a)
        for k, v in b.items():
            if v is None:
                out.pop(k, None)
            else:
                out[k] = merge(out.get(k), v)
        return out

    def f(*docs):
        cur = _json_load(docs[0])
        for d in docs[1:]:
            cur = merge(cur, _json_load(d))
        return _json.dumps(cur)
    return _rowwise(ctx, expr, f)


@op("json_contains_path")
def op_json_contains_path(ctx, expr):
    import re as _re

    def f(s, mode, *paths):
        doc = _json_load(s)
        hits = 0
        for p in paths:
            v = _json_path_get(str(s), str(p))
            if v is not None:
                hits += 1
        if str(mode).lower() == "all":
            return 1 if hits == len(paths) else 0
        return 1 if hits > 0 else 0
    return _rowwise(ctx, expr, f, dtype=np.int64)


@op("timestampadd")
def op_timestampadd(ctx, expr):
    unit = expr.args[0].value.val if hasattr(expr.args[0], "value") else ""
    unit = str(unit).lower()
    n, nn, _ = eval_expr(ctx, expr.args[1])
    micros, an = _arg_micros(ctx, expr.args[2])
    xp = ctx.xp
    nulls = or_nulls(xp, an, nn)
    if unit in _TSD_UNITS:
        return xp.asarray(micros) + xp.asarray(n) * _TSD_UNITS[unit], \
            nulls, None
    mult = {"month": 1, "quarter": 3, "year": 12}.get(unit)
    if mult is None:
        raise UnknownFunctionError("TIMESTAMPADD unit %s", unit)
    days = xp.asarray(micros) // MICROS_PER_DAY
    tod = xp.asarray(micros) % MICROS_PER_DAY
    y, m, d = civil_from_days(xp, days)
    tot = y * 12 + (m - 1) + xp.asarray(n) * mult
    ny, nm = tot // 12, tot % 12 + 1
    # clamp day to the target month's length
    my, mm = xp.where(nm == 12, ny + 1, ny), xp.where(nm == 12, 1, nm + 1)
    mlen = days_from_civil(xp, my, mm, xp.asarray(1)) - \
        days_from_civil(xp, ny, nm, xp.asarray(1))
    nd = xp.minimum(d, mlen)
    return days_from_civil(xp, ny, nm, nd) * MICROS_PER_DAY + tod, \
        nulls, None


def _dur_micros(s):
    s = str(s)
    neg = s.startswith("-")
    body = s.lstrip("-")
    frac = 0
    if "." in body:
        body, fr = body.split(".", 1)
        frac = int((fr + "000000")[:6])
    parts = body.split(":")
    try:
        parts = [int(p) for p in parts]
    except ValueError:
        return None
    while len(parts) < 3:
        parts.insert(0, 0)
    us = (parts[0] * 3600 + parts[1] * 60 + parts[2]) * 1_000_000 + frac
    return -us if neg else us


def _us_to_dur(us):
    sign = "-" if us < 0 else ""
    us = abs(int(us))
    sec, frac = divmod(us, 1_000_000)
    base = "%s%02d:%02d:%02d" % (sign, sec // 3600, sec // 60 % 60,
                                 sec % 60)
    return base + (".%06d" % frac).rstrip("0").rstrip(".") if frac else base


@op("addtime")
def op_addtime(ctx, expr):
    def f(a, b):
        if ":" in str(a) or "-" in str(a)[1:]:
            # datetime or time base
            pass
        da = _dur_micros(a) if "-" not in str(a)[1:] else None
        db_ = _dur_micros(b)
        if db_ is None:
            return None
        if da is not None and ":" in str(a) and " " not in str(a):
            return _us_to_dur(da + db_)
        from ..types.time_types import parse_datetime, micros_to_str
        try:
            return micros_to_str(parse_datetime(str(a)) + db_, 0)
        except Exception:               # noqa: BLE001
            return None
    return _rowwise(ctx, expr, f)


@op("subtime")
def op_subtime(ctx, expr):
    def f(a, b):
        db_ = _dur_micros(b)
        if db_ is None:
            return None
        if ":" in str(a) and " " not in str(a) and "-" not in str(a)[1:]:
            da = _dur_micros(a)
            return _us_to_dur(da - db_) if da is not None else None
        from ..types.time_types import parse_datetime, micros_to_str
        try:
            return micros_to_str(parse_datetime(str(a)) - db_, 0)
        except Exception:               # noqa: BLE001
            return None
    return _rowwise(ctx, expr, f)


@op("timediff")
def op_timediff(ctx, expr):
    def f(a, b):
        sa, sb = str(a), str(b)
        if " " in sa or " " in sb:
            from ..types.time_types import parse_datetime
            try:
                return _us_to_dur(parse_datetime(sa) - parse_datetime(sb))
            except Exception:           # noqa: BLE001
                return None
        da, db_ = _dur_micros(sa), _dur_micros(sb)
        if da is None or db_ is None:
            return None
        return _us_to_dur(da - db_)
    return _rowwise(ctx, expr, f)


@op("time")
def op_time_fn(ctx, expr):
    def f(a):
        s = str(a)
        if " " in s:
            s = s.split(" ", 1)[1]
        us = _dur_micros(s)
        return _us_to_dur(us) if us is not None else None
    return _rowwise(ctx, expr, f)


@op("time_format")
def op_time_format(ctx, expr):
    fmt = _as_str_scalar(eval_expr(ctx, expr.args[1]))
    if fmt is None:
        raise UnknownFunctionError("non-constant TIME_FORMAT format")

    def f(a):
        us = _dur_micros(str(a))
        if us is None:
            return None
        return _format_datetime_py(abs(us), fmt)
    return _rowwise(ctx, type("E", (), {"args": [expr.args[0]]})(), f)


@op("weekofyear")
def op_weekofyear(ctx, expr):
    def f(s):
        import datetime
        try:
            y, m, d = (int(x) for x in str(s).split(" ")[0].split("-"))
            return datetime.date(y, m, d).isocalendar()[1]
        except Exception:               # noqa: BLE001
            return None
    return _rowwise(ctx, type("E", (), {"args": [expr.args[0]]})(), f,
                    dtype=np.int64)


@op("format_bytes")
def op_format_bytes(ctx, expr):
    def f(v):
        v = float(v)
        for unit in ("Bytes", "KiB", "MiB", "GiB", "TiB", "PiB"):
            if abs(v) < 1024 or unit == "PiB":
                return ("%d %s" % (v, unit)) if unit == "Bytes" \
                    else ("%.2f %s" % (v, unit))
            v /= 1024
    return _rowwise(ctx, expr, f)


@op("json_pretty")
def op_json_pretty(ctx, expr):
    import json as _json

    def f(s):
        v = _json_load(s)
        if v is None and str(s).strip() != "null":
            return None
        return _json.dumps(v, indent=2)
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]), f,
                         key=("json_pretty",))


@op("json_storage_size")
def op_json_storage_size(ctx, expr):
    def f(s):
        return len(str(s).encode())
    return _apply_str_fn(ctx, eval_expr(ctx, expr.args[0]), f,
                         out_is_string=False, key=("json_storage_size",))


@op("weight_string")
def op_weight_string(ctx, expr):
    # binary-collation sort key = the string itself (reference
    # pkg/util/collate binary collator)
    return eval_expr(ctx, expr.args[0])
