"""Expression rewriter: AST -> bound, typed Expression trees
(reference pkg/planner/core/expression_rewriter.go).

Uncorrelated subqueries are evaluated at rewrite time through
PlanContext.run_subquery (the reference does the same for non-correlated
scalar subqueries). Correlated subqueries are a planned item
(decorrelation to semi/anti joins).
"""
from __future__ import annotations

from ..parser import ast
from ..expression import (Expression,
                          Constant,
                          ScalarFunc,
                          const_from_py,
                          const_null)
from ..expression.fold import fold_constants
from ..types import FieldType
from ..types.field_type import (TypeClass, new_bigint_type, new_double_type,
                                new_decimal_type, new_string_type,
                                new_date_type, new_datetime_type,
                                new_null_type, merge_field_type,
                                agg_field_type)
from ..types.datum import Datum, Kind
from ..errors import UnsupportedError, WrongArgCountError
from ..parser.parser import _DecimalLiteral

_BOOL_FT = new_bigint_type()

_STRING_FUNCS = {"lower", "lcase", "upper", "ucase", "concat", "substring",
                 "substr", "mid", "left", "right", "trim", "ltrim", "rtrim",
                 "replace", "reverse", "lpad", "rpad", "cast_char",
                 "hex", "unhex", "bin", "oct", "repeat", "space", "md5",
                 "sha1", "sha", "format", "conv", "elt", "char",
                 "json_extract", "json_unquote",
                 "vec_from_text", "vec_as_text"}
_INT_FUNCS = {"length", "octet_length", "char_length", "character_length",
              "locate", "instr", "year", "month", "day", "dayofmonth",
              "quarter", "dayofweek", "weekday", "dayofyear", "hour",
              "minute", "second", "week", "datediff", "sign",
              "unix_timestamp", "cast_signed", "cast_unsigned", "ceil",
              "ceiling", "floor", "extract", "ascii", "ord", "crc32",
              "strcmp", "field", "json_valid", "json_length",
              "vec_dims"}
_FLOAT_FUNCS = {"sqrt", "exp", "ln", "log", "log2", "log10", "pow", "power",
                "cast_double", "rand", "pi", "degrees", "radians", "sin",
                "cos", "tan", "asin", "acos", "atan", "atan2",
                "vec_cosine_distance", "vec_l2_distance", "vec_l1_distance",
                "vec_negative_inner_product", "vec_inner_product",
                "vec_l2_norm", "cot"}
_STRING_FUNCS |= {"substring_index", "insert", "quote", "soundex",
                  "to_base64", "from_base64", "sha2", "make_set",
                  "export_set", "inet_ntoa", "dayname", "monthname",
                  "date_format", "sec_to_time", "maketime",
                  "json_type", "json_keys", "json_quote", "json_array",
                  "json_object", "json_set", "json_insert", "json_replace",
                  "json_remove", "json_merge_patch"}
_INT_FUNCS |= {"find_in_set", "bit_count", "interval", "inet_aton",
               "is_ipv4", "is_ipv6", "to_days", "yearweek", "microsecond",
               "timestampdiff", "period_add", "period_diff", "time_to_sec",
               "json_depth", "json_contains", "json_contains_path"}
_STRING_FUNCS |= {"addtime", "subtime", "timediff", "time",
                  "time_format", "format_bytes", "json_pretty",
                  "weight_string"}
_INT_FUNCS |= {"weekofyear", "json_storage_size"}
# builtin long tail (expression/builtins_ext.py)
_STRING_FUNCS |= {"concat_ws", "translate", "regexp_substr",
                  "regexp_replace", "sm3", "aes_encrypt", "aes_decrypt",
                  "compress", "uncompress", "password", "random_bytes",
                  "encode", "decode", "uuid", "uuid_v4", "uuid_v7",
                  "uuid_to_bin", "bin_to_uuid", "inet6_aton",
                  "inet6_ntoa", "json_array_append", "json_array_insert",
                  "json_merge", "json_merge_preserve", "json_search",
                  "get_format", "tidb_parse_tso",
                  "tidb_encode_sql_digest", "tidb_decode_sql_digests",
                  "tidb_decode_key", "tidb_decode_base64_key",
                  "tidb_decode_plan", "tidb_decode_binary_plan",
                  "tidb_mvcc_info", "tidb_bounded_staleness",
                  "format_nano_time"}
_INT_FUNCS |= {"position", "bit_length", "ilike", "regexp_like",
               "regexp_instr", "uncompressed_length",
               "validate_password_strength", "uuid_short", "is_uuid",
               "uuid_version", "is_ipv4_compat", "is_ipv4_mapped",
               "json_overlaps", "json_memberof", "member_of",
               "json_schema_valid", "json_storage_free", "to_seconds",
               "sleep", "benchmark", "vitess_hash", "tidb_shard",
               "tidb_parse_tso_logical", "tidb_current_tso",
               "tidb_is_ddl_owner", "tidb_row_checksum", "get_lock",
               "release_lock", "is_free_lock", "is_used_lock",
               "release_all_locks"}
_FLOAT_FUNCS |= {"uuid_timestamp"}
_DATE_RET_FUNCS = {"from_days", "last_day", "makedate"}
_DATETIME_RET_FUNCS_EXTRA = {"timestampadd", "convert_tz", "timestamp"}
_DATETIME_RET_FUNCS = {"str_to_date", "from_unixtime"}


def infer_binop_ft(op: str, lft: FieldType, rft: FieldType,
                   div_incr: int = 4) -> FieldType:
    if op in ("=", "!=", "<", "<=", ">", ">=", "<=>", "and", "or", "xor",
              "not", "like", "in", "regexp"):
        return _BOOL_FT.clone()
    if op in ("&", "|", "^", "<<", ">>"):
        return new_bigint_type(unsigned=True)
    if op == "div":
        # MySQL: DIV is signed unless an operand is unsigned
        return new_bigint_type(unsigned=lft.unsigned or rft.unsigned)
    if op in ("+", "-", "*"):
        m = merge_field_type(lft, rft)
        if m.tclass == TypeClass.DECIMAL:
            sa = max(lft.decimal, 0) if lft.tclass == TypeClass.DECIMAL else 0
            sb = max(rft.decimal, 0) if rft.tclass == TypeClass.DECIMAL else 0
            scale = sa + sb if op == "*" else max(sa, sb)
            # MySQL caps result scale at 30 (exact beyond 18 via the
            # big-decimal object path; reference mydecimal.go)
            return new_decimal_type(65, min(scale, 30))
        return m
    if op == "/":
        lc, rc = lft.tclass, rft.tclass
        if TypeClass.FLOAT in (lc, rc) or TypeClass.STRING in (lc, rc):
            return new_double_type()
        sa = max(lft.decimal, 0) if lc == TypeClass.DECIMAL else 0
        scale = min(sa + div_incr, 30)
        return new_decimal_type(65, scale)
    if op in ("%",):
        m = merge_field_type(lft, rft)
        return m
    return merge_field_type(lft, rft)


class Rewriter:
    def __init__(self, pctx, schema, agg_mapper=None, outer_schemas=None,
                 window_mapper=None):
        self.pctx = pctx          # PlanContext
        self.schema = schema
        self.agg_mapper = agg_mapper
        self.window_mapper = window_mapper
        self.outer_schemas = outer_schemas or []
        self.outer_used = False   # set when a column resolved via outer scope

    # ops a VECTOR operand may legally appear under: the VEC_* family,
    # equality/ordering comparisons (text collation, the reference
    # semantics), NULL tests, string casts/render, and control flow.
    # Everything numeric (arithmetic, SUM/AVG inputs) is ER 1235 —
    # a vector must never silently coerce to a float (conformance
    # satellite: VECTOR in an invalid context fails cleanly).
    _VECTOR_OK_OPS = frozenset({
        "=", "!=", "<", "<=", ">", ">=", "<=>", "in", "is_null",
        "isnull", "isnotnull", "istrue", "isfalse",
        "and", "or", "not", "like", "if", "ifnull", "nullif",
        "case", "coalesce", "cast_char", "concat", "concat_ws",
        "length", "octet_length", "char_length", "character_length",
        "vec_cosine_distance", "vec_l2_distance", "vec_l1_distance",
        "vec_negative_inner_product", "vec_inner_product",
        "vec_l2_norm", "vec_dims", "vec_from_text", "vec_as_text"})

    def _check_vector_context(self, op: str, args: list):
        for a in args:
            ft = getattr(a, "ft", None)
            if ft is not None and getattr(ft, "is_vector", False) and \
                    op not in self._VECTOR_OK_OPS:
                raise UnsupportedError(
                    "operator %s is not supported on VECTOR columns",
                    op)

    def mk_func(self, op: str, args: list, ft: FieldType | None = None) -> Expression:
        self._check_vector_context(op, args)
        if ft is None:
            if op in _DATE_RET_FUNCS:
                ft = new_date_type()
            elif op in _DATETIME_RET_FUNCS_EXTRA:
                ft = new_datetime_type()
            elif op in _DATETIME_RET_FUNCS:
                if op == "from_unixtime" and len(args) > 1:
                    ft = new_string_type()
                elif op == "str_to_date" and len(args) > 1 and \
                        isinstance(args[1], Constant) and \
                        not args[1].value.is_null and not any(
                            ("%" + c) in str(args[1].value.val)
                            for c in "HkisSTrpfhIl"):
                    # no time specifiers in the format: MySQL returns
                    # a DATE
                    ft = new_date_type()
                else:
                    ft = new_datetime_type()
            elif op in _STRING_FUNCS:
                ft = new_string_type()
            elif op in _INT_FUNCS:
                ft = new_bigint_type()
            elif op in _FLOAT_FUNCS:
                ft = new_double_type()
            elif len(args) == 2:
                ft = infer_binop_ft(op, args[0].ft, args[1].ft,
                                    self.pctx.div_prec_incr)
            elif len(args) == 1:
                ft = args[0].ft.clone() if op in ("unary-", "~", "abs") \
                    else _BOOL_FT.clone()
            else:
                ft = new_bigint_type()
        return fold_constants(ScalarFunc(op, args, ft))

    # ---- entry --------------------------------------------------------
    def rewrite(self, node) -> Expression:
        m = getattr(self, "_rw_" + type(node).__name__, None)
        if m is None:
            raise UnsupportedError("unsupported expression %s",
                                   type(node).__name__)
        return m(node)

    # ---- leaves -------------------------------------------------------
    def _rw_Literal(self, node: ast.Literal):
        v = node.value
        if isinstance(v, _DecimalLiteral):
            s = str(v)
            scale = len(s.split(".")[1]) if "." in s else 0
            from ..types.decimal import dec_to_scaled_int
            return Constant(
                value=Datum(Kind.DECIMAL, dec_to_scaled_int(s, scale), scale),
                ft=new_decimal_type(38, scale))
        if isinstance(v, bool):
            return const_from_py(int(v))
        return const_from_py(v)

    def _rw_ColumnRef(self, node: ast.ColumnRef):
        sc = self.schema.try_resolve(node.name, node.table, node.db)
        if sc is not None:
            return sc.col
        for outer in self.outer_schemas:
            sc = outer.try_resolve(node.name, node.table, node.db)
            if sc is not None:
                # correlated reference: shares the outer plan's Column so
                # decorrelation can join on it (reference decorrelate.go)
                self.outer_used = True
                return sc.col
        # raise proper error
        self.schema.resolve(node.name, node.table, node.db)

    def _rw_VariableExpr(self, node: ast.VariableExpr):
        # folded at plan time from mutable session state: never cache
        self.pctx.cacheable = False
        if node.is_system:
            v = self.pctx.sess_vars.get(node.name)
            if isinstance(v, bool):
                v = int(v)
            return const_from_py(v)
        v = self.pctx.user_vars.get(node.name.lower())
        return const_from_py(v) if v is not None else const_null()

    def _rw_ParamMarker(self, node: ast.ParamMarker):
        if self.pctx.params is None or node.index >= len(self.pctx.params):
            raise UnsupportedError("missing parameter value")
        return const_from_py(self.pctx.params[node.index])

    def _rw_DefaultExpr(self, node):
        raise UnsupportedError("DEFAULT expression outside INSERT")

    # ---- operators ----------------------------------------------------
    def _coerce_cmp_sides(self, op, l, r):
        """Insert casts so comparisons are type-consistent (temporal vs
        string literal, string vs numeric)."""
        def is_str(e):
            return e.ft.tclass in (TypeClass.STRING, TypeClass.JSON)

        def is_temporal(e):
            return e.ft.is_temporal

        def is_num(e):
            return e.ft.tclass in (TypeClass.INT, TypeClass.UINT,
                                   TypeClass.FLOAT, TypeClass.DECIMAL,
                                   TypeClass.BIT)
        if is_temporal(l) and is_str(r):
            tgt = ("cast_str_to_date" if l.ft.tclass == TypeClass.DATE
                   else "cast_str_to_datetime")
            r = self.mk_func(tgt, [r],
                             new_date_type() if l.ft.tclass == TypeClass.DATE
                             else new_datetime_type())
        elif is_temporal(r) and is_str(l):
            tgt = ("cast_str_to_date" if r.ft.tclass == TypeClass.DATE
                   else "cast_str_to_datetime")
            l = self.mk_func(tgt, [l],
                             new_date_type() if r.ft.tclass == TypeClass.DATE
                             else new_datetime_type())
        elif is_str(l) and is_num(r):
            l = self.mk_func("cast_double", [l], new_double_type())
        elif is_str(r) and is_num(l):
            r = self.mk_func("cast_double", [r], new_double_type())
        elif l.ft.tclass == TypeClass.DATE and \
                r.ft.tclass in (TypeClass.DATETIME, TypeClass.TIMESTAMP):
            l = self.mk_func("cast_date_to_datetime", [l], new_datetime_type())
        elif r.ft.tclass == TypeClass.DATE and \
                l.ft.tclass in (TypeClass.DATETIME, TypeClass.TIMESTAMP):
            r = self.mk_func("cast_date_to_datetime", [r], new_datetime_type())
        return l, r

    def _rw_BinaryOp(self, node: ast.BinaryOp):
        l = self.rewrite(node.left)
        r = self.rewrite(node.right)
        op = node.op
        if op in ("=", "!=", "<", "<=", ">", ">=", "<=>"):
            l, r = self._coerce_cmp_sides(op, l, r)
        if op in ("+", "-") and (l.ft.is_temporal or r.ft.is_temporal):
            # date + int -> date_add days (MySQL-ish)
            if l.ft.is_temporal and not r.ft.is_temporal:
                iv = self._mk_interval(r, "day")
                return self.mk_func("date_add" if op == "+" else "date_sub",
                                    [l, iv], l.ft.clone())
        return self.mk_func(op, [l, r])

    def _rw_UnaryOp(self, node: ast.UnaryOp):
        a = self.rewrite(node.operand)
        if node.op == "-":
            return self.mk_func("unary-", [a], a.ft.clone())
        if node.op == "not" or node.op == "!":
            return self.mk_func("not", [a], _BOOL_FT.clone())
        if node.op == "~":
            return self.mk_func("~", [a], new_bigint_type(unsigned=True))
        raise UnsupportedError("unary op %s", node.op)

    def _rw_IsNull(self, node: ast.IsNull):
        a = self.rewrite(node.expr)
        return self.mk_func("isnotnull" if node.negated else "isnull", [a],
                            _BOOL_FT.clone())

    def _rw_IsTruth(self, node: ast.IsTruth):
        a = self.rewrite(node.expr)
        op = "istrue" if node.truth else "isfalse"
        e = self.mk_func(op, [a], _BOOL_FT.clone())
        if node.negated:
            e = self.mk_func("not", [e], _BOOL_FT.clone())
        return e

    def _rw_Between(self, node: ast.Between):
        a = self.rewrite(node.expr)
        low = self.rewrite(node.low)
        high = self.rewrite(node.high)
        a1, low = self._coerce_cmp_sides(">=", a, low)
        a2, high = self._coerce_cmp_sides("<=", a, high)
        ge = self.mk_func(">=", [a1, low], _BOOL_FT.clone())
        le = self.mk_func("<=", [a2, high], _BOOL_FT.clone())
        e = self.mk_func("and", [ge, le], _BOOL_FT.clone())
        if node.negated:
            e = self.mk_func("not", [e], _BOOL_FT.clone())
        return e

    def _rw_InList(self, node: ast.InList):
        a = self.rewrite(node.expr)
        items = [self.rewrite(i) for i in node.items]
        coerced = []
        for it in items:
            _, it2 = self._coerce_cmp_sides("=", a, it)
            coerced.append(it2)
        if all(isinstance(i, Constant) for i in coerced):
            e = self.mk_func("in", [a] + coerced, _BOOL_FT.clone())
        else:
            e = None
            for it in coerced:
                eq = self.mk_func("=", [a, it], _BOOL_FT.clone())
                e = eq if e is None else self.mk_func("or", [e, eq],
                                                      _BOOL_FT.clone())
        if node.negated:
            e = self.mk_func("not", [e], _BOOL_FT.clone())
        return e

    def _rw_Like(self, node: ast.Like):
        a = self.rewrite(node.expr)
        pat = self.rewrite(node.pattern)
        args = [a, pat]
        if node.escape != "\\":
            args.append(const_from_py(node.escape))
        e = self.mk_func("like", args, _BOOL_FT.clone())
        if node.negated:
            e = self.mk_func("not", [e], _BOOL_FT.clone())
        return e

    def _rw_RegexpExpr(self, node: ast.RegexpExpr):
        a = self.rewrite(node.expr)
        pat = self.rewrite(node.pattern)
        e = self.mk_func("regexp", [a, pat], _BOOL_FT.clone())
        if node.negated:
            e = self.mk_func("not", [e], _BOOL_FT.clone())
        return e

    def _rw_Case(self, node: ast.Case):
        args = []
        results = []
        for cond, res in node.when_clauses:
            if node.operand is not None:
                eq = ast.BinaryOp("=", node.operand, cond)
                args.append(self.rewrite(eq))
            else:
                args.append(self.rewrite(cond))
            r = self.rewrite(res)
            args.append(r)
            results.append(r)
        if node.else_clause is not None:
            e = self.rewrite(node.else_clause)
            args.append(e)
            results.append(e)
        ft = agg_field_type([r.ft for r in results]) if results else new_null_type()
        return self.mk_func("case_when", args, ft)

    def _rw_Collate(self, node: ast.Collate):
        """expr COLLATE name: string identity cast whose result type
        carries the explicit collation, so comparison/group/sort folds
        pick it up (reference pkg/expression collation coercion).
        COLLATE only applies to string-class operands — `1 COLLATE
        utf8mb4_bin` is ER_COLLATION_CHARSET_MISMATCH in MySQL, not a
        silent cast to char."""
        a = self.rewrite(node.expr)
        if a.ft.tclass not in (TypeClass.STRING, TypeClass.NULLT):
            from ..errors import CollationCharsetMismatchError
            raise CollationCharsetMismatchError(
                "COLLATION '%s' is not valid for CHARACTER SET "
                "'binary'", node.collation)
        ft = new_string_type(getattr(a.ft, "flen", -1))
        ft.collate = node.collation
        return self.mk_func("cast_char", [a], ft)

    def _rw_Cast(self, node: ast.Cast):
        a = self.rewrite(node.expr)
        t = node.to_type
        src = a.ft.tclass
        if t in ("signed", "integer", "int"):
            return self.mk_func("cast_signed", [a], new_bigint_type())
        if t == "unsigned":
            return self.mk_func("cast_unsigned", [a],
                                new_bigint_type(unsigned=True))
        if t in ("double", "float", "real"):
            return self.mk_func("cast_double", [a], new_double_type())
        if t in ("decimal", "numeric"):
            scale = max(node.decimal, 0)
            return self.mk_func("cast_decimal", [a],
                                new_decimal_type(node.flen if node.flen > 0 else 10,
                                                 scale))
        if t in ("char", "binary", "varchar", "nchar"):
            ft = new_string_type(node.flen)
            if t == "binary":
                ft.collate = "binary"   # no-pad comparisons
            return self.mk_func("cast_char", [a], ft)
        if t == "date":
            if src in (TypeClass.STRING, TypeClass.JSON):
                return self.mk_func("cast_str_to_date", [a], new_date_type())
            if src in (TypeClass.DATETIME, TypeClass.TIMESTAMP):
                return self.mk_func("cast_datetime_to_date", [a], new_date_type())
            return self.mk_func("cast_signed", [a], new_date_type())
        if t == "datetime":
            if src in (TypeClass.STRING, TypeClass.JSON):
                return self.mk_func("cast_str_to_datetime", [a],
                                    new_datetime_type())
            if src == TypeClass.DATE:
                return self.mk_func("cast_date_to_datetime", [a],
                                    new_datetime_type())
            return self.mk_func("cast_signed", [a], new_datetime_type())
        raise UnsupportedError("unsupported CAST target %s", t)

    def _mk_interval(self, value_expr: Expression, unit: str) -> Constant:
        if not isinstance(value_expr, Constant):
            value_expr = fold_constants(value_expr)
        if not isinstance(value_expr, Constant):
            raise UnsupportedError("non-constant INTERVAL value")
        from ..types.time_types import (_COMPOUND_INTERVALS,
                                        compound_interval_value)
        if unit in _COMPOUND_INTERVALS:
            # 'D H:M:S'-style literal normalizes to the finest unit at
            # plan time; the executor only ever sees single units.
            # NULL propagates (MySQL: DATE_ADD(x, INTERVAL NULL u) is
            # NULL), it must not normalize to zero
            base_unit = _COMPOUND_INTERVALS[unit][0]
            if value_expr.value.is_null:
                return Constant(value=value_expr.value,
                                ft=new_bigint_type().clone(
                                    tp=f"interval_{base_unit}"))
            total, unit = compound_interval_value(
                value_expr.value.to_py(), unit)
            c = const_from_py(total)
            return Constant(value=c.value,
                            ft=new_bigint_type().clone(
                                tp=f"interval_{unit}"))
        ft = new_bigint_type().clone(tp=f"interval_{unit}")
        return Constant(value=value_expr.value, ft=ft)

    def _rw_IntervalExpr(self, node: ast.IntervalExpr):
        return self._mk_interval(self.rewrite(node.value), node.unit)

    def _rw_FuncCall(self, node: ast.FuncCall):
        name = node.name
        if name in ("timestampdiff", "timestampadd") and node.args and \
                isinstance(node.args[0], ast.ColumnRef) and \
                not node.args[0].table:
            # unit keyword parses as a bare identifier
            node = ast.FuncCall(name=name, args=[
                ast.Literal(value=node.args[0].name.lower())]
                + list(node.args[1:]))
        # statement-time constants
        if name in ("now", "current_timestamp", "sysdate", "localtime",
                    "localtimestamp", "utc_timestamp"):
            self.pctx.cacheable = False
            return Constant(value=Datum(Kind.DATETIME, self.pctx.now_micros),
                            ft=new_datetime_type())
        if name in ("curdate", "current_date", "utc_date"):
            self.pctx.cacheable = False
            return Constant(value=Datum(Kind.DATE,
                                        self.pctx.now_micros // 86_400_000_000),
                            ft=new_date_type())
        if name in ("curtime", "current_time", "utc_time"):
            self.pctx.cacheable = False
            us = self.pctx.now_micros % 86_400_000_000
            h, rem = divmod(us // 1_000_000, 3600)
            return const_from_py(f"{h:02d}:{rem // 60:02d}:{rem % 60:02d}")
        if name in ("database", "schema"):
            db = self.pctx.current_db
            return const_from_py(db) if db else const_null()
        if name == "version":
            return const_from_py("8.0.11-tidb-tpu-0.1.0")
        if name in ("user", "current_user", "session_user", "system_user"):
            return const_from_py(getattr(self.pctx, "user", None) or
                                 "root@%")
        if name == "connection_id":
            return const_from_py(self.pctx.conn_id)
        if name == "charset" and node.args:
            return const_from_py("utf8mb4")
        if name == "collation" and node.args:
            arg = self.rewrite(node.args[0])
            coll = getattr(getattr(arg, "ft", None), "collate", None)
            return const_from_py(coll or "utf8mb4_0900_bin")
        if name == "coercibility" and node.args:
            arg = node.args[0]
            return const_from_py(4 if isinstance(arg, ast.Literal) else 2)
        if name == "last_insert_id" and not node.args:
            return const_from_py(self.pctx.sess_vars.last_insert_id)
        if name == "found_rows":
            self.pctx.cacheable = False
            return const_from_py(self.pctx.sess_vars.found_rows)
        if name == "row_count":
            self.pctx.cacheable = False
            return const_from_py(
                getattr(self.pctx.sess_vars, "last_affected", 0))
        if name == "tidb_version":
            return const_from_py(
                "Release Version: v8.0.11-tidb-tpu-0.1.0\n"
                "Edition: TPU-native\nStore: embedded columnar+MVCC")
        if name == "current_role":
            return const_from_py("NONE")
        if name == "name_const" and len(node.args) == 2:
            return self.rewrite(node.args[1])
        if name in ("get_lock", "release_lock", "is_free_lock") and \
                node.args:
            # advisory locks (reference builtin_miscellaneous.go): session
            # side effect at plan time; single-process semantics
            self.pctx.cacheable = False
            arg0 = node.args[0]
            lock_name = str(arg0.value).lower() \
                if isinstance(arg0, ast.Literal) else ""
            locks = self.pctx.user_vars.setdefault("__advisory_locks", {})
            if name == "get_lock":
                locks[lock_name] = self.pctx.conn_id
                return const_from_py(1)
            if name == "is_free_lock":
                return const_from_py(0 if lock_name in locks else 1)
            held = locks.pop(lock_name, None)
            return const_from_py(1 if held is not None else 0)
        if name in ("predict", "embed"):
            # in-SQL inference: resolve the model handle NOW (rewrite
            # time) through the domain's epoch-fenced registry; the
            # bound MLFunc carries name#version in fingerprint/repr so
            # fragment and plan caches fence on model replacement
            from ..ml.lowering import resolve_ml_call
            return resolve_ml_call(self, node)
        if name in ("nextval", "lastval") and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.ColumnRef):
                sdb, sname = arg.table or self.pctx.current_db, arg.name
            elif isinstance(arg, ast.Literal):
                sdb, sname = self.pctx.current_db, str(arg.value)
            else:
                raise UnsupportedError("bad sequence reference")
            self.pctx.cacheable = False
            fn = getattr(self.pctx, "seq_" + name, None)
            if fn is None:
                raise UnsupportedError("sequences not available here")
            v = fn(sdb, sname)
            return const_from_py(v) if v is not None else const_null()
        if name in ("date_add", "date_sub", "adddate", "subdate"):
            base = self.rewrite(node.args[0])
            ivnode = node.args[1]
            if isinstance(ivnode, ast.IntervalExpr):
                iv = self._rw_IntervalExpr(ivnode)
            else:
                iv = self._mk_interval(self.rewrite(ivnode), "day")
            unit = iv.ft.tp.replace("interval_", "")
            subday = unit in ("hour", "minute", "second", "microsecond")
            if base.ft.tclass in (TypeClass.STRING, TypeClass.JSON):
                # keep a literal's time of day whenever it HAS one
                # (MySQL: '... 10:00:00' + INTERVAL 1 DAY keeps the
                # time); sub-day intervals always need datetime space
                has_time = isinstance(base, Constant) and \
                    not base.value.is_null and \
                    (":" in str(base.value.to_py()))
                if subday or has_time:
                    base = self.mk_func("cast_str_to_datetime", [base],
                                        new_datetime_type())
                else:
                    base = self.mk_func("cast_str_to_date", [base],
                                        new_date_type())
            out_ft = base.ft.clone()
            if subday and base.ft.tclass == TypeClass.DATE:
                out_ft = new_datetime_type()
            if unit == "microsecond" and \
                    out_ft.tclass in (TypeClass.DATETIME,
                                      TypeClass.TIMESTAMP):
                out_ft = out_ft.clone(decimal=6)   # show the fraction
            return self.mk_func(name, [base, iv], out_ft)
        if name == "get_format" and node.args:
            # GET_FORMAT(DATE|TIME|DATETIME|TIMESTAMP, region): the unit
            # is a keyword, parsed as a bare column ref
            a0 = node.args[0]
            if isinstance(a0, ast.ColumnRef) and not a0.table and \
                    a0.name.lower() in ("date", "time", "datetime",
                                        "timestamp"):
                node = ast.FuncCall(name=name, args=[
                    ast.Literal(a0.name.lower()), *node.args[1:]])
        if name == "extract":
            unit = node.args[0].value
            inner = self.rewrite(node.args[1])
            return self.mk_func("extract", [const_from_py(unit), inner],
                                new_bigint_type())
        if name == "date":
            a = self.rewrite(node.args[0])
            return self.mk_func("date", [a], new_date_type())
        if name in ("if",):
            if len(node.args) != 3:
                raise WrongArgCountError("Incorrect parameter count for IF")
            c = self.rewrite(node.args[0])
            a = self.rewrite(node.args[1])
            b = self.rewrite(node.args[2])
            return self.mk_func("if", [c, a, b],
                                agg_field_type([a.ft, b.ft]))
        if name in ("ifnull", "nullif", "coalesce"):
            args = [self.rewrite(a) for a in node.args]
            ft = (args[0].ft.clone() if name == "nullif"
                  else agg_field_type([a.ft for a in args]))
            return self.mk_func(name, args, ft)
        if name in ("greatest", "least"):
            args = [self.rewrite(a) for a in node.args]
            return self.mk_func(name, args,
                                agg_field_type([a.ft for a in args]))
        if name == "round" or name == "truncate":
            args = [self.rewrite(a) for a in node.args]
            src = args[0].ft
            d = 0
            if len(args) > 1 and isinstance(args[1], Constant) and \
                    not args[1].value.is_null:
                d = int(args[1].value.val)
            if src.tclass == TypeClass.DECIMAL:
                ft = new_decimal_type(38, min(max(d, 0), max(src.decimal, 0)))
            elif src.tclass == TypeClass.FLOAT:
                ft = new_double_type()
            else:
                ft = new_bigint_type()
            return self.mk_func(name, args, ft)
        if name == "abs":
            a = self.rewrite(node.args[0])
            return self.mk_func("abs", [a], a.ft.clone())
        if name.startswith("cast_str_to_"):
            a = self.rewrite(node.args[0])
            ft = (new_date_type() if name.endswith("date")
                  else new_datetime_type())
            return self.mk_func(name, [a], ft)
        args = [self.rewrite(a) for a in node.args]
        return self.mk_func(name, args)

    def _rw_WindowFunc(self, node):
        if self.window_mapper is None:
            raise UnsupportedError(
                "window function %s not allowed in this context", node.name)
        return self.window_mapper(node)

    def _rw_AggFunc(self, node: ast.AggFunc):
        if self.agg_mapper is None:
            from ..errors import InvalidGroupFuncError
            raise InvalidGroupFuncError("Invalid use of group function")
        return self.agg_mapper(node)

    def _rw_Wildcard(self, node):
        raise UnsupportedError("wildcard not allowed in this context")

    # ---- subqueries (uncorrelated: plan-time execution) ---------------
    def _sub_const(self, datum, ft):
        from ..expression import Constant
        if datum.is_null:
            return const_null()
        return Constant(value=datum, ft=ft)

    def _rw_ScalarSubquery(self, node: ast.ScalarSubquery):
        repl = getattr(self.pctx, "subquery_replacements", None)
        if repl is not None and id(node) in repl:
            return repl[id(node)]
        rows, fts = self.pctx.run_subquery(node.subquery)
        if len(rows) > 1:
            raise UnsupportedError("Subquery returns more than 1 row")
        if not rows:
            return const_null()
        row = rows[0]
        if len(row) != 1:
            raise UnsupportedError("Operand should contain 1 column")
        return self._sub_const(row[0], fts[0])

    def _rw_InSubquery(self, node: ast.InSubquery):
        a = self.rewrite(node.expr)
        rows, fts = self.pctx.run_subquery(node.subquery)
        items = [self._sub_const(r[0], fts[0]) for r in rows]
        if not items:
            result = const_from_py(0)
            if node.negated:
                result = const_from_py(1)
            return result
        lst = ast.InList(expr=node.expr, items=[], negated=node.negated)
        coerced = []
        for it in items:
            _, it2 = self._coerce_cmp_sides("=", a, it)
            coerced.append(it2)
        e = self.mk_func("in", [a] + coerced, _BOOL_FT.clone())
        if node.negated:
            e = self.mk_func("not", [e], _BOOL_FT.clone())
        return e

    def _rw_ExistsSubquery(self, node: ast.ExistsSubquery):
        rows, _ = self.pctx.run_subquery(node.subquery, limit_one=True)
        v = bool(rows)
        if node.negated:
            v = not v
        return const_from_py(int(v))

    def _rw_CompareSubquery(self, node: ast.CompareSubquery):
        a = self.rewrite(node.expr)
        rows, fts = self.pctx.run_subquery(node.subquery)
        vals = [r[0] for r in rows]
        if any(v.is_null for v in vals):
            return const_null()
        if not vals:
            return const_from_py(1 if node.quantifier == "all" else 0)
        agg = (max if ((node.op in (">", ">=")) == (node.quantifier == "all"))
               else min)
        pivot = agg(vals, key=lambda d: d.sort_key())
        c = self._sub_const(pivot, fts[0])
        a2, c2 = self._coerce_cmp_sides(node.op, a, c)
        return self.mk_func(node.op, [a2, c2], _BOOL_FT.clone())
