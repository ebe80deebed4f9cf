"""Builtin conformance table generator (reference
tidb_tpu/tools/conformance.py): coverage of TiDB's function-name surface
by the port's evaluator.

TiDB's ~600 "builtins" are per-type Go signatures
(builtin_arithmetic.go builtinArithmeticPlusIntSig etc.); the
engine's dual-backend evaluator collapses those to name-level functions,
so conformance is tracked by SQL NAME against TiDB's
pkg/parser/ast/functions.go constant list (the port's own copy of the
snapshot below).

Run:  python -m tidb_tpu_torch.tools.conformance
(prints the table; it writes no file)
"""
from __future__ import annotations

# snapshot of TiDB's pkg/parser/ast/functions.go names
# (internal Go aliases and non-function constants pruned)
REF_NAMES = """
abs acos adddate addtime aes_decrypt aes_encrypt any_value
approx_count_distinct approx_percentile ascii asin atan atan2 avg
benchmark bin bin_to_uuid bit_and bit_count bit_length bit_or bit_xor
case cast ceil ceiling char_func char_length character_length charset
coalesce coercibility collation compress concat concat_ws connection_id
conv convert convert_tz cos cot count crc32 cume_dist curdate
current_date current_role current_time current_timestamp current_user
curtime database date date_add date_format date_sub datediff day dayname
dayofmonth dayofweek dayofyear decode default_func degrees dense_rank
div elt encode exp export_set extract field find_in_set first_value
floor format format_bytes format_nano_time found_rows from_base64
from_days from_unixtime get_format get_lock greatest group_concat
hex hour if ifnull ilike in inet6_aton inet6_ntoa inet_aton inet_ntoa
insert_func instr interval is_free_lock is_ipv4 is_ipv4_compat
is_ipv4_mapped is_ipv6 is_used_lock is_uuid isnull json_array
json_array_append json_array_insert json_arrayagg json_contains
json_contains_path json_depth json_extract json_insert json_keys
json_length json_memberof json_merge json_merge_patch
json_merge_preserve json_object json_objectagg json_overlaps
json_pretty json_quote json_remove json_replace json_schema_valid
json_search json_set json_storage_free json_storage_size json_type
json_unquote json_valid lag last_day last_insert_id last_value lcase
lead least left length like ln load_file localtime localtimestamp locate
log log10 log2 lower lpad ltrim make_set makedate maketime max md5
microsecond mid min minute mod month monthname name_const now nth_value
ntile nullif oct octet_length ord password percent_rank period_add
period_diff pi position pow power quarter quote radians rand
random_bytes rank regexp regexp_instr regexp_like regexp_replace
regexp_substr release_all_locks release_lock repeat replace reverse
right round row_count row_number rpad rtrim schema sec_to_time second
session_user sha sha1 sha2 sign sin sleep sm3 soundex space sqrt std
stddev stddev_pop stddev_samp str_to_date strcmp subdate substr
substring substring_index subtime sum sysdate system_user tan
tidb_bounded_staleness tidb_current_tso tidb_decode_base64_key
tidb_decode_key tidb_decode_plan tidb_decode_sql_digests
tidb_is_ddl_owner tidb_parse_tso tidb_parse_tso_logical
tidb_row_checksum tidb_shard tidb_version time time_format time_to_sec
timediff timestamp timestampadd timestampdiff to_base64 to_days
to_seconds translate trim truncate ucase uncompress uncompressed_length
unhex unix_timestamp upper user utc_date utc_time utc_timestamp uuid
uuid_short uuid_timestamp uuid_to_bin uuid_version validate_password_strength
var_pop var_samp variance version vitess_hash week weekday weekofyear
weight_string xor year yearweek
""".split()

# SQL-name aliases the engine implements under a different key
ALIASES = {
    "char_func": "char", "insert_func": "insert", "schema": "database",
    "session_user": "user", "system_user": "user",
    "current_date": "curdate", "current_time": "curtime",
    "localtime": "now", "localtimestamp": "now",
    "current_timestamp": "now", "json_memberof": "json_memberof",
}

# names resolved at plan/rewrite time (planner/rewriter.py), not via the
# scalar registry
REWRITE_TIME = {
    "now", "curdate", "curtime", "current_date", "current_time",
    "current_timestamp", "localtime", "localtimestamp", "sysdate",
    "utc_date", "utc_time", "utc_timestamp", "user", "current_user",
    "session_user", "system_user", "database", "schema", "version",
    "connection_id", "found_rows", "row_count", "last_insert_id",
    "tidb_version", "current_role", "name_const", "charset",
    "collation", "coercibility", "cast", "convert", "case", "rand",
    "default_func", "get_lock", "is_free_lock",
}


def build_table():
    from ..expression import vec
    from ..parser.parser import AGG_FUNCS, WINDOW_ONLY_FUNCS
    scalar = set(vec._REGISTRY)
    rows = []
    for name in sorted(set(REF_NAMES)):
        impl = ALIASES.get(name, name)
        if impl in scalar or name in scalar:
            how = "scalar (dual-backend registry)"
        elif name in AGG_FUNCS or impl in AGG_FUNCS:
            how = "aggregate"
        elif name in WINDOW_ONLY_FUNCS or impl in WINDOW_ONLY_FUNCS:
            how = "window"
        elif name in REWRITE_TIME or impl in REWRITE_TIME:
            how = "plan-time (rewriter fold)"
        else:
            how = "MISSING"
        rows.append((name, how))
    return rows


def main():
    rows = build_table()
    total = len(rows)
    missing = [n for n, h in rows if h == "MISSING"]
    print("# Builtin conformance")
    print()
    print("Generated by `python -m tidb_tpu_torch.tools.conformance`.")
    print("Coverage is tracked by SQL function NAME against TiDB's")
    print("parser/ast/functions.go list; TiDB's")
    print("~600 per-type Go signatures collapse into name-level")
    print("dual-backend functions here (expression/vec.py +")
    print("expression/builtins_ext.py).")
    print()
    print(f"**{total - len(missing)} / {total} TiDB function names "
          f"implemented** ({len(missing)} missing).")
    print()
    print("| function | implementation tier |")
    print("|---|---|")
    for name, how in rows:
        mark = "**MISSING**" if how == "MISSING" else how
        print(f"| {name} | {mark} |")
    if missing:
        print()
        print("Missing: " + ", ".join(missing))


if __name__ == "__main__":
    main()
