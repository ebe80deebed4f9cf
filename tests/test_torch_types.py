"""Foundations: types, decimal, time, datum, codec ordering.

The twin of tests/test_types.py on tidb_tpu_torch, with device="cpu" at
every store."""
import random

import pytest

from tidb_tpu_torch.types import (
    new_bigint_type, new_decimal_type, new_string_type, new_double_type,
    merge_field_type, TypeClass,
    dec_to_scaled_int, scaled_int_to_str, dec_round_scaled,
    parse_date, parse_datetime, days_to_ymd, ymd_to_days, days_to_str,
    micros_to_str,
)
from tidb_tpu_torch.types.datum import Datum, Kind, NULL, datum_from_py, compare_datum
from tidb_tpu_torch.codec import (
    encode_datums_key, decode_datum_key, encode_row_value, decode_row_value,
    record_key, decode_record_key, index_key,
)


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import device_guard, metrics, phase
    metrics.reset_all()
    device_guard.reset()
    phase.reset()
    yield


class TestDecimal:
    def test_parse(self):
        assert dec_to_scaled_int("1.23", 2) == 123
        assert dec_to_scaled_int("-1.23", 2) == -123
        assert dec_to_scaled_int("1.236", 2) == 124      # round half away
        assert dec_to_scaled_int("-1.235", 2) == -124
        assert dec_to_scaled_int("7", 2) == 700
        assert dec_to_scaled_int(".5", 2) == 50
        assert dec_to_scaled_int("1e2", 2) == 10000

    def test_format(self):
        assert scaled_int_to_str(123, 2) == "1.23"
        assert scaled_int_to_str(-5, 2) == "-0.05"
        assert scaled_int_to_str(100, 0) == "100"

    def test_round(self):
        assert dec_round_scaled(12345, 3, 1) == 123   # 12.345 -> 12.3
        assert dec_round_scaled(12350, 3, 2) == 1235
        assert dec_round_scaled(15, 1, 0) == 2        # 1.5 -> 2
        assert dec_round_scaled(-15, 1, 0) == -2


class TestTime:
    def test_roundtrip_days(self):
        for days in [-10000, -1, 0, 1, 365, 10957, 20000]:
            y, m, d = days_to_ymd(days)
            assert ymd_to_days(y, m, d) == days

    def test_parse_date(self):
        assert parse_date("1970-01-01") == 0
        assert parse_date("1970-01-02") == 1
        assert parse_date("1998-09-02") == ymd_to_days(1998, 9, 2)
        assert parse_date("19980902") == ymd_to_days(1998, 9, 2)
        assert days_to_str(parse_date("1996-12-31")) == "1996-12-31"

    def test_leap(self):
        assert parse_date("2000-03-01") - parse_date("2000-02-28") == 2
        assert parse_date("1900-03-01") - parse_date("1900-02-28") == 1

    def test_datetime(self):
        us = parse_datetime("1970-01-01 00:00:01")
        assert us == 1_000_000
        assert micros_to_str(us) == "1970-01-01 00:00:01"
        us = parse_datetime("1995-03-15 12:30:45.5")
        assert micros_to_str(us, 1) == "1995-03-15 12:30:45.5"


class TestDatum:
    def test_compare(self):
        a = datum_from_py(1)
        b = datum_from_py(2.5)
        assert compare_datum(a, b) == -1
        assert compare_datum(NULL, a) == -1
        assert compare_datum(NULL, NULL) == 0
        assert compare_datum(datum_from_py("abc"), datum_from_py("abd")) == -1

    def test_decimal_vs_int(self):
        d = Datum(Kind.DECIMAL, 150, 2)  # 1.50
        assert compare_datum(d, datum_from_py(1)) == 1
        assert compare_datum(d, datum_from_py(2)) == -1


class TestCodec:
    def test_key_order_preserved(self):
        rng = random.Random(42)
        datums = [datum_from_py(rng.randint(-10**9, 10**9)) for _ in range(200)]
        datums += [NULL, datum_from_py(0)]
        keys = [(encode_datums_key([d]), d) for d in datums]
        keys.sort(key=lambda kv: kv[0])
        vals = [d.sort_key() for _, d in keys]
        assert vals == sorted(vals)

    def test_string_key_order(self):
        ss = ["", "a", "ab", "abc", "abcdefgh", "abcdefghi", "b", "ba"]
        enc = sorted((encode_datums_key([datum_from_py(s)]), s) for s in ss)
        assert [s for _, s in enc] == sorted(ss)

    def test_key_roundtrip(self):
        for v in [None, 5, -5, 3.25, "hello", b"bytes\x00x"]:
            d = datum_from_py(v)
            b = encode_datums_key([d])
            got, pos = decode_datum_key(b, 0)
            assert pos == len(b)
            assert compare_datum(got, d) == 0

    def test_float_key_order(self):
        fs = [-1e9, -1.5, -0.0, 0.0, 1e-9, 2.5, 1e9]
        enc = [encode_datums_key([datum_from_py(f)]) for f in fs]
        assert enc == sorted(enc)

    def test_row_value_roundtrip(self):
        row = [datum_from_py(1), NULL, datum_from_py(2.5),
               datum_from_py("text"), Datum(Kind.DECIMAL, 1234, 2)]
        b = encode_row_value(row)
        got = decode_row_value(b)
        assert len(got) == len(row)
        for g, w in zip(got, row):
            assert compare_datum(g, w) == 0

    def test_record_key(self):
        k = record_key(5, 100)
        assert decode_record_key(k) == (5, 100)
        assert record_key(5, 1) < record_key(5, 2) < record_key(6, -10)

    def test_index_key_order(self):
        k1 = index_key(1, 1, [datum_from_py(1), datum_from_py("a")], 1)
        k2 = index_key(1, 1, [datum_from_py(1), datum_from_py("b")], 0)
        k3 = index_key(1, 1, [datum_from_py(2), datum_from_py("a")], 0)
        assert k1 < k2 < k3


class TestFieldType:
    def test_merge(self):
        i = new_bigint_type()
        f = new_double_type()
        d = new_decimal_type(10, 2)
        s = new_string_type()
        assert merge_field_type(i, f).tclass == TypeClass.FLOAT
        assert merge_field_type(i, d).tclass == TypeClass.DECIMAL
        assert merge_field_type(d, s).tclass == TypeClass.FLOAT
        m = merge_field_type(d, new_decimal_type(8, 4))
        assert m.decimal == 4
