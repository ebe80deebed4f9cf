"""TestKit (reference pkg/testkit/testkit.go:79 — MustExec /
MustQuery().Check()). The workhorse harness: whole SQL layer in-process
against the embedded store."""
from __future__ import annotations

from .session import Session, Domain, new_store


class TestKit:
    __test__ = False          # not a pytest test class

    def __init__(self, domain: Domain | None = None, device=None,
                 mesh=None):
        """device: the coprocessor's torch device for a new store
        (default "cuda"; raises when there is none). mesh: its MPP mesh
        (a parallel.Mesh, or an int: that many shards on the device —
        the counterpart of the reference's virtual device count)."""
        self.domain = domain or new_store(device=device, mesh=mesh)
        self.sess = Session(self.domain)
        self.sess.vars.current_db = "test"
        # write-time row<->index self-check in testing builds (reference
        # intest.EnableInternalCheck + mutation_checker.go); perf
        # harnesses opt out (TIDB_TPU_MUTATION_CHECK=0) so measured
        # write paths match a real deployment
        import os as _os
        from .executor.table_rt import MUTATION_CHECK
        MUTATION_CHECK[0] = _os.environ.get(
            "TIDB_TPU_MUTATION_CHECK", "1") != "0"

    def must_exec(self, sql: str, params=None):
        return self.sess.execute(sql, params)

    def must_query(self, sql: str, params=None) -> "QueryResult":
        rs = self.sess.execute(sql, params)
        return QueryResult(rs)

    def exec_err(self, sql: str) -> Exception:
        from .errors import TiDBError
        try:
            self.sess.execute(sql)
        except TiDBError as e:
            return e
        raise AssertionError(f"expected error for: {sql}")

    def new_session(self) -> "TestKit":
        tk = TestKit.__new__(TestKit)
        tk.domain = self.domain
        tk.sess = Session(self.domain)
        tk.sess.vars.current_db = "test"
        return tk


def import_columns(tk, table: str, arrays: dict):
    """Bulk-append columns of `table` (database test) given as
    {column name: (data, nulls, dict values)} — the form tidb_tpu's
    columnar engine holds them in: data the numpy array (int32 codes
    for dictionary columns), nulls a bool mask or None, dict values the
    code -> string list or None. Dictionaries are seeded in code order
    so the codes carry over as-is; rows go through the same bulk_append
    path the TPC-H loader uses."""
    domain = tk.domain
    tbl = domain.infoschema().table_by_name("test", table)
    ctab = domain.columnar.table(tbl)
    cols, nulls, n = {}, {}, None
    for name, (data, nl, values) in arrays.items():
        ci = tbl.find_column(name)
        if ci is None:
            raise KeyError(f"{table} has no column {name}")
        if values is not None:
            d = ctab.dicts[ci.id]
            for v in values:
                d.encode_one(v)
            if d.values[:len(values)] != list(values):
                raise ValueError(f"{table}.{name}: dictionary already "
                                 "holds other values")
        cols[name] = data
        if nl is not None:
            nulls[name] = nl
        n = len(data) if n is None else n
        if len(data) != n:
            raise ValueError(f"{table}.{name}: {len(data)} rows, "
                             f"expected {n}")
    ctab.bulk_append(cols, n or 0, nulls=nulls or None)


class QueryResult:
    __test__ = False

    def __init__(self, rs):
        self.rs = rs
        self.names = rs.names

    @property
    def rows(self):
        return self.rs.rows

    def _norm(self):
        out = []
        for row in self.rows:
            out.append(tuple("<nil>" if v is None else _fmt(v) for v in row))
        return out

    def check(self, expected: list):
        """expected: list of tuples/lists of strings (or values)."""
        got = self._norm()
        want = [tuple("<nil>" if v is None else _fmt(v) for v in row)
                for row in expected]
        assert got == want, f"result mismatch:\n got: {got}\nwant: {want}"
        return self

    def sort_check(self, expected: list):
        got = sorted(self._norm())
        want = sorted(tuple("<nil>" if v is None else _fmt(v) for v in row)
                      for row in expected)
        assert got == want, f"result mismatch:\n got: {got}\nwant: {want}"
        return self

    def check_contain(self, text: str):
        for row in self._norm():
            if any(text in c for c in row):
                return self
        raise AssertionError(f"{text!r} not found in {self._norm()}")


def _fmt(v):
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, float):
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(v)
    return str(v)
