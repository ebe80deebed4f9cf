"""Logical export (reference dumpling/ — consistent-snapshot CSV/SQL dump).

export_table / export_database write CSV (or INSERT-statement SQL) files
from a single snapshot ts, chunked by row count (dumpling -F analog)."""
from __future__ import annotations

import csv
import os


def export_table(domain, db: str, table: str, out_dir: str, fmt="csv",
                 chunk_rows=1_000_000, read_ts=None) -> int:
    from ..session import Session
    sess = Session(domain)
    sess.vars.current_db = db
    t = domain.infoschema().table_by_name(db, table)
    ctab = domain.columnar.tables.get(t.id)
    os.makedirs(out_dir, exist_ok=True)
    cols = t.public_columns()
    names = [c.name for c in cols]
    if ctab is None or ctab.n == 0:
        path = os.path.join(out_dir, f"{db}.{table}.0.{fmt}")
        with open(path, "w", newline="") as f:
            if fmt == "csv":
                csv.writer(f).writerow(names)
        return 0
    import numpy as np
    valid = np.nonzero(ctab.valid_at(read_ts))[0]
    total = 0
    file_no = 0
    for start in range(0, len(valid), chunk_rows):
        idx = valid[start:start + chunk_rows]
        path = os.path.join(out_dir, f"{db}.{table}.{file_no}.{fmt}")
        file_no += 1
        columns = [ctab.column_for(c, idx) for c in cols]
        with open(path, "w", newline="") as f:
            if fmt == "csv":
                w = csv.writer(f)
                w.writerow(names)
                for i in range(len(idx)):
                    w.writerow([columns[j].get_py(i)
                                for j in range(len(cols))])
            else:   # sql
                for i in range(len(idx)):
                    vals = []
                    for j in range(len(cols)):
                        v = columns[j].get_py(i)
                        if v is None:
                            vals.append("NULL")
                        elif isinstance(v, (int, float)):
                            vals.append(str(v))
                        else:
                            s = str(v).replace("'", "''")
                            vals.append(f"'{s}'")
                    f.write(f"INSERT INTO `{table}` VALUES "
                            f"({', '.join(vals)});\n")
        total += len(idx)
    return total


def export_database(domain, db: str, out_dir: str, fmt="csv") -> dict:
    counts = {}
    read_ts = domain.storage.current_ts()
    for t in domain.infoschema().tables_in_schema(db):
        counts[t.name] = export_table(domain, db, t.name, out_dir, fmt,
                                      read_ts=read_ts)
    return counts
