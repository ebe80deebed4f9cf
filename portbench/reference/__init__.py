"""The plain reference: each TPC-H statement of the traffic mixes worked
out in NumPy from the generated arrays and the stream's substitution
parameters, one module per statement (`<statement>.py`, found by the
statement's name). It imports neither jax, nor tidb_tpu, nor anything of
tidb_tpu_torch, and reads nothing the program made.

Each module has `rows(tables, params, precision="exact")` -> the rows as
the MySQL text protocol gives them (str, None for NULL). "exact" holds
decimals as scaled int64, as the configuration states; "float64" and
"float32" compute every decimal expression in that binary type (the
control of the check: a lower precision put in the program's place)."""
from __future__ import annotations

import importlib

PRECISIONS = ("exact", "float64", "float32")


def statement(name: str):
    """-> the reference module of statement `name`."""
    if not name.isidentifier():
        raise ValueError(f"bad statement name {name!r}")
    return importlib.import_module(f"{__name__}.{name}")
